"""Deterministic, resumable data pipelines (numpy batches)."""
