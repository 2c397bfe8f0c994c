"""Elastic scaling and node-failure runtime."""
