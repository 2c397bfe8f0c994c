"""Serving on the port: continuous batching over the dense decoder LM."""
