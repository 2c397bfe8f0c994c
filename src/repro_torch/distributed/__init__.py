"""Distributed training: the mesh (``context``), the sharding rules, the
pipeline, gradient compression and the rank checks."""
