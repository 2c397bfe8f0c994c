"""Meshes over an initialised world and the launcher of ranks."""
