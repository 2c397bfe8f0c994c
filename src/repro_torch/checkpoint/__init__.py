"""Atomic, versioned checkpoints of the training state."""
