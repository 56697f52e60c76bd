"""Checkpoints of a training state in the reference's on-disk format."""
