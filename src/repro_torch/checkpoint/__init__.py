"""Checkpoints of parameter and optimizer trees as flat-key ``.npz``."""
