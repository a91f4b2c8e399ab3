"""Entry points: ``serve`` (transformer pods with Fograph-style placement)
and ``train`` (the training loop with checkpoints)."""
