"""Entry points: ``serve`` (transformer pods with Fograph-style placement)."""
