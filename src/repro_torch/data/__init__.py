"""The synthetic training corpus and the input specs of every shape."""
