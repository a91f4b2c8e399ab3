"""Architecture configurations: one module per architecture and the
``registry`` that resolves them (a copy of the JAX package's data)."""
