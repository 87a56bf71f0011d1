"""Training (port of the JAX package's ``training`` package)."""
