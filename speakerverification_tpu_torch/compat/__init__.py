"""Reference torch checkpoints in and out of the port: ``torch_port``
(a reference ``.pt`` → the JAX layout → a port ``state_dict``) and
``torch_export`` (its inverse)."""
