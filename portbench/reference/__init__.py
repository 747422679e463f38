"""Plain PyTorch references, one file a model family.  They import nothing
of the port, of the JAX package or of JAX."""
