"""Models of the port: ``llama`` (the flagship) and ``convert``, which
carries the JAX Llama's weights across."""
