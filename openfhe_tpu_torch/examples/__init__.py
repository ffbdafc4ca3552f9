"""The JAX package's example programs on the port, one module each."""
