"""Parameter bridges between the JAX package and the port."""
