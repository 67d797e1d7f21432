"""Parameter bridges between the JAX package and the port, and the
checkpoint converters."""
