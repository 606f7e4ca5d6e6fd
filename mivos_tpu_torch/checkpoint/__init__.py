"""Weight conversion from the JAX package's parameter trees."""
