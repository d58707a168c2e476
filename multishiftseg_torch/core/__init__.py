"""Configuration (the port's copy of the JAX package's config tree)."""
