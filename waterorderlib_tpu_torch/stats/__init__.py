"""Statistics: a copy of the JAX package's jax-free `stats.blocks`."""
