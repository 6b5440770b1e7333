"""Utilities: a copy of the JAX package's jax-free `utils.logging`."""
