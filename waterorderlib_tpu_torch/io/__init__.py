"""Topology and trajectory I/O: a copy of the JAX package's jax-free
`waterorderlib_tpu.io`, kept in the port so that it imports nothing of that
package. Native decoders are found under `native/` at the repository root."""
