"""waterorderlib_tpu_torch: the PyTorch/CUDA port of waterorderlib_tpu.

Module names mirror the JAX package (`waterorderlib_tpu`), which stays the
reference the port is held against. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package becomes a CUDA kernel for Hopper (sm_90a)
under `ops/cuda/`. The port imports no jax and nothing of the JAX package:
it keeps its own copies of the jax-free modules it needs (`io`,
`stats.blocks`, `utils.logging`).
"""

__version__ = "0.1.0"
