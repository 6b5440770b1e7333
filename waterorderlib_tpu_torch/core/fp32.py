"""Correctly rounded float32 arithmetic on any device.

The CUDA kernels' `sqrtf` and `fmaf` round once; torch's float32 CPU sqrt
does not always, and torch has no fused multiply-add. Near 0 and 180 degrees
arccos turns one ulp of cosine into ~1e-4 degrees, so the plain paths and
the kernels' plain versions take these two operations from here.
"""

from __future__ import annotations

import torch


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as sqrtf is. torch.sqrt of a
    float32 CPU tensor is off by an ulp for ~13% of inputs; the root of the
    float64 value rounded to float32 is exact (53 >= 2*24+2 bits)."""
    return torch.sqrt(x.double()).float()


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as fmaf: the product is exact in
    float64; the float64 sum rounds once more only if it falls exactly
    halfway between two floats."""
    return (a.double() * b.double() + c.double()).float()


def xla_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last (xyz) axis of a * b as a fused multiply-add
    chain: a0*b0, then fma(a1, b1, .), then fma(a2, b2, .). It is the
    contraction XLA's CPU backend gives the JAX package's norms, sums of
    products over xyz and einsums; near 0 and 180 degrees arccos turns one
    ulp of cosine into ~1e-4 degrees, so the order is kept."""
    acc = a[..., 0] * b[..., 0]
    for i in (1, 2):
        acc = fma_f32(a[..., i], b[..., i], acc)
    return acc
