"""Packed (structure-of-arrays) particle ops: state is [d, N], N minor.

All hot-loop compute in this framework runs packed: the particle axis is
the contiguous one, so every elementwise pass, reduction and rotation over
particles reads whole cache lines, and a propagate is one ``[m, d] @
[d, N]`` matmul instead of N tiny ones. This replaces the reference's
per-particle tiled CUDA matvecs (``src/mvn_dist.cu.cpp:33-172``,
TILE_SIZE=16).

Precision: f32 matmuls are pinned to ``Precision.HIGHEST``. At the
default precision the GPU may run an f32 product in TF32 (10 mantissa
bits), which puts ~1e-3 relative error on the propagated state and the
likelihood quadform at d=128; the on-device check in ``chip_smoke.py``
measures both (numbers in PERF.md).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def matvec(A: jnp.ndarray, X: jnp.ndarray, out_dtype=None) -> jnp.ndarray:
    """[m, d] @ [d, N] -> [m, N] batched over particles, at full f32
    precision (bf16 operands multiply exactly).

    ``out_dtype`` sets the accumulation/output type — the mixed-precision
    path feeds bfloat16 operands with float32 accumulation, so residuals
    carry no accumulation rounding on top of the stored-state rounding."""
    return jnp.matmul(A, X, preferred_element_type=out_dtype,
                      precision=lax.Precision.HIGHEST)


def quadform(Linv: jnp.ndarray, R: jnp.ndarray) -> jnp.ndarray:
    """sum_j (Linv @ R)_j^2 over the state axis -> [N].

    The Mahalanobis quadratic form of residuals R [k, N] given the inverse
    Cholesky factor of the covariance (one fused pass; replaces the
    reference's 3-kernel pdf chain ``mvn_dist.cu.cpp:455-668``).
    """
    Z = matvec(Linv, R)
    return jnp.sum(Z * Z, axis=0)
