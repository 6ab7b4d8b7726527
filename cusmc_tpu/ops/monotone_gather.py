"""Inverse-CDF search and ancestor apply for the CDF resamplers.

The CDF resampler family (systematic / stratified / multinomial /
residual) factors as sorted positions in [0, total) against the
inclusive weight cumsum ``cdf``. Ancestors follow the rank contract

    a[i] = #{j: cdf[j] <= positions[i]}, clipped to N - 1,

which is ``jnp.searchsorted(cdf, positions, side="right")``. At N = 1M the
f32 cdf is 4 MB, so every probe of the binary search stays in the GPU's
L2 cache; the state apply is one ``jnp.take`` over the packed [d, N]
particles. The ``scan_unrolled`` lowering of ``jnp.searchsorted`` was chosen
by measurement (``benchmarks/bench_search.py``; numbers in PERF.md).

- ``weight_cdf(w)`` — the monotone inclusive cumsum the search needs.
- ``inverse_cdf_search(cdf, positions)`` — ancestors only.
- ``inverse_cdf_apply(cdf, positions, X)`` — ancestors and ``X[:, a]``;
  with ``local_base`` it serves the sharded ring exchange.
- ``take_columns(X, a)`` — apply a given ancestor vector.

Replaces the role of the reference's host-side ancestor gather + H2D
round-trip (reference ``src/mvn_dist.cu.cpp:194-205``) for the
low-variance resampler family (north-star extension, BASELINE.md).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

def weight_cdf(w: jnp.ndarray) -> jnp.ndarray:
    """Inclusive cumsum of non-negative weights ``w`` [N], exactly
    monotone. XLA's cumsum sums each prefix in its own order, so across a
    run of zero weights neighbouring entries can differ by an ulp in
    either direction; the running max (exact in any order) removes the
    dips that would break the binary search's contract."""
    return lax.cummax(jnp.cumsum(w))


def inverse_cdf_search(cdf: jnp.ndarray, positions: jnp.ndarray
                       ) -> jnp.ndarray:
    """Ancestors a[i] = #{j: cdf[j] <= positions[i]} clipped to N-1, as
    int32 [L]. ``cdf`` [N] is the inclusive weight cumsum; normalization
    is not required (scale ``positions`` by ``cdf[-1]``). L need not
    equal N: the sharded path searches its n_local queries over the
    gathered global cdf."""
    n = cdf.shape[0]
    a = jnp.searchsorted(cdf, positions.astype(cdf.dtype), side="right",
                         method="scan_unrolled")
    return jnp.minimum(a, n - 1).astype(jnp.int32)


def take_columns(X: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """``X[:, a]`` for packed X [d, N] and in-range int32 ancestors a."""
    return jnp.take(X, a, axis=1, mode="clip")


def inverse_cdf_apply(cdf: jnp.ndarray, positions: jnp.ndarray,
                      X: jnp.ndarray, *, local_base=None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse-CDF resample: returns ``(X[:, a], a)`` with ``a`` from
    ``inverse_cdf_search(cdf, positions)``. ``X`` [d, N] is packed.

    ``local_base`` (traced int32 scalar) switches to the LOCAL-BLOCK mode
    of the sharded ring exchange: ``cdf`` stays the GLOBAL [N] cumsum,
    ``positions`` are this shard's [L] queries, and ``X`` is the shard's
    local [d, L] block holding global columns [local_base, local_base + L).
    Ancestors come back in GLOBAL indices for every query; resampled
    values are valid only where the ancestor lies in the local block (the
    caller masks by that range and fills the rest from later ring rounds).
    """
    a = inverse_cdf_search(cdf, positions)
    if local_base is None:
        return take_columns(X, a), a
    return take_columns(X, a - local_base), a
