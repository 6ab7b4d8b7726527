"""Systematic / stratified / multinomial resamplers.

The reference ships only the Metropolis resampler (its registry at
``/root/reference/inst/include/types.hpp:32-34`` has one entry, registered at
``src/mcmc.cpp:293-295``). These are the north-star extensions
(BASELINE.json: "systematic resampling"): low-variance resamplers built on a
normalized-weight CDF. All operate on log-weights and return int32 ancestor
indices [N].

All three CDF resamplers factor as (sorted positions in [0,1)) x (inverse
CDF). The position generators are exposed in ``POSITION_FNS`` so the packed
filter path can feed them to ``cusmc_tpu.ops.monotone_gather.
inverse_cdf_apply``, which computes the ancestors AND applies them to the
packed state. Every inversion here goes through the same search
(``inverse_cdf_search``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cusmc_tpu.ops.monotone_gather import inverse_cdf_search, weight_cdf


def _normalized_weights(log_weights: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.softmax(log_weights)


def _inverse_cdf(positions: jnp.ndarray, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Ancestors a_i with cdf[a_i - 1] <= positions_i < cdf[a_i]; the
    search clips to N-1, which guards the final bin (cdf[-1] may round
    below 1.0 in f32)."""
    cdf = weight_cdf(_normalized_weights(log_weights))
    return inverse_cdf_search(cdf, positions)


def systematic_positions(key: jax.Array, n: int, dtype=jnp.float32
                         ) -> jnp.ndarray:
    """One shared uniform offset: positions (i + u)/N. Lowest variance."""
    u = jax.random.uniform(key, (), dtype=dtype)
    return (jnp.arange(n, dtype=dtype) + u) / n


def stratified_positions(key: jax.Array, n: int, dtype=jnp.float32
                         ) -> jnp.ndarray:
    """Independent uniform per stratum: positions (i + u_i)/N."""
    u = jax.random.uniform(key, (n,), dtype=dtype)
    return (jnp.arange(n, dtype=dtype) + u) / n


def systematic_ancestors(key: jax.Array, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Systematic resampling (shared offset); see ``systematic_positions``."""
    n = log_weights.shape[0]
    return _inverse_cdf(systematic_positions(key, n, log_weights.dtype),
                        log_weights)


def stratified_ancestors(key: jax.Array, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Stratified resampling (per-stratum offsets)."""
    n = log_weights.shape[0]
    return _inverse_cdf(stratified_positions(key, n, log_weights.dtype),
                        log_weights)


def sorted_uniforms(key: jax.Array, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """Order statistics of n iid U(0,1) draws, generated DIRECTLY sorted
    via exponential spacings (u_(i) = S_i / S_{n+1}, S = cumsum of Exp(1))
    — no sort, no N^2 anything."""
    e = -jnp.log(jax.random.uniform(key, (n + 1,), dtype,
                                    minval=jnp.finfo(dtype).tiny))
    s = jnp.cumsum(e)
    return s[:n] / s[n]


def multinomial_ancestors(key: jax.Array, log_weights: jnp.ndarray) -> jnp.ndarray:
    """IID draws from the weight distribution (highest variance, simplest).

    Implemented by inverse-CDF at sorted uniform order statistics — the
    ancestor MULTISET is exactly multinomial, returned in sorted order
    (resampling is exchangeable, so any order is valid). The obvious
    ``jax.random.categorical(key, logw, shape=(n,))`` materializes an
    [n, n] Gumbel tensor — 4 TB at n=1M."""
    n = log_weights.shape[0]
    return _inverse_cdf(sorted_uniforms(key, n, log_weights.dtype),
                        log_weights)


# Sorted-position generators for the packed inverse-CDF resample
# (ops/monotone_gather.inverse_cdf_apply): (key, n, dtype) -> positions [n].
POSITION_FNS = {
    "systematic": systematic_positions,
    "stratified": stratified_positions,
    "multinomial": sorted_uniforms,
}


def _residual_parts(log_weights: jnp.ndarray):
    """Shared residual-decomposition pieces: (copy-count cumsum [n],
    n_det scalar int32, residual-weight vector [n])."""
    n = log_weights.shape[0]
    w = _normalized_weights(log_weights)
    nw = n * w
    counts = jnp.floor(nw)
    ccum = weight_cdf(counts)
    n_det = jnp.minimum(ccum[-1], n).astype(jnp.int32)
    resid = jnp.maximum(nw - counts, 0.0)
    return ccum, n_det, resid


def _residual_positions(key: jax.Array, n: int, n_det: jnp.ndarray, dtype):
    """Sorted positions in [0, 1) whose first R = n - n_det entries are
    exactly R uniform order statistics (Renyi: S_k / S_{R+1} for
    exponential-spacing partial sums S) — the traced R costs one dynamic
    gather of S_{R+1}, no sorting. Entries past R exceed 1 and map to
    clipped (unused) ranks."""
    e = -jnp.log(jax.random.uniform(key, (n + 1,), dtype,
                                    minval=jnp.finfo(dtype).tiny))
    s = jnp.cumsum(e)
    s_r1 = jnp.take(s, n - n_det)  # S_{R+1} (0-indexed S[R])
    return s[:n] / s_r1


def residual_ancestors(key: jax.Array, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Residual resampling (Liu & Chen 1998): particle i is copied
    ``floor(N*w_i)`` times deterministically; the remaining
    ``R = N - sum(floor(N*w_i))`` slots are filled by multinomial draws from
    the residual weights ``N*w_i - floor(N*w_i)``. Variance below
    multinomial, randomness below stratified.

    Static-shape formulation (jit/scan-safe). The residual multiset is
    drawn as SORTED uniform order statistics over the residual CDF —
    exactly multinomial (resampling is exchangeable, see
    ``multinomial_ancestors``) — with the traced remainder count R handled
    by the Renyi representation (``_residual_positions``): no sorting, one
    dynamic roll to align the draws to the tail slots.
    """
    n = log_weights.shape[0]
    ccum, n_det, resid = _residual_parts(log_weights)
    slots = jnp.arange(n)
    # Deterministic slots i < n_det: a_i = #{j: ccum_j <= i} (integer
    # grid inverse CDF).
    det = inverse_cdf_search(ccum, slots.astype(ccum.dtype))
    # Residual multiset: R sorted-uniform order statistics through the
    # residual CDF (unnormalized; positions scaled by the total).
    rcdf = weight_cdf(resid)
    v = _residual_positions(key, n, n_det, rcdf.dtype) * rcdf[-1]
    res = inverse_cdf_search(rcdf, v)
    # Slot i >= n_det uses residual draw i - n_det: roll right by n_det
    # (double-and-slice: contiguous copies, no gather).
    res = jax.lax.dynamic_slice_in_dim(
        jnp.concatenate([res, res]), n - n_det, n)
    return jnp.where(slots < n_det, det, res)
