"""Multivariate Student-T: log-density and sampling as pure JAX functions.

Replacement for the reference MVT layer:
- CPU pdf with Gamma-ratio normalization at
  ``/root/reference/src/statistics.cc.cpp:295-324`` and CUDA kernels
  (``src/mvt_dist.cu.cpp:356-571``) -> one fused log-density.
- Sampler: the reference draws an *independent* chi-square scale per
  dimension (``src/statistics.cc.cpp:379-411``; GPU ``src/mvt_dist.cu.cpp:71-82``),
  which is a nonstandard product-t. We implement the standard construction
  (one chi-square per vector: ``x = mu + L z * sqrt(nu/g)``) by default and
  keep the reference's per-dimension variant available as
  ``per_dim_chi=True`` for behavioural comparison (SURVEY.md §0, §7).

Note the reference GPU normalization bug — ``pow(nu, d/2)`` missing the pi
factor (``src/statistics.cu.cpp:285-287``) — is NOT reproduced; we match the
correct CPU form ``(pi*nu)^{-d/2}``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from cusmc_tpu.utils.linalg import (
    cov_sqrt,
    log_det_from_chol,
    tri_inverse,
    tri_solve,
)



_PRECISIONS = {"highest": jax.lax.Precision.HIGHEST,
               "default": jax.lax.Precision.DEFAULT}


def make_mvt_logprob(mean: jnp.ndarray, cov: jnp.ndarray, df,
                     precision: str = "highest"):
    """Closure evaluating log MVT(x; mean, cov, df) with the Cholesky
    factor, its explicit inverse, and the normalizer precomputed.

    The MCMC-scan analogue of :func:`make_mvn_logprob`: each call is one
    matmul + row quadform + ``log1p`` instead of a triangular solve.
    """
    mean = jnp.asarray(mean)
    dt = mean.dtype
    L = cov_sqrt(jnp.asarray(cov, dt), "cholesky")
    Linv_t = tri_inverse(L).T
    d = mean.shape[-1]
    df = jnp.asarray(df, dt)
    log_norm = (
        gammaln(0.5 * (df + d))
        - gammaln(0.5 * df)
        - 0.5 * d * (jnp.log(df) + math.log(math.pi))
        - 0.5 * log_det_from_chol(L)
    )

    def log_prob(x: jnp.ndarray) -> jnp.ndarray:
        # "highest" (default): full f32. "default" lets the GPU run the
        # f32 matmul in TF32 (~1e-3 relative on the quadform); the
        # sampler stays exact for that perturbed target.
        z = jnp.matmul(x - mean, Linv_t, precision=_PRECISIONS[precision])
        quad = jnp.sum(z * z, axis=-1)
        return log_norm - 0.5 * (df + d) * jnp.log1p(quad / df)

    return log_prob


def mvt_logpdf(x: jnp.ndarray, mean: jnp.ndarray, scale_tril: jnp.ndarray,
               df) -> jnp.ndarray:
    """log MVT(x; mean, Sigma = L L^T, nu) for batched x [..., d].

    log norm = lgamma((nu+d)/2) - lgamma(nu/2) - (d/2) log(nu*pi) - (1/2)log|Sigma|
    kernel   = -((nu+d)/2) * log1p(quadform / nu)
    (reference CPU form: ``src/statistics.cc.cpp:295-324``).
    """
    d = x.shape[-1]
    df = jnp.asarray(df, dtype=x.dtype)
    z = tri_solve(scale_tril, x - mean)
    quad = jnp.sum(z * z, axis=-1)
    log_norm = (
        gammaln(0.5 * (df + d))
        - gammaln(0.5 * df)
        - 0.5 * d * (jnp.log(df) + math.log(math.pi))
        - 0.5 * log_det_from_chol(scale_tril)
    )
    return log_norm - 0.5 * (df + d) * jnp.log1p(quad / df)


def mvt_logpdf_cov(x: jnp.ndarray, mean: jnp.ndarray, cov: jnp.ndarray, df) -> jnp.ndarray:
    return mvt_logpdf(x, mean, cov_sqrt(cov, "cholesky"), df)


def mvt_sample(key: jax.Array, mean: jnp.ndarray, scale: jnp.ndarray, df,
               shape: tuple = (), per_dim_chi: bool = False) -> jnp.ndarray:
    """Draw from MVT(mean, Sigma = scale scale^T, df); returns ``shape + (d,)``.

    Standard construction (default): ``x = mean + (scale @ z) * sqrt(df / g)``
    with one ``g ~ chi2(df)`` per sample vector.

    ``per_dim_chi=True`` reproduces the reference's nonstandard product-t
    (independent chi-square scale per component, applied AFTER the linear
    map: ``chi.asDiagonal() * (Q*x) + mu`` at ``src/statistics.cc.cpp:411``,
    GPU ``src/mvt_dist.cu.cpp:220-222``).
    """
    d = scale.shape[-1]
    dtype = scale.dtype
    # The chi-square mixing variable is drawn in >= f32 even when the state
    # dtype is bf16 (mixed precision): log/sqrt of bf16 uniforms is too
    # coarse for the heavy tail (same fix as DLM._sample_packed). Only the
    # final sqrt(df/g) factor is cast to the state dtype.
    gdtype = jnp.promote_types(dtype, jnp.float32)
    df = jnp.asarray(df, dtype=gdtype)
    kz, kg = jax.random.split(key)
    z = jax.random.normal(kz, shape + (d,), dtype=dtype)
    lz = z @ scale.T
    if per_dim_chi:
        g = 2.0 * jax.random.gamma(kg, 0.5 * df, shape + (d,), dtype=gdtype)
    else:
        g = 2.0 * jax.random.gamma(kg, 0.5 * df, shape + (1,), dtype=gdtype)
    return mean + lz * jnp.sqrt(df / g).astype(dtype)


def mvt_sample_cov(key: jax.Array, mean: jnp.ndarray, cov: jnp.ndarray, df,
                   shape: tuple = (), method: str = "cholesky",
                   per_dim_chi: bool = False) -> jnp.ndarray:
    return mvt_sample(key, mean, cov_sqrt(cov, method), df, shape, per_dim_chi)
