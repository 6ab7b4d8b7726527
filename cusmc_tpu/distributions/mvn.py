"""Multivariate normal: log-density and sampling as pure JAX functions.

Replacement for the reference's MVN layer:
- CPU pdf ``norm * exp(-0.5 a^T V^-1 a)`` at
  ``/root/reference/src/statistics.cc.cpp:171-196`` and its CUDA 3-kernel chain
  (``src/mvn_dist.cu.cpp:455-668``) become a single fused log-density over a
  batched ``[..., d]`` array (triangular solve + row quadform).
- The CLT-loop sampler (``src/statistics.cc.cpp:224-259``, 200-iteration
  averaging) and curand kernels (``src/mvn_dist.cu.cpp:15-172``) become one
  ``z ~ N(0, I); x = mu + scale @ z`` batched matmul.

Everything is log-space: the reference multiplies raw densities
(``src/mcmc.cpp:212``), which underflows by d≈16; log-weights are a strict
improvement that preserves posteriors (SURVEY.md §7 step 1).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from cusmc_tpu.utils.linalg import (
    cov_sqrt,
    log_det_from_chol,
    tri_inverse,
    tri_solve,
)

_LOG_2PI = math.log(2.0 * math.pi)

_PRECISIONS = {"highest": jax.lax.Precision.HIGHEST,
               "default": jax.lax.Precision.DEFAULT}



def make_mvn_logprob(mean: jnp.ndarray, cov: jnp.ndarray,
                     precision: str = "highest"):
    """Closure evaluating log N(x; mean, cov) with everything that does not
    depend on ``x`` precomputed (Cholesky, its explicit inverse, log-norm).

    For repeated evaluation against one fixed target — MCMC scan bodies
    (BASELINE configs 1/2/5) — each call is one ``[..., d] @ [d, d]``
    matmul plus a row reduction, replacing the per-call triangular solve of
    ``mvn_logpdf_cov``.
    """
    mean = jnp.asarray(mean)
    L = cov_sqrt(jnp.asarray(cov, mean.dtype), "cholesky")
    Linv_t = tri_inverse(L).T
    d = mean.shape[-1]
    const = -0.5 * (d * _LOG_2PI + log_det_from_chol(L))

    def log_prob(x: jnp.ndarray) -> jnp.ndarray:
        # "highest" (default): full f32. "default" lets the GPU run the
        # f32 matmul in TF32 (~1e-3 relative on the quadform); the
        # sampler stays exact for that perturbed target.
        z = jnp.matmul(x - mean, Linv_t, precision=_PRECISIONS[precision])
        return const - 0.5 * jnp.sum(z * z, axis=-1)

    return log_prob


def mvn_logpdf(x: jnp.ndarray, mean: jnp.ndarray, scale_tril: jnp.ndarray) -> jnp.ndarray:
    """log N(x; mean, L L^T) for batched x [..., d].

    Matches the reference normalization ``(2pi)^{-d/2} |Sigma|^{-1/2}``
    (``src/statistics.cc.cpp:205-211``) in log space.
    """
    d = x.shape[-1]
    z = tri_solve(scale_tril, x - mean)
    quad = jnp.sum(z * z, axis=-1)
    return -0.5 * (quad + d * _LOG_2PI + log_det_from_chol(scale_tril))


def mvn_logpdf_cov(x: jnp.ndarray, mean: jnp.ndarray, cov: jnp.ndarray) -> jnp.ndarray:
    return mvn_logpdf(x, mean, cov_sqrt(cov, "cholesky"))


def mvn_sample(key: jax.Array, mean: jnp.ndarray, scale: jnp.ndarray, shape: tuple = ()) -> jnp.ndarray:
    """Draw x = mean + scale @ z with z ~ N(0, I); returns shape ``shape + (d,)``.

    ``scale`` is any square root of the covariance (Cholesky or eigh —
    the reference filter uses the eigh root, ``src/mcmc.cpp:69-71``).
    """
    d = scale.shape[-1]
    z = jax.random.normal(key, shape + (d,), dtype=scale.dtype)
    return mean + z @ scale.T


def mvn_sample_cov(key: jax.Array, mean: jnp.ndarray, cov: jnp.ndarray, shape: tuple = (),
                   method: str = "cholesky") -> jnp.ndarray:
    return mvn_sample(key, mean, cov_sqrt(cov, method), shape)
