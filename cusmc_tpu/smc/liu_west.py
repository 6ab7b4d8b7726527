"""Liu-West filter — ONLINE joint state + parameter estimation.

The reference has no parameter inference at all (fixed F/G/V/W per run,
``/root/reference/src/run.rcpp.cpp:58-62``); PMMH (mcmc/pmmh.py) adds
offline batch inference. This module adds the classic ONLINE alternative
(Liu & West 2001): particles carry (x_i, theta_i) jointly, and parameter
degeneracy is fought with kernel shrinkage —

    m_i   = a * theta_i + (1-a) * theta_bar        (shrinkage toward mean)
    theta'_i ~ N(m_{A_i}, h^2 * V_theta),  a^2 + h^2 = 1, a = (3 delta - 1)/(2 delta)

inside an auxiliary-particle-filter step (lookahead mu_i = E[x_t|x_{t-1,i}]
drives first-stage weights, second stage corrects exactly). The shrinkage
keeps the theta-marginal mean and variance while refreshing diversity.

Whole filter is one ``lax.scan`` under ``jit``; batch layout [N, ...] with
registry resamplers (the theta-space Gaussian kernel needs a per-step
weighted covariance + Cholesky, [p, p] with small p — negligible).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.diagnostics.metrics import effective_sample_size, log_normalize
from cusmc_tpu.resampling import get_resampler


class LiuWestResult(struct.PyTreeNode):
    """``theta_mean`` [T, p] is the running posterior mean E[theta | y_{1:t}]
    (the online-learning trajectory); ``final_*`` are the particle cloud at
    T. History fields are None unless ``return_history=True``."""

    final_x: jnp.ndarray
    final_theta: jnp.ndarray
    final_log_weights: jnp.ndarray
    ess: jnp.ndarray
    log_evidence: jnp.ndarray
    theta_mean: jnp.ndarray
    filtered_mean: jnp.ndarray
    thetas: Optional[jnp.ndarray] = None
    xs: Optional[jnp.ndarray] = None


def _weighted_moments(theta, logw):
    w = jax.nn.softmax(logw)
    mean = w @ theta
    centered = theta - mean[None, :]
    cov = (centered * w[:, None]).T @ centered
    return mean, cov


def liu_west_filter(
    key: jax.Array,
    sample_initial: Callable,      # (key, n, theta [n,p]) -> x [n,d]
    propagate: Callable,           # (key, x [n,d], theta [n,p]) -> x'
    propagate_mean: Callable,      # (x [n,d], theta [n,p]) -> E[x'|x] [n,d]
    observation_logpdf: Callable,  # (y, x [n,d], theta [n,p]) -> [n]
    theta_prior_sample: Callable,  # (key, n) -> theta [n,p]
    ys: jnp.ndarray,
    num_particles: int,
    delta: float = 0.98,
    resampler: str = "systematic",
    return_history: bool = False,
) -> LiuWestResult:
    """Run the Liu-West auxiliary filter on observations ``ys`` [T, k].

    Conventions match ``bootstrap_filter``: row 0 of ``ys`` is the prior
    step (ignored as an observation). ``delta`` in (0.5, 1] is the usual
    discount; a = (3*delta - 1)/(2*delta), h^2 = 1 - a^2. All model
    callables are vectorized over particles and receive each particle's
    own theta — parameter heterogeneity is the point.
    """
    if not 0.5 < delta <= 1.0:
        raise ValueError(f"delta must be in (0.5, 1], got {delta}")
    a = (3.0 * delta - 1.0) / (2.0 * delta)
    h2 = 1.0 - a * a
    n = num_particles
    log_n = math.log(n)
    ancestor_fn = get_resampler(resampler)

    k_th, k_x, k_scan = jax.random.split(key, 3)
    theta0 = theta_prior_sample(k_th, n)
    p = theta0.shape[-1]
    x0 = sample_initial(k_x, n, theta0)
    dtype = x0.dtype
    logw0 = jnp.full((n,), -log_n, dtype)

    def step(carry, inp):
        x, theta, logw, key = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        k_res, k_theta, k_prop = jax.random.split(key_t, 3)
        ess = effective_sample_size(logw)

        # Shrinkage locations + parameter-cloud covariance (weighted).
        theta_bar, v_theta = _weighted_moments(theta, logw)
        m = a * theta + (1.0 - a) * theta_bar[None, :]

        # First stage: lookahead weights at (mu_i, m_i).
        mu = propagate_mean(x, m)
        look = observation_logpdf(y_t, mu, m)
        logg, _ = log_normalize(logw + look)
        anc = ancestor_fn(k_res, logg)

        # Second stage: refresh theta around the shrunk locations, then
        # propagate states under each particle's NEW theta.
        chol = jnp.linalg.cholesky(
            h2 * v_theta + 1e-10 * jnp.eye(p, dtype=v_theta.dtype))
        z = jax.random.normal(k_theta, (n, p), dtype)
        theta_new = m[anc] + z @ chol.T
        x_new = propagate(k_prop, x[anc], theta_new)

        ll = observation_logpdf(y_t, x_new, theta_new)
        logw_unnorm = ll - look[anc]
        logw_new, lse = log_normalize(logw_unnorm)
        # Evidence increment of the auxiliary construction:
        # p(y_t | y_{1:t-1}) ~= (sum_i g_i) * mean_i exp(logw_unnorm_i)
        # with g the normalized first-stage weights absorbed in `anc`.
        lz_first = jax.scipy.special.logsumexp(logw + look)
        lz_inc = lz_first + lse - log_n

        w = jnp.exp(logw_new)
        carry = (x_new, theta_new, logw_new, key)
        hist = (theta_new, x_new) if return_history else ()
        return carry, (hist, ess, lz_inc, w @ theta_new, w @ x_new)

    ts = jnp.arange(1, ys.shape[0])
    (x_f, th_f, logw_f, _), (hist, esss, lzs, th_means, x_means) = lax.scan(
        step, (x0, theta0, logw0, k_scan), (ts, ys[1:]))

    th_mean0 = jnp.mean(theta0, axis=0)
    x_mean0 = jnp.mean(x0, axis=0)
    result = LiuWestResult(
        final_x=x_f, final_theta=th_f, final_log_weights=logw_f,
        ess=jnp.concatenate([effective_sample_size(logw0)[None], esss]),
        log_evidence=jnp.sum(lzs),
        theta_mean=jnp.concatenate([th_mean0[None], th_means]),
        filtered_mean=jnp.concatenate([x_mean0[None], x_means]))
    if return_history:
        ths, xs = hist
        result = result.replace(
            thetas=jnp.concatenate([theta0[None], ths]),
            xs=jnp.concatenate([x0[None], xs]))
    return result
