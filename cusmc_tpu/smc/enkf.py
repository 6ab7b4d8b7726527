"""Stochastic ensemble Kalman filter (EnKF, perturbed observations).

Complements the particle filters for the high-dimensional regime: where a
bootstrap filter's importance weights degenerate as d grows, the EnKF
(Evensen 1994; Burgers et al. 1998) replaces reweighting with a linear
Gaussian update of an ensemble — biased for non-Gaussian posteriors but
weight-degeneracy-free, the standard tool in data assimilation. The
reference has nothing in this family (bootstrap-only,
``/root/reference/src/mcmc.cpp:239-309``).

Device mapping: the entire update is ensemble-anomaly matmuls —
[N, d]ᵀ[N, k] cross-covariances and a [k, k] solve — at any d; no resampling, no gathers, no transcendentals. One ``lax.scan``.

Works with any model exposing ``propagate`` (stochastic forecast, e.g.
``DLM.propagate``) plus a linear observation operator (F, V); the forecast
may be nonlinear — only the update is linear in the observation.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax


class EnKFResult(struct.PyTreeNode):
    """``means`` [T, d] analysis means; ``spread`` [T] mean ensemble
    standard deviation (collapse monitor); ``final_ensemble`` [N, d]."""

    final_ensemble: jnp.ndarray
    means: jnp.ndarray
    spread: jnp.ndarray


def _gmean(x, axis_name, axis=0):
    m = jnp.mean(x, axis=axis)
    return m if axis_name is None else lax.pmean(m, axis_name)


def ensemble_kalman_filter(
    key: jax.Array,
    model,
    ys: jnp.ndarray,
    num_ensemble: int,
    inflation: float = 1.0,
    F: Optional[jnp.ndarray] = None,
    V: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    num_ensemble_global: Optional[int] = None,
) -> EnKFResult:
    """Run the stochastic EnKF on observations ``ys`` [T, k].

    Conventions match ``bootstrap_filter`` (row 0 of ``ys`` = prior step).
    ``model`` provides ``sample_initial(key, (N,))`` and
    ``propagate(key, x)``; the observation model defaults to the DLM's
    (``y = F x + N(0, V)``, with V rebuilt from the model's Cholesky
    factor) and can be overridden via ``F``/``V``. ``inflation`` >= 1
    scales forecast anomalies (multiplicative covariance inflation, the
    standard fix for sampling-noise underdispersion).

    Under ``shard_map`` pass ``axis_name`` (the ensemble mesh axis) and the
    global size via ``num_ensemble_global``; the moment matmuls become
    ``psum``-reduced partial products — the ONLY per-step collectives are
    O(d*k) scalars, so the sharded EnKF scales with zero state exchange.
    """
    n = num_ensemble
    n_global = num_ensemble_global or n
    if F is None:
        F = model.F
    if V is None:
        V = model.V_chol @ model.V_chol.T
    F = jnp.asarray(F)
    V = jnp.asarray(V)
    v_chol = jnp.linalg.cholesky(V)
    k_dim = F.shape[0]

    k_init, k_scan = jax.random.split(key)
    if axis_name is not None:
        k_init = jax.random.fold_in(k_init, lax.axis_index(axis_name))
    x0 = model.sample_initial(k_init, (n,))
    dtype = x0.dtype

    def step(carry, inp):
        x, key = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        if axis_name is not None:
            key_t = jax.random.fold_in(key_t, lax.axis_index(axis_name))
        k_prop, k_obs = jax.random.split(key_t)

        # Forecast (stochastic propagation includes the model noise).
        xf = model.propagate(k_prop, x)
        mean_f = _gmean(xf, axis_name)
        A = (xf - mean_f[None, :]) * inflation          # [N, d] anomalies
        xf = mean_f[None, :] + A

        # Innovation statistics from the ensemble (all matmuls; under
        # shard_map the partial [d,k]/[k,k] products psum over shards).
        HX = xf @ F.T                                    # [N, k]
        mean_h = _gmean(HX, axis_name)
        AH = HX - mean_h[None, :]
        denom = 1.0 / (n_global - 1)
        s_hh = AH.T @ AH
        s_xh = A.T @ AH
        if axis_name is not None:
            s_hh = lax.psum(s_hh, axis_name)
            s_xh = lax.psum(s_xh, axis_name)
        cov_hh = s_hh * denom + V                        # [k, k]
        cov_xh = s_xh * denom                            # [d, k]

        # Perturbed observations + Kalman update via a [k, k] solve.
        pert = jax.random.normal(k_obs, (n, k_dim), dtype) @ v_chol.T
        innov = (y_t[None, :] + pert) - HX               # [N, k]
        gain_t = jnp.linalg.solve(cov_hh, cov_xh.T)      # [k, d] = K^T
        xa = xf + innov @ gain_t                         # [N, d]

        mean_a = _gmean(xa, axis_name)
        spread = jnp.sqrt(_gmean((xa - mean_a[None, :]) ** 2,
                                 axis_name, axis=(0, 1)))
        return (xa, key), (mean_a, spread)

    ts = jnp.arange(1, ys.shape[0])
    (x_f, _), (means, spreads) = lax.scan(step, (x0, k_scan), (ts, ys[1:]))

    mean0 = _gmean(x0, axis_name)
    spread0 = jnp.sqrt(_gmean((x0 - mean0[None, :]) ** 2, axis_name,
                              axis=(0, 1)))
    return EnKFResult(
        final_ensemble=x_f,
        means=jnp.concatenate([mean0[None], means]),
        spread=jnp.concatenate([spread0[None], spreads]))
