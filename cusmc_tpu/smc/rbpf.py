"""Rao-Blackwellized (marginalized) particle filter.

North-star extension: the reference's bootstrap filter samples the FULL
state with particles (``/root/reference/src/mcmc.cpp:239-309``); for
conditionally linear-Gaussian models (models/clgssm.py) the linear substate
can be marginalized exactly — each particle carries a Kalman mean/covariance
for z alongside its sampled nonlinear state u, and the importance weight is
the closed-form predictive likelihood N(y; F m_pred + c, F P_pred Fᵀ + V).
This is the RBPF of Doucet et al. 2000 / Schön et al. 2005.

Device mapping: the per-particle Kalman bank is a batch of small dense
matmuls/Cholesky factorizations, expressed as vmapped einsums over the
particle axis — the batched-small-matmul shape XLA compiles as one
program. When the system matrices do not depend on u (``mats_constant=True``)
the covariance recursion collapses to ONE shared Kalman covariance and the
per-particle work is two matvecs — the classic common-covariance RBPF
optimization.

Whole filter is one ``lax.scan`` under ``jit``, like smc/particle_filter.py.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.diagnostics.metrics import effective_sample_size, log_normalize
from cusmc_tpu.models.clgssm import CLGSSM
from cusmc_tpu.resampling import get_resampler


class RBPFResult(struct.PyTreeNode):
    """``filtered_mean`` [T, dz] is the marginal posterior mean of the
    linear substate E[z_t | y_{1:t}] (weighted mixture of Kalman means);
    ``filtered_nl_mean`` [T, p] the posterior mean of the sampled substate.
    ``final_cov`` is [N, dz, dz] (general) or [dz, dz] (mats_constant).
    History fields are None unless ``return_history=True``.
    """

    final_nl: jnp.ndarray
    final_mean: jnp.ndarray
    final_cov: jnp.ndarray
    final_log_weights: jnp.ndarray
    ess: jnp.ndarray
    log_evidence: jnp.ndarray
    filtered_mean: jnp.ndarray
    filtered_nl_mean: jnp.ndarray
    nl_particles: Optional[jnp.ndarray] = None
    means: Optional[jnp.ndarray] = None


def _kf_general(model: CLGSSM, y, u, m, P):
    """Per-particle conditional Kalman predict+update (vmapped).

    Returns (m_new [N,dz], P_new [N,dz,dz], ll [N]).
    """
    k_dim = model.obs_dim
    dz = model.lin_dim
    log2pi = math.log(2.0 * math.pi)

    def one(u_i, m_i, P_i):
        G = model.Gmat(u_i)
        W = model.Wcov(u_i)
        F = model.Fmat(u_i)
        V = model.Vcov(u_i)
        m_pred = G @ m_i + model.b(u_i)
        P_pred = G @ P_i @ G.T + W
        S = F @ P_pred @ F.T + V
        L = jnp.linalg.cholesky(S)
        r = y - F @ m_pred - model.c(u_i)
        alpha = jax.scipy.linalg.solve_triangular(L, r, lower=True)
        ll = (-0.5 * (alpha @ alpha) - jnp.sum(jnp.log(jnp.diagonal(L)))
              - 0.5 * k_dim * log2pi)
        # Gain K = P_pred Fᵀ S⁻¹ via the Cholesky factor.
        K = jax.scipy.linalg.cho_solve((L, True), F @ P_pred).T
        m_new = m_pred + K @ r
        ikf = jnp.eye(dz, dtype=m_i.dtype) - K @ F
        P_new = ikf @ P_pred @ ikf.T + K @ V @ K.T  # Joseph form
        return m_new, P_new, ll

    return jax.vmap(one)(u, m, P)


def _kf_constant(model: CLGSSM, y, u, m, P):
    """Common-covariance fast path (mats_constant=True): P, S, K shared;
    per-particle work is the offset-dependent mean/residual only.

    ``P`` is a single [dz, dz]. Returns (m_new [N,dz], P_new [dz,dz],
    ll [N]).
    """
    k_dim = model.obs_dim
    dz = model.lin_dim
    log2pi = math.log(2.0 * math.pi)
    u_ref = jnp.zeros((model.nl_dim,), m.dtype)
    G, W = model.Gmat(u_ref), model.Wcov(u_ref)
    F, V = model.Fmat(u_ref), model.Vcov(u_ref)

    bs = jax.vmap(model.b)(u)                     # [N, dz]
    cs = jax.vmap(model.c)(u)                     # [N, k]
    m_pred = m @ G.T + bs                         # [N, dz]
    P_pred = G @ P @ G.T + W
    S = F @ P_pred @ F.T + V
    L = jnp.linalg.cholesky(S)
    r = y[None, :] - m_pred @ F.T - cs            # [N, k]
    alpha = jax.scipy.linalg.solve_triangular(L, r.T, lower=True).T
    ll = (-0.5 * jnp.sum(alpha * alpha, axis=-1)
          - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * k_dim * log2pi)
    K = jax.scipy.linalg.cho_solve((L, True), F @ P_pred).T  # [dz, k]
    m_new = m_pred + r @ K.T
    ikf = jnp.eye(dz, dtype=m.dtype) - K @ F
    P_new = ikf @ P_pred @ ikf.T + K @ V @ K.T
    return m_new, P_new, ll


def rao_blackwell_filter(
    key: jax.Array,
    model: CLGSSM,
    ys: jnp.ndarray,
    num_particles: int,
    resampler: str = "systematic",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = 0.5,
    return_history: bool = False,
) -> RBPFResult:
    """Run the RBPF on observations ``ys`` [T, k].

    Conventions match ``bootstrap_filter``: row 0 of ``ys`` is ignored
    (t=0 is the prior), ``ess_threshold`` in (0, 1] resamples adaptively on
    Kish ESS (None = every step), log-space weights throughout.
    """
    resampler_kwargs = resampler_kwargs or {}
    ancestor_fn = get_resampler(resampler, **resampler_kwargs)
    n = num_particles
    log_n = math.log(n)
    kf = _kf_constant if model.mats_constant else _kf_general

    k_init, k_scan = jax.random.split(key)
    u0 = model.sample_initial_nl(k_init, n)
    dtype = u0.dtype
    m_init = jnp.broadcast_to(model.m0.astype(dtype), (n, model.lin_dim))
    if model.mats_constant:
        P0 = model.C0.astype(dtype)
    else:
        P0 = jnp.broadcast_to(model.C0.astype(dtype),
                              (n, model.lin_dim, model.lin_dim))
    logw0 = jnp.full((n,), -log_n, dtype)

    def step(carry, inp):
        u, m, P, logw, key = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        k_res, k_prop = jax.random.split(key_t)
        ess = effective_sample_size(logw)

        def do_resample(_):
            a = ancestor_fn(k_res, logw)
            P_anc = P if model.mats_constant else P[a]
            return (u[a], m[a], P_anc,
                    jnp.full((n,), -log_n, dtype))

        def skip(_):
            return u, m, P, logw

        if ess_threshold is None:
            u_a, m_a, P_a, logw_pre = do_resample(None)
        else:
            u_a, m_a, P_a, logw_pre = lax.cond(
                ess < ess_threshold * n, do_resample, skip, None)

        u_new = model.propagate_nl(k_prop, u_a)
        m_new, P_new, ll = kf(model, y_t, u_new, m_a, P_a)
        logw_new, lz_inc = log_normalize(logw_pre + ll)

        w = jnp.exp(logw_new)
        fm = w @ m_new                   # E[z_t | y_{1:t}]
        fu = w @ u_new                   # E[u_t | y_{1:t}]
        carry = (u_new, m_new, P_new, logw_new, key)
        hist = (u_new, m_new) if return_history else ()
        return carry, (hist, ess, lz_inc, fm, fu)

    ts = jnp.arange(1, ys.shape[0])
    (u_f, m_f, P_f, logw_f, _), (hist, esss, lzs, fms, fus) = lax.scan(
        step, (u0, m_init, P0, logw0, k_scan), (ts, ys[1:]))

    ess0 = effective_sample_size(logw0)
    fm0 = jnp.mean(m_init, axis=0)
    fu0 = jnp.mean(u0, axis=0)
    result = RBPFResult(
        final_nl=u_f, final_mean=m_f, final_cov=P_f,
        final_log_weights=logw_f,
        ess=jnp.concatenate([ess0[None], esss]),
        log_evidence=jnp.sum(lzs),
        filtered_mean=jnp.concatenate([fm0[None], fms]),
        filtered_nl_mean=jnp.concatenate([fu0[None], fus]))
    if return_history:
        us, ms = hist
        result = result.replace(
            nl_particles=jnp.concatenate([u0[None], us]),
            means=jnp.concatenate([m_init[None], ms]))
    return result
