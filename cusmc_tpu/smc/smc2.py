"""SMC^2 — online, exact Bayesian parameter inference for state-space
models (Chopin, Jacob & Papaspiliopoulos 2013).

Completes the parameter-inference triple: PMMH (offline batch,
mcmc/pmmh.py), Liu-West (online approximate, smc/liu_west.py), SMC^2
(online EXACT up to Monte-Carlo error). The reference has none of these
(fixed F/G/V/W per run, ``/root/reference/src/run.rcpp.cpp:58-62``).

Construction: N_theta parameter particles, each carrying its OWN bootstrap
filter of N_x state particles and unbiased likelihood estimate
Zhat_j(t) = p_hat(y_{1:t} | theta_j). Per observation:

  1. advance every inner filter one step (vmapped over theta);
     theta-weights *= incremental evidence p_hat(y_t | y_{1:t-1}, theta_j)
  2. when ESS over theta drops below a threshold: resample theta particles,
     then REJUVENATE each with a PMMH exchange move — propose theta' from a
     random walk scaled by the theta-cloud covariance, re-run its whole
     inner filter on y_{1:t} (a masked scan: steps s > t are identity, so
     one fixed-shape program serves every t), and accept on the exact
     PMMH ratio Zhat' * prior' / (Zhat * prior). Weights reset uniform.

Device mapping: the theta axis is a pure vmap batch (inner filters are
independent); the rejuvenation re-run is the same compiled scan with a
validity mask, so the entire run — including every conditional re-run —
is ONE ``lax.scan`` under ``jit`` with no host round-trips. The
O(T * N_theta * N_x) rejuvenation cost executes only when the branch is
taken (``lax.cond``).
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


class SMC2Result(struct.PyTreeNode):
    """``thetas`` [N_theta, p] + normalized ``log_weights`` approximate
    p(theta | y_{1:T}); ``log_evidence_path`` [T] is log p_hat(y_{1:t}).
    ``num_rejuvenations`` counts triggered PMMH passes; ``accept_rate`` is
    the mean PMMH acceptance over the last pass."""

    thetas: jnp.ndarray
    log_weights: jnp.ndarray
    log_evidence: jnp.ndarray
    log_evidence_path: jnp.ndarray
    ess_path: jnp.ndarray
    num_rejuvenations: jnp.ndarray
    accept_rate: jnp.ndarray


def smc2(
    key: jax.Array,
    sample_initial: Callable,      # (key, nx, theta [p]) -> x [nx, d]
    propagate: Callable,           # (key, x [nx, d], theta [p]) -> x'
    observation_logpdf: Callable,  # (y, x [nx, d], theta [p]) -> [nx]
    theta_prior_sample: Callable,  # (key, n) -> theta [n, p]
    theta_prior_logpdf: Callable,  # (theta [n, p]) -> [n]
    ys: jnp.ndarray,               # [T, k]; row 0 = prior step (ignored)
    num_theta: int,
    num_x: int,
    ess_threshold: float = 0.5,
    resampler: str = "systematic",
    rw_scale: float = 1.0,
    dtype=jnp.float32,
) -> SMC2Result:
    """Run SMC^2 on observations ``ys``. Model callables operate on one
    theta's inner cloud and are vmapped over the theta axis; the inner
    filter resamples every step (multinomial ancestors from the inner
    weights) with per-theta folded keys."""
    nt, nx = num_theta, num_x
    log_nx = math.log(nx)
    theta_res = get_resampler(resampler)
    t_total = ys.shape[0]

    k_th, k_init, k_scan = jax.random.split(key, 3)
    theta0 = theta_prior_sample(k_th, nt).astype(dtype)
    p = theta0.shape[-1]

    def init_inner(k, theta):
        x = sample_initial(k, nx, theta)
        return x, jnp.full((nx,), -log_nx, dtype)

    def inner_step(k, x, logw, y, theta, valid):
        """One bootstrap step of one inner filter; identity when not valid.
        Returns (x', logw', log-evidence increment)."""
        k_res, k_prop = jax.random.split(k)
        a = jax.random.categorical(k_res, logw, shape=(nx,))
        x_res = x[a]
        x_new = propagate(k_prop, x_res, theta)
        ll = observation_logpdf(y, x_new, theta)
        lse = jax.scipy.special.logsumexp(ll)
        lz_inc = lse - log_nx
        x_out = jnp.where(valid, x_new, x)
        logw_out = jnp.where(valid, ll - lse, logw)
        return x_out, logw_out, jnp.where(valid, lz_inc, 0.0)

    v_init = jax.vmap(init_inner)
    v_step = jax.vmap(inner_step, in_axes=(0, 0, 0, None, 0, None))

    def rerun_filter(k, theta, t_now):
        """Full masked re-run of ONE theta's filter on y_{1:t_now}."""
        x0, lw0 = init_inner(jax.random.fold_in(k, 0), theta)

        def body(carry, inp):
            x, logw, lz = carry
            s, y_s = inp
            x, logw, lzi = inner_step(jax.random.fold_in(k, s), x, logw,
                                      y_s, theta, s <= t_now)
            return (x, logw, lz + lzi), ()

        (x_f, lw_f, lz), _ = lax.scan(
            body, (x0, lw0, jnp.asarray(0.0, dtype)),
            (jnp.arange(1, t_total), ys[1:]))
        return x_f, lw_f, lz

    v_rerun = jax.vmap(rerun_filter, in_axes=(0, 0, None))

    x0, lw0 = v_init(jax.random.split(k_init, nt), theta0)
    logw_th0 = jnp.full((nt,), -math.log(nt), dtype)
    lz0 = jnp.zeros((nt,), dtype)

    def step(carry, inp):
        theta, x, lw, lz, logw_th, key, n_rej, acc = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        k_inner, k_res, k_prop, k_acc, k_rerun = jax.random.split(key_t, 5)

        # 1. Advance every inner filter; theta-weight update by incremental
        #    evidence.
        x, lw, lz_inc = v_step(jax.random.split(k_inner, nt), x, lw, y_t,
                               theta, True)
        lz = lz + lz_inc
        logw_th_un = logw_th + lz_inc
        logw_th, lz_step = log_normalize(logw_th_un)
        ess = effective_sample_size(logw_th)

        # 2. Conditional resample + PMMH rejuvenation.
        def rejuvenate(args):
            theta, x, lw, lz, logw_th = args
            a = theta_res(k_res, logw_th)
            theta_r, x_r, lw_r, lz_r = theta[a], x[a], lw[a], lz[a]

            # RW proposal scaled by the (resampled) cloud covariance.
            mean = jnp.mean(theta_r, axis=0)
            c = theta_r - mean[None, :]
            cov = c.T @ c / nt + 1e-8 * jnp.eye(p, dtype=dtype)
            chol = jnp.linalg.cholesky(cov)
            z = jax.random.normal(k_prop, (nt, p), dtype)
            theta_prop = theta_r + (rw_scale * 2.38 / math.sqrt(p)) * (
                z @ chol.T)

            xp, lwp, lzp = v_rerun(jax.random.split(k_rerun, nt),
                                   theta_prop, t)
            log_alpha = (lzp + theta_prior_logpdf(theta_prop)
                         - lz_r - theta_prior_logpdf(theta_r))
            u = jnp.log(jax.random.uniform(k_acc, (nt,), dtype))
            take = u < log_alpha
            theta_new = jnp.where(take[:, None], theta_prop, theta_r)
            x_new = jnp.where(take[:, None, None], xp, x_r)
            lw_new = jnp.where(take[:, None], lwp, lw_r)
            lz_new = jnp.where(take, lzp, lz_r)
            acc = jnp.mean(take.astype(dtype))
            return (theta_new, x_new, lw_new, lz_new,
                    jnp.full((nt,), -math.log(nt), dtype),
                    jnp.asarray(1, jnp.int32), acc)

        def keep(args):
            theta, x, lw, lz, logw_th = args
            return (theta, x, lw, lz, logw_th, jnp.asarray(0, jnp.int32),
                    acc)

        (theta, x, lw, lz, logw_th, did, acc) = lax.cond(
            ess < ess_threshold * nt, rejuvenate, keep,
            (theta, x, lw, lz, logw_th))

        carry = (theta, x, lw, lz, logw_th, key, n_rej + did, acc)
        return carry, (lz_step, ess)

    ts = jnp.arange(1, t_total)
    carry0 = (theta0, x0, lw0, lz0, logw_th0, k_scan,
              jnp.asarray(0, jnp.int32), jnp.asarray(0.0, dtype))
    (theta_f, _, _, _, logw_th_f, _, n_rej, acc), (lz_steps, esss) = lax.scan(
        step, carry0, (ts, ys[1:]))

    lz_path = jnp.cumsum(lz_steps)
    return SMC2Result(
        thetas=theta_f, log_weights=logw_th_f,
        log_evidence=lz_path[-1],
        log_evidence_path=jnp.concatenate(
            [jnp.zeros((1,), dtype), lz_path]),
        ess_path=jnp.concatenate(
            [jnp.full((1,), float(nt), dtype), esss]),
        num_rejuvenations=n_rej, accept_rate=acc)
