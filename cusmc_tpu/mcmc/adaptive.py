"""Adaptive-Metropolis (Haario et al. 2001) with full covariance learning.

The reference's only tunable is a fixed scalar B (``/root/reference/src/
mcmc.cpp:291``); BASELINE config 2 asks for MH "with tuned proposal
covariance". This module LEARNS that covariance online: a running mean and
covariance of the chain states — pooled across ALL chains (and across the
mesh with ``pmean`` when chain-sharded) — drives the classic AM proposal

    x' = x + s * L z,   L L^T = (2.38^2 / d) * Cov_est + eps * I

with Robbins-Monro scalar adaptation of s toward 0.234 on top. Pooling
across many chains makes the covariance estimate converge far faster than
single-chain AM — this is where the multi-chain layout pays off
statistically, not just in throughput.

One ``lax.scan``; the [d, d] Cholesky refresh per sweep is negligible next
to the [C, d] target evaluations for the chain counts this targets.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax


class AMState(struct.PyTreeNode):
    x: jnp.ndarray             # [C, d]
    logp: jnp.ndarray          # [C]
    mean: jnp.ndarray          # [d] running pooled mean
    cov: jnp.ndarray           # [d, d] running pooled covariance
    count: jnp.ndarray         # scalar: samples absorbed into mean/cov
    log_step: jnp.ndarray      # scalar log of the extra scalar scale s
    accept_count: jnp.ndarray  # [C]


class AMResult(struct.PyTreeNode):
    state: AMState
    samples: Optional[jnp.ndarray]
    accept_rate: jnp.ndarray
    step_size: jnp.ndarray
    proposal_cov: jnp.ndarray  # learned [d, d]


def _pmean(x, axis_name):
    if axis_name is None:
        return x
    return lax.pmean(x, axis_name)


def adaptive_mh_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    step_size: float = 1.0,
    target_accept: float = 0.234,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    reg_eps: float = 1e-6,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name: Optional[str] = None,
    chol_every: int = 1,
    noise_dtype: Optional[jnp.dtype] = None,
) -> AMResult:
    """Run ``num_steps`` adaptive-Metropolis sweeps over [C, d] chains.

    For the first ``num_adapt`` steps (default num_steps//2) both the
    proposal covariance (running pooled moments) and the scalar scale
    (Robbins-Monro) adapt; afterwards both freeze — the kept samples from
    the frozen phase come from a valid Markov chain.

    ``chol_every=k`` refreshes the proposal Cholesky every k sweeps
    (nested scan: factorize once per block of k) instead of every sweep.
    The running moments still absorb every sweep; only the FACTOR lags up
    to k−1 sweeps — standard practice for AM, where the covariance
    estimate moves slowly, and the d=128 [d, d] Cholesky is a small
    sequential op on every sweep.
    ``noise_dtype=jnp.bfloat16`` draws proposal noise in bf16 — exact for
    this symmetric proposal (see mcmc/metropolis.py).
    """
    if num_adapt is None:
        num_adapt = num_steps // 2
    if chol_every > 1 and num_steps % chol_every:
        raise ValueError(
            f"num_steps={num_steps} must be a multiple of "
            f"chol_every={chol_every}")
    c, d = init_x.shape
    dtype = init_x.dtype
    sd = 2.38 * 2.38 / d

    logp0 = log_prob(init_x)
    mean0 = _pmean(jnp.mean(init_x, axis=0), axis_name)
    xc = init_x - mean0
    cov0 = _pmean(xc.T @ xc / c, axis_name) + jnp.eye(d, dtype=dtype)
    state = AMState(
        x=init_x, logp=logp0, mean=mean0, cov=cov0,
        count=jnp.asarray(float(c), dtype),
        log_step=jnp.asarray(jnp.log(step_size), dtype),
        accept_count=jnp.zeros(c, dtype))

    def _chol(state):
        return jnp.linalg.cholesky(
            sd * state.cov + reg_eps * jnp.eye(d, dtype=dtype))

    def sweep(state, t, chol):
        k_t = jax.random.fold_in(key, t)
        kz, ku = jax.random.split(k_t)
        adapting = t < num_adapt

        z = jax.random.normal(kz, (c, d), noise_dtype or dtype).astype(dtype)
        x_prop = state.x + jnp.exp(state.log_step) * (z @ chol.T)
        logp_prop = log_prob(x_prop)
        log_u = jnp.log(jax.random.uniform(ku, (c,), dtype))
        accept = log_u < (logp_prop - state.logp)
        x_new = jnp.where(accept[:, None], x_prop, state.x)
        logp_new = jnp.where(accept, logp_prop, state.logp)

        # Pooled running moments over (chains x time); frozen after adapt.
        batch_mean = _pmean(jnp.mean(x_new, axis=0), axis_name)
        n0, nb = state.count, jnp.asarray(float(c), dtype)
        n1 = n0 + nb
        delta = batch_mean - state.mean
        mean_new = state.mean + (nb / n1) * delta
        xc = x_new - batch_mean[None, :]
        batch_cov = _pmean(xc.T @ xc / c, axis_name)
        cov_new = (n0 / n1) * state.cov + (nb / n1) * batch_cov \
            + (n0 * nb / (n1 * n1)) * jnp.outer(delta, delta)

        pooled_acc = _pmean(jnp.mean(accept.astype(dtype)), axis_name)
        log_step_new = state.log_step + adapt_rate * (pooled_acc
                                                      - target_accept)
        new_state = AMState(
            x=x_new, logp=logp_new,
            mean=jnp.where(adapting, mean_new, state.mean),
            cov=jnp.where(adapting, cov_new, state.cov),
            count=jnp.where(adapting, n1, state.count),
            log_step=jnp.where(adapting, log_step_new, state.log_step),
            accept_count=state.accept_count + accept.astype(dtype))
        out = (x_new,) if keep_samples else ((),)
        return new_state, out

    if chol_every == 1:
        def body(state, t):
            return sweep(state, t, _chol(state))

        final, outs = lax.scan(body, state, jnp.arange(num_steps))
    else:
        def block(state, b):
            chol = _chol(state)
            return lax.scan(
                lambda st, i: sweep(st, b * chol_every + i, chol),
                state, jnp.arange(chol_every))

        final, outs = lax.scan(block, state,
                               jnp.arange(num_steps // chol_every))
        outs = jax.tree_util.tree_map(
            lambda a: a.reshape((num_steps,) + a.shape[2:]), outs)
    samples = None
    if keep_samples:
        (xs,) = outs
        samples = xs[::thin] if thin > 1 else xs
    pooled_rate = _pmean(jnp.mean(final.accept_count / num_steps), axis_name)
    return AMResult(
        state=final, samples=samples, accept_rate=pooled_rate,
        step_size=jnp.exp(final.log_step),
        proposal_cov=sd * final.cov)
