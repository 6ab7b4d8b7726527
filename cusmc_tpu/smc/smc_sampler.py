"""Adaptive tempered SMC sampler for static targets.

The reference is purely a *filtering* engine (state-space models); the
north-star scope is a general SMC/MCMC inference engine (BASELINE.json).
This module adds the standard SMC-sampler construction (Del Moral, Doucet &
Jasra 2006): anneal from a tractable prior to the target through a
tempering ladder lambda: 0 -> 1, with

  reweight:   logw += (lambda' - lambda) * (log target - log prior)
  resample:   registry resampler on the tempered weights (ESS-triggered)
  rejuvenate: K random-walk Metropolis sweeps at the current temperature
              (reuses cusmc_tpu.mcmc.metropolis.mh_step)

The next lambda is chosen adaptively by bisection so the incremental ESS
stays near ``target_ess`` — the whole ladder runs inside ONE ``jit`` as a
``lax.while_loop`` with a static stage cap.

Returns particles ~ target, a log-normalizing-constant estimate, the
number of stages used, and the final MH acceptance rate.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax
from jax.scipy.special import logsumexp

from cusmc_tpu.mcmc.hmc import HMCState, hmc_step
from cusmc_tpu.mcmc.mala import MALAState, _value_and_grad_batched, mala_step
from cusmc_tpu.mcmc.metropolis import MHState, mh_step
from cusmc_tpu.resampling import get_resampler


class SMCSamplerResult(struct.PyTreeNode):
    particles: jnp.ndarray       # [N, d] ~ target
    log_weights: jnp.ndarray     # [N] normalized
    log_evidence: jnp.ndarray    # log Z_target / Z_prior estimate
    num_stages: jnp.ndarray      # int
    accept_rate: jnp.ndarray     # last rejuvenation acceptance


def _ess_at(delta, logw, log_ratio):
    from cusmc_tpu.diagnostics.metrics import effective_sample_size

    return effective_sample_size(logw + delta * log_ratio)


def _next_delta(logw, log_ratio, target_ess_frac, n, bisect_iters=30):
    """Largest delta in (0, 1] with ESS(delta) >= target via bisection."""
    target = target_ess_frac * n

    def body(_, ab):
        lo, hi = ab
        mid = 0.5 * (lo + hi)
        ok = _ess_at(mid, logw, log_ratio) >= target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    full = _ess_at(1.0, logw, log_ratio) >= target
    lo, hi = lax.fori_loop(0, bisect_iters, body,
                           (jnp.asarray(0.0, logw.dtype),
                            jnp.asarray(1.0, logw.dtype)))
    return jnp.where(full, jnp.asarray(1.0, logw.dtype), lo)


def smc_sampler(
    key: jax.Array,
    log_prior: Callable,
    log_target: Callable,
    prior_sample: Callable,
    num_particles: int,
    dim: int,
    resampler: str = "systematic",
    target_ess: float = 0.5,
    rejuvenation_steps: int = 5,
    rejuvenation: str = "rwm",
    waste_free: bool = False,
    step_size: float = 0.5,
    max_stages: int = 100,
    dtype=jnp.float32,
) -> SMCSamplerResult:
    """Sample a static target by tempering from the prior.

    ``log_prior``/``log_target`` map [N, d] -> [N]; ``prior_sample(key,
    (N,))`` draws [N, d]. ``rejuvenation`` selects the move kernel:
    "rwm" (random-walk Metropolis, step size Robbins-Monro adapted toward
    0.234 pooled acceptance), "mala" (Langevin proposal using gradients
    of the tempered density, adapted toward 0.574) or "hmc" (5 jittered
    leapfrog steps per move, adapted toward 0.8; one move explores much
    further than a random-walk sweep on correlated targets). The
    gradient kernels require differentiable log_prior/log_target.

    ``waste_free=True`` switches resample-move to the waste-free scheme of
    Dau & Chopin (2022): each stage resamples only M = N/rejuvenation_steps
    roots (multinomially) and keeps ALL states of each root's length-P
    rejuvenation chain as the next particle set — no MCMC work is thrown
    away, and the chains are P times longer at the same cost. Requires
    N divisible by ``rejuvenation_steps``.
    """
    if rejuvenation not in ("rwm", "mala", "hmc"):
        raise ValueError(f"unknown rejuvenation kernel {rejuvenation!r}")
    if waste_free:
        if num_particles % rejuvenation_steps != 0:
            raise ValueError("waste_free requires num_particles divisible "
                             "by rejuvenation_steps")
        num_roots = num_particles // rejuvenation_steps
    res_fn = get_resampler(resampler)
    n = num_particles
    k_init, k_loop = jax.random.split(key)
    x0 = prior_sample(k_init, (n,)).astype(dtype)
    logw0 = jnp.zeros((n,), dtype)

    def tempered_logpdf(x, lam):
        return (1.0 - lam) * log_prior(x) + lam * log_target(x)

    def cond(state):
        lam, stage, *_ = state
        return (lam < 1.0) & (stage < max_stages)

    def body(state):
        lam, stage, x, logw, log_z, log_step, _ = state
        k_stage = jax.random.fold_in(k_loop, stage)
        k_res, k_mh = jax.random.split(k_stage)

        log_ratio = log_target(x) - log_prior(x)
        # delta is the absolute tempering-exponent step with ESS >= target.
        delta = _next_delta(logw, log_ratio, target_ess, n)
        delta = jnp.maximum(delta, 1e-4)  # guard against stalling
        lam_new = jnp.minimum(lam + delta, 1.0)
        step_exp = lam_new - lam

        logw_unnorm = logw + step_exp * log_ratio
        lse = logsumexp(logw_unnorm)
        log_z = log_z + lse - logsumexp(logw)
        logw_norm = logw_unnorm - lse

        logpdf_now = lambda xx: tempered_logpdf(xx, lam_new)
        logw_res = jnp.full((n,), -math.log(n), dtype)

        if waste_free:
            # M roots, each expanded into its full length-P chain.
            a = jax.random.categorical(k_res, logw_norm, shape=(num_roots,))
            starts = x[a]
            num_moves = rejuvenation_steps - 1
        else:
            a = res_fn(k_res, logw_norm)
            starts = x[a]
            num_moves = rejuvenation_steps

        acc = jnp.asarray(0.0, dtype)
        c = starts.shape[0]
        if rejuvenation == "mala":
            logp0, grad0 = _value_and_grad_batched(logpdf_now)(starts)
            mv_state = MALAState(x=starts, logp=logp0, grad=grad0,
                                 log_step=log_step,
                                 accept_count=jnp.zeros((c,), dtype))
            move = mala_step
        elif rejuvenation == "hmc":
            logp0, grad0 = _value_and_grad_batched(logpdf_now)(starts)
            mv_state = HMCState(x=starts, logp=logp0, grad=grad0,
                                log_step=log_step,
                                accept_count=jnp.zeros((c,), dtype))
            move = lambda k, st, lp, **kw: hmc_step(k, st, lp,
                                                    num_leapfrog=5, **kw)
        else:
            mv_state = MHState(x=starts, logp=logpdf_now(starts),
                               log_step=log_step,
                               accept_count=jnp.zeros((c,), dtype))
            move = mh_step
        trail = [starts]
        for j in range(num_moves):
            mv_state, acc = move(jax.random.fold_in(k_mh, j), mv_state,
                                 logpdf_now, adapt_rate=0.05)
            trail.append(mv_state.x)
        if waste_free:
            x_new = jnp.concatenate(trail, axis=0)  # [P*M, d] == [n, d]
        else:
            x_new = mv_state.x
        return (lam_new, stage + 1, x_new, logw_res, log_z,
                mv_state.log_step, acc)

    init = (jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32), x0, logw0,
            jnp.asarray(0.0, dtype),
            jnp.asarray(math.log(step_size), dtype), jnp.asarray(0.0, dtype))
    lam, stages, x, logw, log_z, _, acc = lax.while_loop(cond, body, init)
    return SMCSamplerResult(
        particles=x, log_weights=logw - logsumexp(logw),
        log_evidence=log_z, num_stages=stages, accept_rate=acc)
