"""Conditional SMC and particle Gibbs.

Complements PMMH (``mcmc/pmmh.py``) as the second exact particle-MCMC
construction (Andrieu, Doucet & Holenstein 2010): conditional SMC runs the
bootstrap filter with one particle slot CLAMPED to a reference trajectory
(state forced, ancestor forced to the clamped slot), which leaves the exact
joint smoothing posterior invariant. Iterating

    x_ref  <- ancestral-trace sample of a cSMC run given x_ref

is the particle Gibbs kernel over p(x_{0:T} | y_{1:T}) — useful on its own
for state inference and as the building block of PG parameter samplers.

Batch layout [N, d]; slot 0 is the clamped particle.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.diagnostics.metrics import effective_sample_size, log_normalize
from cusmc_tpu.resampling import get_resampler


class CSMCResult(struct.PyTreeNode):
    particles: jnp.ndarray   # [T, N, d]
    obs_loglik: jnp.ndarray  # [T, N]
    ancestors: jnp.ndarray   # [T, N]
    ess: jnp.ndarray
    log_evidence: jnp.ndarray
    sampled_path: jnp.ndarray  # [T, d] ancestral-trace draw


def _trace_path(key, particles, ancestors, final_logw):
    """Sample one path by ancestral tracing from the final weights."""
    num_steps = particles.shape[0]
    idx_final = jax.random.categorical(key, final_logw).astype(jnp.int32)

    def back(idx, t):
        x_t = particles[t][idx]
        return ancestors[t][idx], x_t

    ts = jnp.arange(num_steps - 1, 0, -1)
    idx0, xs_rev = lax.scan(back, idx_final, ts)
    x0 = particles[0][idx0]
    return jnp.concatenate([x0[None], xs_rev[::-1]], axis=0)


def conditional_smc(
    key: jax.Array,
    model,
    ys: jnp.ndarray,
    ref_path: jnp.ndarray,
    num_particles: int,
    resampler: str = "multinomial",
) -> CSMCResult:
    """One cSMC sweep conditioned on ``ref_path`` [T, d].

    Multinomial resampling is the default: the cSMC invariance argument is
    cleanest for it (conditional low-variance schemes require care).
    """
    res_fn = get_resampler(resampler)
    n = num_particles
    num_steps = ys.shape[0]

    k_init, k_scan, k_trace = jax.random.split(key, 3)
    x0 = model.sample_initial(k_init, (n,))
    x0 = x0.at[0].set(ref_path[0])
    logw0 = jnp.full((n,), -math.log(n), x0.dtype)

    def step(carry, inp):
        x, logw, key = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        k_res, k_prop = jax.random.split(key_t)

        ess = effective_sample_size(logw)
        a = res_fn(k_res, logw)
        a = a.at[0].set(0)                       # clamp slot-0 ancestry
        x_new = model.propagate(k_prop, x[a])
        x_new = x_new.at[0].set(ref_path[t])     # clamp slot-0 state
        ll = model.observation_logpdf(y_t, x_new)
        logw_new, lse = log_normalize(ll)
        lz_inc = lse - math.log(n)
        return (x_new, logw_new, key), ((x_new, ll, a), ess, lz_inc)

    ts = jnp.arange(1, num_steps)
    (x_f, logw_f, _), ((xs, lls, ancs), esss, lzs) = lax.scan(
        step, (x0, logw0, k_scan), (ts, ys[1:]))

    particles = jnp.concatenate([x0[None], xs], axis=0)
    obs_loglik = jnp.concatenate([logw0[None], lls], axis=0)
    a0 = jnp.arange(n, dtype=jnp.int32)
    ancestors = jnp.concatenate([a0[None], ancs], axis=0)
    ess = jnp.concatenate([effective_sample_size(logw0)[None], esss])
    path = _trace_path(k_trace, particles, ancestors, logw_f)
    return CSMCResult(particles=particles, obs_loglik=obs_loglik,
                      ancestors=ancestors, ess=ess,
                      log_evidence=jnp.sum(lzs), sampled_path=path)


def particle_gibbs(
    key: jax.Array,
    model,
    ys: jnp.ndarray,
    num_particles: int,
    num_iters: int,
    init_path: Optional[jnp.ndarray] = None,
    resampler: str = "multinomial",
) -> jnp.ndarray:
    """Run the particle Gibbs chain; returns sampled paths [I, T, d].

    The whole chain (num_iters cSMC sweeps) runs in one ``lax.scan`` under
    ``jit``. ``init_path`` defaults to a plain bootstrap-filter traced path.
    """
    num_steps = ys.shape[0]
    k_init, key = jax.random.split(key)
    if init_path is None:
        r0 = conditional_smc(k_init, model, ys,
                             jnp.zeros((num_steps, model.state_dim),
                                       ys.dtype),
                             num_particles, resampler)
        init_path = r0.sampled_path

    def sweep(path, i):
        r = conditional_smc(jax.random.fold_in(key, i), model, ys, path,
                            num_particles, resampler)
        return r.sampled_path, r.sampled_path

    _, paths = lax.scan(sweep, init_path, jnp.arange(num_iters))
    return paths
