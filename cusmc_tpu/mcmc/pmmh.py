"""Particle marginal Metropolis-Hastings (PMMH) — parameter inference for
state-space models.

The reference has no parameter-inference capability at all (fixed F, G, V,
W per run). PMMH (Andrieu, Doucet & Holenstein 2010) wraps the bootstrap
filter's unbiased marginal-likelihood estimate in an exact MH chain over
model parameters theta:

    propose theta' ~ N(theta, scale^2 Sigma)
    run a fresh filter  -> log Zhat(theta')
    accept w.p. min(1, exp(logZ' + logprior' - logZ - logprior))

The whole chain (MH loop WITH a full particle filter per iteration) is one
``lax.scan`` under ``jit`` — the device executes thousands of complete filters
without host round-trips. Multiple chains = ``jax.vmap`` over this function.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.smc.particle_filter import bootstrap_filter


class PMMHResult(struct.PyTreeNode):
    thetas: jnp.ndarray        # [T, p] parameter chain
    log_evidences: jnp.ndarray  # [T] filter logZ at current state
    accept_rate: jnp.ndarray
    final_theta: jnp.ndarray


def pmmh(
    key: jax.Array,
    model_builder: Callable,
    log_prior: Callable,
    theta0: jnp.ndarray,
    ys: jnp.ndarray,
    num_particles: int,
    num_steps: int,
    step_size: float = 0.1,
    proposal_chol: Optional[jnp.ndarray] = None,
    resampler: str = "systematic",
    filter_kwargs: Optional[dict] = None,
) -> PMMHResult:
    """Run a PMMH chain.

    ``model_builder(theta [p]) -> model`` must be jit-traceable (e.g.
    ``lambda th: DLM.create(..., W=jnp.exp(th[0]) * I, ...)``);
    ``log_prior(theta) -> scalar``. Systematic resampling is the right
    default here: the metropolis resampler's finite-B logZ bias would leak
    into the parameter posterior.
    """
    filter_kwargs = dict(filter_kwargs or {})
    filter_kwargs.setdefault("return_history", False)
    theta0 = jnp.asarray(theta0)
    p = theta0.shape[0]

    def log_z(k, theta):
        model = model_builder(theta)
        res = bootstrap_filter(k, model, ys, num_particles,
                               resampler=resampler, **filter_kwargs)
        return res.log_evidence

    k_init, k_chain = jax.random.split(key)
    lz0 = log_z(k_init, theta0)

    def step(carry, t):
        theta, lz, accepts = carry
        kt = jax.random.fold_in(k_chain, t)
        kp, kf, ku = jax.random.split(kt, 3)
        z = jax.random.normal(kp, (p,), theta.dtype)
        if proposal_chol is not None:
            z = proposal_chol @ z
        theta_prop = theta + step_size * z
        lz_prop = log_z(kf, theta_prop)
        log_alpha = (lz_prop + log_prior(theta_prop)
                     - lz - log_prior(theta))
        accept = jnp.log(jax.random.uniform(ku, (), theta.dtype)) < log_alpha
        theta_new = jnp.where(accept, theta_prop, theta)
        lz_new = jnp.where(accept, lz_prop, lz)
        return ((theta_new, lz_new, accepts + accept.astype(jnp.int32)),
                (theta_new, lz_new))

    (theta_f, _, accepts), (thetas, lzs) = lax.scan(
        step, (theta0, lz0, jnp.asarray(0, jnp.int32)),
        jnp.arange(num_steps))
    return PMMHResult(
        thetas=thetas, log_evidences=lzs,
        accept_rate=accepts / num_steps, final_theta=theta_f)
