"""Hamiltonian Monte Carlo (fixed-length leapfrog).

Completes the gradient-based MCMC family (random-walk MH in
mcmc/metropolis.py, MALA in mcmc/mala.py): L leapfrog steps per proposal
explore the target far faster than one-step methods on correlated,
high-dimensional densities. The reference has no gradient machinery at all
(SURVEY.md §2); JAX supplies exact gradients of any log-density.

Device mapping: chains are a [C, d] batch axis — every leapfrog step is a
batched gradient evaluation (one forward + one backward over the whole
chain block); the L-step integrator is a ``lax.scan``, the sweep loop
another, so the entire sampler is one compiled program. Fixed L keeps
control flow static (a NUTS-style dynamic tree would serialize chains;
fixed-length HMC with jittered L is the standard accelerator-friendly
choice). Step size adapts by Robbins-Monro toward 0.8 pooled acceptance
(``pmean`` over ``axis_name`` when chain-sharded).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.mcmc.mala import _value_and_grad_batched


class HMCState(struct.PyTreeNode):
    x: jnp.ndarray             # [C, d]
    logp: jnp.ndarray          # [C]
    grad: jnp.ndarray          # [C, d]
    log_step: jnp.ndarray      # scalar
    accept_count: jnp.ndarray  # [C]


class HMCResult(struct.PyTreeNode):
    state: HMCState
    samples: Optional[jnp.ndarray]
    accept_rate: jnp.ndarray
    step_size: jnp.ndarray


def _pmean(x, axis_name):
    if axis_name is None:
        return jnp.mean(x)
    return lax.pmean(jnp.mean(x), axis_name)


def hmc_init(log_prob: Callable, init_x: jnp.ndarray,
             step_size: float = 0.1) -> HMCState:
    vg = _value_and_grad_batched(log_prob)
    logp, grad = vg(init_x)
    return HMCState(
        x=init_x, logp=logp, grad=grad,
        log_step=jnp.asarray(jnp.log(step_size), init_x.dtype),
        accept_count=jnp.zeros(init_x.shape[0], init_x.dtype))


def hmc_step(key: jax.Array, state: HMCState, log_prob: Callable,
             num_leapfrog: int = 10, target_accept: float = 0.8,
             adapt_rate: float = 0.0, axis_name: Optional[str] = None,
             jitter: bool = True):
    """One vectorized HMC sweep over all chains (identity mass matrix).

    ``jitter=True`` draws the trajectory length uniformly from
    [1, num_leapfrog] per sweep (shared across chains) — the standard
    guard against resonant periodic orbits of fixed-length HMC.
    """
    c, d = state.x.shape
    kp, kl, ku = jax.random.split(key, 3)
    eps = jnp.exp(state.log_step)
    vg = _value_and_grad_batched(log_prob)

    p0 = jax.random.normal(kp, (c, d), state.x.dtype)
    if jitter:
        steps = jax.random.randint(kl, (), 1, num_leapfrog + 1)
    else:
        steps = jnp.asarray(num_leapfrog)

    # Leapfrog with a mask past the sampled length (static bound L).
    # vg computes the density alongside the gradient; carrying it makes
    # the final iterate logp(x_prop) — no separate density pass.
    def leap(carry, i):
        x, p, grad, logp = carry
        active = i < steps
        p_half = p + 0.5 * eps * grad
        x_new = x + eps * p_half
        logp_new, grad_new = vg(x_new)
        p_new = p_half + 0.5 * eps * grad_new
        x = jnp.where(active, x_new, x)
        p = jnp.where(active, p_new, p)
        grad = jnp.where(active, grad_new, grad)
        logp = jnp.where(active, logp_new, logp)
        return (x, p, grad, logp), ()

    (x_prop, p_prop, grad_prop, logp_prop), _ = lax.scan(
        leap, (state.x, p0, state.grad, state.logp), jnp.arange(num_leapfrog))

    # Metropolis correction on the joint (x, p) energy.
    ke0 = 0.5 * jnp.sum(p0 * p0, axis=-1)
    ke1 = 0.5 * jnp.sum(p_prop * p_prop, axis=-1)
    log_alpha = (logp_prop - ke1) - (state.logp - ke0)
    log_u = jnp.log(jax.random.uniform(ku, (c,), state.x.dtype))
    accept = log_u < log_alpha
    # Divergences (NaN energies) always reject.
    accept = accept & jnp.isfinite(log_alpha)

    x_new = jnp.where(accept[:, None], x_prop, state.x)
    logp_new = jnp.where(accept, logp_prop, state.logp)
    grad_new = jnp.where(accept[:, None], grad_prop, state.grad)
    pooled = _pmean(accept.astype(state.x.dtype), axis_name)
    log_step = state.log_step + adapt_rate * (pooled - target_accept)
    return HMCState(
        x=x_new, logp=logp_new, grad=grad_new, log_step=log_step,
        accept_count=state.accept_count + accept.astype(state.x.dtype),
    ), pooled


def hmc_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    num_leapfrog: int = 10,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name: Optional[str] = None,
    jitter: bool = True,
) -> HMCResult:
    """Run ``num_steps`` HMC sweeps over [C, d] chains under one ``jit``.
    Conventions match the other samplers (Robbins-Monro step adaptation
    for the first ``num_adapt`` sweeps, then frozen)."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    state = hmc_init(log_prob, init_x, step_size)

    def body(state, t):
        k_t = jax.random.fold_in(key, t)
        adapt = jnp.where(t < num_adapt, adapt_rate, 0.0).astype(init_x.dtype)
        new_state, acc = hmc_step(k_t, state, log_prob, num_leapfrog,
                                  target_accept, adapt, axis_name, jitter)
        out = (new_state.x, acc) if keep_samples else ((), acc)
        return new_state, out

    final, (xs_or_none, _) = lax.scan(body, state, jnp.arange(num_steps))

    samples = None
    if keep_samples:
        samples = xs_or_none[::thin] if thin > 1 else xs_or_none
    pooled_rate = _pmean(final.accept_count / num_steps, axis_name)
    return HMCResult(state=final, samples=samples, accept_rate=pooled_rate,
                     step_size=jnp.exp(final.log_step))
