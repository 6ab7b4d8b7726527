"""Metropolis-adjusted Langevin algorithm (MALA).

Gradient-based MCMC — a north-star extension beyond the reference's only
sampler (random-walk Metropolis over weight vectors,
``/root/reference/src/samplers.cpp:7-36``; it has no gradient machinery at
all). JAX provides exact gradients of any log-density, so the Langevin
proposal

    x' = x + (eps^2 / 2) * grad log p(x) + eps * z,   z ~ N(0, I)

with the asymmetric-proposal MH correction comes almost for free and mixes
far faster than the random walk on smooth targets.

Layout matches mcmc/metropolis.py: chains as a leading [C, d] batch axis,
one ``lax.scan`` over sweeps, Robbins-Monro step adaptation toward the MALA
optimum 0.574, pooled across chains (``pmean`` over ``axis_name`` when
chain-sharded).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax


class MALAState(struct.PyTreeNode):
    x: jnp.ndarray             # [C, d]
    logp: jnp.ndarray          # [C]
    grad: jnp.ndarray          # [C, d] grad log p at x
    log_step: jnp.ndarray      # scalar, shared across chains
    accept_count: jnp.ndarray  # [C]


class MALAResult(struct.PyTreeNode):
    state: MALAState
    samples: Optional[jnp.ndarray]
    accept_rate: jnp.ndarray
    step_size: jnp.ndarray


def _pmean(x, axis_name):
    if axis_name is None:
        return jnp.mean(x)
    return lax.pmean(jnp.mean(x), axis_name)


def _value_and_grad_batched(log_prob: Callable):
    """(value, grad) of a batched log-density [C, d] -> [C] in one
    forward + one backward pass. Chains are independent, so pulling back a
    ones cotangent gives each chain its own gradient."""

    def vg(x):
        logp, vjp = jax.vjp(log_prob, x)
        (grad,) = vjp(jnp.ones_like(logp))
        return logp, grad

    return vg


def mala_init(log_prob: Callable, init_x: jnp.ndarray,
              step_size: float = 0.1) -> MALAState:
    vg = _value_and_grad_batched(log_prob)
    logp, grad = vg(init_x)
    return MALAState(
        x=init_x, logp=logp, grad=grad,
        log_step=jnp.asarray(jnp.log(step_size), init_x.dtype),
        accept_count=jnp.zeros(init_x.shape[0], init_x.dtype))


def mala_step(key: jax.Array, state: MALAState, log_prob: Callable,
              target_accept: float = 0.574, adapt_rate: float = 0.0,
              axis_name: Optional[str] = None):
    """One vectorized MALA sweep over all chains."""
    c, d = state.x.shape
    kz, ku = jax.random.split(key)
    eps = jnp.exp(state.log_step)
    eps2 = eps * eps
    z = jax.random.normal(kz, (c, d), state.x.dtype)
    mean_fwd = state.x + 0.5 * eps2 * state.grad
    x_prop = mean_fwd + eps * z

    vg = _value_and_grad_batched(log_prob)
    logp_prop, grad_prop = vg(x_prop)

    # log q(x | x') - log q(x' | x): Gaussian with mean x' + eps^2/2 grad'.
    mean_rev = x_prop + 0.5 * eps2 * grad_prop
    fwd = -jnp.sum((x_prop - mean_fwd) ** 2, axis=-1) / (2.0 * eps2)
    rev = -jnp.sum((state.x - mean_rev) ** 2, axis=-1) / (2.0 * eps2)
    log_alpha = logp_prop - state.logp + rev - fwd

    log_u = jnp.log(jax.random.uniform(ku, (c,), state.x.dtype))
    accept = log_u < log_alpha
    x_new = jnp.where(accept[:, None], x_prop, state.x)
    logp_new = jnp.where(accept, logp_prop, state.logp)
    grad_new = jnp.where(accept[:, None], grad_prop, state.grad)
    pooled = _pmean(accept.astype(state.x.dtype), axis_name)
    log_step = state.log_step + adapt_rate * (pooled - target_accept)
    return MALAState(
        x=x_new, logp=logp_new, grad=grad_new, log_step=log_step,
        accept_count=state.accept_count + accept.astype(state.x.dtype),
    ), pooled


def mala_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    step_size: float = 0.1,
    target_accept: float = 0.574,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name: Optional[str] = None,
) -> MALAResult:
    """Run ``num_steps`` MALA sweeps over [C, d] chains under one ``jit``.
    Conventions match ``metropolis_hastings_sampler`` (adaptation for the
    first ``num_adapt`` steps, then frozen; thinning of kept samples)."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    state = mala_init(log_prob, init_x, step_size)

    def body(state, t):
        k_t = jax.random.fold_in(key, t)
        adapt = jnp.where(t < num_adapt, adapt_rate, 0.0).astype(init_x.dtype)
        new_state, acc = mala_step(k_t, state, log_prob, target_accept,
                                   adapt, axis_name)
        out = (new_state.x, acc) if keep_samples else ((), acc)
        return new_state, out

    final, (xs_or_none, _) = lax.scan(body, state, jnp.arange(num_steps))

    samples = None
    if keep_samples:
        samples = xs_or_none[::thin] if thin > 1 else xs_or_none
    pooled_rate = _pmean(final.accept_count / num_steps, axis_name)
    return MALAResult(state=final, samples=samples, accept_rate=pooled_rate,
                      step_size=jnp.exp(final.log_step))
