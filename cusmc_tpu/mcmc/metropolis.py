"""Random-walk Metropolis-Hastings MCMC over MVN/MVT targets.

The reference exposes Metropolis-Hastings only as a *resampler* over weight
vectors (``/root/reference/src/samplers.cpp:7-36``); full posterior-sampling
MH over its MVN/MVT distributions is part of the north-star capability set
(BASELINE.json configs 1, 2, 5: MH on MVN posterior, MVT MH with tuned
proposal covariance, 1024-chain MH with pooled acceptance-rate adaptation
across hosts).

Design: one ``lax.scan`` over steps; chains are a leading batch axis that
``vmap``s/shards over a mesh "chains" axis (SNIPPETS.md [1] pattern).
Adaptation pools the acceptance rate across ALL chains — a ``psum`` over the
mesh when sharded — using the standard Robbins-Monro step-size rule toward a
target acceptance rate of 0.234.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax


class MHState(struct.PyTreeNode):
    """Carry for the MH scan. ``x`` [C, d] current positions, ``logp`` [C],
    ``log_step`` scalar log proposal scale (shared across chains),
    ``accept_count`` [C] totals."""

    x: jnp.ndarray
    logp: jnp.ndarray
    log_step: jnp.ndarray
    accept_count: jnp.ndarray


class MHResult(struct.PyTreeNode):
    state: MHState
    samples: Optional[jnp.ndarray]      # [T, C, d] when keep_samples
    accept_rate: jnp.ndarray            # scalar, pooled over chains
    step_size: jnp.ndarray              # final adapted scale


def _pmean(x, axis_name):
    if axis_name is None:
        return jnp.mean(x)
    return lax.pmean(jnp.mean(x), axis_name)


def mh_init(key: jax.Array, log_prob: Callable, init_x: jnp.ndarray,
            step_size: float = 0.5) -> MHState:
    """init_x [C, d] initial chain positions."""
    del key
    logp = log_prob(init_x)
    return MHState(
        x=init_x,
        logp=logp,
        log_step=jnp.asarray(jnp.log(step_size), init_x.dtype),
        accept_count=jnp.zeros(init_x.shape[0], init_x.dtype),
    )


def mh_step(key: jax.Array, state: MHState, log_prob: Callable,
            proposal_chol: Optional[jnp.ndarray] = None,
            target_accept: float = 0.234, adapt_rate: float = 0.0,
            axis_name: Optional[str] = None,
            noise_dtype: Optional[jnp.dtype] = None):
    """One vectorized random-walk MH sweep over all chains.

    Proposal: x' = x + exp(log_step) * (z @ proposal_chol.T), z ~ N(0, I)
    (identity proposal covariance when ``proposal_chol`` is None — the
    "tuned proposal covariance" of BASELINE config 2 passes a Cholesky).

    ``adapt_rate > 0`` applies Robbins-Monro adaptation of ``log_step``
    toward ``target_accept`` using the acceptance rate POOLED across chains
    (pmean over ``axis_name`` when sharded — BASELINE config 5).

    ``noise_dtype=jnp.bfloat16`` draws the proposal noise in bf16 (half
    the PRNG bits) and casts to the state dtype. Unlike bf16 *state* in
    the particle filter, this is EXACT: round-to-nearest is an odd
    function, so the increment distribution stays symmetric and the
    Metropolis ratio is unchanged — no bias, just a coarser (still
    N(0,I)-symmetric) proposal grid.
    """
    c, d = state.x.shape
    kz, ku = jax.random.split(key)
    z = jax.random.normal(kz, (c, d), noise_dtype or state.x.dtype)
    z = z.astype(state.x.dtype)
    if proposal_chol is not None:
        z = z @ proposal_chol.T
    x_prop = state.x + jnp.exp(state.log_step) * z
    logp_prop = log_prob(x_prop)
    log_u = jnp.log(jax.random.uniform(ku, (c,), state.x.dtype))
    accept = log_u < (logp_prop - state.logp)
    x_new = jnp.where(accept[:, None], x_prop, state.x)
    logp_new = jnp.where(accept, logp_prop, state.logp)
    pooled_accept = _pmean(accept.astype(state.x.dtype), axis_name)
    log_step = state.log_step + adapt_rate * (pooled_accept - target_accept)
    return MHState(
        x=x_new, logp=logp_new, log_step=log_step,
        accept_count=state.accept_count + accept.astype(state.x.dtype),
    ), pooled_accept


def metropolis_hastings_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    step_size: float = 0.5,
    proposal_chol: Optional[jnp.ndarray] = None,
    target_accept: float = 0.234,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name: Optional[str] = None,
    noise_dtype: Optional[jnp.dtype] = None,
) -> MHResult:
    """Run ``num_steps`` MH sweeps over [C, d] chains under one ``jit``.

    ``num_adapt`` (default num_steps//2) steps use Robbins-Monro step-size
    adaptation, then the scale freezes (samples from the adaptation phase
    are included in ``samples``; discard as burn-in downstream).
    ``thin`` keeps every thin-th sweep's positions.
    """
    if num_adapt is None:
        num_adapt = num_steps // 2
    state = mh_init(key, log_prob, init_x, step_size)

    # adapt_rate enters via jnp.where on the traced t, so one compiled body
    # serves both phases (no Python branch per step).
    def body(state, t):
        k_t = jax.random.fold_in(key, t)
        adapt = jnp.where(t < num_adapt, adapt_rate, 0.0).astype(init_x.dtype)
        new_state, acc = mh_step(k_t, state, log_prob, proposal_chol,
                                 target_accept, adapt, axis_name,
                                 noise_dtype)
        out = (new_state.x, acc) if keep_samples else ((), acc)
        return new_state, out

    final, (xs_or_none, accs) = lax.scan(body, state, jnp.arange(num_steps))

    samples = None
    if keep_samples:
        samples = xs_or_none[::thin] if thin > 1 else xs_or_none
    pooled_rate = _pmean(final.accept_count / num_steps, axis_name)
    return MHResult(
        state=final,
        samples=samples,
        accept_rate=pooled_rate,
        step_size=jnp.exp(final.log_step),
    )
