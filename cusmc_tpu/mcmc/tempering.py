"""Parallel tempering (replica exchange) over the MCMC family.

Extension beyond the reference's single sampler (random-walk Metropolis
over weight vectors, ``/root/reference/src/samplers.cpp:7-36``): the
reference has no machinery for multimodal targets at all. Tempering is
the classic fix — R replicas sample ``beta_r * log_prob`` with
``1 = beta_0 > beta_1 > ... > beta_{R-1}``, and adjacent rungs propose
state swaps accepted with probability

    min(1, exp((beta_i - beta_j) * (logp_j - logp_i)))

so hot rungs ferry mass between modes and the cold rung stays exact.

Design: replicas are just one more leading batch axis —
state is ``[R, C, d]`` (R rungs x C chains per rung), every within-rung
sweep is a single batched proposal + one log-density evaluation over
all R*C points (one matmul under ``make_*_logprob`` closures), and
the swap phase is a vectorized even/odd pair pass (standard DEO
alternation; Syed et al. 2021 show non-reversible even/odd alternation
dominates random pair choice) — no per-rung Python, no host control
flow, one ``lax.scan`` under jit. Chains may shard over a mesh axis
exactly like mcmc/metropolis.py (swaps are chain-local; only the
pooled acceptance statistics cross shards, via ``pmean``).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax


class PTState(struct.PyTreeNode):
    """``x`` [R, C, d] replica states (rung 0 is the cold, beta=1 chain),
    ``logp`` [R, C] log-densities at beta=1 (UNtempered — swaps and
    tempered acceptances both derive from it), ``log_step`` [R] per-rung
    proposal scales, ``accept_count`` [R] pooled within-rung acceptance
    totals, ``swap_count`` [R-1] accepted-swap totals per adjacent pair."""

    x: jnp.ndarray
    logp: jnp.ndarray
    log_step: jnp.ndarray
    accept_count: jnp.ndarray
    swap_count: jnp.ndarray
    ladder_s: jnp.ndarray      # [R-1] unnormalized log-spacing weights
    swap_ema: jnp.ndarray      # [R-1] EMA of per-pair swap probability


class PTResult(struct.PyTreeNode):
    state: PTState
    samples: Optional[jnp.ndarray]   # [T, C, d] cold-rung positions
    accept_rate: jnp.ndarray         # [R] within-rung, pooled
    swap_rate: jnp.ndarray           # [R-1] per adjacent pair
    step_size: jnp.ndarray           # [R] final adapted scales
    betas: jnp.ndarray               # [R] the ladder used


def geometric_ladder(num_rungs: int, beta_min: float = 0.1,
                     dtype=jnp.float32) -> jnp.ndarray:
    """beta_r = beta_min^(r / (R-1)) — the standard geometric ladder
    (equal log-spacing, uniform swap rates for Gaussian-like targets)."""
    if num_rungs < 2:
        return jnp.ones((num_rungs,), dtype)
    r = jnp.arange(num_rungs, dtype=dtype) / (num_rungs - 1)
    return jnp.asarray(beta_min, dtype) ** r


def _pmean(x, axis_name):
    if axis_name is None:
        return x
    return lax.pmean(x, axis_name)


def parallel_tempering_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    betas: Optional[jnp.ndarray] = None,
    num_rungs: int = 8,
    beta_min: float = 0.1,
    step_size: float = 0.5,
    target_accept: float = 0.234,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    swap_every: int = 1,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name: Optional[str] = None,
    noise_dtype: Optional[jnp.dtype] = None,
    adapt_ladder: bool = False,
    ladder_lr: float = 0.1,
    init_log_step: Optional[jnp.ndarray] = None,
) -> PTResult:
    """Run ``num_steps`` PT sweeps (each: one tempered RW-MH sweep on every
    rung + one even/odd swap pass when ``t % swap_every == 0``).

    ``init_x`` is [C, d] (broadcast to all rungs) or [R, C, d]. ``betas``
    overrides the geometric ladder; betas[0] must be 1 (cold chain).
    Per-rung step sizes Robbins-Monro-adapt toward ``target_accept``
    (pooled over that rung's chains, and over ``axis_name`` when chain
    sharded) for the first ``num_adapt`` sweeps (default num_steps//2),
    scaled 1/sqrt(beta) at init so hot rungs start wider.

    Returns cold-rung samples [T, C, d]; diagnostics include per-pair
    swap rates — tune the ladder toward uniform ~0.2-0.4 swap rates, or
    pass ``adapt_ladder=True`` to do it automatically: the interior
    betas (endpoints beta_0 = 1 and beta_{R-1} fixed) reparameterize as
    softmax log-spacings, and Robbins-Monro equalizes the per-pair swap
    probabilities (widening gaps that swap too easily, shrinking
    starved ones — the fixed-endpoint form of communication-barrier
    equalization). Adaptation runs for ``num_adapt`` sweeps then
    freezes; ``result.betas`` is the adapted ladder.
    """
    if betas is None:
        betas = geometric_ladder(num_rungs, beta_min, init_x.dtype)
    betas = jnp.asarray(betas, init_x.dtype)
    R = betas.shape[0]
    # Validate the ladder when it is concrete (inside jit every array
    # is a tracer — the built-in geometric ladder is correct by
    # construction there; a wrong user ladder is caught on any eager
    # call with the same arguments).
    if not isinstance(betas, jax.core.Tracer):
        import numpy as _np
        b_np = _np.asarray(betas)
        if R and not _np.isclose(b_np[0], 1.0, atol=1e-6):
            raise ValueError(
                f"betas[0] must be 1 (cold chain); got {b_np[0]}")
        if R > 1 and not (_np.diff(b_np) < 0).all():
            raise ValueError("betas must be strictly decreasing")
    if init_x.ndim == 2:
        init_x = jnp.broadcast_to(init_x[None], (R,) + init_x.shape)
    if init_x.shape[0] != R:
        raise ValueError(f"init_x rung axis {init_x.shape[0]} != {R} betas")
    if num_adapt is None:
        num_adapt = num_steps // 2
    _, c, d = init_x.shape
    dtype = init_x.dtype

    logp0 = log_prob(init_x.reshape(R * c, d)).reshape(R, c)
    state = PTState(
        x=init_x,
        logp=logp0,
        # hot rungs sample a flatter target: start sqrt(1/beta) wider
        # (init_log_step overrides for warm restarts — the convergence
        # driver re-injects the adapted per-rung scales).
        log_step=(jnp.asarray(init_log_step, dtype)
                  if init_log_step is not None
                  else jnp.log(jnp.asarray(step_size, dtype)
                               / jnp.sqrt(betas)).astype(dtype)),
        accept_count=jnp.zeros((R,), dtype),
        swap_count=jnp.zeros((max(R - 1, 0),), dtype),
        # softmax(ladder_s) * log(1/beta_min) reproduces the INITIAL
        # spacings exactly (s_i = log rho_i up to a constant).
        ladder_s=jnp.log(jnp.maximum(
            jnp.log(betas[:-1]) - jnp.log(betas[1:]), 1e-6))
        if R > 1 else jnp.zeros((0,), dtype),
        swap_ema=jnp.full((max(R - 1, 0),), 0.3, dtype),
    )
    total_gap = (jnp.log(betas[0]) - jnp.log(betas[-1])) if R > 1 else None

    def ladder_betas(state):
        if not adapt_ladder or R < 2:
            return betas
        rho = jax.nn.softmax(state.ladder_s) * total_gap
        logb = jnp.concatenate([jnp.zeros((1,), dtype),
                                -jnp.cumsum(rho)])
        return jnp.exp(logb)

    def rung_sweep(state, kz, ku, adapt, betas):
        z = jax.random.normal(kz, (R, c, d), noise_dtype or dtype)
        z = z.astype(dtype)
        x_prop = state.x + jnp.exp(state.log_step)[:, None, None] * z
        logp_prop = log_prob(x_prop.reshape(R * c, d)).reshape(R, c)
        log_u = jnp.log(jax.random.uniform(ku, (R, c), dtype))
        # tempered acceptance on beta_r * logp
        accept = log_u < betas[:, None] * (logp_prop - state.logp)
        x = jnp.where(accept[..., None], x_prop, state.x)
        logp = jnp.where(accept, logp_prop, state.logp)
        pooled = _pmean(jnp.mean(accept.astype(dtype), axis=1), axis_name)
        log_step = state.log_step + adapt * (pooled - target_accept)
        return state.replace(
            x=x, logp=logp, log_step=log_step,
            accept_count=state.accept_count + pooled), None

    def swap_pass(state, ks, parity, betas, adapt_on):
        """One DEO half-pass: propose swaps for pairs (r, r+1) with
        r % 2 == parity, vectorized over pairs and chains."""
        if R < 2:
            return state
        lo = jnp.arange(R - 1)
        active = (lo % 2) == parity                      # [R-1]
        dbeta = betas[:-1] - betas[1:]                   # [R-1]
        dlogp = state.logp[1:] - state.logp[:-1]         # [R-1, C]
        log_u = jnp.log(jax.random.uniform(ks, (R - 1, c), dtype))
        acc = (log_u < dbeta[:, None] * dlogp) & active[:, None]
        # Build a per-(rung, chain) source index: rung r takes rung
        # r+1's state when pair r accepted, rung r-1's when pair r-1
        # accepted. Pairs at one parity are disjoint, so the two
        # conditions never both fire for one rung.
        take_up = jnp.concatenate(
            [acc, jnp.zeros((1, c), bool)], axis=0)      # [R, C] r <- r+1
        take_dn = jnp.concatenate(
            [jnp.zeros((1, c), bool), acc], axis=0)      # [R, C] r <- r-1
        # Adjacent-only exchange: two rung-axis rolls + selects instead
        # of a rung-varying gather (the same shape as the filter's roll
        # resampler).
        def exchange(a):
            up = jnp.roll(a, -1, axis=0)                 # row r = a[r+1]
            dn = jnp.roll(a, 1, axis=0)                  # row r = a[r-1]
            tu, td = take_up, take_dn
            if a.ndim == 3:
                tu, td = tu[..., None], td[..., None]
            return jnp.where(tu, up, jnp.where(td, dn, a))

        x = exchange(state.x)
        logp = exchange(state.logp)
        pooled_sw = _pmean(jnp.mean(acc.astype(dtype), axis=1), axis_name)
        new = state.replace(
            x=x, logp=logp, swap_count=state.swap_count + pooled_sw)
        if adapt_ladder:
            # Rao-Blackwellized swap probability (expected, not the
            # 0/1 outcome): lower-variance signal for the ladder.
            p_sw = _pmean(jnp.mean(
                jnp.exp(jnp.minimum(dbeta[:, None] * dlogp, 0.0)),
                axis=1), axis_name)
            ema = jnp.where(active,
                            0.9 * state.swap_ema + 0.1 * p_sw,
                            state.swap_ema)
            # equalize: pairs above the mean get wider gaps
            step = ladder_lr * (ema - jnp.mean(ema))
            s_new = state.ladder_s + adapt_on * step
            new = new.replace(ladder_s=s_new, swap_ema=ema)
        return new

    def body(state, t):
        k_t = jax.random.fold_in(key, t)
        kz, ku, ks = jax.random.split(k_t, 3)
        adapt = jnp.where(t < num_adapt, adapt_rate, 0.0).astype(dtype)
        adapt_on = jnp.where(t < num_adapt, 1.0, 0.0).astype(dtype)
        bet = ladder_betas(state)
        state, _ = rung_sweep(state, kz, ku, adapt, bet)

        # DEO: even pairs at even swap events, odd pairs at odd ones —
        # the non-reversible alternation that gives O(R) round trips.
        event = t // swap_every
        parity = event % 2

        def do_swaps(st):
            return swap_pass(st, ks, parity, bet, adapt_on)

        if swap_every == 1:
            state = do_swaps(state)
        else:
            state = lax.cond(t % swap_every == 0, do_swaps,
                             lambda s: s, state)
        out = (state.x[0],) if keep_samples else ((),)
        return state, out

    final, outs = lax.scan(body, state, jnp.arange(num_steps))
    samples = None
    if keep_samples:
        (xs,) = outs
        samples = xs[::thin] if thin > 1 else xs
    # events fire at t % swap_every == 0 (t = 0 included); event e has
    # parity e % 2, so even pairs are proposed ceil(E/2) times and odd
    # pairs E//2 times (round-5 review: the old 0.5*E denominator could
    # exceed probability 1 and divided never-proposed pairs).
    n_events = -(-num_steps // swap_every)
    n_lo = jnp.maximum((n_events + 1) // 2, 1)
    n_hi = jnp.maximum(n_events // 2, 1)
    pair_events = jnp.where(jnp.arange(max(R - 1, 0)) % 2 == 0,
                            n_lo, n_hi).astype(betas.dtype)
    return PTResult(
        state=final,
        samples=samples,
        accept_rate=final.accept_count / num_steps,
        swap_rate=final.swap_count / pair_events,
        step_size=jnp.exp(final.log_step),
        betas=ladder_betas(final),
    )
