"""Gather-free Metropolis resampling in packed [d, N] layout.

The classic Metropolis resampler needs B random-index gathers per step
(one per sweep). The op here avoids all random gathers and scatters:

``roll_metropolis_resample_op`` — memory-coalesced Metropolis resampler
   (the Megopolis idea, arXiv:2109.13504, as whole-array rotations):
   sweep b proposes ancestor j = (i + s_b) mod N for every chain i, with
   one shared random shift s_b per sweep. Marginally each chain's
   candidate sequence is iid uniform over [0, N), so every chain is a
   valid independence-Metropolis chain over the weights, exactly like the
   reference's per-particle chains (``/root/reference/src/samplers.cpp:7-36``)
   — but candidate WEIGHTS arrive via ``jnp.roll`` (a rotation) and
   candidate STATES are applied by roll+select, so the whole B-sweep
   resample is ~B coalesced passes instead of B random gathers.
   Ancestor indices come free: a = (i + s_b) mod N needs no memory access.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def roll_metropolis_sweeps(key: jax.Array, X: jnp.ndarray, logw: jnp.ndarray,
                           num_steps: int = 10
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run B coalesced Metropolis sweeps; returns (X_resampled [d, N],
    ancestors [N] int32). ``X`` is packed [d, N]; ``logw`` unnormalized.

    Accept iff u < w_cand/w_cur <=> u * w_cur < w_cand: ONE exp pass
    replaces a log pass per sweep (10 transcendental passes over [N] per
    filter step), with bit-identical accept decisions up to rounding.
    Max-shift keeps exp in range; ratios are shift-invariant. Degenerate
    pairs (both weights 0 after underflow) reject, matching the log-space
    NaN-compare behavior.
    """
    w = jnp.exp(logw - jnp.max(logw))
    return roll_metropolis_sweeps_expspace(key, X, w, num_steps)


def roll_metropolis_weight_walk(key: jax.Array, w: jnp.ndarray,
                                num_steps: int = 10):
    """Phase 1 — the Metropolis weight walk WITHOUT touching the state:
    the winning ancestor is always i + s_b for the LAST accepted sweep b,
    so it suffices to carry (current weight, winning-sweep index).
    Unrolled (B is static) so XLA fuses the whole chain into few HBM
    passes over [N] scalars. Returns (b_win [N] int32 with -1 = kept
    self, shifts [B] int32)."""
    n = w.shape[-1]
    k_shift, k_u = jax.random.split(key)
    shifts = jax.random.randint(k_shift, (num_steps,), 0, n, jnp.int32)
    w_cur = w
    b_win = jnp.full((n,), -1, jnp.int32)
    for b in range(num_steps):
        s = shifts[b]
        w_cand = jnp.roll(w, -s)
        u = jax.random.uniform(jax.random.fold_in(k_u, b), (n,), w.dtype)
        acc = u * w_cur < w_cand
        w_cur = jnp.where(acc, w_cand, w_cur)
        b_win = jnp.where(acc, b, b_win)
    return b_win, shifts


def apply_winning_rolls(X: jnp.ndarray, b_win: jnp.ndarray,
                        shifts: jnp.ndarray) -> jnp.ndarray:
    """Phase 2 — materialize the resampled array once: a fused (B+1)-way
    select over shifted reads of X (lane rotations, never gathers).

    Commutes with any per-column map f acting on the row axis:
    apply(f(X)) == f(apply(X)) — the filter's fast path exploits this to
    apply the selection to G @ X directly, never materializing the
    resampled state itself."""
    x_f = X
    for b in range(shifts.shape[0]):
        sel = b_win == b
        x_f = jnp.where(sel[None, :], jnp.roll(X, -shifts[b], axis=1), x_f)
    return x_f


def winning_ancestors(b_win: jnp.ndarray, shifts: jnp.ndarray) -> jnp.ndarray:
    """Global ancestor indices a_i = (i + s_{b_win[i]}) mod n (arithmetic,
    no memory access)."""
    n = b_win.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    a_f = iota
    for b in range(shifts.shape[0]):
        j = iota + shifts[b]
        j = jnp.where(j >= n, j - n, j)
        a_f = jnp.where(b_win == b, j, a_f)
    return a_f


def roll_metropolis_sweeps_expspace(key: jax.Array, X: jnp.ndarray,
                                    w: jnp.ndarray, num_steps: int = 10
                                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``roll_metropolis_sweeps`` taking weights already in (relative)
    exp space — the filter's exp-space fast path carries these directly,
    skipping the per-step exp+max pass."""
    b_win, shifts = roll_metropolis_weight_walk(key, w, num_steps)
    return (apply_winning_rolls(X, b_win, shifts),
            winning_ancestors(b_win, shifts))


def roll_metropolis_sweeps_expspace_auto(key: jax.Array, X: jnp.ndarray,
                                         w: jnp.ndarray,
                                         num_steps: int = 10
                                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ESS-conditioned sweep truncation: the
    independence-MH chains' finite-sweep bias contracts per sweep at
    roughly (1 - 1/(N * max_i w_norm_i)) — near-uniform weights mix in a
    sweep or two, so spending the full budget there buys nothing. Bucket
    the Kish ESS ratio and run B, ceil(B/2), or ceil(B/4) sweeps
    (``lax.switch`` over three unrolled walks; exactly one executes):

        ess/N <= 0.5        -> B        (sharp weights: full budget)
        0.5 < ess/N <= 0.75 -> ceil(B/2)
        ess/N > 0.75        -> ceil(B/4)

    Thresholds: at ess/N ~ 0.8 the B/4 offspring law and filter logZ
    match B=10 within Monte-Carlo error; at ess/N ~ 0.3 truncation
    measurably biases logZ, hence the conservative full budget below 0.5. The reference fixes
    B = 10 unconditionally (``/root/reference/src/samplers.cpp:7-36``).
    Opt-in via ``resampler_kwargs={"num_steps": "auto"}``.
    """
    n = w.shape[-1]
    s1 = jnp.sum(w)
    s2 = jnp.sum(w * w)
    ratio = s1 * s1 / (s2 * n)

    def branch(b):
        return lambda _: roll_metropolis_sweeps_expspace(key, X, w, b)

    counts = sorted({num_steps, -(-num_steps // 2), -(-num_steps // 4)},
                    reverse=True)
    idx = jnp.int32(0)
    if len(counts) > 1:
        idx = ((ratio > 0.5).astype(jnp.int32)
               + (ratio > 0.75).astype(jnp.int32))
        idx = jnp.minimum(idx, len(counts) - 1)
    return lax.switch(idx, [branch(b) for b in counts], None)


def roll_metropolis_resample_op(num_steps: int = 10,
                                num_particles: int = None) -> Callable:
    """Packed-layout ``resample_op`` for ``bootstrap_filter``:
    (key, X [d, N], logw [N]) -> (X_anc, uniform logw, ancestors)."""

    def op(key, X, logw):
        n = logw.shape[-1]
        if num_steps == "auto":
            w = jnp.exp(logw - jnp.max(logw))
            x_anc, a = roll_metropolis_sweeps_expspace_auto(key, X, w)
        else:
            x_anc, a = roll_metropolis_sweeps(key, X, logw, num_steps)
        return x_anc, jnp.full((n,), -math.log(num_particles or n),
                               logw.dtype), a

    return op

