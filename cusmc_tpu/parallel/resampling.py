"""Distributed resampling over a particle-sharded mesh.

The hard part of sharded SMC (SURVEY.md §7 "Hard parts"): resamplers need
*global* weight information and ancestor states may live on other shards.
Weights are always cheap — ``all_gather`` of the log-weight vector is O(N)
scalars (4 MB at N=1M f32). The STATE exchange is where the
strategies differ:

- ``ring_cdf_resample_op`` (CDF family, packed [d, L] layout, the
  default): each shard computes SORTED global ancestors for its own slots
  from the gathered weights, then the state blocks make one trip around
  the ring (P-1 ``ppermute`` rounds); each passing block is mined for the
  slots whose ancestor lives in it via a LOCAL column gather
  (``ops/monotone_gather.take_columns``). Per-device state memory stays O(N/P * d); nothing ever
  materializes the global [N, d] array (closes SURVEY.md §7's
  "avoid all-gathering states at large N*d").
- ``roll_metropolis_sharded_op`` (packed, gather-free): per-sweep GLOBAL
  uniform proposals via one dynamic-source ppermute + local lane roll per
  sweep (``exchange="global"``, the default — unbiased for any weight
  concentration), or the round-1 single rotated 2-shard window
  (``exchange="windowed"`` — 10x less collective traffic, but a particle can
  parent at most ~2*N/P offspring per step, which biases resampling when
  one weight dominates; fine in healthy-ESS regimes).
- ``allgather_resample_op`` (batch [L, d] layout): the round-1 fallback —
  all-gather x [N, d] then a local gather. O(N*d) memory per device; kept
  for batch-layout models and unsorted-ancestor resamplers.

All ops return GLOBAL ancestor indices, so sharded ancestry logs are
directly comparable with single-device runs. Ops accepting ``pred``
support ESS-adaptive filtering without the compute-both-branches
overhead: collectives run unconditionally (shard_map-safe), local heavy
work is gated on ``pred``, and identity ancestry is returned when
``pred`` is False.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def _global_slots(n_local: int, axis_name: str) -> jnp.ndarray:
    shard = lax.axis_index(axis_name)
    return shard * n_local + jnp.arange(n_local, dtype=jnp.int32)


def _to_exp(logw_global: jnp.ndarray) -> jnp.ndarray:
    """Max-normalized exp weights from gathered log weights (the
    log-space entry point; the exp-space carry passes w directly)."""
    return jnp.exp(logw_global - jnp.max(logw_global))


def _search_sorted_positions(w_g: jnp.ndarray, positions_01: jnp.ndarray
                             ) -> jnp.ndarray:
    """Global ancestors for this shard's SORTED positions in [0, 1):
    the single-device weight pipeline (cumsum + sorted search,
    ``ops/monotone_gather.inverse_cdf_search``) applied to the gathered
    exp weights."""
    from cusmc_tpu.ops.monotone_gather import inverse_cdf_search, weight_cdf

    cdf = weight_cdf(w_g)
    return inverse_cdf_search(cdf, positions_01.astype(cdf.dtype) * cdf[-1])


def sharded_sorted_positions_fn(name: str, axis_name: str, n_global: int,
                                n_local: int) -> Callable:
    """Single source of truth for this shard's SORTED resampling positions
    in [0, 1), shared by ``make_sharded_ancestor_fn`` and
    ``ring_cdf_resample_op``.
    ``key`` must be identical on all shards; systematic shares one global
    offset, stratified/multinomial fold the shard index in."""
    if name == "systematic":
        def positions(key):
            u = jax.random.uniform(key, (), jnp.float32)  # shared offset
            slots = _global_slots(n_local, axis_name).astype(jnp.float32)
            return (slots + u) / n_global
    elif name == "stratified":
        def positions(key):
            k = jax.random.fold_in(key, lax.axis_index(axis_name))
            u = jax.random.uniform(k, (n_local,), jnp.float32)
            slots = _global_slots(n_local, axis_name).astype(jnp.float32)
            return (slots + u) / n_global
    elif name == "multinomial":
        from cusmc_tpu.resampling.classic import sorted_uniforms

        def positions(key):
            k = jax.random.fold_in(key, lax.axis_index(axis_name))
            return sorted_uniforms(k, n_local, jnp.float32)
    else:
        raise KeyError(f"no sorted sharded position law for {name!r}")
    return positions


def make_sharded_ancestor_fn(name: str, axis_name: str, n_global: int,
                             n_local: int, num_steps: int = 10,
                             weights: str = "log") -> Callable:
    """Build ``(key, weights_global) -> global ancestors [n_local]`` for
    this shard's slots. ``key`` must be identical on all shards.
    ``weights="log"`` takes gathered log weights (generic path);
    ``weights="exp"`` takes max-normalized exp weights directly (the
    exp-space fast carry, skipping the per-step exp pass)."""
    exp_in = weights == "exp"

    def wexp(w_or_logw):
        return w_or_logw if exp_in else _to_exp(w_or_logw)

    if name in ("systematic", "stratified"):
        pos_fn = sharded_sorted_positions_fn(name, axis_name, n_global,
                                             n_local)

        def fn(key, w_g):
            return _search_sorted_positions(wexp(w_g), pos_fn(key))
    elif name == "multinomial":
        def fn(key, w_g):
            k = jax.random.fold_in(key, lax.axis_index(axis_name))
            if exp_in:
                # categorical wants logits; the gathered exp weights are
                # max-normalized so the log is safe (log(0) slots get
                # -inf, never drawn).
                w_g = jnp.log(w_g)
            return jax.random.categorical(k, w_g,
                                          shape=(n_local,)).astype(jnp.int32)
    elif name == "metropolis":
        def fn(key, w_g):
            k_shard = jax.random.fold_in(key, lax.axis_index(axis_name))
            init = _global_slots(n_local, axis_name)
            wv = wexp(w_g)

            def sweep(b, kcur):
                kb = jax.random.fold_in(k_shard, b)
                kj, ku = jax.random.split(kb)
                j = jax.random.randint(kj, (n_local,), 0, n_global, jnp.int32)
                u = jax.random.uniform(ku, (n_local,), wv.dtype)
                accept = u * wv[kcur] < wv[j]
                return jnp.where(accept, j, kcur)

            return lax.fori_loop(0, num_steps, sweep, init)
    else:
        raise KeyError(f"no sharded variant of resampler {name!r}")
    return fn


def make_sorted_sharded_ancestor_fn(name: str, axis_name: str,
                                    n_global: int, n_local: int,
                                    weights: str = "log") -> Callable:
    """Like ``make_sharded_ancestor_fn`` but guaranteed SORTED per shard
    (what the ring exchange's monotone local gathers want). Systematic and
    stratified are sorted by construction; multinomial uses per-shard
    sorted-uniform order statistics (the ancestor multiset stays exactly
    multinomial — resampling is exchangeable, see resampling/classic.py);
    residual uses the floor-count grid + sorted-uniform remainder
    (law-identical to ``resampling.classic.residual_ancestors`` up to the
    exchangeable order of the remainder draws)."""
    if name in ("systematic", "stratified"):
        return make_sharded_ancestor_fn(name, axis_name, n_global, n_local,
                                        weights=weights)
    exp_in = weights == "exp"
    if name == "multinomial":
        pos_fn = sharded_sorted_positions_fn(name, axis_name, n_global,
                                             n_local)

        def fn(key, w_g):
            return _search_sorted_positions(
                w_g if exp_in else _to_exp(w_g), pos_fn(key))

        return fn
    if name == "residual":
        return _sorted_sharded_residual_fn(axis_name, n_global, n_local,
                                           exp_in)
    raise KeyError(f"no sorted sharded variant of resampler {name!r}")


def _sorted_sharded_residual_fn(axis_name: str, n_global: int,
                                n_local: int, exp_in: bool) -> Callable:
    """Sharded residual ancestors: global output slot s takes the
    deterministic floor-count grid inverse while s < n_det, else the
    (s - n_det)-th sorted-uniform remainder draw — law-identical to
    ``resampling.classic.residual_ancestors``. Each shard computes only
    its own slots' queries. Both families are sorted, but the stitched
    vector is sorted only WITHIN each family (a remainder ancestor can
    precede the last deterministic one), so on the shard holding the
    n_det boundary the ring exchange mines by true min/max range, not
    by first/last (equality with the single-device law is tested)."""
    from cusmc_tpu.ops.monotone_gather import inverse_cdf_search, weight_cdf
    from cusmc_tpu.resampling.classic import _residual_positions

    def fn(key, w_g):
        w = w_g if exp_in else _to_exp(w_g)
        wdt = w.dtype
        s1 = jnp.sum(w)
        nw = w * (n_global / s1)
        counts = jnp.floor(nw)
        ccum = weight_cdf(counts)
        n_det = jnp.minimum(ccum[-1], n_global).astype(jnp.int32)
        rcdf = weight_cdf(jnp.maximum(nw - counts, 0.0))
        slots = _global_slots(n_local, axis_name).astype(wdt)
        # Deterministic-grid queries for my slots (clamped inside the
        # active range; outputs past n_det are replaced below).
        p_det = jnp.minimum(slots + 0.5, n_det.astype(wdt) - 0.5)
        a_det = inverse_cdf_search(ccum, p_det)
        # Remainder order statistics: common key -> all shards draw the
        # SAME global [n_global] vector (cheap: one uniform pass) and
        # slice their slots' entries; draw k belongs to slot n_det + k.
        # Clamp at the VALUE level only (one ulp below the cdf total) so
        # a top order statistic past 1-eps is not collapsed — a fixed
        # 1-1e-6 quantile haircut hits ~63% of runs at R~1e6 draws
        # (round-5 advisor finding).
        rtot = rcdf[-1]
        v = jnp.minimum(_residual_positions(key, n_global, n_det, wdt)
                        * rtot,
                        jnp.nextafter(rtot, jnp.zeros((), wdt)))
        p = lax.axis_index(axis_name)
        # Slot s uses remainder draw v[s - n_det]; my slots start at
        # p * n_local, so slice v (doubled, to absorb the negative
        # wrap when n_det falls inside my range — wrapped entries are
        # masked off below) at (p * n_local - n_det) mod n_global.
        start = lax.rem(p * n_local - n_det + n_global,
                        jnp.int32(n_global))
        v_mine = lax.dynamic_slice_in_dim(jnp.concatenate([v, v]),
                                          start, n_local)
        mask = slots.astype(jnp.int32) < n_det
        # Deterministic slots are a PREFIX of this shard's slots; zero
        # their (wrapped-garbage) queries; their ranks are discarded.
        v_mine = jnp.where(mask, 0.0, v_mine)
        a_res = inverse_cdf_search(rcdf, v_mine)
        return jnp.where(mask, jnp.minimum(a_det, n_global - 1), a_res)

    return fn


def ring_cdf_resample_op(name: str, axis_name: str, n_global: int,
                         n_local: int, with_stats: bool = False,
                         weights: str = "log", ring_window: int = 2,
                         **kwargs) -> Callable:
    """CDF-family resample op with O(n_local * d) state memory.

    Packed [d, L] layout. Weights are all-gathered (O(N) scalars); each
    shard derives SORTED global ancestors for its slots; then the needed
    state blocks are exchanged and each block is mined by a local
    monotone gather + mask-select. The global [N, d] state array is
    never materialized on any device — SURVEY.md §7 "avoid all-gathering
    states at large N*d".

    The exchange is SPAN-BOUNDED (round 5; replaces the round-2..4
    unconditional P-1-round full ring): a shard's sorted ancestors span
    ~ceil(L * concentration) contiguous source blocks — typically 1-2 in
    healthy regimes — so moving the full state P-1 hops per step is
    O(P) wasted traffic and a P-deep serialized permute chain on large
    meshes. Instead:

    1. Round 0 mines the shard's OWN block (in the same
       ``inverse_cdf_apply`` call as the search, for the CDF families).
    2. ``ring_window`` (K) static bidirectional neighbor rounds: two
       chained ppermute rings (forward p+1..p+K, backward p-1..p-K),
       each round's mining gated on ancestor-range intersection. These
       2K single-hop ppermutes are the ONLY unconditional state
       traffic and cover source distances {±1..±K} — the dominant case.
    3. A dynamic-length forward ring (``lax.while_loop`` whose trip
       count F-K is derived from the all-gathered per-shard
       (a_min, a_max) table — 2 ints per shard, identical on all
       shards, so the loop is replicated) covers any shard whose span
       escapes the static window, up to the full rotation in the
       worst (fully concentrated far-block) case. Healthy regimes run
       ZERO dynamic rounds.

    The jaxpr therefore contains O(K) ppermute instances independent of
    P (asserted in tests/test_parallel_resampling.py), and per-step state
    traffic drops from (P-1)*L*d to 2K*L*d + span-excess. For small
    meshes (P <= 2K+1, where the bidirectional window already covers the
    whole ring) the original single-direction ring is kept — same
    traffic, simpler program.

    ``pred`` (optional traced bool, identical on all shards) gates the
    local gather work per round and substitutes identity ancestry — the
    ESS-adaptive path pays only the 2K static hops when skipping (the
    dynamic ring sees the identity ancestry span and runs 0 rounds).

    ``with_stats=True`` makes the op return a 4th element: the number of
    rounds actually mined on this shard (for tests/diagnostics).

    ``weights="exp"`` makes the op consume (and return) max-normalized
    exp weights — the sharded exp-space carry (uniform-after-resample is
    1.0 instead of -log N); "log" keeps the log-weight interface.
    """
    from cusmc_tpu.ops.monotone_gather import take_columns

    exp_in = weights == "exp"
    fused_local = name in ("systematic", "stratified", "multinomial")
    if not fused_local:
        ancestor_fn = make_sorted_sharded_ancestor_fn(name, axis_name,
                                                      n_global, n_local,
                                                      weights=weights)
        sorted_positions = None
    else:
        sorted_positions = sharded_sorted_positions_fn(
            name, axis_name, n_global, n_local)
    num_shards = n_global // n_local
    log_n = math.log(n_global)
    K = max(int(ring_window), 1)
    span_bounded = num_shards > 2 * K + 1
    # device s+1 sends to s: after r fwd rounds, device p holds (p+r)%P.
    perm_fwd = [((s + 1) % num_shards, s) for s in range(num_shards)]
    perm_bwd = [((s - 1) % num_shards, s) for s in range(num_shards)]

    def op(key, X, w_or_logw, pred=None):
        from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply, weight_cdf

        w_g = lax.all_gather(w_or_logw, axis_name, tiled=True)
        p = lax.axis_index(axis_name)
        base0 = p * jnp.int32(n_local)
        slots = _global_slots(n_local, axis_name)
        if fused_local:
            # Round 0: one call both ranks the shard's queries in the
            # gathered cdf AND gathers the ancestors that live in the
            # LOCAL block (local_base mode).
            cdf = weight_cdf(w_g if exp_in else _to_exp(w_g))
            pos = sorted_positions(key) * cdf[-1]
            vals0, a = inverse_cdf_apply(cdf, pos, X, local_base=base0)
        else:
            a = ancestor_fn(key, w_g)
        if pred is not None:
            a = jnp.where(pred, a, slots)
        # Coverage range (residual's stitched vector is sorted only
        # per family, so use true min/max, not first/last).
        a_min, a_max = jnp.min(a), jnp.max(a)

        def need_at(base):
            need = (a_max >= base) & (a_min < base + n_local)
            return need if pred is None else need & pred

        def mine(out_, blk_, base_):
            rel = jnp.clip(a - base_, 0, n_local - 1)
            vals = take_columns(blk_, rel)
            mask = (a >= base_) & (a < base_ + n_local)
            return jnp.where(mask[None, :], vals, out_)

        def mine_round(out_, mined_, blk_, base_):
            need = need_at(base_)
            out_ = lax.cond(need,
                            lambda o: mine(o, blk_, base_),
                            lambda o: o, out_)
            return out_, mined_ + need.astype(jnp.int32)

        # Round 0: own block.
        out = X
        mined = jnp.int32(0)
        need0 = need_at(base0)
        if fused_local:
            # inverse_cdf_apply already gathered in-block ancestors.
            # pred gating: when skipping, a == slots (all in-block)
            # but the state must stay X, so the overwrite is gated
            # on pred too.
            mask = (a >= base0) & (a < base0 + n_local)
            sel = mask if pred is None else (mask & pred)
            out = jnp.where(sel[None, :], vals0, out)
            mined = mined + need0.astype(jnp.int32)
        else:
            out, mined = mine_round(out, mined, X, base0)

        P_ = jnp.int32(num_shards)

        def base_of(r):
            """Block held after r forward rounds, as a column base."""
            return lax.rem(p + jnp.int32(r), P_) * n_local

        if not span_bounded:
            # Small mesh: the original full single-direction ring.
            blk = X
            for r in range(1, num_shards):
                blk = lax.ppermute(blk, axis_name, perm_fwd)
                out, mined = mine_round(out, mined, blk, base_of(r))
        else:
            # 2K static bidirectional neighbor rounds (chained 1-hop
            # ppermutes; fwd and bwd chains are independent).
            fwd = X
            bwd = X
            for s in range(1, K + 1):
                fwd = lax.ppermute(fwd, axis_name, perm_fwd)
                out, mined = mine_round(out, mined, fwd, base_of(s))
                bwd = lax.ppermute(bwd, axis_name, perm_bwd)
                # Backward distance s == forward distance P-s (base_of
                # takes non-negative r so lax.rem stays non-negative).
                out, mined = mine_round(out, mined, bwd,
                                        base_of(num_shards - s))

            # Dynamic forward ring for span escapes: trip count F-K
            # where F = max forward distance any shard needs in the
            # uncovered gap [K+1, P-K-1], from the all-gathered
            # (a_min, a_max) table (identical on all shards, so the
            # while_loop is replicated and its collective matches up).
            table = lax.all_gather(jnp.stack([a_min, a_max]), axis_name)
            bmin = table[:, 0] // n_local                    # [P]
            bmax = table[:, 1] // n_local
            pidx = jnp.arange(num_shards, dtype=jnp.int32)
            # Block seen by shard q at forward distance t: (q + t) % P.
            b_of = lax.rem(pidx[:, None] + pidx[None, :], P_)
            needed = (bmin[:, None] <= b_of) & (b_of <= bmax[:, None])
            need_dist = jnp.any(needed, axis=0)              # [P]
            in_gap = (pidx >= K + 1) & (pidx <= num_shards - K - 1)
            F = jnp.max(jnp.where(need_dist & in_gap, pidx, K))

            def w_cond(carry):
                return carry[0] < F

            def w_body(carry):
                r, blk, out_, mined_ = carry
                blk = lax.ppermute(blk, axis_name, perm_fwd)
                r = r + 1
                out_, mined_ = mine_round(out_, mined_, blk,
                                          base_of(r))
                return r, blk, out_, mined_

            _, _, out, mined = lax.while_loop(
                w_cond, w_body, (jnp.int32(K), fwd, out, mined))

        if exp_in:
            w_out = jnp.ones((n_local,), w_or_logw.dtype)
        else:
            w_out = jnp.full((n_local,), -log_n, w_or_logw.dtype)
        if pred is not None:
            w_out = jnp.where(pred, w_out, w_or_logw)
        if with_stats:
            return out, w_out, a, mined
        return out, w_out, a

    return op


def roll_metropolis_sharded_op(axis_name: str, n_global: int, n_local: int,
                               num_steps: int = 10,
                               exchange: str = "global",
                               weights: str = "log") -> Callable:
    """Gather-free distributed Metropolis resampling in packed [d, L] layout.

    ``exchange="global"`` (default): every sweep b draws a fresh GLOBAL
    proposal alignment — a uniform source shard q_b (one dynamic-source
    ``ppermute`` via ``lax.switch``) plus a uniform local lane roll s_b —
    so slot i's candidate is particle ((p+q_b) mod P, (i+s_b) mod L),
    marginally uniform over all N particles. This matches the
    single-device roll scheme's proposal law exactly: unbiased for ANY
    weight concentration (a w->1 particle can parent ~N offspring).
    Collective traffic: num_steps x (d+1) x L floats per step.

    ``exchange="binary"``: same proposal law and BITWISE-identical
    results to "global" (identical key derivation; the rotate is pure
    data movement), but the B dynamic-source switches are replaced by
    one batched doubling chain of ceil(log2 P) static ppermutes over the
    stacked [B, d+1, L] candidates. Program size O(log P) instead of
    O(B*P) (measured at P=64, B=10: 640 ppermute instances / 1.5 MB
    StableHLO for "global" vs 6 / O(10x smaller) here —
    benchmarks/compile_scale.py), at B*log2(P) block-traffic instead of
    B. Prefer it on large meshes, where program size dominates.

    ``exchange="windowed"`` (round 1 behavior): ONE global rotation per
    step places a 2-shard window; all B sweeps propose inside it. 10x less
    traffic (2 x (d+1) x L, independent of B), but a particle can parent
    at most ~2L offspring per step — biased when one weight dominates
    (quantified in tests/test_parallel.py::test_sharded_concentrated_
    weights); fine in healthy-ESS regimes.

    Returns GLOBAL ancestor indices like the other ops. ``pred`` gates
    the local accept/select work (windowed: also the sweeps); collective
    traffic is unconditional as shard_map requires.
    """
    if num_steps == "auto" and (n_global != n_local
                                or exchange == "windowed"):
        # The ESS-conditioned sweep schedule exists only for the
        # single-shard roll sweeps (the 1-shard specialization of the
        # global/binary exchanges); every other path builds a static
        # per-sweep collective program. Fail clearly instead of a
        # TypeError mid-trace (round-5 review findings).
        raise ValueError(
            "num_steps='auto' needs a 1-shard mesh with "
            "exchange='global'/'binary'; pass an integer sweep count "
            "otherwise")


    num_shards = n_global // n_local
    log_n = math.log(n_global)
    exp_in = weights == "exp"

    if num_shards == 1 and exchange in ("global", "binary"):
        # P=1 specialization: the per-sweep
        # dynamic-source ppermute is provably the identity on a 1-shard
        # mesh, yet its lax.switch indirection adds structural overhead
        # to every sweep. Run the unsharded roll sweeps — the exact
        # single-device program — so a 1-device-mesh sharded filter
        # pays only shard_map framing.
        from cusmc_tpu.resampling.rolls import (
            roll_metropolis_sweeps,
            roll_metropolis_sweeps_expspace,
        )

        def op_single(key, X, wv, pred=None):
            k_shard = jax.random.fold_in(key, lax.axis_index(axis_name))

            def sweeps(_):
                if num_steps == "auto":
                    from cusmc_tpu.resampling.rolls import (
                        roll_metropolis_sweeps_expspace_auto,
                    )

                    w = wv if exp_in else jnp.exp(wv - jnp.max(wv))
                    x_anc, a = roll_metropolis_sweeps_expspace_auto(
                        k_shard, X, w)
                elif exp_in:
                    x_anc, a = roll_metropolis_sweeps_expspace(
                        k_shard, X, wv, num_steps)
                else:
                    x_anc, a = roll_metropolis_sweeps(k_shard, X, wv,
                                                      num_steps)
                if exp_in:
                    w_out = jnp.ones((n_local,), wv.dtype)
                else:
                    w_out = jnp.full((n_local,), -log_n, wv.dtype)
                return x_anc, w_out, a

            if pred is None:
                return sweeps(None)
            slots = jnp.arange(n_local, dtype=jnp.int32)
            return lax.cond(pred, sweeps,
                            lambda _: (X, wv, slots), None)

        return op_single

    def from_shift(shift):
        perm = [((s + shift) % num_shards, s) for s in range(num_shards)]
        return lambda v: lax.ppermute(v, axis_name, perm)

    branches = [from_shift(j) for j in range(num_shards)]

    def op_global(key, X, wv, pred=None):
        p = lax.axis_index(axis_name)
        both = jnp.concatenate([X, wv[None, :]], axis=0)  # [d+1, L]
        iota = jnp.arange(n_local, dtype=jnp.int32)
        slots = p * n_local + iota

        # Per-sweep randomness up front (identical derivation for both
        # exchange variants, so their results are bitwise equal).
        sweep_keys = []
        for b in range(num_steps):
            kb = jax.random.fold_in(key, b)
            sweep_keys.append(jax.random.split(kb, 3))
        qs = jnp.stack([jax.random.randint(kq, (), 0, num_shards,
                                           jnp.int32)
                        for kq, _, _ in sweep_keys])

        if exchange == "binary":
            # Batched binary-decomposition rotate: ONE chain of
            # ceil(log2 P) static ppermutes moves all B candidate
            # blocks at once — per-slice bits of
            # the common shift vector select which slices advance at
            # each doubling stage. O(log P) collective instances in
            # the program instead of the switch's B*P branch bodies
            # (measured: 640 instances / 1.5 MB StableHLO at P=64,
            # B=10 — benchmarks/compile_scale.py), at the cost of
            # B*log2(P) block-traffic instead of B. Data movement
            # only, so results are BITWISE identical to "global".
            stack = jnp.broadcast_to(both[None], (num_steps,)
                                     + both.shape)
            nbits = max((num_shards - 1).bit_length(), 1)
            for kbit in range(nbits):
                shift = (1 << kbit) % num_shards
                perm_k = [((s0 + shift) % num_shards, s0)
                          for s0 in range(num_shards)]
                rotated = lax.ppermute(stack, axis_name, perm_k)
                bit = ((qs >> kbit) & 1) == 1
                stack = jnp.where(bit[:, None, None], rotated, stack)

        x_cur, w_cur, a_cur = X, wv, slots
        for b in range(num_steps):
            _, ks, ku = sweep_keys[b]
            # q, s common across shards (key replicated); accept uniforms
            # per-slot independent (shard-folded).
            q = qs[b]
            s = jax.random.randint(ks, (), 0, n_local, jnp.int32)
            if exchange == "binary":
                cand = stack[b]                         # [d+1, L] shard p+q
            else:
                cand = lax.switch(q, branches, both)    # [d+1, L] shard p+q
            cand = jnp.roll(cand, -s, axis=1)           # slot i <- (i+s)%L
            u = jax.random.uniform(
                jax.random.fold_in(ku, p), (n_local,), wv.dtype)
            if exp_in:
                # u * w_cur < w_cand <=> log u < lw_cand - lw_cur; one
                # log pass per sweep deleted (same trick as
                # resampling/rolls.py).
                acc = u * w_cur < cand[-1]
            else:
                acc = jnp.log(u) < (cand[-1] - w_cur)
            if pred is not None:
                acc = acc & pred
            w_cur = jnp.where(acc, cand[-1], w_cur)
            x_cur = jnp.where(acc[None, :], cand[:-1], x_cur)
            j_new = (lax.rem(p + q, jnp.int32(num_shards)) * jnp.int32(n_local)
                     + lax.rem(iota + s, jnp.int32(n_local)))
            a_cur = jnp.where(acc, j_new, a_cur)

        if exp_in:
            w_out = jnp.ones((n_local,), wv.dtype)
        else:
            w_out = jnp.full((n_local,), -log_n, wv.dtype)
        if pred is not None:
            w_out = jnp.where(pred, w_out, wv)
        return x_cur, w_out, a_cur

    def op_windowed(key, X, wv, pred=None):
        # Common randomness across shards (key is replicated).
        kq, kr, km = jax.random.split(key, 3)
        q = jax.random.randint(kq, (), 0, num_shards, jnp.int32)
        r = jax.random.randint(kr, (), 0, n_local, jnp.int32)
        p = lax.axis_index(axis_name)

        both = jnp.concatenate([X, wv[None, :]], axis=0)  # [d+1, L]
        a_part = lax.switch(q, branches, both)
        b_part = lax.switch((q + 1) % num_shards, branches, both)
        window = jnp.concatenate([a_part, b_part], axis=1)   # [d+1, 2L]
        slots = p * n_local + jnp.arange(n_local, dtype=jnp.int32)

        def sweeps(_):
            rotated = lax.dynamic_slice_in_dim(window, r, n_local, axis=1)
            X_rot = rotated[:-1]
            w_rot = rotated[-1]
            k_shard = jax.random.fold_in(km, p)
            from cusmc_tpu.resampling.rolls import (
                roll_metropolis_sweeps,
                roll_metropolis_sweeps_expspace,
            )

            if exp_in:
                x_anc, a_loc = roll_metropolis_sweeps_expspace(
                    k_shard, X_rot, w_rot, num_steps)
            else:
                x_anc, a_loc = roll_metropolis_sweeps(k_shard, X_rot,
                                                      w_rot, num_steps)
            # Rotated local slot j holds global particle
            # (p*L + j + q*L + r) % N.
            a_global = lax.rem(
                (p + q) * jnp.int32(n_local) + a_loc + r,
                jnp.int32(n_global)).astype(jnp.int32)
            fill = 1.0 if exp_in else -log_n
            return (x_anc, jnp.full((n_local,), fill, wv.dtype),
                    a_global)

        if pred is None:
            return sweeps(None)
        return lax.cond(pred, sweeps,
                        lambda _: (X, wv, slots), None)

    if exchange in ("global", "binary"):
        return op_global
    if exchange == "windowed":
        return op_windowed
    raise KeyError(f"unknown exchange {exchange!r} "
                   f"(global, binary, windowed)")


def allgather_resample_op(name: str, axis_name: str, n_global: int,
                          n_local: int, **kwargs) -> Callable:
    """A ``resample_op`` for ``bootstrap_filter`` that resolves global
    ancestry via all-gathered weights and states."""
    ancestor_fn = make_sharded_ancestor_fn(name, axis_name, n_global,
                                           n_local, **kwargs)
    log_n = math.log(n_global)

    def op(key, x, logw):
        logw_g = lax.all_gather(logw, axis_name, tiled=True)       # [N]
        a_global = ancestor_fn(key, logw_g)                        # [n_local]
        x_g = lax.all_gather(x, axis_name, tiled=True)             # [N, d]
        x_anc = x_g[a_global]
        return x_anc, jnp.full((n_local,), -log_n, logw.dtype), a_global

    return op
