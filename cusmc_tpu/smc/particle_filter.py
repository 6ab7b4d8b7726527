"""Bootstrap particle filter as a single compiled ``lax.scan``.

Replacement for the reference's driver stack
(``/root/reference/src/run.rcpp.cpp:58-126`` -> ``src/particle_filter.cpp:6-39``
-> ``MCMC`` time loop ``src/mcmc.cpp:239-309``). The reference crosses the
host<->device boundary six times per timestep (H2D/D2H around the sample and
pdf wrappers, with per-call cudaMalloc and a cudaDeviceReset per reweight —
call-stack trace in SURVEY.md §3.1/§3.5); here the whole T-step filter is one
XLA program: body = resample -> propagate -> reweight exactly mirroring
``mcmc.cpp:292-308``.

Two layouts for the scan carry:
- "packed" (default on the hot path): particles as [d, N], N minor, with
  the gather-free roll-Metropolis resampler (see ops/packed.py and
  resampling/rolls.py). Public inputs/outputs remain [N, d] / [T, N, d].
- "batch": particles as [N, d] with index-gather resampling — the layout
  the sharded allgather path and the registry resamplers use directly.

Improvements over the reference (capabilities, not defects — SURVEY.md §7):
- log-space weights (reference multiplies raw densities, ``mcmc.cpp:212``);
- optional ESS-adaptive resampling (reference always resamples);
- log-evidence and per-step ESS outputs (reference computes neither);
- counter-based reproducible RNG.

``axis_name`` threads the same body through ``shard_map`` for the
particle-sharded multi-chip path (``cusmc_tpu.parallel``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax

from cusmc_tpu.diagnostics.metrics import effective_sample_size, log_normalize
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.resampling import get_resampler
from cusmc_tpu.resampling.rolls import roll_metropolis_resample_op


class FilterResult(struct.PyTreeNode):
    """Outputs of one filter run.

    ``particles`` [T, N, d], ``obs_loglik`` [T, N] (the unnormalized
    per-step observation log-likelihood — the log of the reference's raw
    weight arrays ``w_t``, ``src/run.rcpp.cpp:110-125``), ``ancestors``
    [T, N] — all None when ``return_history=False``. ``ess`` [T],
    ``log_evidence`` scalar, plus the final particle cloud.
    """

    final_particles: jnp.ndarray
    final_log_weights: jnp.ndarray
    ess: jnp.ndarray
    log_evidence: jnp.ndarray
    particles: Optional[jnp.ndarray] = None
    obs_loglik: Optional[jnp.ndarray] = None
    ancestors: Optional[jnp.ndarray] = None


def _step_factory(propagate_fn: Callable, logpdf_fn: Callable,
                  resample_op: Callable, ess_threshold: Optional[float],
                  num_particles_global: int, axis_name: Optional[str],
                  return_history: bool = True, debug_checks: bool = False):
    """Build the scan body (layout-agnostic: ``x`` is whatever
    ``propagate_fn``/``resample_op`` operate on).

    ``resample_op(key, x, logw) -> (x_ancestors, logw_after, ancestor_idx)``
    abstracts local vs collective and indexed vs roll-based resampling.
    ``num_particles_global`` is the total N across shards (== local N when
    axis_name is None). The resample key is COMMON across shards (needed for
    globally-consistent systematic positions); the propagate key is folded
    with the shard index so noise is shard-unique.

    ESS-adaptive + sharded: ops exposing a ``pred`` keyword (the ops in
    ``cusmc_tpu.parallel.resampling``) are called ONCE with the resample
    predicate — they keep collectives unconditional (shard_map-safe) and
    gate the local heavy work internally, so skipping costs ~only the
    ring/window traffic. Ops without ``pred`` fall back to
    compute-both-and-select.
    """
    from cusmc_tpu.models.base import normalize_time_hook
    propagate_fn = normalize_time_hook(propagate_fn, "x")
    logpdf_fn = normalize_time_hook(logpdf_fn, "y")

    import inspect

    op_takes_pred = False
    if resample_op is not None and ess_threshold is not None:
        try:
            op_takes_pred = ("pred"
                             in inspect.signature(resample_op).parameters)
        except (TypeError, ValueError):
            op_takes_pred = False

    def step(carry, inp):
        x, logw, key = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        k_res, k_prop = jax.random.split(key_t)
        if axis_name is not None:
            k_prop = jax.random.fold_in(k_prop, lax.axis_index(axis_name))

        ess = effective_sample_size(logw, axis_name)

        def do_resample(_):
            return resample_op(k_res, x, logw)

        def skip_resample(_):
            # Identity ancestry in GLOBAL indices (sharded resample ops
            # record global slots; the skip branch must match).
            n_local = logw.shape[0]
            slots = jnp.arange(n_local, dtype=jnp.int32)
            if axis_name is not None:
                slots = slots + lax.axis_index(axis_name) * n_local
            return x, logw, slots

        if ess_threshold is None:
            x_anc, logw_pre, a = do_resample(None)
        elif axis_name is None:
            x_anc, logw_pre, a = lax.cond(
                ess < ess_threshold * num_particles_global,
                do_resample, skip_resample, None)
        elif op_takes_pred:
            # Collective-aware op: one call, local work gated internally.
            pred = ess < ess_threshold * num_particles_global
            x_anc, logw_pre, a = resample_op(k_res, x, logw, pred=pred)
        else:
            # Under shard_map, keep collectives unconditional (cond with
            # collective bodies is fragile); compute both and select.
            rx, rw, ra = do_resample(None)
            sx, sw, sa = skip_resample(None)
            pred = ess < ess_threshold * num_particles_global
            x_anc = jnp.where(pred, rx, sx)
            logw_pre = jnp.where(pred, rw, sw)
            a = jnp.where(pred, ra, sa)

        x_new = propagate_fn(k_prop, x_anc, t)
        ll = logpdf_fn(y_t, x_new, t)

        logw_new, lz_inc = log_normalize(logw_pre + ll, axis_name)
        if debug_checks:
            from cusmc_tpu.utils.debug import assert_finite_weights

            assert_finite_weights(logw_new, t)
        carry = (x_new, logw_new, key)
        history = (x_new, ll, a) if return_history else ()
        return carry, (history, ess, lz_inc)

    return step


def _fast_exp_step_factory(propagate_fn: Callable, logpdf_fn: Callable,
                           n_global: int, resample_exp: Callable,
                           ess_threshold: Optional[float],
                           axis_name: Optional[str],
                           return_history: bool = True):
    """Exp-space scan body — the packed fast path, UNIFIED over
    single-shard vs sharded (psum/pmax replace the local sums) and
    always-resample vs ESS-adaptive. The carry holds max-normalized exp
    weights ``w`` instead of log weights: ESS and the evidence increment
    come from fused sums over ``w``; resamplers consume ``w`` (or its
    unnormalized cumsum) directly, so the per-step softmax/exp passes of
    the generic log-space path disappear.

    ``resample_exp(key, x, w[, pred]) -> (x_anc, w_pre, a)`` with
    ``w_pre`` the post-op weights (ones when resampled, ``w`` when the
    pred-aware op skipped). Evidence algebra (adaptive case):
    lz_inc = log(sum(w_pre * exp(ll))) - log(sum(w_pre)), where the
    denominator is exactly n_global after a resample — identical to the
    generic path's ``log_normalize(logw_pre + ll)`` increment.

    Known representation limit: exp-space weights more than ~88 nats
    below the running max flush to zero (f32 + XLA FTZ) and cannot
    recover on later likelihood spikes. Irrelevant whenever resampling
    actually fires (each fire resets the carry to ones, and a particle
    88 nats down contributes < 1e-38 to every estimate), but in a
    never-resample SIS regime over long horizons the log-space generic
    path (``layout="batch"`` or ``debug_checks=True``) is the exact
    one — measured 0.2 nats divergence after 40 SIS steps on a carry
    whose weight spread had reached e5e5."""
    from cusmc_tpu.models.base import normalize_time_hook
    propagate_fn = normalize_time_hook(propagate_fn, "x")
    logpdf_fn = normalize_time_hook(logpdf_fn, "y")

    import inspect

    log_n = math.log(n_global)
    op_takes_pred = False
    if ess_threshold is not None:
        try:
            op_takes_pred = ("pred"
                             in inspect.signature(resample_exp).parameters)
        except (TypeError, ValueError):
            pass

    def psum_(v):
        return lax.psum(v, axis_name) if axis_name is not None else v

    def pmax_(v):
        return lax.pmax(v, axis_name) if axis_name is not None else v

    def step(carry, inp):
        x, w, key = carry
        t, y_t = inp
        key_t = jax.random.fold_in(key, t)
        k_res, k_prop = jax.random.split(key_t)
        if axis_name is not None:
            k_prop = jax.random.fold_in(k_prop, lax.axis_index(axis_name))

        s1 = psum_(jnp.sum(w))
        s2 = psum_(jnp.sum(w * w))
        ess = s1 * s1 / s2

        if ess_threshold is None:
            x_anc, _, a = resample_exp(k_res, x, w)
            x_new = propagate_fn(k_prop, x_anc, t)
            ll = logpdf_fn(y_t, x_new, t)
            m = pmax_(jnp.max(ll))
            w_new = jnp.exp(ll - m)
            lz_inc = m + jnp.log(psum_(jnp.sum(w_new))) - log_n
        else:
            pred = ess < ess_threshold * n_global
            n_local = w.shape[0]

            def skip(_):
                slots = jnp.arange(n_local, dtype=jnp.int32)
                if axis_name is not None:
                    slots = slots + lax.axis_index(axis_name) * n_local
                return x, w, slots

            if op_takes_pred:
                # Collective-aware op: one call, local work gated
                # internally (shard_map-safe).
                x_anc, w_pre, a = resample_exp(k_res, x, w, pred=pred)
            elif axis_name is None:
                x_anc, w_pre, a = lax.cond(
                    pred, lambda _: resample_exp(k_res, x, w), skip, None)
            else:
                rx, rw, ra = resample_exp(k_res, x, w)
                sx, sw, sa = skip(None)
                x_anc = jnp.where(pred, rx, sx)
                w_pre = jnp.where(pred, rw, sw)
                a = jnp.where(pred, ra, sa)
            denom = jnp.where(pred, jnp.asarray(float(n_global), s1.dtype),
                              s1)
            x_new = propagate_fn(k_prop, x_anc, t)
            ll = logpdf_fn(y_t, x_new, t)
            m = pmax_(jnp.max(ll))
            w_new = w_pre * jnp.exp(ll - m)
            lz_inc = m + jnp.log(psum_(jnp.sum(w_new))) - jnp.log(denom)
            # Long skip runs multiply sub-1 factors into the carry;
            # renormalize by the global max so it can't creep toward
            # f32 underflow (everything downstream is scale-invariant).
            w_new = w_new / pmax_(jnp.max(w_new))

        carry = (x_new, w_new, key)
        history = (x_new, ll, a) if return_history else ()
        return carry, (history, ess, lz_inc)

    return step


def packed_exp_resample_op(resampler_name: str, num_particles_global: int,
                           **kwargs) -> Callable:
    """Single-shard exp-space resample op for the fast factory:
    ``(key, X [d, N], w [N]) -> (x_anc, ones, ancestors)``. The CDF
    family consumes the UNNORMALIZED inclusive cumsum (the search is
    scale-invariant; positions scale by the total) so the softmax pass
    disappears; residual reuses the ESS sum via CSE for its N/sum(w)
    scaling."""
    from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply, weight_cdf
    from cusmc_tpu.resampling.classic import POSITION_FNS

    n = num_particles_global
    if resampler_name == "metropolis":
        from cusmc_tpu.resampling.rolls import (
            roll_metropolis_sweeps_expspace,
            roll_metropolis_sweeps_expspace_auto,
        )

        num_steps = kwargs.get("num_steps", 10)
        if num_steps == "auto":
            # ESS-conditioned sweep truncation (opt-in): B, B/2 or B/4
            # sweeps by Kish ESS bucket — see rolls.py for thresholds.
            base = kwargs.get("base_steps", 10)

            def op(key, X, w):
                x_anc, a = roll_metropolis_sweeps_expspace_auto(
                    key, X, w, base)
                return x_anc, jnp.ones_like(w), a

            return op

        def op(key, X, w):
            x_anc, a = roll_metropolis_sweeps_expspace(key, X, w,
                                                       num_steps)
            return x_anc, jnp.ones_like(w), a

        return op
    if resampler_name in POSITION_FNS:
        pos_fn = POSITION_FNS[resampler_name]

        def op(key, X, w):
            cdf = weight_cdf(w)
            positions = pos_fn(key, n, w.dtype) * cdf[-1]
            x_anc, a = inverse_cdf_apply(cdf, positions, X)
            return x_anc, jnp.ones_like(w), a

        return op
    if resampler_name == "residual":

        def op(key, X, w):
            s1 = jnp.sum(w)
            x_anc, a = _residual_resample_packed(key, X, w * (n / s1))
            return x_anc, jnp.ones_like(w), a

        return op
    raise KeyError(f"no exp-space fast op for resampler {resampler_name!r}")


def _residual_resample_packed(key, X, nw):
    """Residual resampling of packed X [d, n] from PRE-SCALED weights
    ``nw`` [n] (= n * w / sum(w)): two inverse-CDF passes
    (deterministic-floor integer grid + residual order statistics) and a
    dynamic roll. Law identical to
    ``resampling.classic.residual_ancestors``. Returns
    ``(x_anc [d, n], ancestors [n])``."""
    from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply, weight_cdf
    from cusmc_tpu.resampling.classic import _residual_positions

    n = nw.shape[0]
    wdt = nw.dtype
    counts = jnp.floor(nw)
    ccum = weight_cdf(counts)
    n_det = jnp.minimum(ccum[-1], n).astype(jnp.int32)
    rcdf = weight_cdf(jnp.maximum(nw - counts, 0.0))
    slots = jnp.arange(n, dtype=wdt)
    # Positions are clamped inside the cdf range; clamped tail slots
    # land on the last active entry and are masked off below.
    p_det = jnp.minimum(slots + 0.5, n_det.astype(wdt) - 0.5)
    x_det, a_det = inverse_cdf_apply(ccum, p_det, X)
    v = jnp.minimum(_residual_positions(key, n, n_det, wdt),
                    1.0 - 1e-6) * rcdf[-1]
    x_res, a_res = inverse_cdf_apply(rcdf, v, X)
    # Align draw k to slot n_det + k: roll right by n_det
    # (double-and-slice: contiguous copies, no gather).

    def droll(arr, s):
        two = jnp.concatenate([arr, arr], axis=-1)
        return lax.dynamic_slice_in_dim(
            two, arr.shape[-1] - s, arr.shape[-1], axis=-1)

    a_res = droll(a_res, n_det)
    x_res = droll(x_res, n_det)
    mask = slots < n_det
    a = jnp.where(mask, a_det, a_res)
    x_anc = jnp.where(mask[None, :], x_det, x_res)
    return x_anc, a


def local_resample_op(resampler: Callable, num_particles_global: int):
    """Batch-layout resample op from a (key, logw) -> idx resampler."""
    log_n = math.log(num_particles_global)

    def op(key, x, logw):
        a = resampler(key, logw)
        return x[a], jnp.full(logw.shape, -log_n, logw.dtype), a

    return op


def packed_resample_op(resampler_name: str, num_particles_global: int,
                       **kwargs):
    """Packed-layout [d, N] resample op for a registry key.

    "metropolis" -> gather-free roll-Metropolis sweeps;
    CDF family (systematic/stratified/multinomial) -> cumsum + sorted
    search + column take (``ops/monotone_gather.inverse_cdf_apply``);
    "residual" -> ``_residual_resample_packed`` (two inverse-CDF passes
    over the floor/remainder decomposition);
    others (custom) -> registry ancestor fn + ``take_columns``.
    """
    from cusmc_tpu.ops.monotone_gather import (
        inverse_cdf_apply,
        take_columns,
        weight_cdf,
    )
    from cusmc_tpu.resampling.classic import POSITION_FNS

    log_n = math.log(num_particles_global)

    if resampler_name == "metropolis":
        return roll_metropolis_resample_op(
            num_particles=num_particles_global, **kwargs)

    if resampler_name in POSITION_FNS:
        pos_fn = POSITION_FNS[resampler_name]

        def op(key, X, logw):
            n = logw.shape[0]
            wdt = jnp.promote_types(logw.dtype, jnp.float32)
            cdf = weight_cdf(jax.nn.softmax(logw.astype(wdt)))
            positions = pos_fn(key, n, wdt)
            x_anc, a = inverse_cdf_apply(cdf, positions, X)
            return x_anc, jnp.full(logw.shape, -log_n, logw.dtype), a

        return op

    if resampler_name == "residual":

        def op(key, X, logw):
            n = logw.shape[0]
            wdt = jnp.promote_types(logw.dtype, jnp.float32)
            nw = n * jax.nn.softmax(logw.astype(wdt))
            x_anc, a = _residual_resample_packed(key, X, nw)
            return x_anc, jnp.full(logw.shape, -log_n, logw.dtype), a

        return op

    ancestor_fn = get_resampler(resampler_name, **kwargs)

    def op(key, X, logw):
        a = ancestor_fn(key, logw)
        return (take_columns(X, a),
                jnp.full(logw.shape, -log_n, logw.dtype), a)

    return op


def bootstrap_filter(
    key: jax.Array,
    model: DLM,
    ys: jnp.ndarray,
    num_particles: int,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    return_history: bool = True,
    layout: str = "auto",
    axis_name: Optional[str] = None,
    num_particles_global: Optional[int] = None,
    resample_op: Optional[Callable] = None,
    resample_op_weights: str = "log",
    debug_checks: bool = False,
) -> FilterResult:
    """Run the bootstrap filter on observations ``ys`` [T, k].

    Row 0 of ``ys`` is ignored (t=0 is the prior draw — the bundled dataset's
    first observation row is zeros, ``data_raw/y_t.csv``; the reference loop
    starts at t=1, ``src/mcmc.cpp:292``).

    ``resampler`` is a registry key ("metropolis" | "systematic" |
    "stratified" | "multinomial"); ``resample_op`` overrides the whole
    resampling operation with a custom ``(key, x, logw) -> (x_anc, logw, a)``
    matching the chosen layout (used by the sharded path to inject a
    collective-aware resampler); with ``resample_op_weights="exp"`` the
    injected op instead consumes/returns max-normalized exp weights and
    the scan carries them (the sharded fast path — packed layout only).
    ``ess_threshold=None`` -> resample every step (reference behavior);
    a float in (0, 1] -> adaptive on Kish ESS.

    ``layout``: "auto" (packed unless a custom batch-layout resample_op is
    injected), "packed", or "batch". Results are layout-independent in
    distribution; RNG streams differ, so exact values are layout-specific.

    Under ``shard_map`` pass ``axis_name`` (the particle mesh axis) and the
    global N via ``num_particles_global``; ``num_particles`` is then local.
    """
    from cusmc_tpu.models.base import supports_packed

    resampler_kwargs = resampler_kwargs or {}
    n_global = num_particles_global or num_particles
    if layout == "auto":
        if resample_op is not None or not supports_packed(model):
            layout = "batch"
        else:
            layout = "packed"
    if layout not in ("packed", "batch"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "packed" and not supports_packed(model):
        raise ValueError("model has no packed-layout methods; use "
                         "layout='batch'")
    packed = layout == "packed"

    # Exp-space fast paths (packed): carry max-normalized exp weights
    # through the scan (see _fast_exp_step_factory). Round 4 lifted the
    # round-3 single-shard/always-resample restrictions: ESS-adaptive
    # configs gate the resample via cond/pred on the carried sums, and
    # sharded configs inject collective exp ops (parallel/resampling.py
    # weights="exp") via resample_op_weights="exp".
    from cusmc_tpu.resampling.classic import POSITION_FNS

    exp_op = None
    if resample_op is not None and resample_op_weights == "exp":
        if not packed or debug_checks:
            raise ValueError(
                "resample_op_weights='exp' needs packed layout and "
                "debug_checks=False")
        exp_op = resample_op
    elif (packed and not debug_checks and resample_op is None
          and axis_name is None
          and (resampler in ("metropolis", "residual")
               or resampler in POSITION_FNS)):
        exp_op = packed_exp_resample_op(resampler, n_global,
                                        **resampler_kwargs)
    fast_exp = exp_op is not None

    if not fast_exp and resample_op is None:
        if packed:
            resample_op = packed_resample_op(resampler, n_global,
                                             **resampler_kwargs)
        else:
            res_fn = get_resampler(resampler, **resampler_kwargs)
            resample_op = local_resample_op(res_fn, n_global)

    k_init, k_scan = jax.random.split(key)
    if axis_name is not None:
        k_init = jax.random.fold_in(k_init, lax.axis_index(axis_name))
    if packed:
        x0 = model.sample_initial_packed(k_init, num_particles)
        propagate_fn = model.propagate_packed
        logpdf_fn = model.observation_logpdf_packed
    else:
        x0 = model.sample_initial(k_init, (num_particles,))
        propagate_fn = model.propagate
        logpdf_fn = model.observation_logpdf
    # Weights always live in at least float32 — under the mixed-precision
    # state_dtype=bfloat16 mode the state is bf16 but the weight path is not.
    logw0 = jnp.full((num_particles,), -math.log(n_global),
                     jnp.promote_types(x0.dtype, jnp.float32))

    num_steps = ys.shape[0]
    ts = jnp.arange(1, num_steps)
    if fast_exp:
        step = _fast_exp_step_factory(
            propagate_fn, logpdf_fn, n_global, exp_op, ess_threshold,
            axis_name, return_history)
    else:
        step = _step_factory(propagate_fn, logpdf_fn, resample_op,
                             ess_threshold, n_global, axis_name,
                             return_history, debug_checks)
    if fast_exp:
        w0 = jnp.exp(logw0 - jnp.max(logw0))  # uniform -> ones
        (x_f, w_f, _), (history, esss, lzs) = lax.scan(
            step, (x0, w0, k_scan), (ts, ys[1:]))
        sw_f = jnp.sum(w_f)
        if axis_name is not None:
            sw_f = lax.psum(sw_f, axis_name)
        logw_f = jnp.log(w_f) - jnp.log(sw_f)
    else:
        (x_f, logw_f, _), (history, esss, lzs) = lax.scan(
            step, (x0, logw0, k_scan), (ts, ys[1:]))

    ess0 = effective_sample_size(logw0, axis_name)
    ess = jnp.concatenate([ess0[None], esss])
    log_evidence = jnp.sum(lzs)

    if packed:
        x_f = x_f.T
    if not return_history:
        return FilterResult(
            final_particles=x_f, final_log_weights=logw_f,
            ess=ess, log_evidence=log_evidence)

    xs, lls, ancs = history
    x0_out = x0.T if packed else x0
    if packed:
        xs = jnp.swapaxes(xs, 1, 2)  # [T-1, d, N] -> [T-1, N, d]
    particles = jnp.concatenate([x0_out[None], xs], axis=0)
    # t=0 raw weight is the uniform 1/N fill (reference mcmc.cpp:85).
    obs_loglik = jnp.concatenate([logw0[None], lls], axis=0)
    a0 = jnp.arange(num_particles, dtype=jnp.int32)
    if axis_name is not None:  # global slots, matching sharded resample ops
        a0 = a0 + lax.axis_index(axis_name) * num_particles
    ancestors = jnp.concatenate([a0[None], ancs], axis=0)
    return FilterResult(
        final_particles=x_f, final_log_weights=logw_f,
        ess=ess, log_evidence=log_evidence,
        particles=particles, obs_loglik=obs_loglik, ancestors=ancestors)
