"""Chunked streaming particle filter: device scans K steps at a time,
history streams to a host-side arena between chunks.

The reference holds the entire T x N x d history in RAM
(``/root/reference/src/run.rcpp.cpp:80-97``) — at scale (N=1M, T=1000)
that is 8 GB/dim of device memory. Here the scan carry stays on
device across chunks (no re-initialization), only the [K, N, d] history
block crosses to the host per chunk, into ``TrajectoryStore``'s
preallocated arena (native memcpy, no per-step Python).

This is also the checkpoint/resume boundary: the carry returned per chunk
is exactly what ``cusmc_tpu.checkpoint`` snapshots (SURVEY.md §5).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cusmc_tpu.diagnostics.metrics import effective_sample_size
from cusmc_tpu.io.native_store import TrajectoryStore


def _host_fetch(x) -> np.ndarray:
    """Device array -> host numpy, multi-process-safe: under a single-process mesh this is a plain transfer; under
    a multi-process mesh global arrays are not host-addressable, so the
    addressable shards are gathered across processes first. Keep this on
    the COLD path only (checkpoints, history drains, final result) — the
    per-chunk halt guard reads one on-device-reduced scalar instead."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    try:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    except Exception as e:  # pragma: no cover - multi-process only
        raise RuntimeError(
            "streaming filter needs to fetch a non-addressable global "
            "array (checkpoint/history/final result) but "
            "multihost_utils.process_allgather failed; run with "
            "store_particles=False and checkpoint=None, or gather "
            "manually") from e


@functools.lru_cache(maxsize=2)
def _make_halt_pred(exp_carry: bool):
    """One-scalar on-device degeneracy predicate: NaN anywhere, all
    weights collapsed (exp: all zero; log: all -inf), or non-finite
    evidence increments. Only the single bool crosses to the host per
    chunk. Cached per carry mode so repeated filter calls reuse the
    compiled predicate."""

    @jax.jit
    def pred(wv, lzs):
        if exp_carry:
            w_bad = jnp.isnan(wv).any() | ~jnp.any(wv != 0)
        else:
            w_bad = jnp.isnan(wv).any() | jnp.all(jnp.isneginf(wv))
        return w_bad | ~jnp.all(jnp.isfinite(lzs))

    return pred
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.resampling import get_resampler
from cusmc_tpu.smc.particle_filter import (
    FilterResult,
    _fast_exp_step_factory,
    _step_factory,
    local_resample_op,
    packed_resample_op,
)


def _sharded_chunk_runner(model, num_particles, mesh, axis, resampler,
                          resampler_kwargs, ess_threshold):
    """Build the shard_map'd chunk scan + sharded initializer for the
    particle-sharded streaming filter: the same exp-space collective
    machinery as ``parallel.filter.sharded_bootstrap_filter``, exposed
    at chunk granularity so the carry persists on-device between host
    history drains."""
    from jax.sharding import PartitionSpec as P

    from cusmc_tpu.parallel.resampling import (
        ring_cdf_resample_op,
        roll_metropolis_sharded_op,
    )

    n_shards = mesh.shape[axis]
    if num_particles % n_shards != 0:
        raise ValueError(f"num_particles={num_particles} not divisible "
                         f"by mesh axis {axis!r} size {n_shards}")
    n_local = num_particles // n_shards
    if resampler == "metropolis":
        op = roll_metropolis_sharded_op(axis, num_particles, n_local,
                                        weights="exp", **resampler_kwargs)
    else:
        op = ring_cdf_resample_op(resampler, axis, num_particles, n_local,
                                  weights="exp", **resampler_kwargs)
    step = _fast_exp_step_factory(
        model.propagate_packed, model.observation_logpdf_packed,
        num_particles, op, ess_threshold, axis, return_history=True)

    def chunk_local(x, w, key, ts, ys_chunk):
        (x2, w2, _), ((xs, lls, ancs), esss, lzs) = lax.scan(
            step, (x, w, key), (ts, ys_chunk))
        return x2, w2, xs, lls, ancs, esss, lzs

    sh_x = P(None, axis)
    run = jax.jit(jax.shard_map(
        chunk_local, mesh=mesh,
        in_specs=(sh_x, P(axis), P(), P(), P()),
        out_specs=(sh_x, P(axis), P(None, None, axis), P(None, axis),
                   P(None, axis), P(), P()),
        check_vma=False))

    def run_chunk(carry, ts, ys_chunk):
        x, w, key = carry
        x2, w2, xs, lls, ancs, esss, lzs = run(x, w, key, ts, ys_chunk)
        return (x2, w2, key), ((xs, lls, ancs), esss, lzs)

    def init_local(key):
        k = jax.random.fold_in(key, lax.axis_index(axis))
        x0 = model.sample_initial_packed(k, n_local)
        w0 = jnp.ones((n_local,),
                      jnp.promote_types(x0.dtype, jnp.float32))
        return x0, w0

    init = jax.jit(jax.shard_map(init_local, mesh=mesh, in_specs=(P(),),
                             out_specs=(sh_x, P(axis)), check_vma=False))
    wdtype = jnp.promote_types(model.G.dtype, jnp.float32)
    return run_chunk, init, wdtype


def streaming_bootstrap_filter(
    key: jax.Array,
    model: DLM,
    ys: np.ndarray,
    num_particles: int,
    chunk_steps: int = 64,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    store_particles: bool = True,
    force_numpy_store: bool = False,
    spill_path: Optional[str] = None,
    checkpoint=None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    layout: str = "packed",
    halt_on_nonfinite: bool = True,
    mesh=None,
    axis: str = "particles",
):
    """Run the filter over ``ys`` [T, k] in chunks of ``chunk_steps``.

    Returns ``(FilterResult, particle_store)`` where the FilterResult's
    in-HBM history fields are None and ``particle_store`` is a
    ``TrajectoryStore`` holding the streamed [T, N, d] particle history
    (None when ``store_particles=False``).

    ``checkpoint`` (a ``cusmc_tpu.checkpoint.FilterCheckpoint``) snapshots
    the carry every ``checkpoint_every`` steps (default: every chunk);
    ``resume=True`` restores the latest snapshot and continues from its
    step. Particle history before the resume point is NOT replayed: the
    store's row i then corresponds to timestep ``store.start_step + i``
    (0 for fresh runs), and the returned ``ess`` likewise starts at the
    resume point.

    ``halt_on_nonfinite`` is the snapshot-and-halt failure guard
    (SURVEY.md §5 "failure detection / elastic recovery"): each chunk
    boundary verifies the carry weights and evidence increments are
    finite; on degeneration the LAST-GOOD carry is auto-saved to
    ``checkpoint`` (when wired) and ``FilterDivergedError`` is raised
    with the last good step + snapshot path. A later call with
    ``resume=True`` (after fixing the observations) continues from the
    clean prefix with results identical to an uninterrupted run.

    ``mesh`` shards the particle axis over mesh axis ``axis`` (round 4,
    closing "streaming and sharding don't compose"): each chunk runs
    the shard_map'd exp-space scan with the collective resample ops of
    ``parallel.resampling`` (the carry stays device-resident and
    sharded across chunks); history blocks arrive host-side already
    gathered, and checkpoints/halt snapshots hold the global [N, d]
    carry, so a sharded streaming run can resume on any mesh shape.
    Requires the packed layout and a model with packed methods.
    """
    from cusmc_tpu.models.base import supports_packed

    resampler_kwargs = resampler_kwargs or {}
    if layout == "packed" and not supports_packed(model):
        layout = "batch"
    dtype = model.G.dtype
    d = model.state_dim
    num_steps = ys.shape[0]
    packed = layout == "packed"

    wdtype = jnp.promote_types(dtype, jnp.float32)
    exp_carry = False
    if mesh is not None:
        if not packed:
            raise ValueError("sharded streaming requires the packed "
                             "layout (a model with packed methods)")
        run_chunk, init_sharded, wdtype = _sharded_chunk_runner(
            model, num_particles, mesh, axis, resampler,
            resampler_kwargs, ess_threshold)
        exp_carry = True
    else:
        from cusmc_tpu.resampling.classic import POSITION_FNS
        from cusmc_tpu.smc.particle_filter import packed_exp_resample_op

        fast = packed and (resampler in ("metropolis", "residual")
                           or resampler in POSITION_FNS)
        if fast:
            # Same exp-space fast factory as the one-shot filter: the
            # chunked scan stays bitwise-identical to bootstrap_filter
            # (keys fold by absolute t).
            exp_op = packed_exp_resample_op(resampler, num_particles,
                                            **resampler_kwargs)
            step = _fast_exp_step_factory(
                model.propagate_packed, model.observation_logpdf_packed,
                num_particles, exp_op, ess_threshold, None,
                return_history=True)
            exp_carry = True
        else:
            if packed:
                resample_op = packed_resample_op(resampler, num_particles,
                                                 **resampler_kwargs)
                propagate_fn = model.propagate_packed
                logpdf_fn = model.observation_logpdf_packed
            else:
                res_fn = get_resampler(resampler, **resampler_kwargs)
                resample_op = local_resample_op(res_fn, num_particles)
                propagate_fn = model.propagate
                logpdf_fn = model.observation_logpdf
            step = _step_factory(propagate_fn, logpdf_fn, resample_op,
                                 ess_threshold, num_particles,
                                 axis_name=None, return_history=True)

        @jax.jit
        def run_chunk(carry, ts, ys_chunk):
            return lax.scan(step, carry, (ts, ys_chunk))

    k_init, k_scan = jax.random.split(key)
    if mesh is not None:
        x0, w0 = init_sharded(k_init)
        carry = (x0, w0, k_scan)
    elif packed:
        x0 = model.sample_initial_packed(k_init, num_particles)
        if exp_carry:
            carry = (x0, jnp.ones((num_particles,), wdtype), k_scan)
        else:
            carry = (x0, jnp.full((num_particles,),
                                  -math.log(num_particles), dtype), k_scan)
    else:
        x0 = model.sample_initial(k_init, (num_particles,))
        logw0 = jnp.full((num_particles,), -math.log(num_particles), dtype)
        carry = (x0, logw0, k_scan)
    log_evidence = 0.0
    t = 1

    if resume:
        if checkpoint is None:
            raise ValueError("resume=True requires a checkpoint")
        snap = checkpoint.restore()
        # Checkpoints store particles in public [N, d] layout and log
        # weights (mesh-shape-independent: a sharded run can resume on
        # any mesh, or unsharded).
        x_r = snap["particles"].astype(dtype)
        logw_r = snap["log_weights"]
        if exp_carry:
            w_r = jnp.exp(jnp.asarray(logw_r, wdtype)
                          - jnp.max(jnp.asarray(logw_r, wdtype)))
            carry = (x_r.T, w_r, snap["key"])
        else:
            carry = (x_r.T if packed else x_r,
                     logw_r.astype(dtype), snap["key"])
        log_evidence = snap["log_evidence"]
        t = snap["t"] + 1

    def to_rows(x):  # carry layout -> public [N, d]
        x_np = _host_fetch(x).astype(np.float32, copy=False)
        return x_np.T if packed else x_np

    def carry_logw(wv):
        """Carry weights -> normalized log weights (checkpoint/public
        form); the sharded carry is exp-space."""
        if not exp_carry:
            return wv
        w_np = _host_fetch(wv).astype(np.float64)
        with np.errstate(divide="ignore"):
            return jnp.asarray(np.log(w_np) - np.log(w_np.sum()),
                               wdtype)

    def carry_ess(wv):
        if not exp_carry:
            return np.asarray(effective_sample_size(wv))
        w_np = _host_fetch(wv).astype(np.float64)
        return np.asarray(w_np.sum() ** 2 / (w_np * w_np).sum(),
                          np.float32)

    store = None
    if store_particles:
        if spill_path is not None:
            # Out-of-core: history appends to disk via the native async
            # writer (io/disk_store.py) — use when T*N*d exceeds host RAM.
            from cusmc_tpu.io.disk_store import DiskTrajectoryStore

            store = DiskTrajectoryStore(spill_path, (num_particles, d),
                                        np.float32)
        else:
            store = TrajectoryStore((num_particles, d), num_steps,
                                    np.float32,
                                    force_numpy=force_numpy_store)
        # Row i of the store corresponds to timestep start_step + i (on a
        # resumed run history before the snapshot is not replayed).
        store.start_step = t - 1
        store.append(to_rows(carry[0])[None])

    ess_all = [carry_ess(carry[1])[None]]
    halt_pred = _make_halt_pred(exp_carry) if halt_on_nonfinite else None
    ys = np.asarray(ys)
    next_ckpt = None
    if checkpoint is not None:
        checkpoint_every = checkpoint_every or chunk_steps
        next_ckpt = t - 1 + checkpoint_every

    while t < num_steps:
        k = min(chunk_steps, num_steps - t)
        ts = jnp.arange(t, t + k)
        ys_chunk = jnp.asarray(ys[t:t + k], dtype)
        prev_carry, prev_le, prev_t = carry, log_evidence, t
        carry, ((xs, _lls, _ancs), esss, lzs) = run_chunk(carry, ts, ys_chunk)
        if halt_on_nonfinite:
            # One on-device-reduced scalar crosses to host per chunk —
            # never the [N] weight vector (also the only form that works under a multi-process mesh,
            # where the global carry is not host-addressable).
            if bool(halt_pred(carry[1], lzs)):
                from cusmc_tpu.utils.debug import FilterDivergedError

                snap = None
                if checkpoint is not None:
                    x_g, w_g, key_g = prev_carry
                    snap = checkpoint.save(prev_t - 1, to_rows(x_g),
                                           carry_logw(w_g), key_g, prev_le)
                raise FilterDivergedError(
                    f"non-finite filter state in steps "
                    f"[{prev_t}, {prev_t + k}); last good step "
                    f"{prev_t - 1}"
                    + (f", snapshot saved to {snap}" if snap else ""),
                    last_good_step=prev_t - 1, snapshot=snap)
        if store is not None:
            xs_np = _host_fetch(xs).astype(np.float32, copy=False)
            store.append(np.swapaxes(xs_np, 1, 2) if packed else xs_np)
        ess_all.append(np.asarray(esss))
        log_evidence += float(jnp.sum(lzs))
        t += k
        if next_ckpt is not None and t - 1 >= next_ckpt:
            x_c, w_c, key_c = carry
            checkpoint.save(t - 1, to_rows(x_c), carry_logw(w_c), key_c,
                            log_evidence)
            next_ckpt = t - 1 + checkpoint_every

    x_f, w_f, _ = carry
    if packed:
        x_f = x_f.T
    result = FilterResult(
        final_particles=x_f,
        final_log_weights=carry_logw(w_f),
        ess=jnp.asarray(np.concatenate(ess_all)),
        log_evidence=jnp.asarray(log_evidence),
    )
    return result, store
