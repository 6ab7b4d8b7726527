#!/usr/bin/env python
"""Inverse-CDF search variants on the GPU, alone and inside the systematic
filter.

Times, at N = 1,048,576 (sorted systematic positions over a weight cdf
with underflowed weights):
- ``jnp.searchsorted(..., side="right", method=m)`` for m in scan,
  scan_unrolled, sort;
- the rank-by-merge search (two argsorts over the 2N merged array);
- the cdf itself: ``jnp.cumsum`` and ``weight_cdf`` (cumsum + cummax);
- the systematic bootstrap filter end to end (MVT DLM, d=2, T=200) with
  each search, in turns.

All in this one process. Prints the card, then one JSON line per result.

    python benchmarks/bench_search.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

from cusmc_tpu.io.data import demo_model_params
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.ops.monotone_gather import take_columns, weight_cdf
from cusmc_tpu.resampling.classic import systematic_positions
from cusmc_tpu.smc.particle_filter import bootstrap_filter
from cusmc_tpu.utils.compile_cache import enable_compile_cache
from cusmc_tpu.utils.device import card_info, require_gpu

N = 1 << 20
T = 200
METHODS = ("scan", "scan_unrolled", "sort", "merge")


def merge_rank_search(cdf, positions):
    """#{j: cdf[j] <= p_i} by a stable merge: two argsorts over [2N]."""
    n = cdf.shape[0]
    merged = jnp.concatenate([cdf, positions.astype(cdf.dtype)])
    rank = jnp.argsort(jnp.argsort(merged))
    a = rank[n:] - jnp.arange(positions.shape[0])
    return jnp.clip(a, 0, n - 1).astype(jnp.int32)


def search_fn(method):
    if method == "merge":
        return merge_rank_search
    return lambda cdf, pos: jnp.minimum(
        jnp.searchsorted(cdf, pos, side="right", method=method),
        cdf.shape[0] - 1).astype(jnp.int32)


def systematic_op(search):
    """The filter's exp-space systematic resample op with ``search`` in
    place of the library's, for ``bootstrap_filter(resample_op=...)``."""
    def op(key, X, w):
        cdf = weight_cdf(w)
        a = search(cdf, systematic_positions(key, w.shape[0], w.dtype)
                   * cdf[-1])
        return take_columns(X, a), jnp.ones_like(w), a

    return op


def best_time(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    enable_compile_cache(ROOT)
    devices = jax.devices()
    require_gpu(devices)
    card = card_info()[0]
    print(f"card: {card}", flush=True)
    results = []

    def emit(**rec):
        rec["card"] = card
        results.append(rec)
        print(json.dumps(rec), flush=True)

    kw, kp = jax.random.split(jax.random.key(0))
    ll = -0.5 * (3.0 * jax.random.normal(kw, (N,), jnp.float32)) ** 2
    w = jnp.exp(ll - jnp.max(ll))
    cdf = jax.jit(weight_cdf)(w)
    pos = systematic_positions(kp, N, jnp.float32) * cdf[-1]

    emit(op="jnp.cumsum", n=N, seconds=best_time(jax.jit(jnp.cumsum), w))
    emit(op="weight_cdf", n=N, seconds=best_time(jax.jit(weight_cdf), w))
    ref = jax.jit(search_fn("scan"))(cdf, pos)
    for m in METHODS:
        f = jax.jit(search_fn(m))
        same = bool(jnp.all(f(cdf, pos) == ref))
        emit(op="search", method=m, n=N, seconds=best_time(f, cdf, pos),
             agrees_with_scan=same)

    model = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32,
                       **demo_model_params(d=2))
    ys = jnp.asarray(model.simulate(jax.random.key(1), T)[1], jnp.float32)
    filters = {}
    for m in METHODS:
        op = systematic_op(search_fn(m))
        fn = jax.jit(lambda k, op=op: bootstrap_filter(
            k, model, ys, N, layout="packed", resample_op=op,
            resample_op_weights="exp", return_history=False))
        jax.block_until_ready(fn(jax.random.key(2)))
        filters[m] = fn
    best = {m: float("inf") for m in METHODS}
    for rep in range(3):     # in turns, so drift hits every variant
        for m in (METHODS if rep % 2 == 0 else METHODS[::-1]):
            t0 = time.perf_counter()
            jax.block_until_ready(filters[m](jax.random.key(3 + rep)))
            best[m] = min(best[m], time.perf_counter() - t0)
    for m in METHODS:
        emit(op="systematic_filter", method=m, n=N, t=T, seconds=best[m],
             particle_steps_per_sec=N * (T - 1) / best[m])

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bench_search.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
