#!/usr/bin/env python
"""Headline benchmark: particle-steps / sec / chip on the MVT bootstrap
particle filter (BASELINE.json `metric`).

Runs only on a GPU: any other default JAX platform is refused. Prints the
device (platform, device kind, device count) and the card's name and power
limit on earlier lines, then ONE JSON result line.

Env knobs: BENCH_N, BENCH_T, BENCH_D, BENCH_NOISE (mvt|mvn),
BENCH_STATE_DTYPE (e.g. bfloat16: mixed precision, weight path f32),
BENCH_IMPL (PRNG: rbg | threefry), BENCH_RESAMPLER, BENCH_SHARDED=1
(the same filter through shard_map over all visible devices).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from cusmc_tpu.io.data import demo_model_params
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.smc.particle_filter import bootstrap_filter
from cusmc_tpu.utils.compile_cache import enable_compile_cache
from cusmc_tpu.utils.device import card_info, require_gpu


def main():
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    devices = jax.devices()
    require_gpu(devices)
    cards = card_info()
    print(f"device: platform={devices[0].platform} "
          f"kind={devices[0].device_kind} count={len(devices)}", flush=True)
    for line in cards:
        print(f"card: {line}", flush=True)

    num_particles = int(os.environ.get("BENCH_N", 1_048_576))
    num_steps = int(os.environ.get("BENCH_T", 200))
    d = int(os.environ.get("BENCH_D", 2))

    params = demo_model_params(d=d)
    noise = os.environ.get("BENCH_NOISE", "mvt")
    sdt = os.environ.get("BENCH_STATE_DTYPE")
    model = DLM.create(noise=noise, df=5.0 if noise == "mvt" else None,
                       dtype=jnp.float32,
                       state_dtype=None if not sdt else jnp.dtype(sdt),
                       **params)
    # Synthetic observations suffice for throughput (same compute path).
    impl = os.environ.get("BENCH_IMPL", "rbg")
    key = jax.random.key(0, impl=impl)
    _, ys = model.simulate(key, num_steps)
    ys = jnp.asarray(ys, jnp.float32)

    resampler = os.environ.get("BENCH_RESAMPLER", "metropolis")
    sharded = os.environ.get("BENCH_SHARDED") == "1"
    if sharded:
        # The SAME filter through shard_map + the collective resample ops
        # on a mesh over all visible devices.
        from cusmc_tpu.parallel import make_mesh, sharded_bootstrap_filter

        mesh = make_mesh({"particles": len(devices)})
        fn = jax.jit(lambda k: sharded_bootstrap_filter(
            k, model, ys, num_particles, mesh, resampler=resampler,
            return_history=False))
    else:
        fn = jax.jit(lambda k: bootstrap_filter(
            k, model, ys, num_particles, resampler=resampler,
            return_history=False))

    # Warmup/compile.
    out = fn(key)
    jax.block_until_ready(out)

    reps = 3
    best = float("inf")
    for i in range(reps):
        k = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        out = fn(k)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)

    rate = num_particles * (num_steps - 1) / best
    # ESS/sec (BASELINE.md metric 2): total Kish ESS accumulated over the
    # run divided by wall time (the reference computes no ESS anywhere,
    # src/mcmc.cpp:239-309).
    ess_per_sec = float(np.sum(np.asarray(out.ess))) / best

    tag = f"sharded[{len(devices)}] " if sharded else ""
    print(json.dumps({
        "metric": f"particle-steps/sec/chip, MVT bootstrap PF "
                  f"(N={num_particles}, T={num_steps}, d={d}, "
                  f"{tag}{resampler})",
        "value": rate,
        "unit": "particle-steps/s",
        "ess_per_sec": ess_per_sec,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": cards[0],
    }))


if __name__ == "__main__":
    main()
