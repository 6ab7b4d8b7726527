#!/usr/bin/env python
"""Multi-chain MCMC benchmark — BASELINE config 5 shape: 1024 chains on a
d=128 MVT target with pooled acceptance-rate adaptation.

Prints one JSON line per sampler: chain-steps/sec/chip. Defaults:
precomputed-inverse log-density closure (``make_mvt_logprob``) + rbg keys
+ bf16 proposal noise for the two symmetric-proposal samplers (exact —
see mcmc/metropolis.py). All samplers run in this one process, so one
process holds the card.

Env knobs: MH_SAMPLER=mh|adaptive|mala|hmc|chees|pt|stretch|all,
MH_CHAINS/MH_D/MH_STEPS,
MH_IMPL=rbg|threefry2x32, MH_NOISE=bf16|f32, MH_CHOL_EVERY (adaptive).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from cusmc_tpu.distributions import make_mvt_logprob
from cusmc_tpu.mcmc import (
    adaptive_mh_sampler,
    stretch_move_sampler,
    chees_hmc_sampler,
    parallel_tempering_sampler,
    hmc_sampler,
    mala_sampler,
    metropolis_hastings_sampler,
)


def main():
    chains = int(os.environ.get("MH_CHAINS", 1024))
    d = int(os.environ.get("MH_D", 128))
    steps = int(os.environ.get("MH_STEPS", 2000))
    impl = os.environ.get("MH_IMPL", "rbg")
    noise = (jnp.bfloat16 if os.environ.get("MH_NOISE", "bf16") == "bf16"
             else None)
    chol_every = int(os.environ.get("MH_CHOL_EVERY", 50))
    which = os.environ.get("MH_SAMPLER", "mh")
    df = 8.0

    cov = jnp.eye(d, dtype=jnp.float32)
    log_prob = make_mvt_logprob(jnp.zeros(d, jnp.float32), cov, df)
    key = jax.random.key(0, impl=impl)
    init = jax.random.normal(jax.random.key(1), (chains, d), jnp.float32)

    def build(name):
        if name == "mh":
            return lambda k: metropolis_hastings_sampler(
                k, log_prob, init, steps, step_size=2.38 / np.sqrt(d),
                adapt_rate=0.05, keep_samples=False, noise_dtype=noise), 1
        if name == "adaptive":
            return lambda k: adaptive_mh_sampler(
                k, log_prob, init, steps, adapt_rate=0.05,
                keep_samples=False, chol_every=chol_every,
                noise_dtype=noise), 1
        if name == "mala":
            return lambda k: mala_sampler(
                k, log_prob, init, steps, step_size=0.3,
                adapt_rate=0.05, keep_samples=False), 1
        if name == "pt":
            # R=8 rungs x C/8 chains: same total replica count as the
            # other samplers, so chain-steps/s is comparable.
            pt_init = jax.random.normal(jax.random.key(1),
                                        (chains // 8, d), jnp.float32)
            return lambda k: parallel_tempering_sampler(
                k, log_prob, pt_init, steps, num_rungs=8, beta_min=0.05,
                step_size=2.38 / np.sqrt(d), keep_samples=False,
                noise_dtype=noise), 1
        if name == "stretch":
            return lambda k: stretch_move_sampler(
                k, log_prob, init, steps, keep_samples=False), 1
        if name == "chees":
            return lambda k: chees_hmc_sampler(
                k, log_prob, init, max(steps // 10, 1), step_size=0.2,
                init_traj=2.0, keep_samples=False), 10
        if name == "hmc":
            return lambda k: hmc_sampler(
                k, log_prob, init, max(steps // 10, 1), num_leapfrog=10,
                step_size=0.2, adapt_rate=0.05, keep_samples=False), 10
        raise SystemExit(f"unknown MH_SAMPLER {name!r}")

    names = ["mh", "adaptive", "mala", "hmc", "chees", "pt", "stretch"] if which == "all" else [which]
    for name in names:
        make, stride = build(name)
        n_steps = max(steps // stride, 1)
        fn = jax.jit(make)
        out = fn(key)
        _ = np.asarray(out.accept_rate)
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            out = fn(jax.random.fold_in(key, i))
            _ = np.asarray(out.accept_rate)
            best = min(best, time.perf_counter() - t0)
        rate = chains * n_steps / best
        print(json.dumps({
            "metric": f"chain-steps/sec/chip, {name} on d={d} MVT, "
                      f"{chains} chains, pooled adaptation",
            "value": rate,
            "unit": "chain-steps/s",
            "accept_rate": float(np.asarray(out.accept_rate).mean()),
            "step_size": (float(np.asarray(out.step_size).reshape(-1)[0])
                          if hasattr(out, "step_size") else None),
            "impl": impl,
            "noise": "bf16" if noise is not None else "f32",
        }), flush=True)


if __name__ == "__main__":
    main()
