#!/usr/bin/env python
"""On-chip throughput of the auxiliary SMC subsystems (RBPF, EnKF, APF,
Liu-West, FFBS). Prints one JSON line per subsystem: particle-steps/s (or
trajectory draws/s for FFBS). BENCH_SUB=name runs one subsystem; default
runs all, in this one process.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

N = int(os.environ.get("SUB_N", 65536))
T = int(os.environ.get("SUB_T", 200))


def _dlm(d=2):
    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM
    p = demo_model_params(d=d)
    return DLM.create(noise="mvn", dtype=jnp.float32, **p)


def _time(fn, units):
    out = fn()
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return units / best


def bench_rbpf():
    from cusmc_tpu.models.clgssm import CLGSSM
    from cusmc_tpu.smc.rbpf import rao_blackwell_filter
    from cusmc_tpu.io.data import demo_model_params
    d, k = 2, 2
    pr = {kk: jnp.asarray(v, jnp.float32)
          for kk, v in demo_model_params(d=d).items()}
    model = CLGSSM.create(
        nl_dim=1, lin_dim=d, obs_dim=k,
        sample_initial_nl=lambda pp, key, n:
            0.1 * jax.random.normal(key, (n, 1), jnp.float32),
        propagate_nl=lambda pp, key, u:
            u + 0.15 * jax.random.normal(key, u.shape, u.dtype),
        Fmat=lambda pp, u: pr["F"], Gmat=lambda pp, u: pr["G"],
        Vcov=lambda pp, u: pr["V"], Wcov=lambda pp, u: pr["W"],
        c=lambda pp, u: jnp.stack([jnp.sin(u[0]), jnp.cos(u[0])]),
        m0=pr["m0"], C0=pr["C0"], mats_constant=True)
    _, ys = _dlm(d).simulate(jax.random.key(3), T)
    n = min(N, 16384)  # per-particle Kalman banks are O(N d^2)
    fn = jax.jit(lambda key: rao_blackwell_filter(
        key, model, ys, n, return_history=False).log_evidence)
    return "rbpf (offset CLGSSM, per-particle Kalman banks)", \
        _time(lambda: fn(jax.random.key(0)), n * (T - 1))


def bench_enkf():
    # SUB_D / SUB_N select the regime (e.g. d=16 n=16k/65k, d=64 n=65k)
    from cusmc_tpu.smc.enkf import ensemble_kalman_filter
    d = int(os.environ.get("SUB_D", 16))
    model = _dlm(d)
    _, ys = model.simulate(jax.random.key(3), T)
    n = N
    fn = jax.jit(lambda key: ensemble_kalman_filter(
        key, model, ys, n).means)
    return f"enkf (d={d}, stochastic update, n={n})", \
        _time(lambda: fn(jax.random.key(0)), n * (T - 1))


def bench_apf():
    from cusmc_tpu.smc.apf import auxiliary_filter
    model = _dlm(2)
    _, ys = model.simulate(jax.random.key(3), T)
    fn = jax.jit(lambda key: auxiliary_filter(
        key, model, ys, N, return_history=False).log_evidence)
    return "apf (fully-adapted DLM lookahead)", \
        _time(lambda: fn(jax.random.key(0)), N * (T - 1))


def bench_liu_west():
    from cusmc_tpu.smc.liu_west import liu_west_filter
    sw, sv = 0.3, 0.2

    def sample_initial(key, n, theta):
        return jax.random.normal(key, (n, 1), jnp.float32)

    def propagate(key, x, theta):
        return theta[:, :1] * x + sw * jax.random.normal(
            key, x.shape, jnp.float32)

    def propagate_mean(x, theta):
        return theta[:, :1] * x

    def observation_logpdf(y, x, theta):
        r = y[0] - x[:, 0]
        return -0.5 * r * r / (sv * sv)

    def theta_prior(key, n):
        return 0.5 + 0.2 * jax.random.normal(key, (n, 1), jnp.float32)

    rng = np.random.default_rng(0)
    ys = jnp.asarray(rng.normal(size=(T, 1)), jnp.float32)
    n = min(N, 32768)
    fn = jax.jit(lambda key: liu_west_filter(
        key, sample_initial, propagate, propagate_mean,
        observation_logpdf, theta_prior, ys, n).log_evidence)
    return "liu_west (1 parameter, kernel shrinkage)", \
        _time(lambda: fn(jax.random.key(0)), n * (T - 1))


def bench_ffbs():
    from cusmc_tpu.smc.ffbs import ffbs
    from cusmc_tpu.smc.particle_filter import bootstrap_filter
    model = _dlm(2)
    _, ys = model.simulate(jax.random.key(3), T)
    n, m = 8192, 256  # particles, backward draws
    res = jax.jit(lambda key: bootstrap_filter(
        key, model, ys, n, resampler="systematic",
        return_history=True))(jax.random.key(0))
    jax.block_until_ready(res)
    fn = jax.jit(lambda key: ffbs(key, model, res, num_paths=m))
    return f"ffbs ({m} backward draws over T={T}, N={n})", \
        _time(lambda: fn(jax.random.key(1)), m * (T - 1))


ALL = {"rbpf": bench_rbpf, "enkf": bench_enkf, "apf": bench_apf,
       "liu_west": bench_liu_west, "ffbs": bench_ffbs}

if __name__ == "__main__":
    want = os.environ.get("BENCH_SUB")
    for name, fn in ALL.items():
        if want and name != want:
            continue
        label, rate = fn()
        print(json.dumps({"subsystem": name, "config": label,
                          "rate": round(rate),
                          "unit": "particle-steps/s" if name != "ffbs"
                          else "draw-steps/s"}), flush=True)
