#!/usr/bin/env python
"""End-to-end check of cusmc_tpu on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

One card, each phase one line:
  device           platform, device kind, JAX version, XLA_FLAGS, card name
                   and power limit (nvidia-smi), compile-cache directory;
  headline         bootstrap_filter, MVT DLM, N=1,048,576, d=2, T=200,
                   Metropolis B=10, return_history=False, timed under jit;
  systematic       the same filter with resampler="systematic";
  entry-points     the README quick start (cusmc_tpu.run, with history) and
                   the CLI ``demo`` command, in this process;
  mcmc             random-walk MH, 1024 chains on a d=128 MVT target;
  correct-*        the path against plain references on the card:
                   propagate/reweight vs float64 numpy at N=1M (d=2, 128),
                   CDF ancestors vs np.searchsorted, roll-Metropolis
                   ancestors vs their closed form, and the MVN filter vs
                   the Kalman oracle on the bundled y_sim;
  gpu-tests        the tests marked ``gpu``, through pytest in this process.

``--chips 4`` runs only the four-card path, at N = 4 x 1,048,576:
  sharded-*-exchange  the particle exchanges alone, exactly: the Metropolis
                   exchange ("global" == "binary" bit for bit, and both ==
                   a numpy replay of its closed form) and the systematic
                   ring (span-bounded with ring_window=1, whose while_loop
                   runs on far-block weights; and the default full ring)
                   against the one-card inverse-CDF apply, at every slot;
  sharded-*        ``sharded_bootstrap_filter`` (metropolis,
                   exchange="global"; systematic, ring_window=1) and
                   ``sharded_mh_sampler`` over 4 chain shards, against the
                   same program on one card: mean log Z over 4 seeds, or
                   per-chain moments, within 5 standard errors; results
                   checked to sit on four devices.

Everything runs in this one process, so one process holds the cards. The
last stdout line is one JSON object,
``{"ok": ..., "device": {"platform": ..., "kind": ..., "count": ...}}``;
the script exits non-zero with ``"ok": false`` if there is no GPU or any
phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

N_FULL = 1 << 20
T_HEAD = 200
CARD = "unknown card"


def final_line(ok: bool, devices) -> str:
    dev = None
    if devices:
        dev = {"platform": devices[0].platform,
               "kind": devices[0].device_kind, "count": len(devices)}
    return json.dumps({"ok": bool(ok), "device": dev})


def run_phase(name, fn, failures) -> None:
    t0 = time.perf_counter()
    try:
        detail = fn()
    except Exception as e:  # report, keep going, fail at the end
        failures.append(name)
        traceback.print_exc(file=sys.stderr)
        print(f"[{name}] FAIL after {time.perf_counter() - t0:.1f} s: "
              f"{type(e).__name__}: {e}", flush=True)
        return
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {detail}",
          flush=True)


def _check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


# -- one card ---------------------------------------------------------------

def _mvt_model(d=2):
    import jax.numpy as jnp

    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM

    return DLM.create(noise="mvt", df=5.0, dtype=jnp.float32,
                      **demo_model_params(d=d))


def _timed(fn, key, reps=3):
    """(first-call seconds incl. compile, [timed seconds], last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(key))
    first = time.perf_counter() - t0
    times = []
    for i in range(reps):
        k = jax.random.fold_in(key, i + 1)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(k))
        times.append(time.perf_counter() - t0)
    return first, times, out


def phase_filter(resampler):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.smc.particle_filter import bootstrap_filter

    model = _mvt_model()
    ys = jnp.asarray(model.simulate(jax.random.key(0), T_HEAD)[1],
                     jnp.float32)
    kw = {"num_steps": 10} if resampler == "metropolis" else None
    fn = jax.jit(lambda k: bootstrap_filter(
        k, model, ys, N_FULL, resampler=resampler, resampler_kwargs=kw,
        return_history=False))
    first, times, out = _timed(fn, jax.random.key(1))
    lz = float(out.log_evidence)
    ess = np.asarray(out.ess)
    _check(np.isfinite(lz), f"log_evidence {lz}")
    _check(np.all(np.isfinite(ess)) and ess.shape == (T_HEAD,),
           f"ess shape {ess.shape} finite {np.isfinite(ess).all()}")
    best = min(times)
    return (f"N={N_FULL} T={T_HEAD} d=2 {resampler}: first call "
            f"{first:.2f} s (compile incl.), timed {times} s, best "
            f"{N_FULL * (T_HEAD - 1) / best:.6g} particle-steps/s, "
            f"log_evidence {lz:.4f}, ess min {ess.min():.1f} "
            f"[{CARD}]")


def phase_entry_points():
    import numpy as np

    import cusmc_tpu
    from cusmc_tpu.__main__ import main as cli_main
    from cusmc_tpu.io.data import demo_model_params, load_y_sim

    p = demo_model_params()
    ys = load_y_sim()
    t0 = time.perf_counter()
    out = cusmc_tpu.run(
        N=10_000, d=2, timeSteps=1001, Y=ys,
        m0=p["m0"], C0=p["C0"], F=p["F"], G=p["G"], V=p["V"], W=p["W"],
        df=5.0, resampler="metropolis", distribution="mvt", key=0)
    x = np.asarray(out["posterior_x"])
    w = np.asarray(out["weights"], np.float64)
    run_s = time.perf_counter() - t0
    _check(x.shape == (1001, 10_000, 2), f"posterior_x {x.shape}")
    _check(w.shape == (1001, 10_000), f"weights {w.shape}")
    _check(np.isfinite(float(out["log_evidence"])), "log_evidence")
    wn = w / w.sum(axis=1, keepdims=True)
    pm = np.einsum("tn,tnd->td", wn, x)
    rmse = float(np.sqrt(np.mean((pm[1:] - ys[1:]) ** 2)))
    _check(rmse < 0.1, f"posterior mean RMSE vs y {rmse}")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["demo"])
    demo_s = time.perf_counter() - t0
    demo = json.loads(buf.getvalue().strip().splitlines()[-1])
    _check(rc == 0 and np.isfinite(demo["log_evidence"]), f"demo {demo}")
    return (f"run(N=10000, T=1001, mvt, metropolis) {run_s:.2f} s, "
            f"logZ {float(out['log_evidence']):.3f}, posterior-mean RMSE "
            f"vs y {rmse:.4f}; CLI demo rc {rc} in {demo_s:.2f} s, "
            f"logZ {demo['log_evidence']:.3f} [{CARD}]")


def phase_mcmc():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.distributions import make_mvt_logprob
    from cusmc_tpu.mcmc import metropolis_hastings_sampler

    chains, d, steps, df = 1024, 128, 500, 8.0
    log_prob = make_mvt_logprob(jnp.zeros(d, jnp.float32),
                                jnp.eye(d, dtype=jnp.float32), df)
    init = jax.random.normal(jax.random.key(1), (chains, d), jnp.float32)
    fn = jax.jit(lambda k: metropolis_hastings_sampler(
        k, log_prob, init, steps, step_size=2.38 / math.sqrt(d),
        keep_samples=False))
    first, times, out = _timed(fn, jax.random.key(2))
    x = np.asarray(out.state.x)
    acc = float(out.accept_rate)
    var = float(np.mean(x ** 2))
    _check(np.all(np.isfinite(x)), "non-finite chain state")
    _check(0.05 < acc < 0.9, f"acceptance {acc}")
    _check(0.8 < var < 1.8, f"E[x^2] {var} (target {df / (df - 2):.3f})")
    best = min(times)
    return (f"RW-MH {chains} chains d={d} {steps} steps: first call "
            f"{first:.2f} s, timed {times} s, "
            f"{chains * steps / best:.6g} chain-steps/s, acceptance "
            f"{acc:.3f}, E[x^2] {var:.3f} (target {df / (df - 2):.3f}) "
            f"[{CARD}]")


def _dense_model(d, seed):
    """MVT DLM with dense random factors, so every matmul mixes all d.
    Returns the model and its raw W and V as the model received them
    (float32-rounded), in float64."""
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.models.dlm import DLM

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) / math.sqrt(d)
    b = rng.standard_normal((d, d)) / math.sqrt(d)
    W = (a @ a.T + 0.1 * np.eye(d)).astype(np.float32)
    V = (b @ b.T + 0.1 * np.eye(d)).astype(np.float32)
    model = DLM.create(
        F=rng.standard_normal((d, d)) / math.sqrt(d),
        G=0.9 * rng.standard_normal((d, d)) / math.sqrt(d),
        m0=np.zeros(d), C0=np.eye(d), W=W, V=V, df=5.0, noise="mvt",
        dtype=jnp.float32)
    return model, W.astype(np.float64), V.astype(np.float64)


def _factor_residual(model, W, V):
    """Largest float64 residual of the model's covariance factors against
    the raw W and V, relative to the largest entry of each:
    W_sqrt W_sqrt^T = W, V_chol V_chol^T = V with V_chol lower
    triangular (the log-density reads its log-determinant off the
    diagonal), and V_chol_inv V_chol = I."""
    import numpy as np

    Ws, Vc, Vci = (np.asarray(m, np.float64)
                   for m in (model.W_sqrt, model.V_chol, model.V_chol_inv))
    return max(np.max(np.abs(Ws @ Ws.T - W)) / np.max(np.abs(W)),
               np.max(np.abs(Vc @ Vc.T - V)) / np.max(np.abs(V)),
               np.max(np.abs(np.triu(Vc, 1))) / np.max(np.abs(Vc)),
               np.max(np.abs(Vci @ Vc - np.eye(len(V)))))


def _propagate_reweight_errors(d, precision):
    """Max errors of the device propagate/reweight against a float64
    numpy reference on the same inputs and noise draws."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.special import gammaln

    from cusmc_tpu.ops.random import chi2_integer_df

    model, W_raw, V_raw = _dense_model(d, seed=d)
    factor_res = _factor_residual(model, W_raw, V_raw)
    kx, kp, ky = jax.random.split(jax.random.key(10 + d), 3)
    X = jax.random.normal(kx, (d, N_FULL), jnp.float32)
    y = jax.random.normal(ky, (d,), jnp.float32)

    def device(kp, X, y):
        Xn = model.propagate_packed(kp, X)
        kz, kg = jax.random.split(kp)      # the draws propagate_packed makes
        z = jax.random.normal(kz, (d, N_FULL), jnp.float32)
        g = chi2_integer_df(kg, model.df_int, (1, N_FULL), jnp.float32)
        # Unpinned matmul at this precision: what TF32 would do here.
        raw = jnp.matmul(model.G, X)
        return Xn, model.observation_logpdf_packed(y, Xn), z, g, raw

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        Xn, ll, z, g, raw = jax.jit(device)(kp, X, y)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    G, W, F = f64(model.G), f64(model.W_sqrt), f64(model.F)
    Vc, Vci, df = f64(model.V_chol), f64(model.V_chol_inv), float(model.df)
    X64, Xn64 = f64(X), f64(Xn)
    ref_x = G @ X64 + (W @ f64(z)) * np.sqrt(df / f64(g))
    state_rel = np.max(np.abs(Xn64 - ref_x)) / np.max(np.abs(ref_x))
    raw_rel = np.max(np.abs(f64(raw) - G @ X64)) / np.max(np.abs(G @ X64))
    r = f64(y)[:, None] - F @ Xn64
    quad = np.sum((Vci @ r) ** 2, axis=0)
    ref_ll = (gammaln(0.5 * (df + d)) - gammaln(0.5 * df)
              - 0.5 * d * (np.log(df) + np.log(np.pi))
              - np.sum(np.log(np.diag(Vc)))
              - 0.5 * (df + d) * np.log1p(quad / df))
    err = np.abs(f64(ll) - ref_ll)
    bound_ok = bool(np.all(err <= 1e-4 + 1e-6 * np.abs(ref_ll)))
    return state_rel, float(err.max()), float(np.abs(ref_ll).max()), \
        bound_ok, raw_rel, factor_res


def phase_correct_propagate():
    parts = []
    for d in (2, 128):
        for precision in ("highest", None):
            st, ll_err, ll_mag, ok, raw, fac = _propagate_reweight_errors(
                d, precision)
            tag = precision or "default"
            parts.append(f"d={d} {tag}: factors vs raw W, V rel {fac:.3g}, "
                         f"state rel {st:.3g}, logpdf abs {ll_err:.3g} "
                         f"(|logp| up to {ll_mag:.4g}), unpinned G@X rel "
                         f"{raw:.3g}")
            _check(fac <= 1e-5, f"d={d} {tag}: factor residual {fac}")
            _check(st <= 1e-5, f"d={d} {tag}: state rel err {st}")
            _check(ok, f"d={d} {tag}: logpdf err {ll_err} over "
                       f"1e-4 + 1e-6|logp|")
    return "; ".join(parts) + (" — bounds: factors rel <= 1e-5, state rel "
                               "<= 1e-5, logpdf abs <= 1e-4 + 1e-6|logp|")


def phase_correct_resample():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply, weight_cdf
    from cusmc_tpu.resampling.classic import systematic_positions
    from cusmc_tpu.resampling.rolls import (
        roll_metropolis_sweeps_expspace,
        roll_metropolis_weight_walk,
    )

    n = N_FULL
    kw, kx, kp, kr = jax.random.split(jax.random.key(20), 4)
    ll = -0.5 * (3.0 * jax.random.normal(kw, (n,), jnp.float32)) ** 2
    w = jnp.exp(ll - jnp.max(ll))       # max-normalized, many underflow
    X = jax.random.normal(kx, (2, n), jnp.float32)

    @jax.jit
    def cdf_path(kp, w, X):
        cdf = weight_cdf(w)
        pos = systematic_positions(kp, n, jnp.float32) * cdf[-1]
        xa, a = inverse_cdf_apply(cdf, pos, X)
        return jnp.cumsum(w), cdf, pos, xa, a

    raw, cdf, pos, xa, a = cdf_path(kp, w, X)
    c = np.asarray(cdf)
    ref = np.minimum(np.searchsorted(c, np.asarray(pos), side="right"), n - 1)
    a = np.asarray(a)
    _check(np.array_equal(a, ref),
           f"CDF ancestors differ from np.searchsorted at "
           f"{int(np.sum(a != ref))} slots")
    _check(np.array_equal(np.asarray(xa), np.asarray(X)[:, a]),
           "CDF apply != X[:, a]")
    dips = int(np.sum(np.diff(np.asarray(raw)) < 0))

    @jax.jit
    def roll_path(kr, w, X):
        b_win, shifts = roll_metropolis_weight_walk(kr, w, 10)
        xr, ar = roll_metropolis_sweeps_expspace(kr, X, w, 10)
        return b_win, shifts, xr, ar

    b_win, shifts, xr, ar = (np.asarray(v) for v in roll_path(kr, w, X))
    i = np.arange(n)
    expect = np.where(b_win < 0, i,
                      (i + shifts[np.maximum(b_win, 0)]) % n)
    _check(np.array_equal(ar, expect),
           f"roll ancestors differ at {int(np.sum(ar != expect))} slots")
    _check(np.array_equal(xr, np.asarray(X)[:, ar]), "roll apply != X[:, a]")
    return (f"N={n}: CDF ancestors == np.searchsorted on the device cdf "
            f"(all {n}), apply == X[:, a]; plain jnp.cumsum dips "
            f"{dips} times (weight_cdf: 0); roll-Metropolis B=10 "
            f"ancestors == (i + shifts[b_win]) mod N, "
            f"{int(np.sum(b_win >= 0))} moved")


def phase_correct_kalman():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.io.data import demo_model_params, load_y_sim
    from cusmc_tpu.models.dlm import DLM
    from cusmc_tpu.smc.kalman import kalman_filter
    from cusmc_tpu.smc.particle_filter import bootstrap_filter

    params = demo_model_params()
    ys_np = load_y_sim()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys = jnp.asarray(ys_np, jnp.float32)
    with jax.enable_x64(True):
        km, kc, lz_exact = (np.asarray(v) for v in kalman_filter(
            ys_np, **{k: params[k] for k in ("F", "G", "V", "W", "m0",
                                             "C0")}))
    lz_exact = float(lz_exact)
    sd = np.sqrt(kc[5:].diagonal(axis1=1, axis2=2))
    parts = []
    for resampler in ("systematic", "metropolis"):
        @jax.jit
        def run(key):
            r = bootstrap_filter(key, model, ys, N_FULL, resampler=resampler)
            w = jax.nn.softmax(r.obs_loglik, axis=1)
            return r.log_evidence, jnp.einsum("tn,tnd->td", w, r.particles)

        lz, pm = run(jax.random.key(30))
        lz, pm = float(lz), np.asarray(pm, np.float64)
        rel = abs(lz - lz_exact) / abs(lz_exact)
        z = np.abs(pm[5:] - km[5:]) / sd
        _check(rel < 0.02, f"{resampler}: logZ {lz} vs exact {lz_exact}")
        _check(np.mean(z < 4.0) > 0.99 and np.median(z) < 0.5,
               f"{resampler}: filtered mean off by median {np.median(z)} sd")
        parts.append(f"{resampler} logZ {lz:.3f} (rel err {rel:.2e}), "
                     f"mean err median {np.median(z):.3f} sd, max "
                     f"{z.max():.3f} sd")
    return (f"MVN DLM on y_sim (T={len(ys_np)}), N={N_FULL}, threefry: "
            f"exact logZ {lz_exact:.3f}; " + "; ".join(parts)
            + " — bounds: logZ within 2%, filtered mean within 4 "
            "posterior sd at 99% of steps, median < 0.5 sd")


def phase_gpu_tests():
    import pytest

    os.environ["CUSMC_TESTS_ON_CARD"] = "1"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_gpu.py")])
    tail = buf.getvalue().strip().splitlines()
    print("\n".join(tail), file=sys.stderr)
    summary = tail[-1] if tail else "no output"
    _check(rc == 0 and "passed" in summary and "skipped" not in summary,
           f"pytest exit code {int(rc)}: {summary}")
    return summary


# -- four cards -------------------------------------------------------------

def _shard_devices(arr):
    return {s.device for s in arr.addressable_shards}


def _mesh4(axis):
    import jax

    from cusmc_tpu.parallel import make_mesh

    return make_mesh({axis: 4}, devices=jax.devices()[:4])


SEEDS = 4       # seeds per side for the sharded-vs-one-card comparisons
Z_LIMIT = 5.0   # limit on a difference of means, in standard errors


def _within(a, b, what):
    """Means of samples ``a`` (four cards) and ``b`` (one card) agree
    within Z_LIMIT standard errors of their difference; returns the text
    of the comparison."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    diff = float(a.mean() - b.mean())
    _check(abs(diff) <= Z_LIMIT * se,
           f"{what}: 4 cards {a.mean()} vs one card {b.mean()}, diff "
           f"{diff} over {Z_LIMIT} x se {se}")
    return (f"{what} {a.mean():.4f} (sd {a.std(ddof=1):.4f}) vs "
            f"{b.mean():.4f} (sd {b.std(ddof=1):.4f}), diff {diff:+.4f} "
            f"= {diff / se:+.2f} se")


def phase_sharded_filter(resampler, kw):
    """The sharded filter against the same filter on one card: times, the
    shards' devices, and log Z over SEEDS seeds on each side."""
    import jax
    import jax.numpy as jnp

    from cusmc_tpu.parallel import sharded_bootstrap_filter
    from cusmc_tpu.smc.particle_filter import bootstrap_filter

    n = 4 * N_FULL
    mesh = _mesh4("particles")
    model = _mvt_model()
    ys = jnp.asarray(model.simulate(jax.random.key(0), T_HEAD)[1],
                     jnp.float32)
    sharded = jax.jit(lambda k: sharded_bootstrap_filter(
        k, model, ys, n, mesh, resampler=resampler, resampler_kwargs=kw))
    single = jax.jit(lambda k: bootstrap_filter(
        k, model, ys, n, resampler=resampler, return_history=False))
    first_s, times_s, out_s = _timed(sharded, jax.random.key(1), reps=2)
    devs = _shard_devices(out_s.final_particles)
    _check(len(devs) == 4, f"final particles on {len(devs)} devices")
    _, times_1, _ = _timed(single, jax.random.key(1), reps=2)
    lz_s = [float(sharded(jax.random.key(100 + i)).log_evidence)
            for i in range(SEEDS)]
    lz_1 = [float(single(jax.random.key(200 + i)).log_evidence)
            for i in range(SEEDS)]
    return (f"N={n} T={T_HEAD} {resampler} {kw}: 4 cards "
            f"{min(times_s):.4f} s ({n * (T_HEAD - 1) / min(times_s):.6g} "
            f"particle-steps/s, first {first_s:.1f} s), one card "
            f"{min(times_1):.4f} s; {_within(lz_s, lz_1, 'logZ')} over "
            f"{SEEDS} seeds each; shards on {sorted(d.id for d in devs)} "
            f"[{CARD}]")


def _particle_op_fn(mesh, op, with_stats=False):
    """jit(shard_map) of a packed resample op ``(key, X [d, N], w [N])``."""
    from jax.sharding import PartitionSpec as P

    from cusmc_tpu.parallel.mesh import PARTICLE_AXIS, jit_shard_map

    ax = P(PARTICLE_AXIS)
    out_specs = (P(None, PARTICLE_AXIS), ax, ax) + ((ax,) if with_stats
                                                     else ())

    def local(key, X, w):
        out = op(key, X, w)
        return out[:3] + (out[3][None],) if with_stats else out

    return jit_shard_map(local, mesh=mesh,
                         in_specs=(P(), P(None, PARTICLE_AXIS), ax),
                         out_specs=out_specs, check_vma=False)


def phase_sharded_ring():
    """The sharded systematic exchange against the one-card inverse-CDF
    apply over the same weights: ancestors and values at every slot must
    be equal. ring_window=1 takes the span-bounded exchange (two static
    neighbour rounds, then the ``while_loop`` ring); ring_window=2, the
    default, takes the full single-direction ring at 4 shards."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply, weight_cdf
    from cusmc_tpu.parallel.mesh import PARTICLE_AXIS
    from cusmc_tpu.parallel.resampling import ring_cdf_resample_op

    shards, L = 4, N_FULL
    n = shards * L
    mesh = _mesh4(PARTICLE_AXIS)
    kx, kw, kr = jax.random.split(jax.random.key(40), 3)
    X = jax.random.normal(kx, (2, n), jnp.float32)
    X_np = np.asarray(X)
    # Integer weights: their cumsum is exact in any summation order, so
    # the gathered cdf on four cards and the cdf on one card are equal.
    heavy = 2 * L + 7          # block 2: forward distance 2 from shard 0
    cases = {
        "random 0..3": jax.random.randint(kw, (n,), 0, 4).astype(jnp.float32),
        "all on one far particle":
            jnp.zeros((n,), jnp.float32).at[heavy].set(1.0),
    }

    @jax.jit
    def reference(key, X, w):
        cdf = weight_cdf(w)
        u = jax.random.uniform(key, (), jnp.float32)
        pos = (jnp.arange(n, dtype=jnp.float32) + u) / n * cdf[-1]
        return inverse_cdf_apply(cdf, pos, X)

    parts = []
    for K in (1, 2):
        fn = _particle_op_fn(mesh, ring_cdf_resample_op(
            "systematic", PARTICLE_AXIS, n, L, with_stats=True,
            weights="exp", ring_window=K), with_stats=True)
        span_bounded = shards > 2 * K + 1
        for label, w in cases.items():
            x, _, a, mined = fn(kr, X, w)
            devs = _shard_devices(x)
            _check(len(devs) == 4, f"ring output on {len(devs)} devices")
            xa_ref, a_ref = reference(kr, X, w)
            a, x, mined = np.asarray(a), np.asarray(x), np.asarray(mined)
            bad = int(np.sum(a != np.asarray(a_ref)))
            _check(bad == 0, f"K={K} {label}: ancestors differ from the "
                             f"one-card search at {bad} slots")
            _check(np.array_equal(x, np.asarray(xa_ref))
                   and np.array_equal(x, X_np[:, a]),
                   f"K={K} {label}: values differ from X[:, a]")
            # Rounds of the while_loop ring: the farthest forward
            # distance any shard needs beyond the static +-K window.
            blocks = a.reshape(shards, L) // L
            dist = (blocks - np.arange(shards)[:, None]) % shards
            gap = dist[(dist > K) & (dist < shards - K)]
            trips = int(gap.max()) - K if gap.size else 0
            if label.startswith("all"):
                _check((a == heavy).all(), f"K={K}: ancestors not all "
                                           f"{heavy}")
                if span_bounded:
                    _check(trips >= 1, f"K={K}: no while_loop round ran")
            path = (f"span-bounded, {trips} while_loop round(s)"
                    if span_bounded else f"full ring, {shards - 1} rounds")
            parts.append(f"K={K} {label}: {path}, mined rounds per shard "
                         f"{mined.tolist()}")
    return (f"N={n} systematic ring exchange == one-card inverse_cdf_apply "
            f"(ancestors and values, all {n} slots): " + "; ".join(parts))


def phase_sharded_metropolis():
    """The sharded Metropolis exchange at B=10: "global" and "binary" must
    agree bit for bit, and both with a numpy replay of the op's closed
    form (per sweep b: source shard (p + q_b) mod P, lane (i + s_b) mod L,
    accept u * w_cur < w_cand) from the same keys."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.parallel.mesh import PARTICLE_AXIS
    from cusmc_tpu.parallel.resampling import roll_metropolis_sharded_op

    shards, L, B = 4, N_FULL, 10
    n = shards * L
    mesh = _mesh4(PARTICLE_AXIS)
    kx, kw, kr = jax.random.split(jax.random.key(50), 3)
    X = jax.random.normal(kx, (2, n), jnp.float32)
    w = jnp.exp(-0.5 * (2.0 * jax.random.normal(kw, (n,), jnp.float32)) ** 2)
    outs = {}
    for ex in ("global", "binary"):
        fn = _particle_op_fn(mesh, roll_metropolis_sharded_op(
            PARTICLE_AXIS, n, L, num_steps=B, exchange=ex, weights="exp"))
        x, _, a = fn(kr, X, w)
        devs = _shard_devices(x)
        _check(len(devs) == 4, f"{ex}: output on {len(devs)} devices")
        outs[ex] = (np.asarray(x), np.asarray(a))
    _check(np.array_equal(outs["global"][0], outs["binary"][0])
           and np.array_equal(outs["global"][1], outs["binary"][1]),
           "exchange='binary' differs from 'global'")

    wn, X_np = np.asarray(w), np.asarray(X)
    iota = np.arange(L)
    sweeps = []
    for b in range(B):
        kq, ks, ku = jax.random.split(jax.random.fold_in(kr, b), 3)
        sweeps.append((int(jax.random.randint(kq, (), 0, shards, jnp.int32)),
                       int(jax.random.randint(ks, (), 0, L, jnp.int32)), ku))
    a_ref = np.empty(n, np.int64)
    for p in range(shards):
        w_cur, a_cur = wn[p * L:(p + 1) * L].copy(), p * L + iota
        for q, s, ku in sweeps:
            u = np.asarray(jax.random.uniform(jax.random.fold_in(ku, p),
                                              (L,), jnp.float32))
            j = (p + q) % shards * L + (iota + s) % L
            acc = u * w_cur < wn[j]
            w_cur = np.where(acc, wn[j], w_cur)
            a_cur = np.where(acc, j, a_cur)
        a_ref[p * L:(p + 1) * L] = a_cur
    x, a = outs["global"]
    bad = int(np.sum(a != a_ref))
    _check(bad == 0, f"ancestors differ from the closed form at {bad} slots")
    _check(np.array_equal(x, X_np[:, a_ref]), "values differ from X[:, a]")
    moved = a_ref != np.arange(n)
    cross = int(np.sum(a_ref // L != np.arange(n) // L))
    return (f"N={n} B={B}: 'global' == 'binary' bit for bit; ancestors == "
            f"numpy replay of the closed form at all {n} slots, values == "
            f"X[:, a]; {int(moved.sum())} slots moved, {cross} to a parent "
            f"on another card")


def phase_sharded_mcmc():
    """Chain-sharded RW-MH against the same sampler on one card: per-chain
    moments within Z_LIMIT standard errors (chains are independent, so
    the spread over chains gives the error), and the pooled acceptance
    equal to the mean over all chains (the cross-card pmean)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.distributions import make_mvt_logprob
    from cusmc_tpu.mcmc import metropolis_hastings_sampler
    from cusmc_tpu.parallel import sharded_mh_sampler

    chains, d, steps, df = 1024, 128, 500, 8.0
    log_prob = make_mvt_logprob(jnp.zeros(d, jnp.float32),
                                jnp.eye(d, dtype=jnp.float32), df)
    init = jax.random.normal(jax.random.key(1), (chains, d), jnp.float32)
    mesh = _mesh4("chains")
    kw = dict(step_size=2.38 / math.sqrt(d), keep_samples=False)
    sharded = jax.jit(lambda k: sharded_mh_sampler(
        k, log_prob, init, steps, mesh, **kw))
    single = jax.jit(lambda k: metropolis_hastings_sampler(
        k, log_prob, init, steps, **kw))
    _, times_s, out_s = _timed(sharded, jax.random.key(2), reps=2)
    devs = _shard_devices(out_s.state.x)
    _check(len(devs) == 4, f"chains on {len(devs)} devices")
    _, times_1, out_1 = _timed(single, jax.random.key(2), reps=2)
    rate_all = float(np.mean(np.asarray(out_s.state.accept_count))) / steps
    _check(abs(float(out_s.accept_rate) - rate_all) <= 1e-6,
           f"pooled acceptance {float(out_s.accept_rate)} != mean over "
           f"chains {rate_all}")
    xs, x1 = np.asarray(out_s.state.x), np.asarray(out_1.state.x)
    acc_s = np.asarray(out_s.state.accept_count) / steps
    acc_1 = np.asarray(out_1.state.accept_count) / steps
    parts = [_within(xs.mean(1), x1.mean(1), "chain mean"),
             _within((xs ** 2).mean(1), (x1 ** 2).mean(1), "chain E[x^2]"),
             _within(acc_s, acc_1, "acceptance")]
    return (f"RW-MH {chains} chains d={d} {steps} steps: 4 cards "
            f"{min(times_s):.4f} s, one card {min(times_1):.4f} s; "
            + "; ".join(parts) + f" over {chains} chains; pooled "
            f"acceptance == mean over chains; shards on "
            f"{sorted(d.id for d in devs)} [{CARD}]")


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4),
                        help="4: run only the four-card sharded path")
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import jax

        from cusmc_tpu.utils.compile_cache import enable_compile_cache
        from cusmc_tpu.utils.device import card_info, require_gpu
    except ImportError as e:
        print(f"[setup] FAIL: {e}", flush=True)
        print(final_line(False, None))
        return 1

    cache_dir = enable_compile_cache(ROOT)
    devices = jax.devices()
    try:
        require_gpu(devices)
        if len(devices) < args.chips:
            raise RuntimeError(f"--chips {args.chips} but JAX sees "
                               f"{len(devices)} GPU(s)")
    except RuntimeError as e:
        print(f"[device] FAIL: {e}", flush=True)
        print(final_line(False, devices))
        return 1
    devices = devices[:args.chips]
    cards = card_info()
    CARD = cards[0]
    print(f"[device] ok: {devices[0].device_kind} x{len(devices)}, jax "
          f"{jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
          f", compile cache {cache_dir}", flush=True)
    for line in cards:
        print(f"card: {line}", flush=True)

    failures = []
    if args.chips == 4:
        run_phase("sharded-metropolis-exchange", phase_sharded_metropolis,
                  failures)
        run_phase("sharded-ring-exchange", phase_sharded_ring, failures)
        run_phase("sharded-metropolis",
                  lambda: phase_sharded_filter("metropolis",
                                               {"exchange": "global"}),
                  failures)
        run_phase("sharded-systematic",
                  lambda: phase_sharded_filter("systematic",
                                               {"ring_window": 1}),
                  failures)
        run_phase("sharded-mcmc", phase_sharded_mcmc, failures)
    else:
        run_phase("headline", lambda: phase_filter("metropolis"), failures)
        run_phase("systematic", lambda: phase_filter("systematic"), failures)
        run_phase("entry-points", phase_entry_points, failures)
        run_phase("mcmc", phase_mcmc, failures)
        run_phase("correct-propagate", phase_correct_propagate, failures)
        run_phase("correct-resample", phase_correct_resample, failures)
        run_phase("correct-kalman", phase_correct_kalman, failures)
        run_phase("gpu-tests", phase_gpu_tests, failures)
    if failures:
        print(f"failed phases: {', '.join(failures)}", flush=True)
    print(f"card: {CARD}", flush=True)
    print(final_line(not failures, devices), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
