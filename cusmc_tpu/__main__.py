"""Command-line runner: ``python -m cusmc_tpu <command>``.

The reference is driven from R scripts calling ``CuSMC::run`` and
inspecting the CSVs it writes (``/root/reference/src/io.cpp:7-43``).
This is the equivalent headless entry point:

    python -m cusmc_tpu demo
        Smoke-run the bootstrap filter on the bundled ``y_sim`` trace
        with the demo DLM; prints one JSON diagnostics line.

    python -m cusmc_tpu run --config cfg.json --data y.csv \
           [--output-dir out/] [--mesh P] [--track p]
        Run a declaratively configured filter (``config.FilterConfig``
        schema: num_particles, model {F,G,m0,C0,V,W[,df]}, distribution,
        resampler, resampler_kwargs, ess_threshold, seed, layout, ...)
        on a [T, k] observation CSV. ``--output-dir`` writes the
        reference's CSV pair (weights + tracked-particle trajectory);
        ``--mesh P`` shards particles over the first P local devices.

Diagnostics go to stdout as ONE JSON line (logZ, final ESS, wall time,
particle-steps/s); everything else to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_demo(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from cusmc_tpu.api import run
    from cusmc_tpu.io.data import demo_model_params, load_y_sim

    p = demo_model_params()
    ys = load_y_sim()[:args.steps]
    t0 = time.perf_counter()
    out = run(args.particles, 2, ys.shape[0], ys, p["m0"], p["C0"],
              p["F"], p["G"], p["V"], p["W"], df=5.0,
              resampler=args.resampler, distribution="mvt",
              key=args.seed,
              output_dir=args.output_dir)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "command": "demo",
        "log_evidence": float(out["log_evidence"]),
        "final_ess": float(np.asarray(out["ess"])[-1]),
        "wall_s": wall,
        "particle_steps_per_sec":
            args.particles * (ys.shape[0] - 1) / wall,
    }))
    return 0


def _cmd_run(args) -> int:
    import numpy as np

    from cusmc_tpu.config import FilterConfig, build_model, run_filter
    from cusmc_tpu.io.data import load_csv, write_output

    with open(args.config) as f:
        cfg = FilterConfig.from_dict(json.load(f))
    ys = load_csv(args.data)
    if args.stream and args.output_dir:
        print("--stream keeps history out of HBM; use --checkpoint for "
              "durable state instead of --output-dir", file=sys.stderr)
        return 2
    if args.resume and not args.checkpoint:
        print("--resume requires --checkpoint", file=sys.stderr)
        return 2
    if (args.checkpoint or args.resume) and not args.stream:
        # silently ignoring these cost a user their resume semantics
        # (round-5 review finding): checkpointing is a streaming-mode
        # feature — fail loudly.
        print("--checkpoint/--resume require --stream CHUNK",
              file=sys.stderr)
        return 2
    if args.output_dir is not None and not (
            0 <= args.track < cfg.num_particles):
        print(f"--track {args.track} out of range for "
              f"num_particles={cfg.num_particles}", file=sys.stderr)
        return 2

    mesh = None
    if args.mesh:
        from cusmc_tpu.parallel import make_mesh

        mesh = make_mesh({"particles": args.mesh})

    t0 = time.perf_counter()
    if args.stream:
        import jax
        import jax.numpy as jnp

        from cusmc_tpu.smc.streaming import streaming_bootstrap_filter

        ckpt = None
        if args.checkpoint:
            from cusmc_tpu.checkpoint import FilterCheckpoint

            ckpt = FilterCheckpoint(args.checkpoint, use_orbax=False)
        result, _ = streaming_bootstrap_filter(
            jax.random.key(cfg.seed), build_model(cfg),
            np.asarray(ys, np.dtype(cfg.dtype)), cfg.num_particles,
            chunk_steps=args.stream, resampler=cfg.resampler,
            resampler_kwargs=cfg.resampler_kwargs,
            ess_threshold=cfg.ess_threshold, store_particles=False,
            checkpoint=ckpt, resume=args.resume, mesh=mesh)
    elif mesh is not None:
        import jax
        import jax.numpy as jnp

        from cusmc_tpu.parallel import sharded_bootstrap_filter

        result = sharded_bootstrap_filter(
            jax.random.key(cfg.seed), build_model(cfg),
            jnp.asarray(ys, jnp.dtype(cfg.dtype)), cfg.num_particles,
            mesh, resampler=cfg.resampler,
            resampler_kwargs=cfg.resampler_kwargs,
            ess_threshold=cfg.ess_threshold,
            # history dominates HBM at sharded scales; only materialize
            # it when the CSV export actually needs it
            return_history=(cfg.return_history
                            and args.output_dir is not None))
    else:
        result = run_filter(cfg, ys)
    wall = time.perf_counter() - t0

    if args.output_dir is not None:
        if result.particles is None:
            print("--output-dir needs return_history=true in the config",
                  file=sys.stderr)
            return 2
        weights = np.exp(np.asarray(result.obs_loglik))
        write_output(args.output_dir, ys, weights,
                     np.asarray(result.particles), args.track)

    print(json.dumps({
        "command": "run",
        "config": args.config,
        "num_particles": cfg.num_particles,
        "timesteps": int(ys.shape[0]),
        "resampler": cfg.resampler,
        "mesh": args.mesh,
        "stream": args.stream,
        "log_evidence": float(result.log_evidence),
        "final_ess": float(np.asarray(result.ess)[-1]),
        "wall_s": wall,
        "particle_steps_per_sec":
            cfg.num_particles * (ys.shape[0] - 1) / wall,
    }))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cusmc_tpu",
        description="SMC runner (see cusmc_tpu/__main__.py)")
    sub = parser.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demo", help="smoke-run on the bundled y_sim")
    d.add_argument("--particles", type=int, default=10_000)
    d.add_argument("--steps", type=int, default=200)
    d.add_argument("--resampler", default="metropolis")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--output-dir", default=None)
    d.set_defaults(fn=_cmd_demo)

    r = sub.add_parser("run", help="run a configured filter on a CSV")
    r.add_argument("--config", required=True,
                   help="FilterConfig JSON file")
    r.add_argument("--data", required=True,
                   help="[T, k] observation CSV (header row ok)")
    r.add_argument("--output-dir", default=None,
                   help="write the reference-style CSV output pair")
    r.add_argument("--mesh", type=int, default=None,
                   help="shard particles over this many local devices")
    r.add_argument("--track", type=int, default=0,
                   help="tracked particle index for the trajectory CSV")
    r.add_argument("--stream", type=int, default=None, metavar="CHUNK",
                   help="streaming mode: scan CHUNK steps per device "
                        "dispatch (long runs; composes with --mesh)")
    r.add_argument("--checkpoint", default=None,
                   help="snapshot directory (streaming mode): periodic "
                        "checkpoints + snapshot-and-halt on divergence")
    r.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint snapshot")
    r.set_defaults(fn=_cmd_run)

    args = parser.parse_args(argv)
    from cusmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
