"""Multi-host helper tests (single-process semantics; the DCN path shares
all code with the single-host SPMD programs)."""

import jax
import numpy as np
import pytest

from cusmc_tpu.parallel.multihost import (
    global_mesh,
    initialize_distributed,
    process_info,
)


def test_process_info_single_host():
    info = process_info()
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["global_devices"] == 8  # conftest virtual mesh


def test_initialize_noop_for_single_process():
    # num_processes<=1 must not touch the distributed runtime.
    initialize_distributed(num_processes=1)


def test_global_mesh_default_and_custom():
    mesh = global_mesh()
    assert mesh.shape["particles"] == 8
    mesh2 = global_mesh({"particles": 4, "chains": 2})
    assert mesh2.shape["particles"] == 4 and mesh2.shape["chains"] == 2
    with pytest.raises(ValueError):
        global_mesh({"particles": 3})


def test_two_process_loopback():
    """Execute the REAL multi-host branch once (SURVEY.md §4): two
    subprocesses, localhost coordinator, 4 virtual CPU devices each ->
    an 8-device global mesh over DCN. Each process runs (a) a shard_map
    psum + the idempotent re-init path, (b) the FULL
    ``sharded_bootstrap_filter`` (systematic AND metropolis) over the
    process-spanning mesh with logZ checked against the single-process
    8-device run computed here, and (c) the span-bounded ring exchange
    with concentrated far-block weights, forcing real while-loop
    ppermute iterations across the process boundary.
    Skips loudly if the sandbox forbids local sockets."""
    import os
    import socket
    import subprocess
    import sys

    import jax.numpy as jnp
    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM
    from cusmc_tpu.parallel.filter import sharded_bootstrap_filter

    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    except OSError as e:  # pragma: no cover
        pytest.skip(f"sandbox forbids local sockets: {e}")

    # Reference logZ on THIS process's 8-device mesh: the worker's
    # process-spanning 8-device mesh runs the identical SPMD program, so
    # the values must agree to float tolerance.
    params = demo_model_params(d=2)
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    key = jax.random.key(7)
    _, ys = model.simulate(key, 5)
    ys = jnp.asarray(ys, jnp.float32)
    mesh = global_mesh({"particles": 8})
    refs = []
    for resampler in ("systematic", "metropolis"):
        res = sharded_bootstrap_filter(key, model, ys, 64, mesh,
                                       resampler=resampler)
        refs.append(float(np.asarray(res.log_evidence)))

    # chain-sharded sampler references (same SPMD program as the
    # worker's process-spanning chains mesh)
    from cusmc_tpu.parallel import sharded_chees_sampler, sharded_mh_sampler

    mesh_c = global_mesh({"chains": 8})
    logp = lambda x: -0.5 * jnp.sum(x * x, axis=-1)
    key_c = jax.random.key(11)
    init_c = jax.random.normal(jax.random.key(12), (16, 3), jnp.float32)
    mh = sharded_mh_sampler(key_c, logp, init_c, 10, mesh_c,
                            adapt_rate=0.1)
    ch = sharded_chees_sampler(key_c, logp, init_c, 5, mesh_c,
                               max_leapfrog=8)
    mcmc_refs = [float(np.asarray(mh.step_size)),
                 float(np.asarray(mh.accept_rate)),
                 float(np.asarray(ch.traj_length)),
                 float(np.asarray(ch.accept_rate))]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_multihost_worker.py")
    coord = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(pid),
         repr(refs[0]), repr(refs[1])] + [repr(v) for v in mcmc_refs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    except subprocess.TimeoutExpired as e:  # pragma: no cover
        for p in procs:
            p.kill()
        pytest.skip(f"distributed loopback timed out in this sandbox: {e}")

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid} 28.0" in out, out
