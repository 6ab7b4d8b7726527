"""Streaming (chunked) filter tests: equivalence with the one-shot filter
and correct history streaming through the host arena."""

import jax
import jax.numpy as jnp
import numpy as np

from cusmc_tpu.io.data import demo_model_params, load_y_sim
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.smc.particle_filter import bootstrap_filter
from cusmc_tpu.smc.streaming import streaming_bootstrap_filter


def test_streaming_matches_oneshot(key):
    params = demo_model_params()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys = load_y_sim()[:101]
    n = 512

    oneshot = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), n,
                               resampler="systematic")
    streamed, store = streaming_bootstrap_filter(
        key, model, ys, n, chunk_steps=17, resampler="systematic")

    # Same carry evolution: chunked scan must be bitwise-identical to the
    # one-shot scan (same step fn, same keys folded by absolute t).
    np.testing.assert_allclose(np.asarray(streamed.final_particles),
                               np.asarray(oneshot.final_particles),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(streamed.log_evidence),
                               float(oneshot.log_evidence), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(streamed.ess),
                               np.asarray(oneshot.ess), rtol=1e-4)
    # Streamed history == in-HBM history.
    assert store.size == 101
    np.testing.assert_allclose(store.view(), np.asarray(oneshot.particles),
                               rtol=1e-6, atol=1e-6)


def test_streaming_no_store(key):
    params = demo_model_params()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys = load_y_sim()[:41]
    result, store = streaming_bootstrap_filter(key, model, ys, 128,
                                               chunk_steps=10,
                                               store_particles=False)
    assert store is None
    assert result.final_particles.shape == (128, 2)


def test_snapshot_and_halt_then_resume(tmp_path, key):
    # SURVEY.md §5 failure detection: a NaN observation mid-run triggers
    # snapshot-and-halt; resuming from the auto-snapshot on clean data
    # reproduces the uninterrupted run exactly.
    import pytest

    from cusmc_tpu.checkpoint import FilterCheckpoint
    from cusmc_tpu.utils.debug import FilterDivergedError

    params = demo_model_params()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys_clean = load_y_sim()[:81]
    n = 256

    ys_bad = np.array(ys_clean, np.float32)
    ys_bad[50, 0] = np.nan  # lands in chunk [41, 61)

    ckpt = FilterCheckpoint(str(tmp_path / "snap"), use_orbax=False)
    with pytest.raises(FilterDivergedError) as ei:
        streaming_bootstrap_filter(key, model, ys_bad, n, chunk_steps=20,
                                   resampler="systematic", checkpoint=ckpt)
    err = ei.value
    # Chunks are [1,21), [21,41), [41,61): the last good step is 40 and
    # the auto-snapshot was written for it.
    assert err.last_good_step == 40
    assert err.snapshot is not None and "step_40" in err.snapshot

    # Resume on clean observations == uninterrupted run.
    resumed, _ = streaming_bootstrap_filter(
        key, model, ys_clean, n, chunk_steps=20, resampler="systematic",
        checkpoint=ckpt, resume=True, store_particles=False)
    full, _ = streaming_bootstrap_filter(
        key, model, ys_clean, n, chunk_steps=20, resampler="systematic",
        store_particles=False)
    np.testing.assert_allclose(np.asarray(resumed.final_particles),
                               np.asarray(full.final_particles),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(resumed.log_evidence),
                               float(full.log_evidence), rtol=1e-5)


def test_sharded_streaming_matches_sharded_oneshot(key):
    # Round 4 (streaming x sharding): the mesh-sharded chunked scan must
    # reproduce the one-shot sharded filter exactly (same exp-space step
    # and collective ops; keys fold by absolute t).
    from cusmc_tpu.parallel import make_mesh, sharded_bootstrap_filter

    params = demo_model_params()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys = load_y_sim()[:61]
    n = 512
    mesh = make_mesh({"particles": 8})

    oneshot = sharded_bootstrap_filter(
        key, model, jnp.asarray(ys, jnp.float32), n, mesh,
        resampler="systematic", return_history=False)
    streamed, store = streaming_bootstrap_filter(
        key, model, ys, n, chunk_steps=13, resampler="systematic",
        mesh=mesh)

    np.testing.assert_allclose(np.asarray(streamed.final_particles),
                               np.asarray(oneshot.final_particles),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(streamed.log_evidence),
                               float(oneshot.log_evidence), rtol=1e-5)
    assert store.size == 61
    assert store.view().shape == (61, n, 2)


def test_sharded_streaming_snapshot_halt_resume(tmp_path, key):
    # The failure guard now protects the DISTRIBUTED filter too: NaN
    # observations mid-run -> snapshot-and-halt with the gathered global
    # carry; resume (on the same mesh) off clean data completes.
    import pytest

    from cusmc_tpu.checkpoint import FilterCheckpoint
    from cusmc_tpu.parallel import make_mesh
    from cusmc_tpu.utils.debug import FilterDivergedError

    params = demo_model_params()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys = np.asarray(load_y_sim()[:81], np.float32)
    mesh = make_mesh({"particles": 8})
    n = 256

    bad = ys.copy()
    bad[50:] = np.nan
    ckpt = FilterCheckpoint(str(tmp_path / "shard_snap"), use_orbax=False)
    with pytest.raises(FilterDivergedError) as ei:
        streaming_bootstrap_filter(key, model, bad, n, chunk_steps=16,
                                   resampler="systematic", mesh=mesh,
                                   checkpoint=ckpt)
    assert ei.value.snapshot is not None

    resumed, _ = streaming_bootstrap_filter(
        key, model, ys, n, chunk_steps=16, resampler="systematic",
        mesh=mesh, checkpoint=ckpt, resume=True)
    clean, _ = streaming_bootstrap_filter(
        key, model, ys, n, chunk_steps=16, resampler="systematic",
        mesh=mesh)
    # Resume restarts from the last good chunk boundary; the completed
    # run must agree with the uninterrupted one.
    np.testing.assert_allclose(float(resumed.log_evidence),
                               float(clean.log_evidence), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(resumed.final_particles),
                               np.asarray(clean.final_particles),
                               rtol=1e-5, atol=1e-5)


def test_sharded_streaming_halt_guard_stays_on_device(key, monkeypatch):
    # The per-chunk degeneracy guard must
    # read ONE on-device-reduced scalar, never the [N] weight vector or
    # the [d, N] carry. With no store and no checkpoint, _host_fetch
    # (the only sanctioned device->host path for big arrays) must not
    # run during the chunk loop — only for the final result.
    from cusmc_tpu.parallel import make_mesh
    from cusmc_tpu.smc import streaming as streaming_mod

    params = demo_model_params()
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys = load_y_sim()[:41]
    n = 256
    mesh = make_mesh({"particles": 8})

    calls = []
    orig = streaming_mod._host_fetch

    def spy(x):
        calls.append(np.shape(x))
        return orig(x)

    monkeypatch.setattr(streaming_mod, "_host_fetch", spy)
    res, store = streaming_bootstrap_filter(
        key, model, ys, n, chunk_steps=8, resampler="systematic",
        mesh=mesh, store_particles=False)
    assert store is None
    assert np.isfinite(float(res.log_evidence))
    # 41 steps / 8-step chunks = 6 chunks; only the final-result fetches
    # (final weights for carry_logw) may appear — never one per chunk.
    big = [s for s in calls if s and np.prod(s) >= n]
    assert len(big) <= 2, calls
