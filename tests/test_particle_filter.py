"""Integration tests: bootstrap filter vs the exact Kalman oracle on the
bundled linear-Gaussian trace (SURVEY.md §4 — the strongest oracle
available; the reference itself has no tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.io.data import demo_model_params, load_y_sim
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.smc.kalman import kalman_filter
from cusmc_tpu.smc.particle_filter import bootstrap_filter


@pytest.fixture(scope="module")
def demo():
    params = demo_model_params()
    ys = load_y_sim()[:301]  # truncate for test speed
    return params, ys


def posterior_mean(result):
    w = np.exp(np.asarray(result.obs_loglik)
               - np.asarray(result.obs_loglik).max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return (w[:, :, None] * np.asarray(result.particles)).sum(axis=1)


@pytest.mark.parametrize("resampler", ["systematic", "metropolis",
                                       "residual"])
def test_matches_kalman_oracle(demo, resampler, key):
    # "residual" exercises the exp-space fast residual step (packed,
    # always-resample) end to end against the oracle.
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    n = 4096
    result = jax.jit(
        lambda k: bootstrap_filter(k, model, jnp.asarray(ys, jnp.float32), n,
                                   resampler=resampler)
    )(key)
    km, kc, _ = kalman_filter(ys, **{k: params[k] for k in
                                     ("F", "G", "V", "W", "m0", "C0")})
    pm = posterior_mean(result)
    # Skip the first few steps (prior-dominated, high MC noise).
    err = np.abs(pm[5:] - np.asarray(km)[5:])
    scale = np.sqrt(np.asarray(kc)[5:].diagonal(axis1=1, axis2=2))
    # Filter mean should track Kalman mean well within posterior sd.
    assert np.mean(err < 4.0 * scale) > 0.99
    assert np.median(err / scale) < 0.5


def test_log_evidence_matches_kalman(demo, key):
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    result = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 8192,
                              resampler="systematic")
    _, _, loglik = kalman_filter(ys, **{k: params[k] for k in
                                        ("F", "G", "V", "W", "m0", "C0")})
    # Log-evidence estimate is consistent; tolerance scales with T.
    assert abs(float(result.log_evidence) - float(loglik)) < 0.02 * abs(float(loglik))


def test_mvt_filter_runs_and_tracks(demo, key):
    # MVT noise on (nearly) Gaussian data: posterior means still track the
    # latent state closely; this exercises the full MVT path end to end.
    params, ys = demo
    model = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32, **params)
    result = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 4096,
                              resampler="metropolis")
    pm = posterior_mean(result)
    resid = pm[10:] - np.asarray(ys)[10:]
    assert np.sqrt((resid ** 2).mean()) < 0.2
    assert np.isfinite(float(result.log_evidence))


def test_adaptive_resampling(demo, key):
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    result = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 2048,
                              resampler="systematic", ess_threshold=0.5)
    km, kc, _ = kalman_filter(ys, **{k: params[k] for k in
                                     ("F", "G", "V", "W", "m0", "C0")})
    # Adaptive weights: reconstruct posterior mean from normalized weights.
    # (obs_loglik alone is not the full weight here; use ESS sanity +
    # tracking of the observed series instead.)
    assert np.isfinite(np.asarray(result.ess)).all()
    assert (np.asarray(result.ess)[1:] >= 1.0).all()
    x_mean = np.asarray(result.particles).mean(axis=1)
    resid = x_mean[10:] - np.asarray(km)[10:]
    assert np.sqrt((resid ** 2).mean()) < 0.3


def test_return_history_false(demo, key):
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    result = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 512,
                              return_history=False)
    assert result.particles is None and result.ancestors is None
    assert result.final_particles.shape == (512, 2)
    assert result.ess.shape == (ys.shape[0],)


def test_reproducible_under_jit(demo, key):
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys32 = jnp.asarray(ys[:50], jnp.float32)
    r1 = bootstrap_filter(key, model, ys32, 256)
    r2 = jax.jit(lambda k: bootstrap_filter(k, model, ys32, 256))(key)
    np.testing.assert_allclose(np.asarray(r1.final_particles),
                               np.asarray(r2.final_particles), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(np.asarray(r1.ancestors),
                                  np.asarray(r2.ancestors))


def test_fast_metropolis_path_matches_generic(key):
    # The exp-space fast path (default for packed metropolis, always
    # resample) consumes the same key stream as the generic factory;
    # outputs must agree to float rounding. debug_checks=True forces the
    # generic path with identical keys.
    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM

    params = demo_model_params(d=2)
    model = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32, **params)
    _, ys = model.simulate(key, 40)
    ys = jnp.asarray(ys, jnp.float32)
    fast = bootstrap_filter(key, model, ys, 512, resampler="metropolis")
    slow = bootstrap_filter(key, model, ys, 512, resampler="metropolis",
                            debug_checks=True)
    np.testing.assert_array_equal(np.asarray(fast.ancestors),
                                  np.asarray(slow.ancestors))
    np.testing.assert_allclose(np.asarray(fast.particles),
                               np.asarray(slow.particles), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(fast.log_evidence),
                               float(slow.log_evidence), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(fast.ess), np.asarray(slow.ess),
                               rtol=1e-3)


def test_mixed_precision_state_dtype(demo, key):
    # state_dtype=bfloat16 mixed precision: the particle state and its
    # matmuls run in bf16 while the weight path (log-densities, evidence,
    # resampling) stays float32. This CPU regression checks dtypes,
    # tracking, and evidence accuracy.
    params, ys = demo
    ys = jnp.asarray(ys, jnp.float32)
    model = DLM.create(noise="mvn", dtype=jnp.float32,
                       state_dtype=jnp.bfloat16, **params)
    assert model.G.dtype == jnp.bfloat16
    assert model.V_chol.dtype == jnp.float32
    result = jax.jit(
        lambda k: bootstrap_filter(k, model, ys, 8192,
                                   resampler="systematic"))(key)
    assert result.particles.dtype == jnp.bfloat16
    assert result.obs_loglik.dtype == jnp.float32
    assert result.final_log_weights.dtype == jnp.float32
    km, kc, loglik = kalman_filter(ys, **{k: params[k] for k in
                                          ("F", "G", "V", "W", "m0", "C0")})
    assert abs(float(result.log_evidence) - float(loglik)) \
        < 0.02 * abs(float(loglik))
    pm = posterior_mean(result)
    err = np.abs(pm[5:] - np.asarray(km)[5:])
    scale = np.sqrt(np.asarray(kc)[5:].diagonal(axis1=1, axis2=2))
    assert np.mean(err < 4.0 * scale) > 0.99

    # MVT mixed-precision path (chi-square scale computed in f32).
    mvt = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32,
                     state_dtype=jnp.bfloat16, **params)
    r = bootstrap_filter(key, mvt, ys[:50], 1024, resampler="metropolis",
                         return_history=False)
    assert r.final_particles.dtype == jnp.bfloat16
    assert np.isfinite(float(r.log_evidence))


def test_adaptive_exp_path_matches_always_resample(demo, key):
    # Round 4: ESS-adaptive routes through the exp-space fast factory.
    # With a threshold that always fires (ESS < 1.01 N always) the cond
    # resample branch must reproduce the always-resample run exactly
    # (same keys -> same ancestors; evidence to rounding).
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys32 = jnp.asarray(ys[:60], jnp.float32)
    r_always = bootstrap_filter(key, model, ys32, 2048,
                                resampler="systematic")
    r_adapt = bootstrap_filter(key, model, ys32, 2048,
                               resampler="systematic", ess_threshold=1.01)
    np.testing.assert_array_equal(np.asarray(r_always.ancestors),
                                  np.asarray(r_adapt.ancestors))
    np.testing.assert_allclose(float(r_always.log_evidence),
                               float(r_adapt.log_evidence), rtol=1e-5)


def test_adaptive_exp_path_never_resample_is_sis(demo, key):
    # Threshold 0: pred never fires -> pure SIS: identity ancestry
    # everywhere. Against the exact log-space oracle (debug_checks=True
    # forces the generic step with the same packed layout and per-step
    # key consumption) the evidence matches while the exp carry's
    # representable range holds (~88 nats of weight spread; the
    # documented flush-to-zero limit kicks in on longer degenerate
    # horizons — see _fast_exp_step_factory).
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys32 = jnp.asarray(ys[:30], jnp.float32)
    res = bootstrap_filter(key, model, ys32, 4096,
                           resampler="systematic", ess_threshold=0.0)
    a = np.asarray(res.ancestors)
    np.testing.assert_array_equal(a, np.tile(np.arange(4096), (30, 1)))
    ref = bootstrap_filter(key, model, ys32, 4096,
                           resampler="systematic", ess_threshold=0.0,
                           debug_checks=True)
    np.testing.assert_allclose(float(res.log_evidence),
                               float(ref.log_evidence), rtol=1e-5)


def test_adaptive_exp_path_matches_log_oracle_realistic(demo, key):
    # Realistic adaptive threshold: resampling fires intermittently,
    # resetting the exp carry. Exact equality with the log-space generic
    # path is chaotic (one near-threshold ESS rounding flip diverges all
    # later states), so assert the statistical contract instead: both
    # paths fire a similar number of times and land on the Kalman
    # evidence.
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys32 = jnp.asarray(ys[:100], jnp.float32)
    res = bootstrap_filter(key, model, ys32, 2048,
                           resampler="systematic", ess_threshold=0.5)
    ref = bootstrap_filter(key, model, ys32, 2048,
                           resampler="systematic", ess_threshold=0.5,
                           debug_checks=True)

    def fires(r):
        a = np.asarray(r.ancestors)
        return int((a != np.arange(2048)[None, :]).any(axis=1).sum())

    assert abs(fires(res) - fires(ref)) <= 5, (fires(res), fires(ref))
    _, _, kll = kalman_filter(np.asarray(ys32),
                              **{k: params[k] for k in
                                 ("F", "G", "V", "W", "m0", "C0")})
    for r in (res, ref):
        assert abs(float(r.log_evidence) - float(kll)) \
            < 0.03 * abs(float(kll))


@pytest.mark.parametrize("resampler", ["metropolis", "residual"])
def test_adaptive_exp_other_resamplers(demo, key, resampler):
    # The unified exp factory serves every packed fast resampler with a
    # threshold; sanity: finite evidence, tracking, mixed skip/fire.
    params, ys = demo
    model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
    ys32 = jnp.asarray(ys[:80], jnp.float32)
    res = bootstrap_filter(key, model, ys32, 2048, resampler=resampler,
                           ess_threshold=0.5)
    assert np.isfinite(float(res.log_evidence))
    a = np.asarray(res.ancestors)
    ident = (a == np.arange(2048)[None, :]).all(axis=1)
    assert ident.any(), "threshold 0.5 should skip some steps"
