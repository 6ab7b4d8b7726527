"""Tests for the gather-free packed-layout resampler (resampling/rolls.py):
roll-Metropolis statistical correctness; systematic exactness against a
numpy searchsorted reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.resampling.classic import systematic_ancestors
from cusmc_tpu.resampling.rolls import (
    roll_metropolis_resample_op,
    roll_metropolis_sweeps,
)


class TestRollMetropolis:
    def test_ancestors_match_states(self, key):
        # The returned states must be exactly X[:, a] for the returned a.
        n, d = 256, 3
        X = jax.random.normal(key, (d, n), jnp.float32)
        logw = jax.random.normal(jax.random.fold_in(key, 1), (n,))
        Xr, a = roll_metropolis_sweeps(key, X, logw, num_steps=10)
        np.testing.assert_allclose(np.asarray(Xr),
                                   np.asarray(X[:, np.asarray(a)]))

    def test_unbiased(self, key):
        n, reps = 32, 4000
        rng = np.random.default_rng(0)
        w = rng.random(n) + 0.05
        w /= w.sum()
        logw = jnp.log(jnp.asarray(w, jnp.float32))
        X = jnp.zeros((1, n), jnp.float32)

        def anc(k):
            _, a = roll_metropolis_sweeps(k, X, logw, num_steps=10)
            return a

        ancs = jax.vmap(anc)(jax.random.split(key, reps))
        counts = np.zeros(n)
        for row in np.asarray(ancs):
            counts += np.bincount(row, minlength=n)
        emp = counts / (reps * n)
        np.testing.assert_allclose(emp, w, atol=0.02)

    def test_degenerate_converges(self, key):
        n = 64
        logw = jnp.full((n,), -1e30, jnp.float32).at[17].set(0.0)
        X = jnp.arange(n, dtype=jnp.float32)[None, :]
        Xr, a = roll_metropolis_sweeps(key, X, logw, num_steps=400)
        assert (np.asarray(a) == 17).mean() > 0.95
        assert (np.asarray(Xr)[0] == 17.0).mean() > 0.95

    def test_resample_op_uniform_logw(self, key):
        n = 128
        op = roll_metropolis_resample_op(num_steps=10, num_particles=n)
        X = jax.random.normal(key, (2, n), jnp.float32)
        logw = jax.random.normal(key, (n,), jnp.float32)
        Xa, logw_pre, a = op(key, X, logw)
        np.testing.assert_allclose(np.asarray(logw_pre),
                                   -np.log(n) * np.ones(n), rtol=1e-6)
        assert Xa.shape == (2, n) and a.shape == (n,)


class TestSortfreeSystematic:
    @pytest.mark.parametrize("n", [16, 128, 1000])
    def test_matches_searchsorted_impl(self, n, key):
        logw = jax.random.normal(key, (n,), jnp.float32) * 2.0
        u = jax.random.uniform(key, (), jnp.float32)
        positions = (jnp.arange(n, dtype=jnp.float32) + u) / n
        cdf = np.asarray(jnp.cumsum(jax.nn.softmax(logw)))
        a_ref = np.minimum(np.searchsorted(cdf, np.asarray(positions),
                                           side="right"), n - 1)
        a_new = systematic_ancestors(key, logw)
        np.testing.assert_array_equal(a_ref, np.asarray(a_new))

    def test_degenerate(self, key):
        n = 64
        logw = jnp.full((n,), -1e30, jnp.float32).at[5].set(0.0)
        a = systematic_ancestors(key, logw)
        assert (np.asarray(a) == 5).all()


class TestPackedFilterEquivalence:
    def test_packed_matches_batch_statistically(self, key):
        from cusmc_tpu.io.data import demo_model_params, load_y_sim
        from cusmc_tpu.models.dlm import DLM
        from cusmc_tpu.smc.particle_filter import bootstrap_filter
        from cusmc_tpu.smc.kalman import kalman_filter

        params = demo_model_params()
        model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
        ys = load_y_sim()[:201]
        n = 2048
        packed = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), n,
                                  layout="packed", return_history=False)
        batch = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), n,
                                 layout="batch", return_history=False)
        km, kc, kll = kalman_filter(ys, **{k: params[k] for k in
                                           ("F", "G", "V", "W", "m0", "C0")})
        # Both must estimate the same evidence within MC error.
        assert abs(float(packed.log_evidence) - float(kll)) < \
            0.05 * abs(float(kll))
        assert abs(float(batch.log_evidence) - float(kll)) < \
            0.05 * abs(float(kll))
        assert packed.final_particles.shape == batch.final_particles.shape

    def test_packed_history_layout(self, key):
        from cusmc_tpu.io.data import demo_model_params, load_y_sim
        from cusmc_tpu.models.dlm import DLM
        from cusmc_tpu.smc.particle_filter import bootstrap_filter

        params = demo_model_params()
        model = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32, **params)
        ys = load_y_sim()[:31]
        res = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 64,
                               layout="packed")
        assert res.particles.shape == (31, 64, 2)
        assert res.ancestors.shape == (31, 64)
        assert np.isfinite(np.asarray(res.obs_loglik)).all()

    def test_packed_mvn_logpdf_matches_batch(self, key):
        from cusmc_tpu.io.data import demo_model_params
        from cusmc_tpu.models.dlm import DLM

        params = demo_model_params()
        for noise, df in (("mvn", None), ("mvt", 5.0)):
            model = DLM.create(noise=noise, df=df, dtype=jnp.float32, **params)
            x = jax.random.normal(key, (100, 2), jnp.float32)
            y = jnp.asarray([0.3, -0.2], jnp.float32)
            ll_batch = model.observation_logpdf(y, x)
            ll_packed = model.observation_logpdf_packed(y, x.T)
            np.testing.assert_allclose(np.asarray(ll_batch),
                                       np.asarray(ll_packed),
                                       rtol=2e-4, atol=2e-5)

    def test_packed_propagate_moments(self, key):
        from cusmc_tpu.io.data import demo_model_params
        from cusmc_tpu.models.dlm import DLM

        params = demo_model_params()
        model = DLM.create(noise="mvn", dtype=jnp.float32, **params)
        n = 100_000
        X = jnp.zeros((2, n), jnp.float32) + jnp.asarray([1.0, -1.0])[:, None]
        Xn = model.propagate_packed(key, X)
        mean_expect = np.asarray(params["G"]) @ np.array([1.0, -1.0])
        np.testing.assert_allclose(np.asarray(Xn).mean(1), mean_expect,
                                   atol=0.002)
        np.testing.assert_allclose(np.asarray(Xn).var(1), [0.001, 0.001],
                                   rtol=0.1)
