"""MCMC unit tests: moment recovery on known targets, adaptation behavior,
multi-chain vmap semantics (BASELINE configs 1, 2, 5 on CPU scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.distributions import mvn_logpdf_cov, mvt_logpdf_cov
from cusmc_tpu.mcmc import metropolis_hastings_sampler
from cusmc_tpu.utils.linalg import chol_sqrt


def test_mvn_target_moments(key):
    d, chains, steps = 4, 64, 4000
    rng = np.random.default_rng(0)
    mu = jnp.asarray(rng.standard_normal(d), jnp.float32)
    a = rng.standard_normal((d, d))
    cov = jnp.asarray(a @ a.T + d * np.eye(d), jnp.float32)

    log_prob = lambda x: mvn_logpdf_cov(x, mu, cov)
    init = jax.random.normal(key, (chains, d), jnp.float32)
    result = jax.jit(
        lambda k: metropolis_hastings_sampler(
            k, log_prob, init, steps, proposal_chol=chol_sqrt(cov))
    )(key)

    samples = np.asarray(result.samples[steps // 2:]).reshape(-1, d)
    np.testing.assert_allclose(samples.mean(0), np.asarray(mu), atol=0.25)
    np.testing.assert_allclose(np.cov(samples.T), np.asarray(cov),
                               atol=1.2, rtol=0.25)


def test_adaptation_reaches_target_accept(key):
    d, chains, steps = 16, 32, 3000
    log_prob = lambda x: mvn_logpdf_cov(x, jnp.zeros(d, jnp.float32),
                                        jnp.eye(d, dtype=jnp.float32))
    init = jnp.zeros((chains, d), jnp.float32)
    # Start far off: tiny step size; adaptation must pull it up.
    result = metropolis_hastings_sampler(key, log_prob, init, steps,
                                         step_size=1e-3, adapt_rate=0.1)
    assert 0.1 < float(result.accept_rate) < 0.5
    assert float(result.step_size) > 0.01


def test_mvt_target_marginal_variance(key):
    # BASELINE config 2: MVT target with tuned proposal covariance, d=16.
    d, df, chains, steps = 16, 8.0, 64, 4000
    log_prob = lambda x: mvt_logpdf_cov(x, jnp.zeros(d, jnp.float32),
                                        jnp.eye(d, dtype=jnp.float32), df)
    init = jax.random.normal(key, (chains, d), jnp.float32)
    result = metropolis_hastings_sampler(
        key, log_prob, init, steps,
        proposal_chol=jnp.eye(d, dtype=jnp.float32), step_size=0.4)
    samples = np.asarray(result.samples[steps // 2:]).reshape(-1, d)
    # Marginal variance of t_nu is nu/(nu-2).
    np.testing.assert_allclose(samples.var(0).mean(), df / (df - 2.0),
                               rtol=0.2)


def test_no_samples_mode(key):
    d = 2
    log_prob = lambda x: mvn_logpdf_cov(x, jnp.zeros(d, jnp.float32),
                                        jnp.eye(d, dtype=jnp.float32))
    result = metropolis_hastings_sampler(
        key, log_prob, jnp.zeros((8, d), jnp.float32), 100,
        keep_samples=False)
    assert result.samples is None
    assert result.state.x.shape == (8, d)


def test_reproducible(key):
    d = 3
    log_prob = lambda x: mvn_logpdf_cov(x, jnp.zeros(d, jnp.float32),
                                        jnp.eye(d, dtype=jnp.float32))
    init = jnp.ones((4, d), jnp.float32)
    r1 = metropolis_hastings_sampler(key, log_prob, init, 200)
    r2 = jax.jit(lambda k: metropolis_hastings_sampler(k, log_prob, init, 200))(key)
    np.testing.assert_allclose(np.asarray(r1.state.x), np.asarray(r2.state.x),
                               rtol=1e-5, atol=1e-5)


class TestFastLogprobFactories:
    """Round 5: precomputed-inverse log-density closures (the MCMC hot
    path replaces a per-step triangular solve with one matmul)."""

    def test_mvn_factory_matches_direct(self, key):
        from cusmc_tpu.distributions import make_mvn_logprob
        d = 12
        rng = np.random.default_rng(3)
        a = rng.standard_normal((d, d))
        cov = jnp.asarray(a @ a.T + d * np.eye(d), jnp.float32)
        mu = jnp.asarray(rng.standard_normal(d), jnp.float32)
        x = jax.random.normal(key, (128, d), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(make_mvn_logprob(mu, cov)(x)),
            np.asarray(mvn_logpdf_cov(x, mu, cov)), rtol=2e-5, atol=2e-4)

    def test_mvt_factory_matches_direct(self, key):
        from cusmc_tpu.distributions import make_mvt_logprob
        d = 12
        rng = np.random.default_rng(4)
        a = rng.standard_normal((d, d))
        cov = jnp.asarray(a @ a.T + d * np.eye(d), jnp.float32)
        mu = jnp.asarray(rng.standard_normal(d), jnp.float32)
        x = jax.random.normal(key, (128, d), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(make_mvt_logprob(mu, cov, 7.0)(x)),
            np.asarray(mvt_logpdf_cov(x, mu, cov, 7.0)),
            rtol=2e-5, atol=2e-4)

    def test_factory_grad_matches_direct(self, key):
        # MALA/HMC differentiate log_prob; the closure's gradient must
        # agree with the solve-based form.
        from cusmc_tpu.distributions import make_mvt_logprob
        d = 6
        rng = np.random.default_rng(5)
        a = rng.standard_normal((d, d))
        cov = jnp.asarray(a @ a.T + d * np.eye(d), jnp.float32)
        mu = jnp.zeros(d, jnp.float32)
        x = jax.random.normal(key, (8, d), jnp.float32)
        g1 = jax.grad(lambda y: make_mvt_logprob(mu, cov, 5.0)(y).sum())(x)
        g2 = jax.grad(
            lambda y: mvt_logpdf_cov(y, mu, cov, 5.0).sum())(x)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-4, atol=1e-5)


class TestBf16Noise:
    """bf16 proposal noise is exact for symmetric random-walk proposals
    (round-to-nearest is odd, so the increment law stays symmetric)."""

    def test_moments_recovered_with_bf16_noise(self, key):
        d, chains, steps = 4, 64, 4000
        rng = np.random.default_rng(6)
        mu = jnp.asarray(rng.standard_normal(d), jnp.float32)
        cov = jnp.eye(d, dtype=jnp.float32) * 2.0
        from cusmc_tpu.distributions import make_mvn_logprob
        log_prob = make_mvn_logprob(mu, cov)
        init = jax.random.normal(key, (chains, d), jnp.float32)
        result = jax.jit(lambda k: metropolis_hastings_sampler(
            k, log_prob, init, steps, proposal_chol=chol_sqrt(cov),
            noise_dtype=jnp.bfloat16))(key)
        assert result.state.x.dtype == jnp.float32
        samples = np.asarray(result.samples[steps // 2:]).reshape(-1, d)
        np.testing.assert_allclose(samples.mean(0), np.asarray(mu),
                                   atol=0.25)
        np.testing.assert_allclose(samples.var(0), 2.0, rtol=0.25)

    def test_precision_knob(self, key):
        from cusmc_tpu.distributions import make_mvt_logprob
        d = 8
        rng = np.random.default_rng(12)
        a = rng.standard_normal((d, d))
        cov = jnp.asarray(a @ a.T + d * np.eye(d), jnp.float32)
        mu = jnp.zeros(d, jnp.float32)
        x = jax.random.normal(key, (64, d), jnp.float32)
        hi = make_mvt_logprob(mu, cov, 5.0)(x)
        lo = make_mvt_logprob(mu, cov, 5.0, precision="default")(x)
        # same function up to reduced-precision matmul accumulation
        np.testing.assert_allclose(np.asarray(lo), np.asarray(hi),
                                   rtol=5e-3, atol=5e-2)
        with pytest.raises(KeyError):
            make_mvt_logprob(mu, cov, 5.0, precision="bogus")(x)
