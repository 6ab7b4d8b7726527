"""Tests for the weight cdf the inverse-CDF search runs on
(ops/monotone_gather.weight_cdf): a plain cumsum, made exactly monotone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.ops.monotone_gather import weight_cdf


@pytest.mark.parametrize("n", [128, 4096, 8192, 98304])
def test_weight_cdf_matches_cumsum(key, n):
    w = jax.random.uniform(key, (n,), jnp.float32)
    cdf = weight_cdf(w)
    ref = np.cumsum(np.asarray(w, np.float64))
    np.testing.assert_allclose(np.asarray(cdf), ref, rtol=2e-6, atol=1e-5)
    assert cdf.dtype == jnp.float32 and cdf.shape == (n,)


@pytest.mark.parametrize("n", [2048, 98304])
def test_weight_cdf_monotone_across_zero_runs(key, n):
    # Sparse live weights between runs of exact zeros: the case where a
    # plain cumsum's per-prefix summation order lets neighbours dip.
    live = jnp.arange(n) % 97 == 0
    w = jnp.where(live, jax.random.uniform(key, (n,), jnp.float32), 0.0)
    cdf = np.asarray(weight_cdf(w))
    assert (np.diff(cdf) >= 0).all()
    np.testing.assert_allclose(cdf[-1], float(np.sum(np.asarray(w,
                                                                np.float64))),
                               rtol=1e-5)


def test_weight_cdf_short_and_odd_lengths():
    np.testing.assert_allclose(np.asarray(weight_cdf(jnp.ones((7,),
                                                              jnp.float32))),
                               np.arange(1, 8), rtol=1e-6)
    cdf = weight_cdf(jnp.ones((3 * 128,), jnp.float32))
    np.testing.assert_allclose(np.asarray(cdf), np.arange(1, 385), rtol=1e-6)
