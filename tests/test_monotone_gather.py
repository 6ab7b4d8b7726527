"""Tests for the inverse-CDF search and ancestor apply
(ops/monotone_gather): every result is compared with an independent numpy
reference (``np.searchsorted`` or a stable merge rank) on the same cdf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.ops.monotone_gather import (
    inverse_cdf_apply,
    inverse_cdf_search,
    take_columns,
    weight_cdf,
)
from cusmc_tpu.resampling.classic import (
    POSITION_FNS,
    systematic_ancestors,
)

N, D = 2048, 3


def _rand_sorted_ancestors(key, n):
    return jnp.sort(jax.random.randint(key, (n,), 0, n, jnp.int32))


def _np_merge_rank(cdf, positions):
    """#{j: cdf[j] <= p_i} clipped to N-1, by a stable merge (ref entries
    sort before equal queries)."""
    cdf = np.asarray(cdf)
    pos = np.asarray(positions).astype(cdf.dtype)
    merged = np.concatenate([cdf, pos])
    rank = np.empty(merged.size, np.int64)
    rank[np.argsort(merged, kind="stable")] = np.arange(merged.size)
    a = rank[cdf.size:] - np.arange(pos.size)
    return np.minimum(a, cdf.size - 1)


def _np_take(X, a):
    return np.asarray(X)[:, np.asarray(a)]


def test_take_columns_cpu_fallback(key):
    # A length that is not a multiple of any block size.
    X = jax.random.normal(key, (D, 300), jnp.float32)
    a = _rand_sorted_ancestors(key, 300)
    np.testing.assert_array_equal(take_columns(X, a), _np_take(X, a))


def test_take_columns_kernel_matches_take(key):
    X = jax.random.normal(key, (D, N), jnp.float32)
    a = _rand_sorted_ancestors(key, N)
    out = take_columns(X, a)
    np.testing.assert_array_equal(out, _np_take(X, a))


def test_take_columns_huge_spans(key):
    # Sorted ancestors with constant runs then a jump (what concentrated
    # weights produce).
    X = jax.random.normal(key, (D, N), jnp.float32)
    a = jnp.sort(jnp.where(jnp.arange(N) % 7 == 0, N - 1,
                           jnp.arange(N) % 3)).astype(jnp.int32)
    out = take_columns(X, a)
    np.testing.assert_array_equal(out, _np_take(X, a))


def test_take_columns_unsorted_falls_back(key):
    # Unsorted ancestors (residual's stitched vector, user indices) take
    # the same path: no monotonicity is assumed.
    X = jax.random.normal(key, (D, N), jnp.float32)
    a = jax.random.randint(key, (N,), 0, N, jnp.int32)  # unsorted
    out = take_columns(X, a)
    np.testing.assert_array_equal(out, _np_take(X, a))


@pytest.mark.parametrize("name", sorted(POSITION_FNS))
def test_inverse_cdf_apply_matches_merge_rank(key, name):
    kw, kp = jax.random.split(key)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    cdf = weight_cdf(jax.nn.softmax(logw))
    positions = POSITION_FNS[name](kp, N, jnp.float32)
    X = jax.random.normal(kp, (D, N), jnp.float32)

    y, a = inverse_cdf_apply(cdf, positions, X)
    a_ref = _np_merge_rank(cdf, positions)
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(y, _np_take(X, a_ref))


def test_inverse_cdf_apply_concentrated_weights(key):
    # One particle carries ~all the mass at index 0: every rank is 0
    # except past the spike's cdf plateau.
    logw = jnp.full((N,), -20.0).at[0].set(0.0)
    cdf = weight_cdf(jax.nn.softmax(logw))
    positions = POSITION_FNS["systematic"](key, N, jnp.float32)
    X = jax.random.normal(key, (D, N), jnp.float32)

    y, a = inverse_cdf_apply(cdf, positions, X)
    a_ref = _np_merge_rank(cdf, positions)
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(y, _np_take(X, a_ref))


def test_inverse_cdf_apply_long_zero_runs(key):
    # Floor-count cdf (the residual resampler's deterministic pass):
    # most entries are zero-weight, so the cdf has long plateaus and
    # ties must resolve past the whole plateau (side="right").
    kw, kp, kx = jax.random.split(key, 3)
    w = jnp.floor(N * jax.nn.softmax(
        3.0 * jax.random.normal(kw, (N,), jnp.float32)))
    cdf = weight_cdf(w)
    positions = POSITION_FNS["systematic"](kp, N, jnp.float32) * cdf[-1]
    X = jax.random.normal(kx, (D, N), jnp.float32)

    y, a = inverse_cdf_apply(cdf, positions, X)
    a_ref = _np_merge_rank(cdf, positions)
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(y, _np_take(X, a_ref))


def test_inverse_cdf_apply_matches_registry_systematic(key):
    # End-to-end semantic parity with the registry resampler.
    logw = jax.random.normal(key, (N,), jnp.float32)
    cdf = weight_cdf(jax.nn.softmax(logw))
    from cusmc_tpu.resampling.classic import systematic_positions

    positions = systematic_positions(key, N, jnp.float32)
    X = jax.random.normal(key, (D, N), jnp.float32)
    _, a = inverse_cdf_apply(cdf, positions, X)
    a_reg = systematic_ancestors(key, logw)
    np.testing.assert_array_equal(a, a_reg)


def test_packed_filter_systematic_uses_new_op(key):
    # The packed-layout filter with a CDF resampler must still match the
    # Kalman oracle statistically — covered by test_particle_filter; here
    # just smoke the wiring end to end on CPU.
    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM
    from cusmc_tpu.smc.particle_filter import bootstrap_filter

    model = DLM.create(noise="mvn", **demo_model_params(d=2))
    _, ys = model.simulate(key, 30)
    res = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 1024,
                           resampler="systematic", layout="packed")
    assert bool(jnp.isfinite(res.log_evidence))
    assert res.particles.shape == (30, 1024, 2)
    # ancestors must be valid indices
    assert int(res.ancestors.min()) >= 0
    assert int(res.ancestors.max()) < 1024


def test_inverse_cdf_apply_local_base(key):
    # local_base mode — search the GLOBAL cdf while applying against a
    # LOCAL block (the sharded ring exchange's round 0).
    # Ancestors must be identical to global mode; values must equal the
    # gather wherever the ancestor falls inside the local block.
    n_glob = 8192
    n_loc = 2048
    kw, kp, kx = jax.random.split(key, 3)
    w = jax.random.uniform(kw, (n_glob,), jnp.float32, minval=0.01)
    cdf = weight_cdf(w)
    X_glob = jax.random.normal(kx, (D, n_glob), jnp.float32)
    for shard in range(4):
        base = shard * n_loc
        u = jax.random.uniform(jax.random.fold_in(kp, shard), ())
        slots = jnp.arange(base, base + n_loc, dtype=jnp.float32)
        pos = (slots + u) / n_glob * cdf[-1]
        X_loc = X_glob[:, base:base + n_loc]
        y, a = inverse_cdf_apply(cdf, pos, X_loc, local_base=base)
        np.testing.assert_array_equal(a, _np_merge_rank(cdf, pos))
        a_np = np.asarray(a)
        hit = (a_np >= base) & (a_np < base + n_loc)
        assert hit.any()
        np.testing.assert_array_equal(
            np.asarray(y)[:, hit],
            np.asarray(X_glob)[:, a_np[hit]])


def test_inverse_cdf_apply_local_base_concentrated(key):
    # All mass on one particle OUTSIDE most shards' blocks: ancestors
    # still exact; no value hits for shards not owning it.
    n_glob = 8192
    n_loc = 2048
    kx = jax.random.fold_in(key, 9)
    w = jnp.full((n_glob,), 1e-12, jnp.float32).at[100].set(1.0)
    cdf = weight_cdf(w)
    X_glob = jax.random.normal(kx, (D, n_glob), jnp.float32)
    for shard in (0, 3):
        base = shard * n_loc
        slots = jnp.arange(base, base + n_loc, dtype=jnp.float32)
        pos = (slots + 0.5) / n_glob * cdf[-1]
        X_loc = X_glob[:, base:base + n_loc]
        y, a = inverse_cdf_apply(cdf, pos, X_loc, local_base=base)
        a_np = np.asarray(a)
        assert (a_np == 100).all()
        if shard == 0:
            np.testing.assert_array_equal(
                np.asarray(y), np.asarray(X_glob)[:, a_np])


def _weights(kind, n, key):
    if kind == "uniform":
        return jnp.ones((n,), jnp.float32)
    if kind == "spike":
        return jnp.full((n,), 1e-12, jnp.float32).at[n // 3].set(1.0)
    if kind == "zero_runs":
        # Long runs of exactly-zero weight between sparse live entries.
        live = jnp.arange(n) % 97 == 0
        return jnp.where(live, jax.random.uniform(key, (n,), jnp.float32),
                         0.0)
    return jnp.exp(2.0 * jax.random.normal(key, (n,), jnp.float32))


@pytest.mark.parametrize("kind", ["uniform", "spike", "zero_runs", "random"])
@pytest.mark.parametrize("n", [1000, 2048, 98304])
def test_search_matches_numpy_searchsorted(key, n, kind):
    kw, kp = jax.random.split(jax.random.fold_in(key, n))
    w = _weights(kind, n, kw)
    cdf = weight_cdf(w)
    positions = POSITION_FNS["systematic"](kp, n, jnp.float32) * cdf[-1]
    a = inverse_cdf_search(cdf, positions)
    ref = np.minimum(np.searchsorted(np.asarray(cdf), np.asarray(positions),
                                     side="right"), n - 1)
    assert a.dtype == jnp.int32 and a.shape == (n,)
    np.testing.assert_array_equal(np.asarray(a), ref)


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_inverse_cdf_apply_local_base_offsets(key, shard):
    # One shard of four: global ancestors match numpy searchsorted over
    # the global cdf; values match the gather where the ancestor is local.
    n_glob, n_loc = 8192, 2048
    kw, kx = jax.random.split(key)
    w = jnp.exp(jax.random.normal(kw, (n_glob,), jnp.float32))
    cdf = weight_cdf(w)
    X_glob = jax.random.normal(kx, (D, n_glob), jnp.float32)
    base = shard * n_loc
    slots = jnp.arange(base, base + n_loc, dtype=jnp.float32)
    pos = (slots + 0.5) / n_glob * cdf[-1]
    y, a = inverse_cdf_apply(cdf, pos, X_glob[:, base:base + n_loc],
                             local_base=base)
    a_np = np.asarray(a)
    ref = np.minimum(np.searchsorted(np.asarray(cdf), np.asarray(pos),
                                     side="right"), n_glob - 1)
    np.testing.assert_array_equal(a_np, ref)
    hit = (a_np >= base) & (a_np < base + n_loc)
    assert hit.any()
    np.testing.assert_array_equal(np.asarray(y)[:, hit],
                                  np.asarray(X_glob)[:, a_np[hit]])
