"""Distributed-resampling exchange tests (parallel/resampling.py).

Covers the round-2 exchanges: the O(L*d)-memory ring exchange for CDF
resamplers (ring == allgather equality, no [N, d] materialization), the
global-proposal sharded Metropolis (offspring law matches the
single-device roll resampler under concentrated weights — the round-1
windowed scheme's documented bias), and the pred-gated adaptive path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from cusmc_tpu.parallel import make_mesh
from cusmc_tpu.parallel.resampling import (
    allgather_resample_op,
    ring_cdf_resample_op,
    roll_metropolis_sharded_op,
)
from cusmc_tpu.resampling.rolls import roll_metropolis_sweeps

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

AXIS = "particles"
N, NSH = 4096, 8
L = N // NSH
D = 2


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({AXIS: NSH})


_FN_CACHE = {}


def _run_packed_op(mesh, op, key, X, logw, pred=None):
    """Run a packed-layout resample op under shard_map; X is [d, N].
    The jitted shard_map program is cached per (op, pred) so repeated
    statistical trials don't re-trace."""
    cache_key = (id(op), pred, mesh)
    fn = _FN_CACHE.get(cache_key)
    if fn is None:
        def local(key, X, logw):
            if pred is None:
                return op(key, X, logw)
            return op(key, X, logw, pred=jnp.asarray(pred))

        fn = jax.jit(shard_map(local, mesh=mesh,
                               in_specs=(P(), P(None, AXIS), P(AXIS)),
                               out_specs=(P(None, AXIS), P(AXIS), P(AXIS)),
                               check_vma=False))
        _FN_CACHE[cache_key] = fn
    return fn(key, X, logw)


@pytest.mark.parametrize("name", ["systematic", "stratified"])
def test_ring_equals_allgather(mesh, key, name):
    # Identical ancestor fns + identical keys -> identical resampled state.
    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)

    ring = ring_cdf_resample_op(name, AXIS, N, L)
    x_ring, lw_ring, a_ring = _run_packed_op(mesh, ring, kr, X, logw)

    ag = allgather_resample_op(name, AXIS, N, L)

    def local_ag(key, Xb, logw):
        return ag(key, Xb, logw)

    fn = shard_map(local_ag, mesh=mesh,
                   in_specs=(P(), P(AXIS, None), P(AXIS)),
                   out_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
                   check_vma=False)
    x_ag, lw_ag, a_ag = fn(kr, X.T, logw)

    np.testing.assert_array_equal(np.asarray(a_ring), np.asarray(a_ag))
    np.testing.assert_array_equal(np.asarray(x_ring), np.asarray(x_ag.T))
    np.testing.assert_allclose(np.asarray(lw_ring), np.asarray(lw_ag))


def test_ring_multinomial_offspring_proportional(mesh, key):
    # Sorted per-shard multinomial: offspring counts ~ Multinomial(N, w).
    kx, kr = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    w = jnp.array([0.5] + [0.5 / (N - 1)] * (N - 1))
    logw = jnp.log(w)
    op = ring_cdf_resample_op("multinomial", AXIS, N, L)
    counts = []
    for i in range(10):
        _, _, a = _run_packed_op(mesh, op, jax.random.fold_in(kr, i),
                                 X, logw)
        counts.append(int((np.asarray(a) == 0).sum()))
    m = np.mean(counts)
    # E = N/2 = 2048, sd ~ 32 per draw -> sd of mean ~ 10.
    assert abs(m - N / 2) < 60, counts


def test_ring_never_materializes_global_state(mesh, key):
    # Shape accounting: the ring exchange
    # must never hold an [N, d]-sized array; only O(N) weight vectors and
    # O(L*d) state blocks may appear in the local program.
    op = ring_cdf_resample_op("systematic", AXIS, N, L)

    def local(key, X, logw):
        return op(key, X, logw)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(None, AXIS), P(AXIS)),
                   out_specs=(P(None, AXIS), P(AXIS), P(AXIS)),
                   check_vma=False)
    X = jnp.zeros((D, N), jnp.float32)
    logw = jnp.zeros((N,), jnp.float32)
    jaxpr = jax.make_jaxpr(fn)(key, X, logw)

    limit = D * N  # the materialized-global-state size to rule out

    def max_aval_size(jxp):
        sizes = [limit // 2]  # ignore empty
        for eqn in jxp.eqns:
            for v in eqn.outvars:
                if hasattr(v.aval, "size"):
                    sizes.append(v.aval.size)
            for param in eqn.params.values():
                inner = getattr(param, "jaxpr", None)
                if inner is not None:
                    sizes.append(max_aval_size(inner))
                if isinstance(param, (list, tuple)):
                    for p in param:
                        inner = getattr(p, "jaxpr", None)
                        if inner is not None:
                            sizes.append(max_aval_size(inner))
        return max(sizes)

    # Outside shard_map the global [d, N] operands legitimately exist;
    # inspect the inner (per-shard) jaxpr only.
    inner = None
    for eqn in jaxpr.eqns:
        if "shard_map" in str(eqn.primitive):
            inner = eqn.params["jaxpr"]
            break
    assert inner is not None
    assert max_aval_size(inner) < limit


def _offspring_of_heavy(a, heavy=0):
    return int((np.asarray(a) == heavy).sum())


def test_sharded_concentrated_weights_global_matches_single(mesh, key):
    # One particle at w ~ 0.9. Finite-B Metropolis resampling gives the
    # heavy particle ~B+1 offspring per step (each sweep's common shift
    # makes exactly one slot propose it) — an inherent finite-B property
    # shared by the reference's resampler (samplers.cpp:7-36), NOT a
    # sharding artifact. The sharded GLOBAL exchange must reproduce the
    # single-device law; measured, the windowed exchange does too on this
    # metric (its bias shows elsewhere — see the desert test below).
    B = 10
    logw = jnp.full((N,), jnp.log(0.1 / (N - 1))).at[0].set(jnp.log(0.9))
    kx = jax.random.fold_in(key, 99)
    X = jax.random.normal(kx, (D, N), jnp.float32)

    op_g = roll_metropolis_sharded_op(AXIS, N, L, num_steps=B,
                                      exchange="global")

    reps = 30
    single_fn = jax.jit(lambda k: roll_metropolis_sweeps(k, X, logw, B)[1])
    single, glob = [], []
    for i in range(reps):
        k = jax.random.fold_in(key, i)
        single.append(_offspring_of_heavy(single_fn(k)))
        _, _, a_g = _run_packed_op(mesh, op_g, k, X, logw)
        glob.append(_offspring_of_heavy(a_g))

    m_single, m_glob = map(np.mean, (single, glob))
    # Single-device law: ~B+1. Global exchange matches it.
    assert abs(m_single - (B + 1)) < 2.5, m_single
    assert abs(m_glob - m_single) < 2.5, (m_glob, m_single)


def test_sharded_weight_desert_bias(mesh, key):
    # THE regime separating the exchanges: a contiguous half of the slots
    # carries ~zero weight (a "desert" — arises naturally after repeated
    # roll resampling, which preserves slot locality). Slots whose
    # windowed candidate slice lies inside the desert can never escape it
    # in that step, so ~half the offspring keep zero-weight ancestors;
    # global per-sweep proposals escape with prob ~1-2^-B.
    B = 10
    logw = jnp.concatenate([jnp.zeros((N // 2,)),
                            jnp.full((N // 2,), -30.0)]).astype(jnp.float32)
    X = jax.random.normal(key, (D, N), jnp.float32)

    op_g = roll_metropolis_sharded_op(AXIS, N, L, num_steps=B,
                                      exchange="global")
    op_w = roll_metropolis_sharded_op(AXIS, N, L, num_steps=B,
                                      exchange="windowed")

    reps = 10
    dead_g, dead_w = [], []
    for i in range(reps):
        k = jax.random.fold_in(key, i)
        _, _, a_g = _run_packed_op(mesh, op_g, k, X, logw)
        dead_g.append(float((np.asarray(a_g) >= N // 2).mean()))
        _, _, a_w = _run_packed_op(mesh, op_w, k, X, logw)
        dead_w.append(float((np.asarray(a_w) >= N // 2).mean()))

    # Global: P(stuck) ~ (1/2)^B per slot ~ 0.1%.
    assert np.mean(dead_g) < 0.02, dead_g
    # Windowed: slices inside the desert trap their slots (~1/2 of slots
    # minus boundary effects) — the documented low-traffic tradeoff.
    assert np.mean(dead_w) > 0.25, dead_w


def test_global_exchange_unbiased_healthy_weights(mesh, key):
    # E[#offspring_i] proportional to w_i in a healthy-ESS regime.
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32) * 0.5
    w = np.asarray(jax.nn.softmax(logw))
    op = roll_metropolis_sharded_op(AXIS, N, L, num_steps=10)
    counts = np.zeros(N)
    reps = 40
    for i in range(reps):
        _, _, a = _run_packed_op(mesh, op, jax.random.fold_in(key, i),
                                 X, logw)
        counts += np.bincount(np.asarray(a), minlength=N)
    est = counts / (reps * N)
    # Aggregate into 16 weight-ordered buckets to beat MC noise.
    order = np.argsort(w)
    wb = w[order].reshape(16, -1).sum(1)
    eb = est[order].reshape(16, -1).sum(1)
    np.testing.assert_allclose(eb, wb, atol=0.02)


@pytest.mark.parametrize("make_op", [
    functools.partial(roll_metropolis_sharded_op, AXIS, N, L),
    functools.partial(roll_metropolis_sharded_op, AXIS, N, L,
                      exchange="windowed"),
    functools.partial(ring_cdf_resample_op, "systematic", AXIS, N, L),
])
def test_pred_false_is_identity(mesh, key, make_op):
    op = make_op()
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    x_out, lw_out, a = _run_packed_op(mesh, op, key, X, logw, pred=False)
    np.testing.assert_array_equal(np.asarray(x_out), np.asarray(X))
    np.testing.assert_array_equal(np.asarray(lw_out), np.asarray(logw))
    np.testing.assert_array_equal(np.asarray(a), np.arange(N))


@pytest.mark.parametrize("make_op", [
    functools.partial(roll_metropolis_sharded_op, AXIS, N, L),
    functools.partial(ring_cdf_resample_op, "systematic", AXIS, N, L),
])
def test_pred_true_matches_unconditional(mesh, key, make_op):
    op = make_op()
    kx, kw = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    got = _run_packed_op(mesh, op, key, X, logw, pred=True)
    want = _run_packed_op(mesh, op, key, X, logw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))


def test_sharded_systematic_concentrated_exact(mesh, key):
    # CDF resamplers handle weight spikes exactly: w_0 = 0.9 -> the heavy
    # particle gets floor/ceil(0.9 N) offspring under systematic.
    logw = jnp.full((N,), jnp.log(0.1 / (N - 1))).at[0].set(jnp.log(0.9))
    X = jax.random.normal(key, (D, N), jnp.float32)
    op = ring_cdf_resample_op("systematic", AXIS, N, L)
    _, _, a = _run_packed_op(mesh, op, key, X, logw)
    got = _offspring_of_heavy(a)
    assert abs(got - 0.9 * N) <= 1, got


def test_ring_round_gating_pod_scale(mesh, key):
    # Round-3 pod-scale gating: the P-1 ppermutes are unconditional, but
    # each shard mines only rounds whose passing block intersects its
    # sorted-ancestor range — O(span) local passes instead of O(P).
    kx, kr = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    op = ring_cdf_resample_op("systematic", AXIS, N, L, with_stats=True)

    def local(k, Xb, lw):
        x, lwo, a, mined = op(k, Xb, lw)
        return x, lwo, a, mined[None]

    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P(), P(None, AXIS), P(AXIS)),
                           out_specs=(P(None, AXIS), P(AXIS), P(AXIS),
                                      P(AXIS)),
                           check_vma=False))

    # Uniform weights: systematic ancestors track the slot index, so each
    # shard's span is ~its own block (+1 for boundary straddle).
    x, _, a, mined = fn(kr, X, jnp.zeros((N,), jnp.float32))
    assert np.asarray(mined).max() <= 2, np.asarray(mined)
    np.testing.assert_array_equal(np.asarray(x),
                                  np.asarray(jnp.take(X, a, axis=1)))

    # Concentrated weight: every ancestor is particle 0 -> exactly ONE
    # mined round per shard (when block 0 passes by).
    logw_c = jnp.full((N,), -40.0).at[0].set(0.0)
    x, _, a, mined = fn(kr, X, logw_c)
    np.testing.assert_array_equal(np.asarray(mined), np.ones(NSH))
    assert (np.asarray(a) == 0).all()
    np.testing.assert_array_equal(np.asarray(x),
                                  np.asarray(jnp.take(X, a, axis=1)))


# ---- round 5: span-bounded exchange ------------------------------------


from cusmc_tpu.utils.debug import count_primitive as _count_primitive


def test_ring_jaxpr_ppermute_count_is_o_k(mesh, key):
    # The exchange must embed O(K) ppermute
    # instances, NOT O(P): 2K static bidirectional hops + exactly one
    # inside the dynamic while-ring body. At K=2 that is 5, regardless
    # of mesh size (P=8 here; the full-ring fallback would show 7).
    K = 2
    op = ring_cdf_resample_op("systematic", AXIS, N, L, ring_window=K)

    def local(key, X, logw):
        return op(key, X, logw)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(None, AXIS), P(AXIS)),
                   out_specs=(P(None, AXIS), P(AXIS), P(AXIS)),
                   check_vma=False)
    jaxpr = jax.make_jaxpr(fn)(key, jnp.zeros((D, N), jnp.float32),
                               jnp.zeros((N,), jnp.float32))
    inner = None
    for eqn in jaxpr.jaxpr.eqns:
        if "shard_map" in str(eqn.primitive):
            inner = eqn.params["jaxpr"]
            break
    assert inner is not None
    assert _count_primitive(inner, "ppermute") == 2 * K + 1


@pytest.mark.parametrize("name", ["systematic", "stratified",
                                  "multinomial"])
def test_ring_far_block_escape_equals_allgather(mesh, key, name):
    # Adversarial span: ALL weight on the block at forward distance P/2
    # from every shard's own block — outside the static +-K window, so
    # every slot's state must arrive through the dynamic while-ring.
    heavy = 4 * L + 7  # a particle in block 4 (P=8: gap distances 3..5)
    logw = jnp.full((N,), -40.0).at[heavy].set(0.0)
    kx, kr = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)

    ring = ring_cdf_resample_op(name, AXIS, N, L)
    x_ring, _, a_ring = _run_packed_op(mesh, ring, kr, X, logw)
    a_ring = np.asarray(a_ring)
    assert (a_ring == heavy).all()
    np.testing.assert_array_equal(
        np.asarray(x_ring), np.asarray(jnp.take(X, jnp.asarray(a_ring),
                                                axis=1)))


@pytest.mark.parametrize("K", [1, 3, 4])
def test_ring_window_sizes_equal_allgather(mesh, key, K):
    # The ring_window knob must not change the law: K=1 (minimal static
    # window, more while-ring work), K=3 (2K+1=7 < P=8, still
    # span-bounded), K=4 (2K+1 >= P -> the small-mesh full-ring
    # fallback) all reproduce the allgather ancestors/state on both
    # healthy and far-block-concentrated weights.
    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    for logw in (jax.random.normal(kw, (N,), jnp.float32),
                 jnp.full((N,), -40.0).at[5 * L + 11].set(0.0)):
        ring = ring_cdf_resample_op("systematic", AXIS, N, L,
                                    ring_window=K)
        x_r, _, a_r = _run_packed_op(mesh, ring, kr, X, logw)
        ag = allgather_resample_op("systematic", AXIS, N, L)
        fn = shard_map(lambda k, Xb, lw: ag(k, Xb, lw), mesh=mesh,
                       in_specs=(P(), P(AXIS, None), P(AXIS)),
                       out_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
                       check_vma=False)
        x_a, _, a_a = fn(kr, X.T, logw)
        np.testing.assert_array_equal(np.asarray(a_r), np.asarray(a_a))
        np.testing.assert_array_equal(np.asarray(x_r),
                                      np.asarray(x_a.T))


def test_ring_wide_span_equals_allgather(mesh, key):
    # Spans wider than the static window but not concentrated: a comb of
    # heavy particles across ALL blocks at very unequal weights makes
    # per-shard ancestor ranges span most of the ring, forcing static
    # AND dynamic rounds to compose in one step.
    kx, kr = jax.random.split(key)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jnp.full((N,), -40.0)
    # One heavy particle per block, exponentially decaying weight.
    idx = jnp.arange(NSH) * L + 3
    logw = logw.at[idx].set(-1.5 * jnp.arange(NSH, dtype=jnp.float32))

    ring = ring_cdf_resample_op("systematic", AXIS, N, L)
    x_ring, _, a_ring = _run_packed_op(mesh, ring, kr, X, logw)

    ag = allgather_resample_op("systematic", AXIS, N, L)
    fn = shard_map(lambda k, Xb, lw: ag(k, Xb, lw), mesh=mesh,
                   in_specs=(P(), P(AXIS, None), P(AXIS)),
                   out_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
                   check_vma=False)
    x_ag, _, a_ag = fn(kr, X.T, logw)

    np.testing.assert_array_equal(np.asarray(a_ring), np.asarray(a_ag))
    np.testing.assert_array_equal(np.asarray(x_ring), np.asarray(x_ag.T))


# ---- round 4: exp-space sharded weight pipeline ------------------------


@pytest.mark.parametrize("name", ["systematic", "stratified",
                                  "multinomial"])
def test_exp_ops_match_log_ops(mesh, key, name):
    # weights="exp" fed max-normalized exp weights must produce exactly
    # the ancestors the log op derives from logw (same key): both reduce
    # to the same gathered exp-weight vector before the cumsum/search.
    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    w = jnp.exp(logw - jnp.max(logw))

    op_log = ring_cdf_resample_op(name, AXIS, N, L, weights="log")
    op_exp = ring_cdf_resample_op(name, AXIS, N, L, weights="exp")
    x_l, lw_l, a_l = _run_packed_op(mesh, op_log, kr, X, logw)
    x_e, w_e, a_e = _run_packed_op(mesh, op_exp, kr, X, w)

    np.testing.assert_array_equal(np.asarray(a_l), np.asarray(a_e))
    np.testing.assert_array_equal(np.asarray(x_l), np.asarray(x_e))
    # exp op returns uniform-as-ones; log op returns -log N.
    np.testing.assert_allclose(np.asarray(w_e), 1.0)
    np.testing.assert_allclose(np.asarray(lw_l), -np.log(N), rtol=1e-6)


def test_exp_metropolis_matches_log(mesh, key):
    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    w = jnp.exp(logw - jnp.max(logw))
    op_log = roll_metropolis_sharded_op(AXIS, N, L, weights="log")
    op_exp = roll_metropolis_sharded_op(AXIS, N, L, weights="exp")
    _, _, a_l = _run_packed_op(mesh, op_log, kr, X, logw)
    _, _, a_e = _run_packed_op(mesh, op_exp, kr, X, w)
    # u * w_cur < w_cand <=> log u < lw_cand - lw_cur up to rounding;
    # identical uniforms -> near-identical accept chains.
    assert (np.asarray(a_l) == np.asarray(a_e)).mean() > 0.999


def test_binary_exchange_bitwise_equals_global(mesh, key):
    # exchange="binary" moves the same candidate blocks by a doubling
    # ppermute chain instead of dynamic-source switches — pure data
    # movement with identical key derivation, so EVERY output must be
    # bitwise equal to exchange="global".
    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    op_g = roll_metropolis_sharded_op(AXIS, N, L, exchange="global")
    op_b = roll_metropolis_sharded_op(AXIS, N, L, exchange="binary")
    for pred in (None, True):
        got_g = _run_packed_op(mesh, op_g, kr, X, logw, pred=pred)
        got_b = _run_packed_op(mesh, op_b, kr, X, logw, pred=pred)
        for g, b_ in zip(got_g, got_b):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(b_))


def test_sharded_residual_deterministic_prefix(mesh, key):
    # The first n_det output slots of residual resampling are
    # key-independent (floor-count grid): the sharded op must reproduce
    # the single-device law exactly there, and fill the remainder with
    # draws from the residual distribution.
    from cusmc_tpu.resampling.classic import (
        _residual_parts,
        residual_ancestors,
    )

    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = 2.5 * jax.random.normal(kw, (N,), jnp.float32)

    op = ring_cdf_resample_op("residual", AXIS, N, L, weights="log")
    x_s, _, a_s = _run_packed_op(mesh, op, kr, X, logw)
    a_s = np.asarray(a_s)

    _, n_det, _ = _residual_parts(logw)
    n_det = int(n_det)
    assert 0 < n_det < N  # the fixture weights give a mixed decomposition
    a_single = np.asarray(residual_ancestors(kr, logw))
    np.testing.assert_array_equal(a_s[:n_det], a_single[:n_det])
    # State equals the gather of the op's own ancestors everywhere.
    np.testing.assert_array_equal(np.asarray(x_s),
                                  np.asarray(jnp.take(X, a_s, axis=1)))
    # Offspring counts dominate the floor counts.
    w = np.asarray(jax.nn.softmax(logw))
    floor = np.floor(N * w).astype(int)
    counts = np.bincount(a_s, minlength=N)
    assert (counts >= floor).all()


def test_sharded_residual_exp_matches_log(mesh, key):
    kx, kw, kr = jax.random.split(key, 3)
    X = jax.random.normal(kx, (D, N), jnp.float32)
    logw = jax.random.normal(kw, (N,), jnp.float32)
    w = jnp.exp(logw - jnp.max(logw))
    op_log = ring_cdf_resample_op("residual", AXIS, N, L, weights="log")
    op_exp = ring_cdf_resample_op("residual", AXIS, N, L, weights="exp")
    _, _, a_l = _run_packed_op(mesh, op_log, kr, X, logw)
    _, _, a_e = _run_packed_op(mesh, op_exp, kr, X, w)
    np.testing.assert_array_equal(np.asarray(a_l), np.asarray(a_e))
