"""Worker for the 2-process ``jax.distributed`` loopback test
(tests/test_multihost.py::test_two_process_loopback). Runs as a separate
interpreter per process: argv = coordinator host:port, num_processes,
process_id, [logZ_systematic, logZ_metropolis, mh_step, mh_acc,
chees_traj, chees_acc]. Prints
``MULTIHOST_OK <pid> <psum>`` on success.

When the two reference logZ values are given, the worker ALSO runs the
full ``sharded_bootstrap_filter`` (systematic: span-bounded ring exchange
with dynamic-source ppermutes + all_gather; metropolis: per-sweep
dynamic-source ppermute switch) over the process-spanning mesh and
asserts logZ matches the single-process run bitwise-or-within-tolerance
across a real process boundary."""

import os
import sys


def main():
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    refs = [float(a) for a in sys.argv[4:6]]
    mcmc_refs = [float(a) for a in sys.argv[6:10]]
    # 4 virtual CPU devices per process -> 8 global devices over DCN
    # (P=8 > 2*ring_window+1, so the sharded systematic filter takes the
    # span-bounded exchange, not the small-mesh full ring).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cusmc_tpu.parallel.multihost import (
        global_mesh,
        initialize_distributed,
        process_info,
    )

    initialize_distributed(coordinator_address=coord, num_processes=nproc,
                           process_id=pid)
    # Idempotency: a second call must be a silent no-op.
    initialize_distributed(coordinator_address=coord, num_processes=nproc,
                           process_id=pid)

    info = process_info()
    assert info["process_count"] == nproc, info
    assert info["global_devices"] == 4 * nproc, info
    assert info["local_devices"] == 4, info

    try:
        shard_map = jax.shard_map
    except AttributeError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    mesh = global_mesh({"particles": 4 * nproc})
    sharding = NamedSharding(mesh, P("particles"))
    data = np.arange(4 * nproc, dtype=np.float32)
    garr = jax.make_array_from_callback((4 * nproc,), sharding,
                                        lambda idx: data[idx])

    @jax.jit
    def total(x):
        return shard_map(lambda v: jax.lax.psum(jnp_sum(v), "particles"),
                         mesh=mesh, in_specs=P("particles"),
                         out_specs=P())(x)

    import jax.numpy as jnp

    def jnp_sum(v):
        return jnp.sum(v)

    def jnp_arange_state(n):
        col = jnp.arange(n, dtype=jnp.float32)
        return jnp.stack([col, col])  # [2, n], column j == j

    s = total(garr)
    val = float(np.asarray(s.addressable_data(0)))
    expect = float(data.sum())
    assert val == expect, (val, expect)

    if refs:
        # The REAL sharded filter across the process boundary: the
        # collective resample ops (span-bounded ring with its
        # while-loop ppermute, dynamic-source lax.switch ppermutes,
        # all_gather) execute over DCN, not just a psum. The program is
        # identical to the single-process 4-device one, so logZ must
        # match the parent's reference to float tolerance.
        import jax.numpy as jnp2

        from cusmc_tpu.io.data import demo_model_params
        from cusmc_tpu.models.dlm import DLM
        from cusmc_tpu.parallel.filter import sharded_bootstrap_filter

        params = demo_model_params(d=2)
        model = DLM.create(noise="mvn", dtype=jnp2.float32, **params)
        key = jax.random.key(7)
        _, ys = model.simulate(key, 5)
        ys = jnp2.asarray(ys, jnp2.float32)
        for resampler, ref in zip(("systematic", "metropolis"), refs):
            res = sharded_bootstrap_filter(key, model, ys, 64, mesh,
                                           resampler=resampler)
            got = float(np.asarray(
                res.log_evidence.addressable_data(0)))
            assert abs(got - ref) < 1e-4, (resampler, got, ref)
            ess0 = float(np.asarray(res.ess.addressable_data(0))[0])
            assert np.isfinite(ess0), resampler

        # Force the dynamic while-ring to take real iterations ACROSS
        # the process boundary: all weight on a block in the static
        # window's gap, so every slot's state arrives via the
        # dynamic-length ppermute ring.
        from cusmc_tpu.parallel.resampling import ring_cdf_resample_op

        n_r, p_r = 64, 4 * nproc
        l_r = n_r // p_r
        heavy = 4 * l_r + 3
        op = ring_cdf_resample_op("systematic", "particles", n_r, l_r)
        ring_fn = jax.jit(shard_map(
            lambda k, X, lw: op(k, X, lw), mesh=mesh,
            in_specs=(P(), P(None, "particles"), P("particles")),
            out_specs=(P(None, "particles"), P("particles"),
                       P("particles")),
            check_vma=False))
        Xr = jnp_arange_state(n_r)
        lw = np.full((n_r,), -40.0, np.float32)
        lw[heavy] = 0.0
        x_out, _, anc = ring_fn(key, Xr, jnp2.asarray(lw))
        anc_local = np.asarray(anc.addressable_data(0))
        assert (anc_local == heavy).all(), anc_local
        x_local = np.asarray(x_out.addressable_data(0))
        assert np.allclose(x_local, float(heavy)), x_local

    if mcmc_refs:
        # Round-5 session: the chain-sharded SAMPLERS over DCN — pmean
        # pooled adaptation (MH scalar pooling; ChEES vector pooling for
        # the mass diagonal + the shared dynamic-trip-count leapfrog)
        # across the process boundary, asserted equal to the parent's
        # single-process 8-device run of the identical SPMD program.
        import jax.numpy as jnp3

        from cusmc_tpu.parallel import (
            sharded_chees_sampler,
            sharded_mh_sampler,
        )

        mesh_c = global_mesh({"chains": 4 * nproc})
        logp = lambda x: -0.5 * jnp3.sum(x * x, axis=-1)
        key_c = jax.random.key(11)
        init_c = jax.random.normal(jax.random.key(12), (16, 3),
                                   jnp3.float32)
        mh = sharded_mh_sampler(key_c, logp, init_c, 10, mesh_c,
                                adapt_rate=0.1)
        got = [float(np.asarray(mh.step_size.addressable_data(0))),
               float(np.asarray(mh.accept_rate.addressable_data(0)))]
        ch = sharded_chees_sampler(key_c, logp, init_c, 5, mesh_c,
                                   max_leapfrog=8)
        got += [float(np.asarray(ch.traj_length.addressable_data(0))),
                float(np.asarray(ch.accept_rate.addressable_data(0)))]
        for g, r in zip(got, mcmc_refs):
            assert abs(g - r) < 1e-4, (got, mcmc_refs)

    print(f"MULTIHOST_OK {pid} {val}", flush=True)


if __name__ == "__main__":
    main()
