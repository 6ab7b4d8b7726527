"""Chain-sharded Metropolis-Hastings over a device mesh.

BASELINE config 5: many chains (e.g. 1024) on a d=128 MVT target with
acceptance-rate adaptation POOLED across all chains — the pooling is a
``pmean`` over the chain mesh axis, so every shard adapts the same step
size and the sharded run is statistically identical to one big vmapped run.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cusmc_tpu.mcmc.metropolis import MHResult, metropolis_hastings_sampler
from cusmc_tpu.parallel.mesh import jit_shard_map, CHAIN_AXIS


def sharded_mh_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    mesh: Mesh,
    axis: str = CHAIN_AXIS,
    keep_samples: bool = False,
    **mh_kwargs,
) -> MHResult:
    """Run ``metropolis_hastings_sampler`` with chains [C, d] sharded over
    ``mesh`` axis ``axis``. ``init_x`` is a global [C, d] array; adaptation
    statistics are pooled with collectives so step-size trajectories match a
    single-device run with the same pooled acceptance sequence."""
    c = init_x.shape[0]
    n_shards = mesh.shape[axis]
    if c % n_shards != 0:
        raise ValueError(f"chains={c} not divisible by axis size {n_shards}")
    if n_shards == 1:
        # 1-shard mesh: pooling is the identity — run the unsharded
        # sampler (same key fold as shard 0) and skip the SPMD program
        # overhead.
        return metropolis_hastings_sampler(
            jax.random.fold_in(key, 0), log_prob, init_x, num_steps,
            keep_samples=keep_samples, **mh_kwargs)

    def local(key, init_local):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return metropolis_hastings_sampler(
            k, log_prob, init_local, num_steps, keep_samples=keep_samples,
            axis_name=axis, **mh_kwargs)

    from cusmc_tpu.mcmc.metropolis import MHState

    out_specs = MHResult(
        state=MHState(x=P(axis), logp=P(axis), log_step=P(),
                      accept_count=P(axis)),
        samples=P(None, axis) if keep_samples else None,
        accept_rate=P(),
        step_size=P(),
    )
    fn = jit_shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                   out_specs=out_specs, check_vma=False)
    return fn(key, init_x)


def sharded_pt_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    mesh: Mesh,
    axis: str = CHAIN_AXIS,
    keep_samples: bool = False,
    **pt_kwargs,
):
    """Chain-sharded parallel tempering (mcmc/tempering.py).

    Replica swaps are CHAIN-LOCAL (each chain column swaps its own rung
    states), so sharding the chain axis needs no state collectives at
    all — only the pooled per-rung acceptance/swap statistics cross
    shards, via the sampler's own ``pmean`` over ``axis``. ``init_x``
    is a global [C, d] (broadcast to every rung) and each shard runs
    the full rung ladder over its chain slice.
    """
    from cusmc_tpu.mcmc.tempering import (
        PTResult,
        PTState,
        parallel_tempering_sampler,
    )

    c = init_x.shape[0]
    n_shards = mesh.shape[axis]
    if c % n_shards != 0:
        raise ValueError(f"chains={c} not divisible by axis size {n_shards}")
    if n_shards == 1:
        return parallel_tempering_sampler(
            jax.random.fold_in(key, 0), log_prob, init_x, num_steps,
            keep_samples=keep_samples, **pt_kwargs)
    if init_x.ndim != 2:
        raise ValueError("sharded PT takes [C, d] init (rungs broadcast)")

    def local(key, init_local):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return parallel_tempering_sampler(
            k, log_prob, init_local, num_steps, keep_samples=keep_samples,
            axis_name=axis, **pt_kwargs)

    out_specs = PTResult(
        state=PTState(x=P(None, axis), logp=P(None, axis), log_step=P(),
                      accept_count=P(), swap_count=P(),
                      ladder_s=P(), swap_ema=P()),
        samples=P(None, axis) if keep_samples else None,
        accept_rate=P(),
        swap_rate=P(),
        step_size=P(),
        betas=P(),
    )
    fn = jit_shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                   out_specs=out_specs, check_vma=False)
    return fn(key, init_x)


def sharded_chees_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    mesh: Mesh,
    axis: str = CHAIN_AXIS,
    keep_samples: bool = False,
    **chees_kwargs,
):
    """Chain-sharded ChEES-HMC (mcmc/chees.py).

    Everything the adaptation needs is a pooled cross-chain expectation
    (the ChEES gradient's means, the acceptance rate, the diagonal-mass
    variance EMA) — each becomes one small ``pmean`` per sweep over
    ``axis``; trajectories are shared by construction, so every shard
    integrates the same number of leapfrog steps and the program stays
    SPMD with no load imbalance.
    """
    from cusmc_tpu.mcmc.chees import ChEESResult, ChEESState, \
        chees_hmc_sampler

    c = init_x.shape[0]
    n_shards = mesh.shape[axis]
    if c % n_shards != 0:
        raise ValueError(f"chains={c} not divisible by axis size {n_shards}")
    if n_shards == 1:
        return chees_hmc_sampler(
            jax.random.fold_in(key, 0), log_prob, init_x, num_steps,
            keep_samples=keep_samples, **chees_kwargs)

    def local(key, init_local):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return chees_hmc_sampler(
            k, log_prob, init_local, num_steps, keep_samples=keep_samples,
            axis_name=axis, **chees_kwargs)

    out_specs = ChEESResult(
        state=ChEESState(x=P(axis), logp=P(axis), grad=P(axis),
                         log_step=P(), log_traj=P(), adam_m=P(),
                         adam_v=P(), var_est=P(), accept_count=P(axis)),
        samples=P(None, axis) if keep_samples else None,
        accept_rate=P(),
        step_size=P(),
        traj_length=P(),
        mean_leapfrog=P(),
        mass_var=P(),
    )
    fn = jit_shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                   out_specs=out_specs, check_vma=False)
    return fn(key, init_x)


def sharded_stretch_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    mesh: Mesh,
    axis: str = CHAIN_AXIS,
    keep_samples: bool = False,
    **st_kwargs,
):
    """Sharded affine-invariant ensemble sampling: each shard runs an
    INDEPENDENT full ensemble over its walker slice (the stretch move
    needs whole-ensemble pairing, so walkers are not split across a
    proposal — parallel independent ensembles of W/P walkers each,
    every one a valid sampler of the same target; samples pool).
    Requires W/P to still satisfy the 2d+2 walker floor.
    """
    from cusmc_tpu.mcmc.ensemble import EnsembleResult, \
        stretch_move_sampler

    w, d_ = init_x.shape
    n_shards = mesh.shape[axis]
    if w % n_shards != 0:
        raise ValueError(f"walkers={w} not divisible by axis {n_shards}")
    if n_shards > 1 and ((w // n_shards) % 2
                         or w // n_shards < 2 * d_ + 2):
        raise ValueError(
            f"each shard's ensemble needs an EVEN walker count >= 2d+2:"
            f" global W={w} over {n_shards} shards gives "
            f"{w // n_shards} walkers/shard for d={d_}")
    if n_shards == 1:
        return stretch_move_sampler(
            jax.random.fold_in(key, 0), log_prob, init_x, num_steps,
            keep_samples=keep_samples, **st_kwargs)

    def local(key, init_local):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis))
        res = stretch_move_sampler(
            k, log_prob, init_local, num_steps,
            keep_samples=keep_samples, **st_kwargs)
        return res.replace(
            accept_rate=jax.lax.pmean(res.accept_rate, axis))

    out_specs = EnsembleResult(
        x=P(axis),
        samples=P(None, axis) if keep_samples else None,
        accept_rate=P(),
    )
    fn = jit_shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                       out_specs=out_specs, check_vma=False)
    return fn(key, init_x)
