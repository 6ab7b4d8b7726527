"""Replicated sharded filters over a 2-D mesh (chains x particles).

Composes the framework's two parallel axes: independent filter replicates
(for variance estimation of log-evidence, PMMH pre-runs, or embarrassingly
parallel seeds) shard over the "chains" mesh axis, while EACH replicate's
particles shard over the "particles" axis with the usual collectives. This
is the SMC analog of composing data parallelism with model/sequence
parallelism in NN training: the replicate axis is pure DP (no traffic),
the particle axis carries psum/ppermute collectives over ICI.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cusmc_tpu.models.base import supports_packed
from cusmc_tpu.parallel.mesh import jit_shard_map, CHAIN_AXIS, PARTICLE_AXIS
from cusmc_tpu.parallel.resampling import (
    allgather_resample_op,
    roll_metropolis_sharded_op,
)
from cusmc_tpu.smc.particle_filter import FilterResult, bootstrap_filter


def replicated_sharded_filters(
    key: jax.Array,
    model,
    ys: jnp.ndarray,
    num_particles: int,
    num_replicates: int,
    mesh: Mesh,
    chain_axis: str = CHAIN_AXIS,
    particle_axis: str = PARTICLE_AXIS,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
) -> FilterResult:
    """Run ``num_replicates`` independent filters, each with
    ``num_particles`` particles sharded over ``particle_axis``; replicates
    shard over ``chain_axis``. Returns a FilterResult whose leaves carry a
    leading replicate axis: ``log_evidence`` [R], ``ess`` [R, T],
    ``final_particles`` [R, N, d].
    """
    n_c = mesh.shape[chain_axis]
    n_p = mesh.shape[particle_axis]
    if num_replicates % n_c != 0:
        raise ValueError(f"replicates={num_replicates} not divisible by "
                         f"{chain_axis} size {n_c}")
    if num_particles % n_p != 0:
        raise ValueError(f"particles={num_particles} not divisible by "
                         f"{particle_axis} size {n_p}")
    r_local = num_replicates // n_c
    n_local = num_particles // n_p

    if resampler == "metropolis" and supports_packed(model):
        layout = "packed"
        resample_op = roll_metropolis_sharded_op(
            particle_axis, num_particles, n_local,
            **(resampler_kwargs or {}))
    else:
        layout = "batch"
        resample_op = allgather_resample_op(
            resampler, particle_axis, num_particles, n_local,
            **(resampler_kwargs or {}))

    def local(key, model, ys):
        rep0 = jax.lax.axis_index(chain_axis) * r_local
        rep_keys = jax.vmap(
            lambda r: jax.random.fold_in(key, rep0 + r)
        )(jnp.arange(r_local))

        def one(k):
            return bootstrap_filter(
                k, model, ys, n_local,
                ess_threshold=ess_threshold,
                return_history=False,
                layout=layout,
                axis_name=particle_axis,
                num_particles_global=num_particles,
                resample_op=resample_op)

        return jax.vmap(one)(rep_keys)

    out_specs = FilterResult(
        final_particles=P(chain_axis, particle_axis),
        final_log_weights=P(chain_axis, particle_axis),
        ess=P(chain_axis),
        log_evidence=P(chain_axis),
    )
    fn = jit_shard_map(local, mesh=mesh, in_specs=(P(), P(), P()),
                   out_specs=out_specs, check_vma=False)
    return fn(key, model, ys)
