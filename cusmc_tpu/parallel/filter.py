"""Particle-sharded bootstrap filter over a device mesh.

The reference's only scaling axis is one GPU's thread grid (SURVEY.md §2);
this module is its multi-chip replacement: particles shard over a mesh axis
under ``shard_map``, weight normalization/ESS ride ``psum`` collectives, and
resampling uses the allgather exchange in ``cusmc_tpu.parallel.resampling``.
The scan body is the SAME code as the single-device filter — only the
resample op and the axis name differ.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.parallel.mesh import jit_shard_map, PARTICLE_AXIS
from cusmc_tpu.parallel.resampling import (
    allgather_resample_op,
    ring_cdf_resample_op,
    roll_metropolis_sharded_op,
)
from cusmc_tpu.smc.particle_filter import FilterResult, bootstrap_filter


def sharded_bootstrap_filter(
    key: jax.Array,
    model: DLM,
    ys: jnp.ndarray,
    num_particles: int,
    mesh: Mesh,
    axis: str = PARTICLE_AXIS,
    resampler: str = "systematic",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    return_history: bool = False,
) -> FilterResult:
    """Run the filter with N particles sharded over ``mesh`` axis ``axis``.

    Returns the same ``FilterResult`` as the single-device filter with
    history arrays sharded on their particle dimension. Default
    ``return_history=False``: at the scales that need sharding, the [T,N,d]
    history dominates HBM; diagnostics (ess, log_evidence) are replicated.
    """
    n_shards = mesh.shape[axis]
    if num_particles % n_shards != 0:
        raise ValueError(f"num_particles={num_particles} not divisible by "
                         f"mesh axis {axis!r} size {n_shards}")
    n_local = num_particles // n_shards
    from cusmc_tpu.models.base import supports_packed

    # Metropolis: gather-free global-proposal exchange (packed layout; see
    # roll_metropolis_sharded_op for the exchange="windowed" low-traffic
    # variant). CDF/residual resamplers: the O(n_local*d)-memory ring
    # exchange when the model supports the packed layout, else the
    # allgather fallback (batch layout, O(N*d) memory). Packed ops are
    # built exp-space (weights="exp"): the local filter then carries
    # max-normalized exp weights (psum-fused ESS/normalizer sums, no
    # per-step softmax) — the single-chip fast-path pipeline, sharded.
    if resampler == "metropolis":
        layout = "packed"
        op_weights = "exp"
        resample_op = roll_metropolis_sharded_op(
            axis, num_particles, n_local, weights="exp",
            **(resampler_kwargs or {}))
    elif supports_packed(model):
        layout = "packed"
        op_weights = "exp"
        resample_op = ring_cdf_resample_op(
            resampler, axis, num_particles, n_local, weights="exp",
            **(resampler_kwargs or {}))
    else:
        layout = "batch"
        op_weights = "log"
        resample_op = allgather_resample_op(
            resampler, axis, num_particles, n_local,
            **(resampler_kwargs or {}))

    def local_filter(key, model, ys):
        return bootstrap_filter(
            key, model, ys, n_local,
            ess_threshold=ess_threshold,
            return_history=return_history,
            layout=layout,
            axis_name=axis,
            num_particles_global=num_particles,
            resample_op=resample_op,
            resample_op_weights=op_weights,
        )

    sharded = P(axis)
    repl = P()
    out_specs = FilterResult(
        final_particles=sharded,
        final_log_weights=sharded,
        ess=repl,
        log_evidence=repl,
        particles=P(None, axis) if return_history else None,
        obs_loglik=P(None, axis) if return_history else None,
        ancestors=P(None, axis) if return_history else None,
    )
    fn = jit_shard_map(
        local_filter, mesh=mesh,
        in_specs=(repl, repl, repl),
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(key, model, ys)
