"""Ensemble-sharded EnKF over a device mesh.

The EnKF is the framework's cheapest algorithm to distribute: the only
global quantities per step are the ensemble moments — O(d + d*k + k*k)
scalars reduced with ``psum``/``pmean`` — so ensemble members never move
between chips (contrast the particle filter, whose resampling must
exchange states; ``cusmc_tpu.parallel.resampling``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cusmc_tpu.parallel.mesh import jit_shard_map, PARTICLE_AXIS
from cusmc_tpu.smc.enkf import EnKFResult, ensemble_kalman_filter


def sharded_ensemble_kalman_filter(
    key: jax.Array,
    model,
    ys: jnp.ndarray,
    num_ensemble: int,
    mesh: Mesh,
    axis: str = PARTICLE_AXIS,
    inflation: float = 1.0,
    F: Optional[jnp.ndarray] = None,
    V: Optional[jnp.ndarray] = None,
) -> EnKFResult:
    """Run the EnKF with the ensemble sharded over ``mesh`` axis ``axis``.
    ``means``/``spread`` are replicated; ``final_ensemble`` stays sharded
    on its member axis."""
    n_shards = mesh.shape[axis]
    if num_ensemble % n_shards != 0:
        raise ValueError(f"num_ensemble={num_ensemble} not divisible by "
                         f"mesh axis {axis!r} size {n_shards}")
    n_local = num_ensemble // n_shards

    def local(key, model, ys):
        return ensemble_kalman_filter(
            key, model, ys, n_local, inflation=inflation, F=F, V=V,
            axis_name=axis, num_ensemble_global=num_ensemble)

    out_specs = EnKFResult(final_ensemble=P(axis), means=P(), spread=P())
    fn = jit_shard_map(local, mesh=mesh, in_specs=(P(), P(), P()),
                   out_specs=out_specs, check_vma=False)
    return fn(key, model, ys)
