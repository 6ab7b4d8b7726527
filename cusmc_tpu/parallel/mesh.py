"""Device mesh construction for particle / chain sharding.

The reference has NO multi-device support (single GPU, no MPI/NCCL —
``/root/reference/src/Makevars:14`` links only cudart; SURVEY.md §2
"Parallelism strategies"). The design here scales the particle axis (the SMC
analog of data parallelism) and the chain axis across devices via
``jax.sharding.Mesh`` + ``shard_map``, with XLA collectives (NCCL over
NVLink on GPUs). The mesh is flat: it follows the algorithm, not a
device topology.

Axis names:
- "particles": shards the N axis of particle-filter state.
- "chains":    shards the C axis of multi-chain MCMC.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


PARTICLE_AXIS = "particles"
CHAIN_AXIS = "chains"


def make_mesh(axis_sizes: Optional[dict] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh over the given devices.

    ``axis_sizes`` maps axis name -> size, e.g. ``{"particles": 4,
    "chains": 2}``; the product must equal the device count. Default: all
    devices on one "particles" axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = {PARTICLE_AXIS: len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"axis sizes {axis_sizes} != #devices {len(devices)}")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, names)


def particle_sharding(mesh: Mesh, axis: str = PARTICLE_AXIS) -> NamedSharding:
    """Sharding for [N, ...] particle arrays: N split over the mesh axis."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def jit_shard_map(*args, **kwargs):
    """``jax.jit(shard_map(...))`` — the wrapper boundary for every
    sharded entry point in this package.

    ``shard_map`` called eagerly dispatches its body op by op: a
    2000-step sampler scan becomes one dispatch per primitive. Jitting
    at the boundary makes each public sharded function one compiled
    program regardless of how the caller invokes it; nesting inside a
    caller's jit is free.
    """
    return jax.jit(jax.shard_map(*args, **kwargs))
