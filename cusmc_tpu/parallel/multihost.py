"""Multi-host (DCN) initialization and process-spanning meshes.

The reference is strictly single-process/single-GPU (no MPI/NCCL anywhere —
``/root/reference/src/Makevars:14``; SURVEY.md §2). The scale-out path
is: ``jax.distributed.initialize`` once per host process, then the SAME
SPMD programs (``sharded_bootstrap_filter``, ``sharded_mh_sampler``) over a
mesh spanning all hosts' devices — XLA routes collectives within a host
and across hosts automatically.

Single-host runs need none of this; every function degrades gracefully.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize JAX's multi-host runtime (idempotent, no-op for 1 host).

    Pass the three arguments explicitly (coordinator "host:port"); only
    managed cluster environments can auto-detect them. Call
    before any device access in every host process.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if jax.distributed.is_initialized():  # documented idempotency check
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def global_mesh(axis_sizes: Optional[dict] = None) -> Mesh:
    """Mesh over ALL devices across hosts (jax.devices() is global after
    initialize). Defaults to one "particles" axis spanning everything."""
    from cusmc_tpu.parallel.mesh import make_mesh

    return make_mesh(axis_sizes)


def process_info() -> dict:
    """Host/process topology summary for logging."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
