"""Timing / profiling harness.

Replaces the reference's gettimeofday Timer (reference
``src/utility.cpp:18-32``, used around init and the MCMC loop at
``src/particle_filter.cpp:19-38``) with device-aware tooling:

- ``sync_time``: wall-clock a jitted fn, synchronised by reading one
  output element back to the host.
- ``scan_slope``: per-step cost of a scan body measured as the slope
  between two horizon lengths — cancels compile and dispatch latency.
- ``named_scope``: re-export of ``jax.named_scope`` for profiler traces;
  ``trace``: context manager around ``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import time
from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

named_scope = jax.named_scope


def _force(out) -> None:
    leaves = jax.tree_util.tree_leaves(out)
    if leaves:
        np.asarray(leaves[0]).ravel()[:1]


def sync_time(fn: Callable, *args, reps: int = 5) -> float:
    """Best-of-reps wall time (seconds) of ``fn(*args)`` with readback sync.
    ``fn`` should already be jitted; the first (compile) call is excluded."""
    out = fn(*args)
    _force(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _force(out)
        best = min(best, time.perf_counter() - t0)
    return best


def scan_slope(mk_scan: Callable, carry, steps: Tuple[int, int] = (4, 16),
               reps: int = 3) -> float:
    """Per-step seconds of a scan: ``mk_scan(carry, T=T)`` runs T steps.

    Returns (time(T2) - time(T1)) / (T2 - T1) — latency-free per-step cost.
    """
    t1, t2 = steps
    times = []
    for T in (t1, t2):
        f = jax.jit(partial(mk_scan, T=T))
        times.append(sync_time(f, carry, reps=reps))
    return (times[1] - times[0]) / (t2 - t1)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Phase timer mirroring the reference's start/stop/elapsed interface
    (``inst/include/utility.hpp:8-24``) with a sync barrier on stop."""

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, out=None) -> float:
        if out is not None:
            _force(out)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed
