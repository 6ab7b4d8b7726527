"""Large-mesh program-size / compile-time check on a virtual CPU mesh.

The sharded programs embed per-shard collective
instances whose count can grow with mesh size P — the metropolis op's
per-sweep dynamic-source `lax.switch` holds P ppermute branches x B
sweeps, and the (round-5) span-bounded ring holds O(K) ppermutes — but
compile time and program size had never been checked at two different P.
This script traces + lowers + compiles one resampling step of each
sharded op at the given P and reports jaxpr collective counts, StableHLO
size, and wall-clock compile time.

Run per P in a fresh process (device count is fixed at startup):

    XLA_FLAGS=--xla_force_host_platform_device_count=8  python benchmarks/compile_scale.py 8
    XLA_FLAGS=--xla_force_host_platform_device_count=64 python benchmarks/compile_scale.py 64
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

P_ARG = int(sys.argv[1]) if len(sys.argv) > 1 else 8
os.environ.setdefault("XLA_FLAGS",
                      f"--xla_force_host_platform_device_count={P_ARG}")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cusmc_tpu.parallel import make_mesh
from cusmc_tpu.parallel.resampling import (
    ring_cdf_resample_op,
    roll_metropolis_sharded_op,
)

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

AXIS = "particles"


from cusmc_tpu.utils.debug import count_primitive


def measure(tag, op, mesh, n, nsh):
    l = n // nsh
    key = jax.random.key(0)
    X = jnp.zeros((2, n), jnp.float32)
    logw = jnp.zeros((n,), jnp.float32)

    fn = shard_map(lambda k, x, w: op(k, x, w), mesh=mesh,
                   in_specs=(P(), P(None, AXIS), P(AXIS)),
                   out_specs=(P(None, AXIS), P(AXIS), P(AXIS)),
                   check_vma=False)
    t0 = time.perf_counter()
    jaxpr = jax.make_jaxpr(fn)(key, X, logw)
    t_trace = time.perf_counter() - t0

    inner = None
    for eqn in jaxpr.jaxpr.eqns:
        if "shard_map" in str(eqn.primitive):
            inner = eqn.params["jaxpr"]
            break
    pp = count_primitive(inner, "ppermute")
    ag = count_primitive(inner, "all_gather")

    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    lowered = jfn.lower(key, X, logw)
    t_lower = time.perf_counter() - t0
    hlo_kb = len(lowered.as_text()) / 1024.0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    try:
        mem = compiled.memory_analysis()
        code_kb = (mem.generated_code_size_in_bytes / 1024.0
                   if mem is not None else float("nan"))
    except Exception:
        code_kb = float("nan")
    print(f"P={nsh:3d} {tag:24s} ppermute={pp:5d} all_gather={ag:2d} "
          f"stablehlo={hlo_kb:8.0f}KB code={code_kb:8.0f}KB "
          f"trace={t_trace:5.2f}s lower={t_lower:5.2f}s "
          f"compile={t_compile:6.2f}s", flush=True)


def main():
    nsh = P_ARG
    assert len(jax.devices()) >= nsh, (len(jax.devices()), nsh)
    mesh = make_mesh({AXIS: nsh})
    n = 256 * nsh  # fixed per-shard size: weak-scaling shape
    measure("ring systematic", ring_cdf_resample_op(
        "systematic", AXIS, n, n // nsh), mesh, n, nsh)
    measure("metropolis global B=10", roll_metropolis_sharded_op(
        AXIS, n, n // nsh, num_steps=10), mesh, n, nsh)
    measure("metropolis binary B=10", roll_metropolis_sharded_op(
        AXIS, n, n // nsh, num_steps=10, exchange="binary"),
        mesh, n, nsh)


if __name__ == "__main__":
    main()
