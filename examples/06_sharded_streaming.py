"""Round-4 features in one script: a particle-sharded STREAMING filter
(out-of-HBM history, checkpointed, failure-guarded) with ESS-adaptive
resampling, plus the ESS-conditioned Metropolis sweep schedule.

Runs anywhere: on a multi-chip mesh the particles shard over devices;
here it demos on however many devices JAX exposes (force 8 virtual CPU
devices with XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import jax
import jax.numpy as jnp
import numpy as np

from cusmc_tpu.io.data import demo_model_params, load_y_sim
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.parallel import make_mesh
from cusmc_tpu.smc.particle_filter import bootstrap_filter
from cusmc_tpu.smc.streaming import streaming_bootstrap_filter

key = jax.random.key(0)
params = demo_model_params()
model = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32, **params)
ys = load_y_sim()[:501]

# --- 1. Sharded streaming filter: the scan carry stays sharded on the
# mesh between chunks; only history blocks cross to the host arena.
n_dev = len(jax.devices())
mesh = make_mesh({"particles": n_dev})
n = 4096 * n_dev
res, store = streaming_bootstrap_filter(
    key, model, ys, n, chunk_steps=64, resampler="systematic",
    ess_threshold=0.5, mesh=mesh)
print(f"sharded streaming over {n_dev} device(s): logZ "
      f"{float(res.log_evidence):.1f}, history {store.view().shape}, "
      f"min ESS {float(np.min(np.asarray(res.ess))):.0f}")

# --- 2. ESS-conditioned Metropolis sweeps: full B=10 budget only on
# sharp-weight steps (see resampling/rolls.py for the thresholds).
out = bootstrap_filter(key, model, jnp.asarray(ys, jnp.float32), 8192,
                       resampler="metropolis",
                       resampler_kwargs={"num_steps": "auto"},
                       return_history=False)
print(f"auto-sweep metropolis: logZ {float(out.log_evidence):.1f}")
