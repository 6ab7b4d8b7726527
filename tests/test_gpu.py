"""Checks that need the GPU: the default device, and the compiled GPU
filter against the CPU backend of the same process. Marked ``gpu``; they
skip on the CPU and run from chip_smoke.py, whose correctness phases hold
the on-card checks against plain references (search, matmul precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.io.data import demo_model_params
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.smc.particle_filter import bootstrap_filter

pytestmark = pytest.mark.gpu


def test_default_device_is_gpu():
    assert jax.devices()[0].platform == "gpu"
    assert jax.numpy.zeros(3).devices() == {jax.devices()[0]}


@pytest.mark.parametrize("resampler", ["systematic", "metropolis"])
def test_filter_gpu_matches_cpu_backend(resampler):
    # Threefry draws are backend-independent, so the GPU and CPU programs
    # see the same noise; only summation order and ties differ.
    params = demo_model_params()
    model = DLM.create(noise="mvt", df=5.0, dtype=jnp.float32, **params)
    ys = jnp.asarray(model.simulate(jax.random.key(2), 50)[1], jnp.float32)

    def run(k, y):
        return bootstrap_filter(k, model, y, 4096, resampler=resampler,
                                return_history=False).log_evidence

    key = jax.random.key(3)
    z_gpu = float(jax.jit(run)(key, ys))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        z_cpu = float(jax.jit(run)(jax.device_put(key, cpu),
                                   jax.device_put(ys, cpu)))
    assert np.isfinite(z_gpu) and np.isfinite(z_cpu)
    assert abs(z_gpu - z_cpu) < 0.05 * max(1.0, abs(z_cpu))
