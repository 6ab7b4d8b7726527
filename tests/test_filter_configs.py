"""The packed XLA filter at every configuration the removed kernel engines
used to cover — {mvn, mvt} noise x {f32, bf16 state} x {metropolis,
systematic} — and the removed engine options raising instead of being
silently ignored."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cusmc_tpu
from cusmc_tpu.config import FilterConfig
from cusmc_tpu.io.data import demo_model_params, load_y_sim
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.smc.kalman import kalman_filter
from cusmc_tpu.smc.particle_filter import bootstrap_filter

T = 101
N = 4096


def _model(noise, state_dtype):
    return DLM.create(noise=noise, df=5.0 if noise == "mvt" else None,
                      dtype=jnp.float32, state_dtype=state_dtype,
                      **demo_model_params())


@pytest.mark.parametrize("resampler", ["metropolis", "systematic"])
@pytest.mark.parametrize("state_dtype", [None, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("noise", ["mvn", "mvt"])
def test_packed_filter_configuration(noise, state_dtype, resampler):
    ys_np = load_y_sim()[:T]
    ys = jnp.asarray(ys_np, jnp.float32)
    model = _model(noise, state_dtype)
    key = jax.random.key(7)
    res = jax.jit(lambda k: bootstrap_filter(
        k, model, ys, N, resampler=resampler, layout="packed"))(key)
    lz = float(res.log_evidence)
    assert np.isfinite(lz)
    assert res.particles.dtype == (state_dtype or jnp.float32)
    assert res.obs_loglik.dtype == jnp.float32
    if noise == "mvn":
        params = demo_model_params()
        _, _, exact = kalman_filter(ys_np, **{k: params[k] for k in (
            "F", "G", "V", "W", "m0", "C0")})
        reference = float(exact)
    else:
        # Student-t noise has no closed form: the batch-layout parity
        # path (indexed resampling, [N, d] state) estimates the same
        # evidence with an independent implementation.
        batch = jax.jit(lambda k: bootstrap_filter(
            k, _model(noise, None), ys, N, resampler=resampler,
            layout="batch", return_history=False))(key)
        reference = float(batch.log_evidence)
    # Metropolis with fixed B = 10 sweeps carries the reference's
    # finite-B resampling bias; systematic is exact.
    tol = 0.08 if resampler == "metropolis" else 0.02
    assert abs(lz - reference) < tol * abs(reference)


def _demo_args():
    p = demo_model_params()
    ys = load_y_sim()[:11]
    return (64, 2, 11, ys, p["m0"], p["C0"], p["F"], p["G"], p["V"],
            p["W"])


@pytest.mark.parametrize("option", ["engine", "pallas_tile",
                                    "pallas_interpret"])
def test_bootstrap_filter_rejects_removed_options(option):
    model = _model("mvn", None)
    ys = jnp.asarray(load_y_sim()[:11], jnp.float32)
    value = {"engine": "pallas", "pallas_tile": 256,
             "pallas_interpret": True}[option]
    with pytest.raises(TypeError, match=option):
        bootstrap_filter(jax.random.key(0), model, ys, 64, **{option: value})


def test_run_rejects_engine():
    with pytest.raises(TypeError, match="engine"):
        cusmc_tpu.run(*_demo_args(), engine="xla")


def test_filter_config_rejects_engine():
    p = {k: np.asarray(v).tolist() for k, v in demo_model_params().items()}
    with pytest.raises(ValueError, match="engine"):
        FilterConfig.from_dict({"num_particles": 64, "model": p,
                                "engine": "auto"})
    with pytest.raises(TypeError, match="engine"):
        FilterConfig(num_particles=64, model=p, engine="auto")
