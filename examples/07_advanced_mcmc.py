"""The round-5 MCMC stack: fast log-prob closures, ChEES-HMC with
diagonal-mass preconditioning, parallel tempering for a multimodal
target, and convergence diagnostics (split R-hat / multi-chain ESS).

Run: python examples/07_advanced_mcmc.py   (CPU or GPU)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # run from anywhere

import jax
import jax.numpy as jnp
import numpy as np

from cusmc_tpu.diagnostics import mcmc_summary
from cusmc_tpu.distributions import make_mvt_logprob
from cusmc_tpu.mcmc import chees_hmc_sampler, parallel_tempering_sampler

# --- 1. ChEES-HMC on an anisotropic MVT (the NUTS-class workflow) ----
d, chains, steps = 16, 128, 2000
stds = jnp.linspace(1.0, 10.0, d)
cov = jnp.diag(stds ** 2).astype(jnp.float32)
# precomputed-inverse closure: each density eval is one matmul
log_prob = make_mvt_logprob(jnp.zeros(d, jnp.float32), cov, df=8.0)

key = jax.random.key(0, impl="rbg")     # XLA RngBitGenerator keys
init = stds * jax.random.normal(jax.random.key(1), (chains, d),
                                jnp.float32)
res = jax.jit(lambda k: chees_hmc_sampler(
    k, log_prob, init, steps, step_size=0.3, init_traj=0.6))(key)

summ = mcmc_summary(res.samples[steps // 2:])
print("ChEES-HMC:")
print("  accept", round(float(res.accept_rate), 3),
      "| mean leapfrog/step", round(float(res.mean_leapfrog), 1),
      "| learned traj", round(float(res.traj_length), 2))
print("  max R-hat", round(float(np.asarray(summ["rhat"]).max()), 4),
      "| min ESS", int(np.asarray(summ["ess"]).min()),
      "of", steps // 2 * chains, "draws")
mvt_sd = np.asarray(stds) * np.sqrt(8.0 / (8.0 - 2.0))  # t marginal sd
print("  sd recovered / true (first 4):",
      np.round(np.asarray(summ["sd"])[:4] / mvt_sd[:4], 3))

# --- 2. Parallel tempering across a 2-mode target -------------------
SEP = 4.0

def mixture(x):
    a = -0.5 * jnp.sum((x + SEP) ** 2, axis=-1)
    b = -0.5 * jnp.sum((x - SEP) ** 2, axis=-1)
    return jnp.logaddexp(a, b)

init2 = -SEP + 0.5 * jax.random.normal(jax.random.key(2), (64, 2),
                                       jnp.float32)
pt = jax.jit(lambda k: parallel_tempering_sampler(
    k, mixture, init2, 4000, num_rungs=8, beta_min=0.02,
    step_size=0.6, noise_dtype=jnp.bfloat16))(key)
s = np.asarray(pt.samples[2000:])
print("\nParallel tempering (all chains start in the LEFT mode):")
print("  fraction of cold-chain mass in the right mode:",
      round(float((s[..., 0] > 0).mean()), 3), "(target 0.5)")
print("  adjacent-rung swap rates:",
      np.round(np.asarray(pt.swap_rate), 2))
