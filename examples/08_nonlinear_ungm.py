"""Nonlinear/non-Gaussian filtering: the UNGM benchmark (bimodal
posteriors, time-varying drift — the regime where the Kalman filter is
inapplicable and bootstrap particle filtering is the textbook answer).

Run: python examples/08_nonlinear_ungm.py   (CPU or GPU)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from cusmc_tpu.models import UNGM
from cusmc_tpu.smc.particle_filter import bootstrap_filter

model = UNGM.create(q=10.0, r=1.0)
xs_true, ys = model.simulate(jax.random.key(7), 200)

res = jax.jit(lambda k: bootstrap_filter(
    k, model, ys, 16384, resampler="systematic",
    return_history=True))(jax.random.key(0))

hist = np.asarray(res.particles)[..., 0]           # [T, N]
ll = np.asarray(res.obs_loglik)
w = np.exp(ll - ll.max(axis=1, keepdims=True))
w /= w.sum(axis=1, keepdims=True)
pf_mean = (w * hist).sum(-1)

x_np = np.asarray(xs_true)
print("UNGM bootstrap filter (N=16384, T=200):")
print("  logZ:", round(float(res.log_evidence), 1),
      "| final ESS:", int(np.asarray(res.ess)[-1]))
print("  RMSE(posterior mean, truth):",
      round(float(np.sqrt(np.mean((pf_mean[1:] - x_np[1:]) ** 2))), 3),
      " (obs noise sd = 1; y = x^2/20 makes the sign unidentifiable,",
      "so the error is dominated by the bimodal steps)")
# bimodality: fraction of steps where the cloud straddles both signs
straddle = float(((w * (hist > 0)).sum(-1) * (w * (hist < 0)).sum(-1)
                  > 0.05).mean())
print("  fraction of steps with mass on BOTH modes:", round(straddle, 2))
