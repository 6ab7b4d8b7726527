"""Metropolis resampler (Murray et al., arXiv:1202.6163).

Replacement for ``Sampler::metropolis_hastings``
(``/root/reference/src/samplers.cpp:7-36``): each particle i runs a B-step
independent Metropolis chain over ancestor indices, accepting candidate j
over current k with probability ``min(1, w[j]/w[k])`` (reference
``src/samplers.cpp:28-33``). No prefix-sum or normalization is needed —
only weight *ratios* — which is why the reference picked it for GPUs and
why it vectorizes cleanly here: every chain advances in lockstep as one
``[N]``-wide gather + compare per sweep.

Differences from the reference (defects designed out, SURVEY.md §7):
- log-weights (the reference compares raw densities, underflowing at d≳16);
- counter-based per-sweep keys instead of one shared, racy mt19937
  (``src/samplers.cpp:11,17-18``);
- B is a static argument (reference hard-codes B=10 at ``src/mcmc.cpp:291``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def metropolis_ancestors(key: jax.Array, log_weights: jnp.ndarray,
                         num_steps: int = 10) -> jnp.ndarray:
    """Ancestor indices [N] via B-step vectorized Metropolis chains.

    ``log_weights`` may be unnormalized. Returns int32 indices into [0, N).
    """
    n = log_weights.shape[0]
    init = jnp.arange(n, dtype=jnp.int32)

    def sweep(b, k):
        kb = jax.random.fold_in(key, b)
        kj, ku = jax.random.split(kb)
        j = jax.random.randint(kj, (n,), 0, n, dtype=jnp.int32)
        log_u = jnp.log(jax.random.uniform(ku, (n,), dtype=log_weights.dtype))
        accept = log_u < (log_weights[j] - log_weights[k])
        return jnp.where(accept, j, k)

    return lax.fori_loop(0, num_steps, sweep, init)
