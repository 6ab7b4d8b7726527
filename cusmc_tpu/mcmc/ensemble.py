"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move,
the `emcee` algorithm).

Rounds out the MCMC family with the popular no-tuning option: proposals
are built from the ensemble's own geometry (walker i stretches toward a
random partner j), so correlated and badly-scaled targets need neither a
tuned proposal covariance (adaptive-MH) nor gradients (MALA/HMC) — the
move is invariant under every affine reparametrization.

Device mapping: the standard parallelizable variant updates the ensemble in
two half-batches (each half proposes against the OTHER, frozen, half),
so one sweep is two fully vectorized [W/2, d] updates inside the usual
``lax.scan`` — no per-walker loop. Partner selection is the one gather
([W/2, d] rows from the complementary half); at typical walker counts
(hundreds) it is a rounding error next to the density evaluation.

The reference has one sampler total (random-walk Metropolis over weight
vectors, ``/root/reference/src/samplers.cpp:7-36``).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax import lax


class EnsembleResult(struct.PyTreeNode):
    x: jnp.ndarray                  # [W, d] final walkers
    samples: Optional[jnp.ndarray]  # [T, W, d]
    accept_rate: jnp.ndarray        # scalar


def stretch_move_sampler(
    key: jax.Array,
    log_prob: Callable,
    init_x: jnp.ndarray,
    num_steps: int,
    a: float = 2.0,
    keep_samples: bool = True,
    thin: int = 1,
) -> EnsembleResult:
    """Run ``num_steps`` stretch-move sweeps over [W, d] walkers.

    ``a`` is the stretch scale (2.0 is the universal default): z is
    drawn from g(z) ∝ 1/sqrt(z) on [1/a, a] via z = ((a-1)u + 1)^2 / a,
    the proposal is ``x_j + z (x_i - x_j)``, accepted with probability
    ``min(1, z^(d-1) p(y)/p(x_i))``.

    Walker-count guidance (Goodman & Weare): use W >= 2d+2, even —
    enforced here (the ensemble spans the proposal space; too few
    walkers cannot).
    """
    w, d = init_x.shape
    if w % 2 or w < 2 * d + 2:
        raise ValueError(
            f"stretch move needs an EVEN walker count >= 2d+2 "
            f"(got W={w}, d={d})")
    half = w // 2
    dtype = init_x.dtype

    logp0 = log_prob(init_x)

    def half_update(key, x_mine, logp_mine, x_other):
        kz, kj, ku = jax.random.split(key, 3)
        u = jax.random.uniform(kz, (half,), dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        j = jax.random.randint(kj, (half,), 0, half)
        partner = x_other[j]
        y = partner + z[:, None] * (x_mine - partner)
        logp_y = log_prob(y)
        log_alpha = (d - 1.0) * jnp.log(z) + logp_y - logp_mine
        accept = jnp.log(jax.random.uniform(ku, (half,), dtype)) < log_alpha
        x_new = jnp.where(accept[:, None], y, x_mine)
        logp_new = jnp.where(accept, logp_y, logp_mine)
        return x_new, logp_new, jnp.mean(accept.astype(dtype))

    def body(carry, t):
        x, logp = carry
        k_t = jax.random.fold_in(key, t)
        k1, k2 = jax.random.split(k_t)
        xa, la = x[:half], logp[:half]
        xb, lb = x[half:], logp[half:]
        xa, la, acc_a = half_update(k1, xa, la, xb)
        xb, lb, acc_b = half_update(k2, xb, lb, xa)
        x = jnp.concatenate([xa, xb], axis=0)
        logp = jnp.concatenate([la, lb], axis=0)
        out = (x,) if keep_samples else ((),)
        return (x, logp), (out, 0.5 * (acc_a + acc_b))

    (x, _), (outs, accs) = lax.scan(body, (init_x, logp0),
                                    jnp.arange(num_steps))
    samples = None
    if keep_samples:
        (xs,) = outs
        samples = xs[::thin] if thin > 1 else xs
    return EnsembleResult(x=x, samples=samples,
                          accept_rate=jnp.mean(accs))
