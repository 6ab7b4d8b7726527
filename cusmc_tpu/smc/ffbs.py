"""Forward-filter backward-simulation (FFBS) smoother.

Genealogy tracing (``smc/smoothing.py``) is free but path-degenerate for
t << T. FFBS (Godsill, Doucet & West 2004) draws M independent smoothing
trajectories by reweighting the stored filter clouds backward with the
transition density:

    w_{t|t+1}^i  ∝  w_t^i · p(x_{t+1}* | x_t^i)

For the DLM the transition term is a Gaussian quadform of
``x_{t+1}* − G x_t^i`` — for M simultaneous paths this is an [M, N]
residual tensor per step, built from two small matmuls and reduced on the
vector units: a dense-batched shape that needs no gathers. Cost
O(T·M·N·d); with M=64, N=4096 it runs the whole backward pass in one
``lax.scan``.

Supports any model exposing ``transition_logpdf(x_next [M,d], x_prev
[N,d]) -> [M,N]``; provided here for DLM and StochasticVolatility.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.models.stochvol import StochasticVolatility
from cusmc_tpu.smc.particle_filter import FilterResult
from cusmc_tpu.utils.linalg import tri_solve


def _dlm_transition_logpdf(model: DLM, x_next: jnp.ndarray,
                           x_prev: jnp.ndarray) -> jnp.ndarray:
    """log p(x_next | x_prev) for all pairs: [M, d] x [N, d] -> [M, N].

    Gaussian or Student-T transition (matching the model's ``noise``).
    Quadform expansion: |Li(a - b)|^2 = |Li a|^2 - 2 (Li a)·(Li b) + |Li b|^2
    — the cross term is ONE [M,d]x[d,N] matmul.
    """
    # W_sqrt is any square root (eigh roots are NOT triangular); rebuild a
    # genuine Cholesky factor from W = W_sqrt W_sqrt^T for the solves.
    # Smoothing weights stay in >= f32 even under state_dtype=bfloat16
    # mixed precision (DLM.create keeps log-densities in the weight dtype).
    wdtype = jnp.promote_types(model.W_sqrt.dtype, jnp.float32)
    W_sqrt = model.W_sqrt.astype(wdtype)
    w_chol = jnp.linalg.cholesky(W_sqrt @ W_sqrt.T)
    za = tri_solve(w_chol, x_next.astype(wdtype))            # [M, d]
    zb = tri_solve(w_chol, (x_prev @ model.G.T).astype(wdtype))  # [N, d]
    cross = za @ zb.T                          # [M, N]
    qa = jnp.sum(za * za, axis=-1)[:, None]
    qb = jnp.sum(zb * zb, axis=-1)[None, :]
    quad = qa - 2.0 * cross + qb
    d = x_next.shape[-1]
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(w_chol)))
    if model.noise == "mvt":
        from jax.scipy.special import gammaln

        df = model.df
        log_norm = (gammaln(0.5 * (df + d)) - gammaln(0.5 * df)
                    - 0.5 * d * (jnp.log(df) + jnp.log(jnp.pi))
                    - half_logdet)
        return log_norm - 0.5 * (df + d) * jnp.log1p(quad / df)
    log_norm = -0.5 * d * jnp.log(2.0 * jnp.pi) - half_logdet
    return log_norm - 0.5 * quad


def _sv_transition_logpdf(model: StochasticVolatility, x_next, x_prev):
    mean = model.mu + model.phi * (x_prev[:, 0] - model.mu)   # [N]
    resid = x_next[:, 0][:, None] - mean[None, :]             # [M, N]
    var = model.sigma ** 2
    return -0.5 * (jnp.log(2.0 * jnp.pi * var) + resid * resid / var)


def transition_logpdf(model, x_next, x_prev):
    if isinstance(model, DLM):
        if model.per_dim_chi:
            raise NotImplementedError(
                "FFBS transition density for the reference's nonstandard "
                "per-dimension-chi MVT is not defined; use per_dim_chi="
                "False (the standard construction)")
        return _dlm_transition_logpdf(model, x_next, x_prev)
    if isinstance(model, StochasticVolatility):
        return _sv_transition_logpdf(model, x_next, x_prev)
    if hasattr(model, "transition_logpdf"):
        return model.transition_logpdf(x_next, x_prev)
    raise NotImplementedError(f"no transition_logpdf for {type(model)}")


def ffbs(key: jax.Array, model, result: FilterResult,
         num_paths: int = 64) -> jnp.ndarray:
    """Draw ``num_paths`` smoothing trajectories; returns [T, M, d].

    ``result`` must come from a run with ``return_history=True``. Filter
    log-weights per step are reconstructed from ``obs_loglik`` (valid for
    resample-every-step runs, the default)."""
    if result.particles is None:
        raise ValueError("ffbs needs return_history=True")
    particles = result.particles      # [T, N, d]
    logw = result.obs_loglik          # [T, N] (unnormalized per step)
    num_steps = particles.shape[0]

    k_last, k_scan = jax.random.split(key)
    idx_last = jax.random.categorical(k_last, result.final_log_weights,
                                      shape=(num_paths,))
    x_last = particles[-1][idx_last]  # [M, d]

    def back(x_next, t):
        # t runs T-2 .. 0; select x_t for each path.
        lw_pair = transition_logpdf(model, x_next, particles[t])  # [M, N]
        lw = logw[t][None, :] + lw_pair
        kt = jax.random.fold_in(k_scan, t)
        idx = jax.random.categorical(kt, lw, axis=-1)             # [M]
        x_t = particles[t][idx]
        return x_t, x_t

    ts = jnp.arange(num_steps - 2, -1, -1)
    _, xs_rev = lax.scan(back, x_last, ts)
    return jnp.concatenate([xs_rev[::-1], x_last[None]], axis=0)
