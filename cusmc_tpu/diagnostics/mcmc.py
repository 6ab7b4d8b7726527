"""MCMC convergence diagnostics: split-R-hat and autocorrelation ESS.

The reference ships no convergence tooling of any kind (its MH driver
returns raw draws, ``/root/reference/src/mcmc.cpp:239-309``); these are
the standard companions to the multi-chain samplers in ``mcmc/`` —
exactly the quantities the many-chain layout makes cheap, since both
reduce over the chain axis the samplers already batch.

Implementations follow the Stan reference formulations (Vehtari et al.
2021): SPLIT R-hat (halved chains catch within-chain drift) and the
FFT-based multi-chain autocorrelation ESS with Geyer's initial-positive
and initial-monotone truncation. Everything is jit-friendly: the Geyer
truncation is a vectorized mask (cumulative product of pair-sum
positivity) rather than a data-dependent loop, so the whole diagnostic
runs on device over [T, C, d] sample stacks.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _split_chains(samples: jnp.ndarray) -> jnp.ndarray:
    """[T, C, ...] -> [T//2, 2C, ...] (drop the odd last draw)."""
    t = samples.shape[0] - (samples.shape[0] % 2)
    half = t // 2
    return jnp.concatenate([samples[:half], samples[half:t]], axis=1)


def split_rhat(samples: jnp.ndarray) -> jnp.ndarray:
    """Split potential-scale-reduction R-hat.

    ``samples`` [T, C] or [T, C, d]; returns a scalar or [d]. Values
    near 1 indicate mixed chains; > 1.01 (Vehtari et al.) means the
    chains disagree in mean or variance — run longer.
    """
    x = _split_chains(jnp.asarray(samples))
    n = x.shape[0]
    chain_mean = jnp.mean(x, axis=0)                  # [2C, ...]
    chain_var = jnp.var(x, axis=0, ddof=1)            # [2C, ...]
    w = jnp.mean(chain_var, axis=0)                   # within
    b = n * jnp.var(chain_mean, axis=0, ddof=1)       # between
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / w)


def _autocov_fft(x: jnp.ndarray) -> jnp.ndarray:
    """Per-chain biased autocovariance via FFT. x [T, C, ...] ->
    acov [T, C, ...] (lag along axis 0, normalized by T)."""
    t = x.shape[0]
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    nfft = 2 * t  # zero-pad to avoid circular wrap
    f = jnp.fft.rfft(xc, n=nfft, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=0)[:t]
    return jnp.real(acov) / t


def effective_sample_size_chains(samples: jnp.ndarray) -> jnp.ndarray:
    """Multi-chain autocorrelation ESS (bulk ESS on the raw draws).

    ``samples`` [T, C] or [T, C, d]; returns a scalar or [d]: the
    equivalent number of independent draws among the T*C dependent ones.
    """
    x = _split_chains(jnp.asarray(samples))
    n, m = x.shape[0], x.shape[1]
    acov = _autocov_fft(x)                            # [n, m, ...]
    chain_var = acov[0] * n / (n - 1.0)               # [m, ...]
    w = jnp.mean(chain_var, axis=0)
    mean_acov = jnp.mean(acov, axis=1)                # [n, ...]
    chain_mean = jnp.mean(x, axis=0)
    b_over_n = jnp.var(chain_mean, axis=0, ddof=1)
    var_plus = (n - 1.0) / n * w + b_over_n

    # rho_t, t >= 1 (Stan's combined-chain estimator)
    rho = 1.0 - (w - mean_acov) / var_plus            # [n, ...]

    # Geyer pairs P_k = rho_{2k} + rho_{2k+1} (P_0 includes rho_0 ~ 1,
    # so the first pair is always positive) — vectorized initial-
    # positive (stop at first non-positive pair) + initial-monotone
    # (cummin) truncation; tau = -1 + 2 sum P_k.
    npair = n // 2
    p = rho[:2 * npair]
    pair = p[0::2] + p[1::2]                          # [npair, ...]
    pos = jnp.cumprod((pair > 0.0).astype(x.dtype), axis=0)
    pair_mono = lax.associative_scan(
        jnp.minimum, jnp.where(pos > 0, pair, jnp.inf), axis=0)
    tau = -1.0 + 2.0 * jnp.sum(
        jnp.where(pos > 0, jnp.maximum(pair_mono, 0.0), 0.0), axis=0)
    tau = jnp.maximum(tau, 1.0 / jnp.log10(jnp.asarray(n * m, x.dtype)))
    return n * m / tau


def _rank_normalize(x: jnp.ndarray) -> jnp.ndarray:
    """Fractional ranks over all draws (per trailing dim), mapped through
    the normal quantile function (Blom offsets) — the transform behind
    Vehtari et al.'s rank-normalized diagnostics. Robust to heavy tails
    and monotone reparametrization."""
    from jax.scipy.special import ndtri
    t, c = x.shape[0], x.shape[1]
    flat = x.reshape((t * c,) + x.shape[2:])
    order = jnp.argsort(flat, axis=0)
    ranks = jnp.argsort(order, axis=0).astype(x.dtype) + 1.0
    z = ndtri((ranks - 0.375) / (t * c + 0.25))
    return z.reshape(x.shape)


def rank_normalized_rhat(samples: jnp.ndarray) -> jnp.ndarray:
    """The Vehtari et al. (2021) recommended R-hat: the max of the split
    R-hat on rank-normalized draws (location disagreement) and on
    rank-normalized FOLDED draws |x - median| (scale disagreement)."""
    samples = jnp.asarray(samples)
    bulk = split_rhat(_rank_normalize(samples))
    med = jnp.median(samples.reshape((-1,) + samples.shape[2:]), axis=0)
    folded = split_rhat(_rank_normalize(jnp.abs(samples - med)))
    return jnp.maximum(bulk, folded)


def ess_tail(samples: jnp.ndarray, prob: float = 0.05) -> jnp.ndarray:
    """Tail ESS: the smaller of the ESS of the two tail-indicator
    sequences I(x <= q_prob) and I(x >= q_{1-prob}) — how reliably the
    chains estimate tail quantiles (slow tails hide from bulk ESS)."""
    samples = jnp.asarray(samples)
    flat = samples.reshape((-1,) + samples.shape[2:])
    qlo = jnp.quantile(flat, prob, axis=0)
    qhi = jnp.quantile(flat, 1.0 - prob, axis=0)
    dt = samples.dtype
    lo = effective_sample_size_chains((samples <= qlo).astype(dt))
    hi = effective_sample_size_chains((samples >= qhi).astype(dt))
    return jnp.minimum(lo, hi)


def mcmc_summary(samples: jnp.ndarray) -> dict:
    """Per-dimension posterior summary for a [T, C, d] sample stack:
    mean, sd, rank-normalized folded R-hat, bulk ESS (rank-normalized),
    tail ESS, and bulk ESS per draw."""
    samples = jnp.asarray(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    ess = effective_sample_size_chains(_rank_normalize(samples))
    return {
        "mean": jnp.mean(flat, axis=0),
        "sd": jnp.std(flat, axis=0, ddof=1),
        "rhat": rank_normalized_rhat(samples),
        "ess": ess,
        "ess_tail": ess_tail(samples),
        "ess_per_draw": ess / (samples.shape[0] * samples.shape[1]),
    }
