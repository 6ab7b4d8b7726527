"""Public API — signature parity with the reference R surface.

The reference exports six functions (``/root/reference/NAMESPACE:3-8``,
implementations under ``R/RcppExports.R`` -> ``src/*.rcpp.cpp``):
``run``, ``MVN``, ``MVNPDF``, ``MVT``, ``MVTPDF``, ``metropolis_hastings``.
This module reproduces each with the same positional arguments and return
structure, minus the R/Rcpp FFI (layers 1-2 of SURVEY.md §1 collapse into
plain Python). Randomness is explicit: every sampling entry point takes an
optional ``key``/``seed`` (the reference seeds from ``time()`` — not
reproducible; defect designed out).

Known reference defects intentionally NOT reproduced (SURVEY.md §7 ledger):
GPU builds returning zeros from MVN()/MVNPDF(), the df/runtime argument swap
in run() -> particle_filter(), and the per-dimension chi-square MVT sampler
(available via ``per_dim_chi=True`` for behavioural comparison).
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from cusmc_tpu.distributions.mvn import mvn_logpdf_cov, mvn_sample_cov
from cusmc_tpu.distributions.mvt import mvt_logpdf_cov, mvt_sample_cov
from cusmc_tpu.models.dlm import DLM
from cusmc_tpu.resampling.metropolis import metropolis_ancestors
from cusmc_tpu.smc.particle_filter import bootstrap_filter

KeyLike = Union[jax.Array, int, None]


def _as_key(key: KeyLike) -> jax.Array:
    if key is None:
        key = 0
    if isinstance(key, int):
        return jax.random.key(key)
    return key


def MVN(mu, sigma, key: KeyLike = None, shape: tuple = (), method: str = "cholesky"):
    """Draw from MVN(mu, sigma). Reference: ``src/mvn_dist.rcpp.cpp:31-48``
    (which, note, passes sigma itself as the square root — SURVEY.md §3.2;
    we factor properly)."""
    mu = jnp.asarray(mu)
    return mvn_sample_cov(_as_key(key), mu, jnp.asarray(sigma, mu.dtype),
                          shape, method)


def MVNPDF(x, mu, sigma, log: bool = False):
    """MVN density at x. Reference: ``src/mvn_dist.rcpp.cpp:52-58`` ->
    ``src/statistics.cc.cpp:183-196``. MVNPDF(0; 0, I2) = 1/(2*pi) =
    0.1591549 (executed example in CuSMC/CuSMC.pdf §2.2)."""
    x = jnp.asarray(x)
    lp = mvn_logpdf_cov(x, jnp.asarray(mu, x.dtype), jnp.asarray(sigma, x.dtype))
    return lp if log else jnp.exp(lp)


def MVT(mu, sigma, nu, key: KeyLike = None, shape: tuple = (),
        method: str = "cholesky", per_dim_chi: bool = False):
    """Draw from MVT(mu, sigma, nu). Reference: ``src/mvt_dist.rcpp.cpp:28-48``."""
    mu = jnp.asarray(mu)
    return mvt_sample_cov(_as_key(key), mu, jnp.asarray(sigma, mu.dtype), nu,
                          shape, method, per_dim_chi)


def MVTPDF(x, mu, sigma, nu, log: bool = False):
    """MVT density at x. Reference: ``src/mvt_dist.rcpp.cpp:60-66`` ->
    ``src/statistics.cc.cpp:295-324``."""
    x = jnp.asarray(x)
    lp = mvt_logpdf_cov(x, jnp.asarray(mu, x.dtype), jnp.asarray(sigma, x.dtype), nu)
    return lp if log else jnp.exp(lp)


def metropolis_hastings(w, N: Optional[int] = None, B: int = 10,
                        key: KeyLike = None, log: bool = False):
    """Standalone Metropolis resampler: weights [N] -> ancestor indices [N].

    Reference: ``src/samplers.rcpp.cpp:35-55`` -> ``src/samplers.cpp:7-36``
    (B=10 default per ``src/mcmc.cpp:291``). ``log=True`` means w are
    log-weights already."""
    w = jnp.asarray(w)
    if N is not None and N != w.shape[0]:
        raise ValueError(f"N={N} != len(w)={w.shape[0]}")
    logw = w if log else jnp.log(w)
    return metropolis_ancestors(_as_key(key), logw, num_steps=B)


def run(N: int, d: int, timeSteps: int, Y, m0, C0, F, G, V, W,
        df: float = 4.0, resampler: str = "metropolis",
        distribution: str = "mvn", p: int = 0,
        key: KeyLike = None, output_dir: Optional[str] = None,
        ess_threshold: Optional[float] = None, dtype=jnp.float32,
        sqrt_method: str = "cholesky", return_diagnostics: bool = False,
        B: int = 10):
    """Full bootstrap particle-filter run; mirrors ``CuSMC::run``
    (``src/run.rcpp.cpp:58-126``, R wrapper ``R/RcppExports.R:66-84``).

    Arguments (positional parity with the reference):
      N particles, d state dim, timeSteps T, Y observations [d, T] (column
      t = y_t, as marshalled at ``run.rcpp.cpp:93-97``; [T, d] also accepted),
      prior (m0, C0), transition (G, W), observation (F, V), MVT df,
      resampler/distribution registry keys, tracked particle p.

    Returns a dict with the reference's R List fields
    (``run.rcpp.cpp:110-125``): ``weights`` [T, N] raw (unnormalized)
    observation densities and ``posterior_x`` [T, N, d]; plus ``ess`` [T] and
    ``log_evidence`` (new diagnostics). ``output_dir`` writes the CSV pair
    like ``writeOutput`` (``src/io.cpp:7-43``).
    """
    Y = np.asarray(Y)
    k_obs = np.asarray(F).shape[0]  # observation dim (may differ from d)
    if Y.shape == (k_obs, timeSteps):
        ys = Y.T
    elif Y.shape == (timeSteps, k_obs):
        ys = Y
    else:
        raise ValueError(
            f"Y shape {Y.shape} matches neither (k,T)=({k_obs},{timeSteps}) "
            f"nor (T,k)")
    model = DLM.create(F=F, G=G, m0=m0, C0=C0, V=V, W=W,
                       df=df if distribution == "mvt" else None,
                       noise=distribution, sqrt_method=sqrt_method, dtype=dtype)
    resampler_kwargs = {"num_steps": B} if resampler == "metropolis" else None
    result = bootstrap_filter(
        _as_key(key), model, jnp.asarray(ys, dtype), N,
        resampler=resampler, resampler_kwargs=resampler_kwargs,
        ess_threshold=ess_threshold, return_history=True)

    weights = jnp.exp(result.obs_loglik)  # raw densities, parity with w_t
    out = {
        "weights": weights,
        "posterior_x": result.particles,
        "ess": result.ess,
        "log_evidence": result.log_evidence,
    }
    if return_diagnostics:
        out["ancestors"] = result.ancestors
        out["obs_loglik"] = result.obs_loglik
    if output_dir is not None:
        from cusmc_tpu.io.data import write_output

        write_output(output_dir, ys, np.asarray(weights),
                     np.asarray(result.particles), p)
    return out
