"""Dynamic linear model (state-space model) specification.

The model the reference filter targets (``/root/reference/src/mcmc.cpp``,
SURVEY.md §0):

    x_0 ~ Dist(m0, C0)                        (initialize, mcmc.cpp:44-88)
    x_t = G x_{t-1} + w_t,  w_t ~ Dist(0, W)  (propagate_K, mcmc.cpp:90-160)
    y_t = F x_t + v_t,      v_t ~ Dist(0, V)  (reweight_G,  mcmc.cpp:162-237)

with Dist in {MVN, MVT(df)}. The reference re-derives factorizations each
run (eigenSolver of C0 at mcmc.cpp:69-71, of W at :278-280; V determinant and
inverse at :275-277); here they are precomputed once into an immutable pytree
that traces straight through ``jit``/``scan``/``shard_map``.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct
from jax.scipy.special import gammaln

from cusmc_tpu.distributions.mvn import mvn_logpdf, mvn_sample
from cusmc_tpu.distributions.mvt import mvt_logpdf, mvt_sample
from cusmc_tpu.ops.packed import matvec, quadform
from cusmc_tpu.ops.random import MAX_INTEGER_DF, chi2_integer_df, fast_gamma
from cusmc_tpu.utils.linalg import chol_sqrt, cov_sqrt


def _mm(a, b, out_dtype=None):
    """Batch-layout matmul at full f32 precision (see ops/packed.py)."""
    return jnp.matmul(a, b, preferred_element_type=out_dtype,
                      precision=jax.lax.Precision.HIGHEST)


class DLM(struct.PyTreeNode):
    """Immutable DLM spec with precomputed covariance factors.

    ``noise`` selects the family for ALL THREE of prior / transition /
    observation noise, matching the reference's single ``distribution``
    option (``src/run.rcpp.cpp:58-62``). ``df`` is used only for "mvt".
    """

    F: jnp.ndarray            # [k, d] observation matrix
    G: jnp.ndarray            # [d, d] transition matrix
    m0: jnp.ndarray           # [d] prior mean
    C0_sqrt: jnp.ndarray      # [d, d] prior covariance square root
    W_sqrt: jnp.ndarray       # [d, d] transition covariance square root
    V_chol: jnp.ndarray       # [k, k] observation covariance Cholesky factor
    V_chol_inv: jnp.ndarray = None  # [k, k] inverse Cholesky (packed path)
    df: Optional[jnp.ndarray] = None
    noise: str = struct.field(pytree_node=False, default="mvn")
    per_dim_chi: bool = struct.field(pytree_node=False, default=False)
    # Static copy of df when it is a concrete small integer: enables the
    # exact sum-of-exponentials chi-square (ops/random.chi2_integer_df),
    # one log pass instead of the Marsaglia-Tsang rounds on the hot path.
    # None when df is traced (e.g. PMMH tunes it) or non-integer.
    df_int: Optional[int] = struct.field(pytree_node=False, default=None)

    @classmethod
    def create(cls, F, G, m0, C0, V, W, df=None, noise: str = "mvn",
               sqrt_method: str = "cholesky", dtype=jnp.float32,
               per_dim_chi: bool = False, state_dtype=None) -> "DLM":
        """``state_dtype`` (e.g. ``jnp.bfloat16``) enables mixed precision:
        the particle state, transition factors (G, W_sqrt, C0_sqrt, m0, F)
        and their matmuls run in ``state_dtype``, while the weight path
        (V factors, df, log-densities, resampling) stays in ``dtype``.
        Matmuls feeding the likelihood accumulate in ``dtype``
        (bf16 x bf16 -> f32), so log-evidence stays accurate while the
        memory traffic over the [d, N] state halves."""
        sdtype = dtype if state_dtype is None else state_dtype
        F = jnp.asarray(F, sdtype)
        G = jnp.asarray(G, sdtype)
        m0 = jnp.asarray(m0, sdtype)
        if noise == "mvt" and df is None:
            raise ValueError("mvt noise requires df")
        V_chol = chol_sqrt(jnp.asarray(V, dtype))
        eye_k = jnp.eye(V_chol.shape[-1], dtype=dtype)
        V_chol_inv = jax.scipy.linalg.solve_triangular(V_chol, eye_k,
                                                       lower=True)
        df_int = None
        if noise == "mvt":
            try:
                df_f = float(df)  # raises on traced df (PMMH)
                if df_f.is_integer() and 1 <= df_f <= MAX_INTEGER_DF:
                    df_int = int(df_f)
            except (TypeError, jax.errors.TracerArrayConversionError):
                pass
        return cls(
            F=F,
            G=G,
            m0=m0,
            C0_sqrt=cov_sqrt(jnp.asarray(C0, dtype), sqrt_method).astype(sdtype),
            W_sqrt=cov_sqrt(jnp.asarray(W, dtype), sqrt_method).astype(sdtype),
            V_chol=V_chol,
            V_chol_inv=V_chol_inv,
            df=None if df is None else jnp.asarray(df, dtype),
            noise=noise,
            per_dim_chi=per_dim_chi,
            df_int=df_int,
        )

    @property
    def state_dim(self) -> int:
        return self.G.shape[-1]

    @property
    def obs_dim(self) -> int:
        return self.F.shape[-2]

    # -- the three phases of the reference filter, as pure batched fns ----

    def sample_initial(self, key: jax.Array, shape: tuple) -> jnp.ndarray:
        """x_0 draws, ``shape + (d,)`` (reference initialize, mcmc.cpp:44-88)."""
        return self._sample(key, self.m0, self.C0_sqrt, shape)

    def propagate(self, key: jax.Array, x_prev: jnp.ndarray) -> jnp.ndarray:
        """x_t | x_{t-1}: mean G @ x_prev plus Dist(0, W) noise for a batch
        [..., d] (reference propagate_K, proposal mean at mcmc.cpp:133)."""
        mean = _mm(x_prev, self.G.T)
        return self._sample(key, mean, self.W_sqrt, x_prev.shape[:-1])

    def propagate_mean(self, x_prev: jnp.ndarray) -> jnp.ndarray:
        """E[x_t | x_{t-1}] — the APF lookahead point (smc/apf.py)."""
        return _mm(x_prev, self.G.T)

    def lookahead_logpdf(self, y: jnp.ndarray, x_prev: jnp.ndarray) -> jnp.ndarray:
        """EXACT predictive log p(y_t | x_{t-1}) = N(y; F G x, F W F' + V)
        (Gaussian case) — gives the fully-adapted APF first stage
        (smc/apf.py), which strictly reduces weight variance vs the point
        lookahead. For MVT noise this Gaussian form is an approximation
        (moment-matched up to the df scale); still a valid lookahead since
        the second-stage weight corrects any first-stage choice exactly."""
        pred_cov = self.F @ self.W_sqrt @ self.W_sqrt.T @ self.F.T \
            + self.V_chol @ self.V_chol.T
        chol = jnp.linalg.cholesky(pred_cov)
        return mvn_logpdf(y - _mm(self.propagate_mean(x_prev), self.F.T),
                          0.0, chol)

    def observation_logpdf(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """log p(y | x) = log Dist(y - F x; 0, V) for batched x [..., d]
        (reference reweight_G, CPU form at mcmc.cpp:212) — in log space."""
        resid = y - _mm(x, self.F.T, self.V_chol.dtype)
        if self.noise == "mvt":
            return mvt_logpdf(resid, 0.0, self.V_chol, self.df)
        return mvn_logpdf(resid, 0.0, self.V_chol)

    def _sample(self, key, mean, scale, shape):
        if self.noise == "mvt":
            return mvt_sample(key, mean, scale, self.df, shape, self.per_dim_chi)
        return mvn_sample(key, mean, scale, shape)

    # -- packed [d, N] layout (the hot path; see ops/packed.py) -----------

    def sample_initial_packed(self, key: jax.Array, n: int) -> jnp.ndarray:
        """x_0 draws in packed layout [d, n]."""
        return self._sample_packed(key, self.m0[:, None], self.C0_sqrt, n)

    def propagate_packed(self, key: jax.Array, X_prev: jnp.ndarray) -> jnp.ndarray:
        """X_t | X_{t-1} for packed X [d, n]: mean G @ X plus Dist(0, W)."""
        mean = matvec(self.G, X_prev)
        return self._sample_packed(key, mean, self.W_sqrt, X_prev.shape[-1])

    def observation_logpdf_packed(self, y: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
        """log p(y | x) for packed X [d, n] -> [n], via the precomputed
        inverse Cholesky of V (single fused pass, no triangular solve)."""
        k = self.obs_dim
        wdtype = self.V_chol.dtype  # f32 weight path under mixed precision
        resid = y[:, None].astype(wdtype) - matvec(self.F, X,
                                                   out_dtype=wdtype)
        quad = quadform(self.V_chol_inv, resid)
        half_logdet = jnp.sum(jnp.log(jnp.diagonal(self.V_chol)))
        if self.noise == "mvt":
            df = self.df
            log_norm = (gammaln(0.5 * (df + k)) - gammaln(0.5 * df)
                        - 0.5 * k * (jnp.log(df) + math.log(math.pi))
                        - half_logdet)
            return log_norm - 0.5 * (df + k) * jnp.log1p(quad / df)
        log_norm = -0.5 * k * math.log(2.0 * math.pi) - half_logdet
        return log_norm - 0.5 * quad

    def _sample_packed(self, key, mean, scale, n):
        """mean [d, n] (or [d, 1]) + scale @ z with z [d, n] ~ N(0, I);
        MVT applies the chi-square scale mixture on the lane axis."""
        d = scale.shape[-1]
        dtype = scale.dtype
        if self.noise == "mvt":
            kz, kg = jax.random.split(key)
            z = jax.random.normal(kz, (d, n), dtype)
            lz = matvec(scale, z)
            df = self.df
            shape = (d, n) if self.per_dim_chi else (1, n)
            # Chi-square scale in the weight dtype (f32 under mixed
            # precision — log/sqrt of bf16 uniforms is too coarse), cast
            # once to the state dtype for the multiply.
            gdtype = self.V_chol.dtype
            if self.df_int is not None:
                # Exact one-log chi-square for small integer df — the
                # common case, one log pass (ops/random.chi2_integer_df).
                g = chi2_integer_df(kg, self.df_int, shape, gdtype)
            else:
                # fast_gamma: fixed-round Marsaglia-Tsang, no
                # data-dependent rejection loop (ops/random.py).
                g = 2.0 * fast_gamma(kg, 0.5 * df, shape, gdtype)
            return mean + lz * jnp.sqrt(df / g).astype(dtype)
        z = jax.random.normal(key, (d, n), dtype)
        return mean + matvec(scale, z)

    # -- data generation --------------------------------------------------

    def sample_observation(self, key: jax.Array, x: jnp.ndarray) -> jnp.ndarray:
        """y | x ~ Dist(F x, V) for batched x [..., d] -> [..., k]
        (predictive sampling; smc/forecast.py)."""
        mean = x @ self.F.T
        noise = self._sample(key, jnp.zeros(self.obs_dim, x.dtype),
                             self.V_chol, x.shape[:-1])
        return mean + noise

    def simulate(self, key: jax.Array, num_steps: int):
        """Draw a latent path and observations (reference generateInput,
        mcmc.cpp:6-42). Returns (xs [T, d], ys [T, k]); row 0 of ys is zero
        like the bundled y_t.csv (its first row is '0,0')."""
        k0, key = jax.random.split(key)
        x0 = self.sample_initial(k0, ())

        def step(x, kt):
            kp, ko = jax.random.split(kt)
            x_next = self.propagate(kp, x)
            resid_scale = self.V_chol
            y = x_next @ self.F.T + self._sample(ko, jnp.zeros(self.obs_dim,
                                                              x.dtype),
                                                 resid_scale, ())
            return x_next, (x_next, y)

        keys = jax.random.split(key, num_steps - 1)
        _, (xs, ys) = jax.lax.scan(step, x0, keys)
        xs = jnp.concatenate([x0[None], xs], axis=0)
        ys = jnp.concatenate([jnp.zeros((1, self.obs_dim), ys.dtype), ys], axis=0)
        return xs, ys
