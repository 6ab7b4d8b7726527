"""Covariance factorization helpers.

The reference factorizes covariances with an eigendecomposition square root
``Q = U @ sqrt(diag(lambda))`` (``/root/reference/src/linear_algebra.cpp:10-23``,
used for C0 at ``src/mcmc.cpp:69-71`` and W at ``src/mcmc.cpp:278-280``).

We default to a Cholesky factor (one triangular matmul, and the natural
input to triangular-solve based log-densities), but keep the
eigh square root available for covariance matrices that are only positive
*semi*-definite, where Cholesky fails.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def chol_sqrt(cov: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Lower-triangular Cholesky factor L with L @ L.T == cov."""
    if jitter:
        cov = cov + jitter * jnp.eye(cov.shape[-1], dtype=cov.dtype)
    return jnp.linalg.cholesky(cov)


def eigh_sqrt(cov: jnp.ndarray) -> jnp.ndarray:
    """Symmetric eigendecomposition square root ``U @ sqrt(diag(w))``.

    Mirrors the reference's ``eigenSolver`` (``src/linear_algebra.cpp:10-23``):
    any PSD matrix works (eigenvalues clipped at 0). The result Q satisfies
    ``Q @ Q.T == cov`` but is not triangular.
    """
    w, u = jnp.linalg.eigh(cov)
    w = jnp.clip(w, 0.0, None)
    return u * jnp.sqrt(w)[..., None, :]


def cov_sqrt(cov: jnp.ndarray, method: str = "cholesky") -> jnp.ndarray:
    """Factor ``cov`` into Q with Q @ Q.T == cov.

    method: "cholesky" (default, requires PD) or "eigh" (PSD-robust parity
    with the reference's eigenSolver).
    """
    if method == "cholesky":
        return chol_sqrt(cov)
    if method == "eigh":
        return eigh_sqrt(cov)
    raise ValueError(f"unknown cov sqrt method: {method!r}")


def tri_solve(chol: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L z = b for z with L lower triangular [d, d]; b is [..., d].

    The batch collapses into a single multi-RHS triangular solve
    (one [d, d] x [d, B] op, no per-row dispatch).
    """
    batch = b.shape[:-1]
    d = b.shape[-1]
    flat = b.reshape(-1, d)
    z = lax.linalg.triangular_solve(chol, flat.T, left_side=True, lower=True)
    return z.T.reshape(*batch, d)


def tri_inverse(chol: jnp.ndarray) -> jnp.ndarray:
    """Explicit inverse of a lower-triangular [d, d] factor.

    For densities evaluated MANY times against one fixed covariance
    (MCMC scan bodies), precomputing ``Linv`` turns every per-step
    triangular solve into a single matmul ``(x - mean) @ Linv.T``.
    One solve at trace time; numerically
    equivalent to ``tri_solve`` at f32 for well-conditioned factors.
    """
    d = chol.shape[-1]
    return lax.linalg.triangular_solve(
        chol, jnp.eye(d, dtype=chol.dtype), left_side=True, lower=True)


def log_det_from_chol(chol: jnp.ndarray) -> jnp.ndarray:
    """log|Sigma| from its Cholesky factor: 2 * sum(log diag L)."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
