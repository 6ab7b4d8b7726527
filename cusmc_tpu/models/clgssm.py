"""Conditionally linear-Gaussian state-space model (CLGSSM).

Model family for Rao-Blackwellized particle filtering (Doucet, de Freitas,
Murphy & Russell 2000; Schön, Gustafsson & Nordlund 2005) — a north-star
extension of the reference's single hard-wired DLM family
(``/root/reference/src/mcmc.cpp:90-237``; the reference has no
marginalized/conditional structure anywhere):

    u_t ~ f(u_t | u_{t-1})                                  (nonlinear, sampled)
    z_t = G(u_t) z_{t-1} + b(u_t) + w_t,  w_t ~ N(0, W(u_t))  (linear, marginalized)
    y_t = F(u_t) z_t     + c(u_t) + v_t,  v_t ~ N(0, V(u_t))

Conditional on a trajectory u_{0:t}, the linear substate z is exactly
Gaussian — the RBPF (smc/rbpf.py) runs one Kalman filter per particle and
only samples u, cutting Monte-Carlo variance versus a bootstrap filter on
the joint (u, z) state.

The conditional-matrix callables take a SINGLE particle's u [p] (plus the
params pytree) and are vmapped by the filter; set ``mats_constant=True``
when F/G/V/W do not depend on u (only the offsets b/c do) to enable the
common-covariance fast path — one shared covariance recursion, per-particle
means only.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
from cusmc_tpu.utils import struct


def _zero_b(params, u, dz):
    return jnp.zeros((dz,), u.dtype)


def _zero_c(params, u, k):
    return jnp.zeros((k,), u.dtype)


class CLGSSM(struct.PyTreeNode):
    """Immutable CLGSSM spec.

    ``sample_initial_nl(params, key, n) -> u0 [n, p]`` and
    ``propagate_nl(params, key, u_prev [n, p]) -> u [n, p]`` are vectorized
    over particles (use ``jax.vmap`` yourself if you write per-particle
    samplers). ``Fmat/Gmat/Vcov/Wcov/b/c`` take ``(params, u[p])`` for one
    particle and return ``[k,dz] / [dz,dz] / [k,k] / [dz,dz] / [dz] / [k]``.
    """

    params: dict
    m0: jnp.ndarray                # [dz] linear-substate prior mean
    C0: jnp.ndarray                # [dz, dz] linear-substate prior covariance
    nl_dim: int = struct.field(pytree_node=False)
    lin_dim: int = struct.field(pytree_node=False)
    obs_dim: int = struct.field(pytree_node=False)
    mats_constant: bool = struct.field(pytree_node=False)
    _sample_initial_nl: Callable = struct.field(pytree_node=False)
    _propagate_nl: Callable = struct.field(pytree_node=False)
    _Fmat: Callable = struct.field(pytree_node=False)
    _Gmat: Callable = struct.field(pytree_node=False)
    _Vcov: Callable = struct.field(pytree_node=False)
    _Wcov: Callable = struct.field(pytree_node=False)
    _b: Callable = struct.field(pytree_node=False)
    _c: Callable = struct.field(pytree_node=False)

    @classmethod
    def create(cls, nl_dim: int, lin_dim: int, obs_dim: int,
               sample_initial_nl: Callable, propagate_nl: Callable,
               Fmat: Callable, Gmat: Callable, Vcov: Callable, Wcov: Callable,
               m0, C0, b: Optional[Callable] = None,
               c: Optional[Callable] = None, params: Optional[dict] = None,
               mats_constant: bool = False, dtype=jnp.float32) -> "CLGSSM":
        if b is None:
            b = lambda p, u: _zero_b(p, u, lin_dim)
        if c is None:
            c = lambda p, u: _zero_c(p, u, obs_dim)
        return cls(
            params=params or {},
            m0=jnp.asarray(m0, dtype), C0=jnp.asarray(C0, dtype),
            nl_dim=nl_dim, lin_dim=lin_dim, obs_dim=obs_dim,
            mats_constant=mats_constant,
            _sample_initial_nl=sample_initial_nl, _propagate_nl=propagate_nl,
            _Fmat=Fmat, _Gmat=Gmat, _Vcov=Vcov, _Wcov=Wcov, _b=b, _c=c)

    # --- nonlinear substate -------------------------------------------------
    def sample_initial_nl(self, key, n):
        return self._sample_initial_nl(self.params, key, n)

    def propagate_nl(self, key, u_prev):
        return self._propagate_nl(self.params, key, u_prev)

    # --- conditional system matrices (single particle u [p]) ---------------
    def Fmat(self, u):
        return self._Fmat(self.params, u)

    def Gmat(self, u):
        return self._Gmat(self.params, u)

    def Vcov(self, u):
        return self._Vcov(self.params, u)

    def Wcov(self, u):
        return self._Wcov(self.params, u)

    def b(self, u):
        return self._b(self.params, u)

    def c(self, u):
        return self._c(self.params, u)
