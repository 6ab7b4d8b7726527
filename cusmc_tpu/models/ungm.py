"""The univariate nonlinear growth model (UNGM) — the canonical
nonlinear/non-Gaussian particle-filter benchmark (Gordon, Salmond &
Smith 1993; Kitagawa 1996):

    x_t = x_{t-1}/2 + 25 x_{t-1} / (1 + x_{t-1}^2) + 8 cos(1.2 t) + w,
    y_t = x_t^2 / 20 + v,     w ~ N(0, q), v ~ N(0, r).

The reference supports only linear-Gaussian DLMs with MVN/MVT noise
(``/root/reference/src/mcmc.cpp:6-42``); this module exists to
demonstrate the open model protocol (``models/base.py``) on the
standard hard case: bimodal filtering posteriors (the y = x^2 likelihood
cannot tell +x from -x) where the Kalman filter is inapplicable and the
bootstrap filter is the textbook solution. Time enters the dynamics, so
the propagate hook takes ``t`` — the filter's scan passes it through.

Packed convention: state is [1, N].
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct


class UNGM(struct.PyTreeNode):
    q: jnp.ndarray          # process noise variance
    r: jnp.ndarray          # observation noise variance
    x0_std: jnp.ndarray

    @classmethod
    def create(cls, q: float = 10.0, r: float = 1.0, x0_std: float = 2.0,
               dtype=jnp.float32):
        return cls(q=jnp.asarray(q, dtype), r=jnp.asarray(r, dtype),
                   x0_std=jnp.asarray(x0_std, dtype))

    @property
    def state_dim(self):
        return 1

    def sample_initial_packed(self, key, n):
        return self.x0_std * jax.random.normal(key, (1, n), self.q.dtype)

    def propagate_packed(self, key, X, t=None):
        """X [1, N] -> [1, N]; t is the scan step (static 0 if absent)."""
        tt = jnp.asarray(0.0 if t is None else t, X.dtype)
        drift = 0.5 * X + 25.0 * X / (1.0 + X * X) \
            + 8.0 * jnp.cos(1.2 * tt)
        return drift + jnp.sqrt(self.q) * jax.random.normal(
            key, X.shape, X.dtype)

    def observation_logpdf_packed(self, y, X, t=None):
        """y scalar-ish [1], X [1, N] -> [N]."""
        mu = X[0] * X[0] / 20.0
        resid = jnp.asarray(y, X.dtype).reshape(()) - mu
        return -0.5 * (resid * resid / self.r
                       + jnp.log(2.0 * math.pi * self.r))

    def simulate(self, key, num_steps):
        """Returns (xs [T], ys [T, 1]); row 0 is the initial state /
        a placeholder observation (filter convention)."""
        k0, key = jax.random.split(key)
        x0 = self.x0_std * jax.random.normal(k0, (), self.q.dtype)

        def step(x, kt):
            t, k = kt
            kp, ko = jax.random.split(k)
            x = self.propagate_packed(kp, x.reshape(1, 1), t)[0, 0]
            y = x * x / 20.0 + jnp.sqrt(self.r) * jax.random.normal(
                ko, (), self.q.dtype)
            return x, (x, y)

        ts = jnp.arange(1, num_steps, dtype=self.q.dtype)
        keys = jax.random.split(key, num_steps - 1)
        _, (xs, ys) = jax.lax.scan(step, x0, (ts, keys))
        xs = jnp.concatenate([x0[None], xs])
        ys = jnp.concatenate([jnp.zeros((1,), self.q.dtype), ys])
        return xs, ys[:, None]
