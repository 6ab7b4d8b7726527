"""Stochastic volatility model — the second concrete model family.

The canonical nonlinear SMC benchmark (no Kalman solution exists):

    x_0 ~ N(mu, sigma^2 / (1 - phi^2))          (stationary prior)
    x_t = mu + phi (x_{t-1} - mu) + sigma eta_t
    y_t ~ N(0, beta^2 exp(x_t))                 (volatility observation)

The observation density is log-concave in x and heavy-tailed in y; a
bootstrap filter on this model exercises exactly the weight-degeneracy
machinery (ESS-adaptive resampling, log-space weights) the linear demo
cannot. State is univariate (d=1) but the layout machinery is shared, and
a packed implementation is provided for the packed fast path.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct

_LOG_2PI = math.log(2.0 * math.pi)


class StochasticVolatility(struct.PyTreeNode):
    """SV-AR(1) model; parameters are scalars (pytree leaves)."""

    mu: jnp.ndarray
    phi: jnp.ndarray
    sigma: jnp.ndarray
    beta: jnp.ndarray

    @classmethod
    def create(cls, mu=-1.0, phi=0.95, sigma=0.3, beta=1.0,
               dtype=jnp.float32):
        return cls(mu=jnp.asarray(mu, dtype), phi=jnp.asarray(phi, dtype),
                   sigma=jnp.asarray(sigma, dtype),
                   beta=jnp.asarray(beta, dtype))

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def obs_dim(self) -> int:
        return 1

    def _stationary_sd(self):
        return self.sigma / jnp.sqrt(1.0 - self.phi ** 2)

    # -- batch layout [N, 1] ---------------------------------------------

    def sample_initial(self, key, shape):
        z = jax.random.normal(key, shape + (1,), self.mu.dtype)
        return self.mu + self._stationary_sd() * z

    def propagate(self, key, x_prev):
        z = jax.random.normal(key, x_prev.shape, x_prev.dtype)
        return self.mu + self.phi * (x_prev - self.mu) + self.sigma * z

    def propagate_mean(self, x_prev):
        """E[x_t | x_{t-1}] — the APF lookahead point (smc/apf.py)."""
        return self.mu + self.phi * (x_prev - self.mu)

    def observation_logpdf(self, y, x):
        # y scalar or [1]; x [..., 1]. log N(y; 0, beta^2 exp(x)).
        log_var = 2.0 * jnp.log(self.beta) + x[..., 0]
        y0 = jnp.reshape(y, ())
        return -0.5 * (_LOG_2PI + log_var + (y0 * y0) * jnp.exp(-log_var))

    # -- packed layout [1, N] --------------------------------------------

    def sample_initial_packed(self, key, n):
        z = jax.random.normal(key, (1, n), self.mu.dtype)
        return self.mu + self._stationary_sd() * z

    def propagate_packed(self, key, X):
        z = jax.random.normal(key, X.shape, X.dtype)
        return self.mu + self.phi * (X - self.mu) + self.sigma * z

    def observation_logpdf_packed(self, y, X):
        log_var = 2.0 * jnp.log(self.beta) + X[0]
        y0 = jnp.reshape(y, ())
        return -0.5 * (_LOG_2PI + log_var + (y0 * y0) * jnp.exp(-log_var))

    def sample_observation(self, key, x):
        """y | x ~ N(0, beta^2 exp(x)) for batched x [..., 1] -> [..., 1]
        (predictive sampling; smc/forecast.py)."""
        scale = self.beta * jnp.exp(0.5 * x[..., 0])
        return (scale * jax.random.normal(key, scale.shape,
                                          x.dtype))[..., None]

    def simulate(self, key, num_steps):
        """Latent path + observations; row 0 of ys is zero (convention
        shared with the DLM demo trace)."""
        k0, key = jax.random.split(key)
        x0 = self.sample_initial(k0, ())

        def step(x, kt):
            kp, ko = jax.random.split(kt)
            x_next = self.propagate(kp, x)
            scale = self.beta * jnp.exp(0.5 * x_next[..., 0])
            y = scale * jax.random.normal(ko, (), x.dtype)
            return x_next, (x_next, y[None])

        keys = jax.random.split(key, num_steps - 1)
        _, (xs, ys) = jax.lax.scan(step, x0, keys)
        xs = jnp.concatenate([x0[None], xs], axis=0)
        ys = jnp.concatenate([jnp.zeros((1, 1), ys.dtype), ys], axis=0)
        return xs, ys
