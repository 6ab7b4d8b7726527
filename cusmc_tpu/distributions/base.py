"""Distribution abstraction + string-keyed registry.

Replaces the reference's virtual ``StatisticalDistribution`` base class
(``/root/reference/inst/include/statistics.hpp:36-96``) and its string-keyed
factory registry ``distributions_t`` (``inst/include/mcmc.hpp:24-25``,
registered per call at ``src/mcmc.cpp:252-266``). Here a distribution is an
immutable pytree (``utils.struct`` dataclass) whose array fields trace through
``jit``/``scan``/``shard_map``; there is no CPU/GPU method split — the same
pure functions run on any backend.

Registry keys match the reference ("mvn", "mvt") for drop-in parity.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct

from cusmc_tpu.distributions.mvn import mvn_logpdf, mvn_sample
from cusmc_tpu.distributions.mvt import mvt_logpdf, mvt_sample
from cusmc_tpu.utils.linalg import cov_sqrt


class Distribution(struct.PyTreeNode):
    """A location-family distribution with a linear scale.

    ``mean`` [d], ``scale`` [d, d] (any square root of the covariance; lower
    Cholesky by default). Subclasses implement ``log_prob`` (batched over
    leading axes of x) and ``sample``.
    """

    mean: jnp.ndarray
    scale: jnp.ndarray

    @property
    def dim(self) -> int:
        return self.scale.shape[-1]

    def log_prob(self, x: jnp.ndarray, mean: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        raise NotImplementedError

    def sample(self, key: jax.Array, shape: tuple = (),
               mean: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        raise NotImplementedError

    def prob(self, x: jnp.ndarray) -> jnp.ndarray:
        """Raw density, for parity with the reference's pdf() that returns
        unnormalized-by-log densities (``src/statistics.cc.cpp:183-196``)."""
        return jnp.exp(self.log_prob(x))


class MVN(Distribution):
    """Multivariate normal. Reference: ``statistics.hpp:137-192``."""

    def log_prob(self, x, mean=None):
        return mvn_logpdf(x, self.mean if mean is None else mean, self.scale)

    def sample(self, key, shape=(), mean=None):
        return mvn_sample(key, self.mean if mean is None else mean, self.scale, shape)


class MVT(Distribution):
    """Multivariate Student-T. Reference: ``statistics.hpp:194-250``.

    ``df`` is the degrees of freedom nu (reference stores it as float,
    ``statistics.hpp:230``). ``per_dim_chi`` reproduces the reference's
    nonstandard per-component chi-square scaling when True (see mvt.py).
    """

    df: jnp.ndarray = struct.field(default=None)
    per_dim_chi: bool = struct.field(pytree_node=False, default=False)

    def log_prob(self, x, mean=None):
        return mvt_logpdf(x, self.mean if mean is None else mean, self.scale, self.df)

    def sample(self, key, shape=(), mean=None):
        return mvt_sample(key, self.mean if mean is None else mean, self.scale,
                          self.df, shape, self.per_dim_chi)


DistributionFactory = Callable[..., Distribution]

# String-keyed factory registry; mirrors distributions_t (mcmc.hpp:24-25).
DISTRIBUTIONS: Dict[str, DistributionFactory] = {}


def register_distribution(name: str, factory: DistributionFactory) -> None:
    DISTRIBUTIONS[name] = factory


def make_distribution(name: str, mean, cov, df=None, *, sqrt_method: str = "cholesky",
                      dtype=None, **kwargs) -> Distribution:
    """Build a distribution from a covariance matrix, by registry key.

    Mirrors ``getInstance(mu, sigma, nu)`` dispatch (``src/mcmc.cpp:252-266``).
    """
    if name not in DISTRIBUTIONS:
        raise KeyError(f"unknown distribution {name!r}; have {sorted(DISTRIBUTIONS)}")
    mean = jnp.asarray(mean, dtype=dtype)
    cov = jnp.asarray(cov, dtype=mean.dtype)
    scale = cov_sqrt(cov, sqrt_method)
    return DISTRIBUTIONS[name](mean=mean, scale=scale, df=df, **kwargs)


def _mvn_factory(mean, scale, df=None, **kwargs):
    del df
    return MVN(mean=mean, scale=scale, **kwargs)


def _mvt_factory(mean, scale, df=None, **kwargs):
    if df is None:
        raise ValueError("MVT requires df (degrees of freedom)")
    return MVT(mean=mean, scale=scale, df=jnp.asarray(df, dtype=scale.dtype), **kwargs)


register_distribution("mvn", _mvn_factory)
register_distribution("mvt", _mvt_factory)
