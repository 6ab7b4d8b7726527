"""State-space model protocol.

The reference hard-wires ONE model family (the linear-Gaussian/Student-T
DLM baked into ``propagate_K``/``reweight_G``, ``/root/reference/src/
mcmc.cpp:90-237``). Here any object implementing this protocol runs through
the same filter/smoother machinery — ``DLM`` is just the first instance.

Required (batch layout, x as [N, d]):
    sample_initial(key, shape) -> x0 [*shape, d]
    propagate(key, x_prev)     -> x  [N, d]
    observation_logpdf(y, x)   -> ll [N]
    state_dim: int

Optional (packed layout, x as [d, N]; enables the packed fast path):
    sample_initial_packed(key, n) -> [d, n]
    propagate_packed(key, X)      -> [d, n]
    observation_logpdf_packed(y, X) -> [n]

``CustomSSM`` adapts plain functions to the protocol for one-off models.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from cusmc_tpu.utils import struct


def supports_packed(model) -> bool:
    return (hasattr(model, "sample_initial_packed")
            and hasattr(model, "propagate_packed")
            and hasattr(model, "observation_logpdf_packed"))


class CustomSSM(struct.PyTreeNode):
    """Wrap user functions into a state-space model (batch layout only;
    the filter automatically selects layout='batch').

    Functions close over their own parameters, or take them from ``params``
    (a pytree carried through jit): each fn receives ``params`` as its
    first argument.
    """

    params: dict
    dim: int = struct.field(pytree_node=False)
    _sample_initial: Callable = struct.field(pytree_node=False)
    _propagate: Callable = struct.field(pytree_node=False)
    _observation_logpdf: Callable = struct.field(pytree_node=False)

    @classmethod
    def create(cls, dim: int, sample_initial: Callable, propagate: Callable,
               observation_logpdf: Callable, params: Optional[dict] = None):
        return cls(params=params or {}, dim=dim,
                   _sample_initial=sample_initial, _propagate=propagate,
                   _observation_logpdf=observation_logpdf)

    @property
    def state_dim(self) -> int:
        return self.dim

    def sample_initial(self, key, shape):
        return self._sample_initial(self.params, key, shape)

    def propagate(self, key, x_prev):
        return self._propagate(self.params, key, x_prev)

    def observation_logpdf(self, y, x):
        return self._observation_logpdf(self.params, y, x)


def normalize_time_hook(fn, kind):
    """Normalize a model hook to the 3-argument form the filter's scan
    body uses: propagate ``(key, X, t)`` / logpdf ``(y, X, t)``.

    Models whose hooks declare a ``t`` parameter (time-varying dynamics
    or observation models, e.g. models/ungm.py) receive the scan step;
    the standard time-invariant hooks are wrapped at TRACE time (the
    wrapper vanishes under jit — zero runtime cost on the hot paths).
    """
    import inspect

    try:
        takes_t = "t" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        takes_t = False
    if takes_t:
        return (lambda k, x, t: fn(k, x, t=t)) if kind == "x" else \
            (lambda y, x, t: fn(y, x, t=t))
    return (lambda k, x, t: fn(k, x)) if kind == "x" else \
        (lambda y, x, t: fn(y, x))
