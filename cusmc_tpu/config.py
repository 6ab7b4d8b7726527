"""Declarative run configuration.

The reference passes everything positionally into ``run()``
(``/root/reference/src/run.rcpp.cpp:58-62``) and ships an *unused* ``opts_t``
config struct (``inst/include/types.hpp:15-21``). This is that struct, made
real: one dataclass capturing a full filter run, buildable from plain dicts
(JSON/YAML-friendly), with the same string registry keys ("metropolis",
"mvn", ...) for drop-in parity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class FilterConfig:
    """Everything needed to reproduce a bootstrap-filter run."""

    num_particles: int
    model: Dict[str, Any]                 # F, G, m0, C0, V, W [, df]
    distribution: str = "mvn"             # registry key (mcmc.hpp:24-25)
    resampler: str = "metropolis"         # registry key (types.hpp:32-34)
    resampler_kwargs: Optional[Dict[str, Any]] = None
    ess_threshold: Optional[float] = None
    seed: int = 0
    layout: str = "auto"
    return_history: bool = True
    sqrt_method: str = "cholesky"
    dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FilterConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["model"] = {k: np.asarray(v).tolist()
                        for k, v in self.model.items()}
        return out


def build_model(config: FilterConfig):
    """Construct the configured DLM — the single source of truth for
    config -> model (used by run_filter AND the CLI's stream/mesh
    paths, which previously duplicated it)."""
    import jax.numpy as jnp

    from cusmc_tpu.models.dlm import DLM

    m = dict(config.model)
    return DLM.create(noise=config.distribution, df=m.pop("df", None),
                      sqrt_method=config.sqrt_method,
                      dtype=jnp.dtype(config.dtype), **m)


def run_filter(config: FilterConfig, ys):
    """Execute a configured run; returns a FilterResult."""
    import jax
    import jax.numpy as jnp

    from cusmc_tpu.smc.particle_filter import bootstrap_filter

    dtype = jnp.dtype(config.dtype)
    model = build_model(config)
    return bootstrap_filter(
        jax.random.key(config.seed), model, jnp.asarray(ys, dtype),
        config.num_particles, resampler=config.resampler,
        resampler_kwargs=config.resampler_kwargs,
        ess_threshold=config.ess_threshold,
        return_history=config.return_history,
        layout=config.layout)
