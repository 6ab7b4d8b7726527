"""The in-repo frozen-dataclass pytree (utils/struct.py) under every state,
result and model class of the package: a jit round trip keeps the class,
the data leaves and the static fields; static fields stay Python values
inside the trace; ``.replace`` returns an updated copy."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusmc_tpu.utils import struct

CLASSES = [
    ("cusmc_tpu.distributions.base", "Distribution"),
    ("cusmc_tpu.distributions.base", "MVN"),
    ("cusmc_tpu.distributions.base", "MVT"),
    ("cusmc_tpu.models.base", "CustomSSM"),
    ("cusmc_tpu.models.clgssm", "CLGSSM"),
    ("cusmc_tpu.models.dlm", "DLM"),
    ("cusmc_tpu.models.stochvol", "StochasticVolatility"),
    ("cusmc_tpu.models.ungm", "UNGM"),
    ("cusmc_tpu.smc.csmc", "CSMCResult"),
    ("cusmc_tpu.smc.enkf", "EnKFResult"),
    ("cusmc_tpu.smc.liu_west", "LiuWestResult"),
    ("cusmc_tpu.smc.particle_filter", "FilterResult"),
    ("cusmc_tpu.smc.rbpf", "RBPFResult"),
    ("cusmc_tpu.smc.smc2", "SMC2Result"),
    ("cusmc_tpu.smc.smc_sampler", "SMCSamplerResult"),
    ("cusmc_tpu.mcmc.adaptive", "AMState"),
    ("cusmc_tpu.mcmc.adaptive", "AMResult"),
    ("cusmc_tpu.mcmc.chees", "ChEESState"),
    ("cusmc_tpu.mcmc.chees", "ChEESResult"),
    ("cusmc_tpu.mcmc.ensemble", "EnsembleResult"),
    ("cusmc_tpu.mcmc.hmc", "HMCState"),
    ("cusmc_tpu.mcmc.hmc", "HMCResult"),
    ("cusmc_tpu.mcmc.mala", "MALAState"),
    ("cusmc_tpu.mcmc.mala", "MALAResult"),
    ("cusmc_tpu.mcmc.metropolis", "MHState"),
    ("cusmc_tpu.mcmc.metropolis", "MHResult"),
    ("cusmc_tpu.mcmc.pmmh", "PMMHResult"),
    ("cusmc_tpu.mcmc.tempering", "PTState"),
    ("cusmc_tpu.mcmc.tempering", "PTResult"),
]


def _is_static(f):
    return not f.metadata.get("pytree_node", True)


def _instance(cls):
    vals = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        vals[f.name] = (("static", i) if _is_static(f)
                        else jnp.full((2,), float(i), jnp.float32))
    return cls(**vals)


@pytest.mark.parametrize("module,name", CLASSES,
                         ids=[n for _, n in CLASSES])
def test_pytree_roundtrip(module, name):
    cls = getattr(importlib.import_module(module), name)
    assert issubclass(cls, struct.PyTreeNode)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if not _is_static(f)]
    static = [f.name for f in fields if _is_static(f)]
    obj = _instance(cls)
    assert len(jax.tree_util.tree_leaves(obj)) == len(data)

    seen = {}

    def body(t):
        seen.update({n: isinstance(getattr(t, n), jax.core.Tracer)
                     for n in data + static})
        return t

    out = jax.jit(body)(obj)
    assert type(out) is cls
    assert all(seen[n] for n in data)
    assert not any(seen[n] for n in static)
    for n in data:
        np.testing.assert_array_equal(getattr(out, n), getattr(obj, n))
    for n in static:
        assert getattr(out, n) == getattr(obj, n)

    if data:
        new = obj.replace(**{data[0]: jnp.ones((3,), jnp.float32)})
        assert type(new) is cls and getattr(new, data[0]).shape == (3,)
        assert getattr(obj, data[0]).shape == (2,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, fields[0].name, None)


def test_static_field_changes_tree_structure():
    class Node(struct.PyTreeNode):
        x: jnp.ndarray
        tag: str = struct.field(pytree_node=False, default="a")

    a, b = Node(jnp.zeros(2)), Node(jnp.zeros(2), tag="b")
    assert (jax.tree_util.tree_structure(a)
            != jax.tree_util.tree_structure(b))
    assert Node(jnp.zeros(2)).replace(tag="c").tag == "c"
