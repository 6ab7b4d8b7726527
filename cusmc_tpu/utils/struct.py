"""Immutable dataclass pytrees: the library's models, states and results.

``class R(struct.PyTreeNode)`` makes ``R`` a frozen dataclass registered
with ``jax.tree_util.register_dataclass``. Fields are pytree leaves
(traced through ``jit``/``scan``/``shard_map``) unless declared with
``struct.field(pytree_node=False)``: such a field is static, part of the
tree structure and of ``jit``'s cache key, so it must be hashable.
``.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: every subclass becomes a frozen, registered dataclass."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if f.metadata.get("pytree_node", True)],
            meta_fields=[f.name for f in fields
                         if not f.metadata.get("pytree_node", True)])

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
