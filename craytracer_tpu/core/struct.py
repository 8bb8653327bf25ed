"""Frozen dataclasses registered as JAX pytrees.

`dataclass` marks every field a pytree child unless it was declared with
`field(pytree_node=False)`; those fields are static metadata, so `jit`
specializes on their values (and they must be hashable). Instances gain
`.replace(**changes)`, a `dataclasses.replace` that returns a new
instance.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration (children and static
    metadata split by each field's `pytree_node`)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = _replace
    return cls
