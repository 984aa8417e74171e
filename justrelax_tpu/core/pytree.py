"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a ``dataclasses.dataclass(frozen=True)`` whose fields
are pytree leaves, except those declared with ``field(static=True)``: those
are part of the tree structure, so they are hashed into ``jit``'s cache key
and must be hashable. ``obj.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(*, static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
