"""Frozen dataclasses registered as JAX pytrees.

``dataclass`` makes a frozen dataclass whose fields are pytree children,
except fields declared with ``field(pytree_node=False)``: those are static
metadata (part of the treedef, hashed into the jit cache key). Instances
get ``.replace(**changes)``, a ``dataclasses.replace`` shorthand.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field plus the pytree_node flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
