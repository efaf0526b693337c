"""Minimal pytree dataclasses.

The reference stores model state in framework Parameter objects (GPflow Parameter /
torch nn.Parameter).  This design is functional: model parameters are
immutable pytree dataclasses that flow through ``jax.jit`` / ``jax.grad`` /
``shard_map`` like any other array container.

``pytree_dataclass`` registers a frozen dataclass with JAX.  Fields marked with
``static_field()`` become aux_data (hashable, trigger recompilation when changed);
everything else is a child pytree.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

__all__ = ["pytree_dataclass", "static_field", "field", "replace"]

_T = TypeVar("_T")


def static_field(**kwargs):
    """Dataclass field treated as static (aux) metadata by JAX."""
    return dataclasses.field(metadata={"pytree_static": True}, **kwargs)


def field(**kwargs):
    return dataclasses.field(**kwargs)


def pytree_dataclass(cls: _T) -> _T:
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("pytree_static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


def replace(obj, **changes):
    return dataclasses.replace(obj, **changes)
