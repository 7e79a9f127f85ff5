"""Frozen dataclasses that are JAX pytrees.

Every field is a pytree child (an array or a nested pytree), so instances
pass through `jit`, `vmap`, `lax` loops and `jax.tree.map` unchanged.
`.replace(**changes)` returns a copy with some fields swapped, the
functional update the engines use on their state and statistics.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Decorator: a frozen dataclass registered as a pytree, with
    `.replace`. Leaves flatten in field-declaration order."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
