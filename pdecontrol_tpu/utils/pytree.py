"""Frozen dataclasses that are JAX pytrees.

Subclassing ``PyTreeNode`` makes a class a frozen dataclass registered with
``jax.tree_util.register_dataclass``: its fields are pytree children unless
declared with ``field(static=True)``, in which case they are static metadata
(hashed into the treedef, so a change retraces).  ``.replace(**kw)`` returns
an updated copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T", bound="PyTreeNode")


def field(*, static: bool = False, **kwargs: Any) -> Any:
    """``dataclasses.field`` that marks the field static (not a leaf)."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


class PyTreeNode:
    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self: T, **updates: Any) -> T:
        return dataclasses.replace(self, **updates)
