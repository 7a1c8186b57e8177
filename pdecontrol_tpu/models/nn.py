"""Plain-JAX layers with named parameter trees.

A layer is a frozen dataclass whose ``__call__(p, *args)`` takes a ``Scope``
``p`` as its first argument: ``p.param(name, init, shape)`` returns the named
array and ``p.child(name)`` the scope of a sub-layer.  ``Module.init(key,
*args)`` runs the layer once, creating every parameter on first use, and
returns ``{"params": tree}``; ``Module.apply(variables, *args)`` runs it on a
given tree.  Parameter names, shapes and default initialisers (lecun-normal
kernels, zero biases) follow flax's ``Dense``/``Conv``/``ConvTranspose``, so
trees and checkpoints keep the layout they had when the layers were flax
modules.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp

Array = jax.Array
Initializer = Callable[..., Array]

lecun_normal = jax.nn.initializers.lecun_normal()
xavier_uniform = jax.nn.initializers.xavier_uniform()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


class Scope:
    """Parameters of one layer.  With a ``key`` (initialisation) missing
    parameters are created; without one they must already exist."""

    def __init__(self, params: Dict[str, Any], key: Optional[Array] = None):
        self.params = params
        self.key = key

    def _key(self, name: str) -> Array:
        return jax.random.fold_in(self.key, zlib.crc32(name.encode()))

    def param(self, name: str, init: Initializer, shape, dtype=jnp.float32):
        if name not in self.params:
            if self.key is None:
                raise KeyError(f"missing parameter {name!r}")
            self.params[name] = init(self._key(name), shape, dtype)
        return self.params[name]

    def child(self, name: str) -> "Scope":
        if self.key is None:
            return Scope(self.params.get(name, {}))
        return Scope(self.params.setdefault(name, {}), self._key(name))


def _prune(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the empty sub-trees of parameter-free layers."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Module:
    """Base layer: subclasses are dataclasses with ``__call__(p, ...)``."""

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True, eq=False)(cls)

    def clone(self, **updates: Any) -> "Module":
        return dataclasses.replace(self, **updates)

    def init(self, key: Array, *args, **kwargs) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        self(Scope(params, key), *args, **kwargs)
        return {"params": _prune(params)}

    def apply(self, variables: Dict[str, Any], *args,
              method: Optional[Callable] = None, **kwargs):
        scope = Scope(variables["params"])
        return (method or type(self).__call__)(self, scope, *args, **kwargs)


def _promote(*xs: Array):
    dtype = jnp.result_type(*xs)
    return [x.astype(dtype) for x in xs]


def dense(p: Scope, x: Array, features: int, use_bias: bool = True,
          kernel_init: Initializer = lecun_normal,
          bias_init: Initializer = zeros) -> Array:
    """``x @ kernel + bias`` over the last axis (flax ``Dense``)."""
    kernel = p.param("kernel", kernel_init, (x.shape[-1], features))
    x, kernel = _promote(x, kernel)
    y = jnp.matmul(x, kernel)
    if use_bias:
        y = y + p.param("bias", bias_init, (features,))
    return y


_NWC = ("NWC", "WIO", "NWC")


def conv_circular(p: Scope, x: Array, features: int, kernel_size: int,
                  stride: int = 1, use_bias: bool = True,
                  bias_init: Initializer = zeros) -> Array:
    """1-D convolution over NWC input with periodic padding (flax ``Conv``
    with ``padding="CIRCULAR"``: wrap ``(k-1)//2`` left, ``k//2`` right)."""
    kernel = p.param("kernel", lecun_normal,
                     (kernel_size, x.shape[-1], features))
    x, kernel = _promote(x, kernel)
    x = jnp.pad(x, [(0, 0), ((kernel_size - 1) // 2, kernel_size // 2),
                    (0, 0)], mode="wrap")
    y = jax.lax.conv_general_dilated(x, kernel, (stride,), "VALID",
                                     dimension_numbers=_NWC)
    if use_bias:
        y = y + p.param("bias", bias_init, (features,))
    return y


def conv_transpose(p: Scope, x: Array, features: int, kernel_size: int,
                   stride: int, use_bias: bool = True) -> Array:
    """1-D transposed convolution over NWC input, ``SAME`` padding (flax
    ``ConvTranspose``): output length = ``stride * input length``."""
    kernel = p.param("kernel", lecun_normal,
                     (kernel_size, x.shape[-1], features))
    x, kernel = _promote(x, kernel)
    y = jax.lax.conv_transpose(x, kernel, (stride,), "SAME",
                               dimension_numbers=_NWC)
    if use_bias:
        y = y + p.param("bias", zeros, (features,))
    return y
