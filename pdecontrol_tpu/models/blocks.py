"""NN building blocks for the PDE surrogates (plain JAX, ``models/nn.py``).

Functional re-design of ``/root/reference/pdecontrol/surrogates/models/
{cnn,fcnn}.py``: 1-D conv / deconv / NVAE-style residual blocks with
**circular padding** for the periodic domain, LayerNorm over the spatial
axis, and per-layer-configured ``ConvNet`` stacks.

Layout: the public convention matches the reference — tensors are
``[B, C, H]`` (channel-first) at module boundaries; internally convs run in
NWC (``[B, H, C]``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp

from pdecontrol_tpu.models import nn
from pdecontrol_tpu.models.nn import Scope

Array = jax.Array


class SpatialLayerNorm(nn.Module):
    """LayerNorm over the spatial axis with learned scale/bias along it —
    matches ``nn.LayerNorm(spatial)`` applied to ``[B, C, H]`` tensors in the
    reference (cnn.py:60,72,93).  Operates on NWC ``[B, H, C]`` input."""

    epsilon: float = 1e-5

    def __call__(self, p: Scope, x: Array) -> Array:
        # Normalise over the spatial axis (-2 in NWC).
        mean = jnp.mean(x, axis=-2, keepdims=True)
        var = jnp.var(x, axis=-2, keepdims=True)
        y = (x - mean) * jax.lax.rsqrt(var + self.epsilon)
        h = x.shape[-2]
        scale = p.param("scale", nn.ones, (h, 1))
        bias = p.param("bias", nn.zeros, (h, 1))
        return y * scale.astype(x.dtype) + bias.astype(x.dtype)


def _norm(p: Scope, name: str, x: Array) -> Array:
    return SpatialLayerNorm()(p.child(name), x)


class ConvBlock(nn.Module):
    """Circular conv -> activation -> optional spatial LayerNorm
    (reference ``ConvBlock``, cnn.py:6-41)."""

    features: int
    kernel_size: int = 3
    stride: int = 1
    use_bias: bool = True
    activation: Callable = jax.nn.silu
    layernorm: bool = False

    def __call__(self, p: Scope, x: Array) -> Array:
        y = nn.conv_circular(p.child("Conv_0"), x, self.features,
                             self.kernel_size, self.stride, self.use_bias)
        y = self.activation(y)
        if self.layernorm:
            y = _norm(p, "SpatialLayerNorm_0", y)
        return y


class DeConvBlock(nn.Module):
    """Stride-2 transposed conv upsampling (reference ``DeConvolutionBlock``,
    cnn.py:44-70; output length = stride * input length)."""

    features: int
    kernel_size: int = 3
    stride: int = 2
    use_bias: bool = True
    activation: Callable = jax.nn.silu
    layernorm: bool = False

    def __call__(self, p: Scope, x: Array) -> Array:
        y = nn.conv_transpose(p.child("ConvTranspose_0"), x, self.features,
                              self.kernel_size, self.stride, self.use_bias)
        y = self.activation(y)
        if self.layernorm:
            y = _norm(p, "SpatialLayerNorm_0", y)
        return y


class ResidualBlock(nn.Module):
    """NVAE-style 1-D residual cell with circular padding (reference
    ``ResidualBlock``, cnn.py:73-145): two k-convs (act+norm each), a 1x1
    strided skip, and a post-addition norm."""

    features: int
    kernel_size: int = 3
    stride: int = 2
    use_bias: bool = False
    activation: Callable = jax.nn.silu
    layernorm: bool = False

    def __call__(self, p: Scope, x: Array) -> Array:
        identity = nn.conv_circular(p.child("skip"), x, self.features, 1,
                                    self.stride, self.use_bias)

        out = nn.conv_circular(p.child("conv_l1"), x, self.features,
                               self.kernel_size, self.stride, self.use_bias)
        out = self.activation(out)
        if self.layernorm:
            out = _norm(p, "norm_l1", out)

        out = nn.conv_circular(p.child("conv_l2"), out, self.features,
                               self.kernel_size, 1, self.use_bias)
        out = self.activation(out)
        if self.layernorm:
            out = _norm(p, "norm_l2", out)

        out = out + identity
        if self.layernorm:
            out = _norm(p, "norm_skip", out)
        return out


class ConvNet(nn.Module):
    """Stack of blocks with per-layer parameter lists (reference ``ConvNet``,
    cnn.py:148-173).  ``blocks`` entries are block classes; missing per-layer
    values fall back to block defaults.  Input/output are ``[B, C, H]``."""

    blocks: Sequence[type]
    features: Sequence[int]
    kernel_size: Sequence[int] = ()
    stride: Sequence[int] = ()
    activation: Sequence[Any] = ()
    layernorm: Sequence[bool] = ()

    def _get(self, seq, idx, default):
        return seq[idx] if idx < len(seq) else default

    def __call__(self, p: Scope, x: Array) -> Array:
        x = jnp.swapaxes(x, -1, -2)  # -> NWC
        for i, block_cls in enumerate(self.blocks):
            block = block_cls(
                features=self.features[i],
                kernel_size=self._get(self.kernel_size, i, 3),
                stride=self._get(self.stride, i,
                                 1 if block_cls is ConvBlock else 2),
                activation=self._get(self.activation, i, jax.nn.silu),
                layernorm=self._get(self.layernorm, i, False),
            )
            x = block(p.child(f"block_l{i}"), x)
        return jnp.swapaxes(x, -1, -2)  # -> [B, C, H]


class LinearBlock(nn.Module):
    """Flatten -> Dense -> activation -> reshape (reference ``LinearBlock``,
    fcnn.py:5-29).  ``[B, Cin, Hin] -> [B, Cout, Hout]``."""

    out_channels: int
    out_size: int
    activation: Callable = jax.nn.silu

    def __call__(self, p: Scope, x: Array) -> Array:
        b = x.shape[0]
        y = nn.dense(p.child("Dense_0"), x.reshape(b, -1),
                     self.out_channels * self.out_size)
        y = self.activation(y)
        return y.reshape(b, self.out_channels, self.out_size)


class MLP(nn.Module):
    """Sequence of LinearBlocks."""

    sizes: Sequence[Tuple[int, int]]  # per layer: (out_channels, out_size)
    activations: Sequence[Callable]

    def __call__(self, p: Scope, x: Array) -> Array:
        for i, ((c, h), act) in enumerate(zip(self.sizes, self.activations)):
            x = LinearBlock(c, h, act)(p.child(f"linear_l{i}"), x)
        return x


class IdentityModule(nn.Module):
    def __call__(self, p: Scope, x: Array) -> Array:
        return x


def batched_apply(module: nn.Module, p: Scope, x: Array) -> Array:
    """Fold time into batch for per-frame modules (reference
    ``BatchingWrapper``, surrogates/utils.py:35-47): [B, T, C, H] -> module
    over [B*T, C, H] -> [B, T, C', H']."""
    b, t = x.shape[:2]
    y = module(p, x.reshape((b * t,) + x.shape[2:]))
    return y.reshape((b, t) + y.shape[1:])
