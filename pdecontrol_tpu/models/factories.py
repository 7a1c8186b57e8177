"""Architecture factories + string registry.

Re-creates the five model families of ``/root/reference/pdecontrol/
architectures/{autoreg,latent,delay}.py`` and the registry pattern of
``architectures/__init__.py`` / ``factory.py``: a factory name (CLI
``--factory``) resolves to a builder returning a configured
``PDESurrogate`` plus a ``defaults`` config tree that CLI JSON overrides
merge onto (reference ``PDESurrogateFactory.defaults``, factory.py:19-34).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from pdecontrol_tpu.models import blocks as B
from pdecontrol_tpu.models import transition as Tr
from pdecontrol_tpu.models.surrogate import AUTOREG, LATENT, PDESurrogate


@dataclass
class Factory:
    """Named surrogate builder with default config tree."""

    name: str
    build: Callable[..., PDESurrogate]
    defaults: Dict = field(
        default_factory=lambda: {
            "model": {},
            "surrogate": {},
            "training": {},
            "trainer": {},
            "curriculum": {},
        }
    )


REGISTRY: Dict[str, Factory] = {}


def register(name: str):
    def wrap(fn):
        REGISTRY[name] = Factory(name=name, build=fn)
        return fn

    return wrap


def make(name: str, delta: float, **kwargs) -> PDESurrogate:
    if name not in REGISTRY:
        raise KeyError(f"unknown factory {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name].build(delta=delta, **kwargs)


def _conv_lstm_parts(N: int = 64, **_):
    """Shared encoder/decoder/cell of the conv-LSTM families
    (architectures/autoreg.py:49-101, latent.py:16-60)."""
    lat = N // 4  # two stride-2 stages
    state_encoder = B.ConvNet(
        blocks=[B.ResidualBlock] * 3,
        features=[8, 16, 16],
        kernel_size=[3, 3, 3],
        stride=[2, 2, 1],
        activation=[jax.nn.silu] * 3,
        layernorm=[True] * 3,
    )
    action_encoder = B.ConvNet(
        blocks=[B.ResidualBlock] * 3,
        features=[2, 4, 4],
        kernel_size=[3, 3, 3],
        stride=[2, 2, 1],
        activation=[jax.nn.silu] * 3,
        layernorm=[True] * 3,
    )
    state_decoder = B.ConvNet(
        blocks=[B.DeConvBlock, B.DeConvBlock, B.ConvBlock, B.ConvBlock],
        features=[16, 8, 1, 1],
        kernel_size=[3, 3, 7, 5],
        stride=[2, 2, 1, 1],
        activation=[jax.nn.silu, jax.nn.silu, jax.nn.silu, lambda x: x],
        layernorm=[True, True, True, False],
    )
    cell = Tr.CNNLSTMCell(schannels=16, ssize=lat)
    return state_encoder, state_decoder, action_encoder, cell


@register("KSAutoRegConvolutionalLSTM")
def ks_autoreg_conv_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Main model (architectures/autoreg.py:44-101)."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )


@register("KSLatentConvolutionalLSTM")
def ks_latent_conv_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Hard-encoded-IC ablation (architectures/latent.py:10-67)."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=LATENT,
    )


@register("KSAutoRegFullyConnectedLSTM")
def ks_autoreg_fc_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Spatial/temporal locality ablation (architectures/autoreg.py:10-41)."""
    enc = B.MLP(sizes=[(1, N // 2), (1, N // 4)], activations=[jax.nn.silu, jax.nn.silu])
    dec = B.MLP(sizes=[(1, N // 2), (1, N)], activations=[jax.nn.silu, jnp.tanh])
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=B.IdentityModule(),
        cell=Tr.LSTMCell(schannels=1, ssize=N // 4), delta=delta, mode=AUTOREG,
    )


@register("KSLatentLSTM")
def ks_latent_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Fully-connected LSTM baseline (architectures/latent.py:70-101)."""
    enc = B.MLP(sizes=[(1, N // 2), (1, N // 4)], activations=[jax.nn.elu, jax.nn.elu])
    dec = B.MLP(sizes=[(1, N // 2), (1, N)], activations=[jax.nn.elu, lambda x: x])
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=B.IdentityModule(),
        cell=Tr.LSTMCell(schannels=1, ssize=N // 4), delta=delta, mode=LATENT,
    )


@register("KSDelayCNNSurrogateFactory")
def ks_delay_cnn(delta: float, N: int = 64, delay: int = 3, **kwargs) -> PDESurrogate:
    """Delay-history model (architectures/delay.py:19-79)."""
    lat = N // 8  # three stride-2 stages
    enc = B.ConvNet(
        blocks=[B.ResidualBlock] * 3,
        features=[1, 4, 8],
        kernel_size=[3, 3, 3],
        stride=[2, 2, 2],
        activation=[jax.nn.elu, jax.nn.elu, jnp.tanh],
        layernorm=[True, True, False],
    )
    dec = B.ConvNet(
        blocks=[B.DeConvBlock, B.DeConvBlock, B.DeConvBlock, B.ConvBlock],
        features=[8, 4, 1, 1],
        kernel_size=[3, 3, 3, 5],
        stride=[2, 2, 2, 1],
        activation=[jax.nn.elu, jax.nn.elu, jax.nn.elu, jnp.tanh],
        layernorm=[True, True, False, False],
    )
    aenc = B.MLP(sizes=[(4, 4), (4, lat)], activations=[jax.nn.elu, jnp.tanh])
    fwd = B.MLP(
        sizes=[(12, lat), (8, lat), (8, lat)],
        activations=[jax.nn.elu, jax.nn.elu, jnp.tanh],
    )
    cell = Tr.DelayCell(
        schannels=8, ssize=lat, achannels=4, asize=lat, delay=delay, fwd=fwd
    )
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )
