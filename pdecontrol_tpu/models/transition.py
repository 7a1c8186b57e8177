"""Latent transition models as scan-ready cells.

Re-designs ``/root/reference/pdecontrol/surrogates/transition.py`` for JAX:
instead of separate Python-loop ``teacherforcing``/``transition`` methods,
every model is a single *cell* with signature

    carry, outlatent = cell(carry, laction, lstate, tf)

driven by ``lax.scan``.  ``tf`` is a (traced) boolean: when true the cell
adopts the reference's teacher-forcing scheme — the hidden state ``H`` is
*overwritten* with the provided latent before the gate update
(transition.py:83,276-277) — and when false it runs the free-running
transition (which for the LSTM-family ignores ``lstate`` entirely, exactly
like the reference's ``transition`` methods ignore their ``states`` arg;
transition.py:91-109,285-296).  The ``DelayCell`` instead pushes ``lstate``
into its history buffer in both modes (transition.py:334-382).

Initial carries are zeros, mirroring the reference's non-learnable
``H0``/``C0`` parameters (transition.py:50-58,253-258).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
from pdecontrol_tpu.models import nn
from pdecontrol_tpu.models.nn import Scope

Array = jax.Array
Carry = Any


class TransitionCell(nn.Module):
    """Interface; concrete cells define state shapes and the update."""

    #: Whether the free-running path consumes the re-encoded previous output.
    needs_prev_latent: bool = False

    def init_carry(self, batch: int, dtype=jnp.float32) -> Carry:
        raise NotImplementedError


class LSTMCell(TransitionCell):
    """Flattened-input LSTM (reference ``LSTMTransitionModel``,
    transition.py:34-109).  Latent states/actions ``[B, C, H]`` are flattened
    to vectors; hidden size = schannels * ssize."""

    schannels: int = 1
    ssize: int = 16
    needs_prev_latent: bool = False

    @property
    def hidden_size(self) -> int:
        return self.schannels * self.ssize

    def init_carry(self, batch: int, dtype=jnp.float32) -> Carry:
        z = jnp.zeros((batch, self.hidden_size), dtype)
        return (z, z)

    def __call__(
        self, p: Scope, carry: Carry, laction: Array, lstate: Array,
        tf: Array,
    ) -> Tuple[Carry, Array]:
        # Standard LSTM gate math (torch nn.LSTM parameterisation).
        h, c = carry
        b = laction.shape[0]
        forced = lstate.reshape(b, -1)
        h = jnp.where(jnp.reshape(tf, (-1, 1)), forced, h)

        gates = (nn.dense(p.child("wx"), laction.reshape(b, -1),
                          4 * self.hidden_size)
                 + nn.dense(p.child("wh"), h, 4 * self.hidden_size,
                            use_bias=False))
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        out = h.reshape(b, self.schannels, self.ssize)
        return (h, c), out


def _fused_gate_bias(schannels: int):
    """Bias init for the fused gate conv: gate order (i, f, c, o) with the
    output-gate block at 1.0 and the rest at 0 (transition.py:213-216)."""

    def init(key, shape, dtype=jnp.float32):
        del key
        assert shape == (4 * schannels,)
        return jnp.concatenate(
            [jnp.zeros((3 * schannels,), dtype), jnp.ones((schannels,), dtype)]
        )

    return init


class CNNLSTMCell(TransitionCell):
    """Convolutional LSTM over the periodic spatial axis (reference
    ``CNNLSTMCell``/``CNNLSTMTransitionModel``, transition.py:112-296).

    Gate math: four x-convs (with bias; output-gate bias initialised to 1.0,
    the others to 0 — transition.py:213-216) and four h-convs (no bias), all
    circular, kernel 3.  Latents are ``[B, C, H]``; internally NWC.

    ``fused=True`` (default) issues the gates as ONE 4x-output-channel x-conv
    plus ONE 4x-output-channel h-conv and splits into (i, f, c, o) blocks —
    mathematically identical per output channel (each output channel of a
    conv is an independent reduction over the same inputs), but two convs
    instead of eight small ones; this is the standard LSTM kernel fusion.
    ``fused=False`` keeps the eight per-gate convs for the equivalence test
    (tests/test_surrogate.py::test_fused_cnn_lstm_cell_equivalence).
    """

    schannels: int = 16
    ssize: int = 16
    kernel_size: int = 3
    fused: bool = True
    needs_prev_latent: bool = False

    def init_carry(self, batch: int, dtype=jnp.float32) -> Carry:
        z = jnp.zeros((batch, self.schannels, self.ssize), dtype)
        return (z, z)

    def __call__(
        self, p: Scope, carry: Carry, laction: Array, lstate: Array,
        tf: Array,
    ) -> Tuple[Carry, Array]:
        x_ = jnp.swapaxes(laction, -1, -2)  # NWC for the convs
        h, c = carry
        h = jnp.where(jnp.reshape(tf, (-1, 1, 1)), lstate, h)
        h_ = jnp.swapaxes(h, -1, -2)

        def conv(name, x, feats, bias_init=None):
            return nn.conv_circular(
                p.child(name), x, feats, self.kernel_size,
                use_bias=bias_init is not None,
                bias_init=bias_init or nn.zeros,
            )

        if self.fused:
            gates = (conv("wx", x_, 4 * self.schannels,
                          _fused_gate_bias(self.schannels))
                     + conv("wh", h_, 4 * self.schannels))
            gi, gf, gc, go = jnp.split(gates, 4, axis=-1)
        else:
            gi, gf, gc, go = (
                conv(f"wx{g}", x_, self.schannels, binit)
                + conv(f"wh{g}", h_, self.schannels)
                for g, binit in (("i", nn.zeros), ("f", nn.zeros),
                                 ("c", nn.zeros), ("o", nn.ones))
            )
        ci, cf, co = jax.nn.sigmoid(gi), jax.nn.sigmoid(gf), jax.nn.sigmoid(go)
        cc = cf * jnp.swapaxes(c, -1, -2) + ci * jnp.tanh(gc)
        ch = co * jnp.tanh(cc)
        return (jnp.swapaxes(ch, -1, -2), jnp.swapaxes(cc, -1, -2)), \
            jnp.swapaxes(ch, -1, -2)


def fuse_cnn_lstm_params(unfused: dict) -> dict:
    """Map an unfused CNNLSTMCell param subtree (wxi/wxf/wxc/wxo +
    whi/whf/whc/who) onto the fused layout (wx/wh) by concatenating kernels
    and biases along the output-channel axis in gate order (i, f, c, o)."""
    gates = ("i", "f", "c", "o")
    wx = {
        "kernel": jnp.concatenate(
            [unfused[f"wx{g}"]["kernel"] for g in gates], axis=-1
        ),
        "bias": jnp.concatenate(
            [unfused[f"wx{g}"]["bias"] for g in gates], axis=-1
        ),
    }
    wh = {
        "kernel": jnp.concatenate(
            [unfused[f"wh{g}"]["kernel"] for g in gates], axis=-1
        ),
    }
    return {"wx": wx, "wh": wh}


class DelayCell(TransitionCell):
    """Fixed-delay history MLP (reference ``DelayTransitionModel``,
    transition.py:299-382): ring buffers of the last ``delay`` latent states
    and actions, pushed newest-last, fed through an MLP."""

    schannels: int = 8
    ssize: int = 8
    achannels: int = 4
    asize: int = 8
    delay: int = 3
    fwd: nn.Module = None
    needs_prev_latent: bool = True

    def init_carry(self, batch: int, dtype=jnp.float32) -> Carry:
        s = jnp.zeros((batch, self.delay, self.schannels, self.ssize), dtype)
        a = jnp.zeros((batch, self.delay, self.achannels, self.asize), dtype)
        return (s, a)

    def __call__(
        self, p: Scope, carry: Carry, laction: Array, lstate: Array,
        tf: Array,
    ) -> Tuple[Carry, Array]:
        sctx, actx = carry
        # Write into slot 0 then roll left: newest ends at slot -1
        # (transition.py:348-353).
        sctx = jnp.roll(sctx.at[:, 0].set(lstate), shift=-1, axis=1)
        actx = jnp.roll(actx.at[:, 0].set(laction), shift=-1, axis=1)

        b = sctx.shape[0]
        augmented = jnp.concatenate((sctx, actx), axis=2)
        augmented = augmented.reshape(
            b, self.delay * (self.schannels + self.achannels), self.ssize
        )
        out = self.fwd(p.child("fwd"), augmented)
        out = out.reshape(b, self.schannels, self.ssize)
        return (sctx, actx), out
