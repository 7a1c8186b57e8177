"""The surrogate and SAC networks as flax modules, kept as the reference for
the plain-JAX layers' parity tests (``tests/test_nn.py``).  Import only after
``pytest.importorskip("flax")``."""

from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from pdecontrol_tpu.data.types import ModelRollout
from pdecontrol_tpu.envs.transforms import Identity, Transform

Array = jax.Array
Carry = Any
AUTOREG = "autoreg"
LATENT = "latent"


class SpatialLayerNorm(nn.Module):
    """LayerNorm over the spatial axis with learned scale/bias along it —
    matches ``nn.LayerNorm(spatial)`` applied to ``[B, C, H]`` tensors in the
    reference (cnn.py:60,72,93).  Operates on NWC ``[B, H, C]`` input."""

    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x: Array) -> Array:
        # Normalise over the spatial axis (-2 in NWC).
        mean = jnp.mean(x, axis=-2, keepdims=True)
        var = jnp.var(x, axis=-2, keepdims=True)
        y = (x - mean) * jax.lax.rsqrt(var + self.epsilon)
        h = x.shape[-2]
        scale = self.param("scale", nn.initializers.ones, (h, 1), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (h, 1), jnp.float32)
        return y * scale.astype(x.dtype) + bias.astype(x.dtype)


class ConvBlock(nn.Module):
    """Circular conv -> activation -> optional spatial LayerNorm
    (reference ``ConvBlock``, cnn.py:6-41)."""

    features: int
    kernel_size: int = 3
    stride: int = 1
    use_bias: bool = True
    activation: Callable = nn.silu
    layernorm: bool = False

    @nn.compact
    def __call__(self, x: Array) -> Array:
        y = nn.Conv(
            self.features,
            (self.kernel_size,),
            strides=(self.stride,),
            padding="CIRCULAR",
            use_bias=self.use_bias,
        )(x)
        y = self.activation(y)
        if self.layernorm:
            y = SpatialLayerNorm()(y)
        return y


class DeConvBlock(nn.Module):
    """Stride-2 transposed conv upsampling (reference ``DeConvolutionBlock``,
    cnn.py:44-70; output length = stride * input length)."""

    features: int
    kernel_size: int = 3
    stride: int = 2
    use_bias: bool = True
    activation: Callable = nn.silu
    layernorm: bool = False

    @nn.compact
    def __call__(self, x: Array) -> Array:
        y = nn.ConvTranspose(
            self.features,
            (self.kernel_size,),
            strides=(self.stride,),
            padding="SAME",
            use_bias=self.use_bias,
        )(x)
        y = self.activation(y)
        if self.layernorm:
            y = SpatialLayerNorm()(y)
        return y


class ResidualBlock(nn.Module):
    """NVAE-style 1-D residual cell with circular padding (reference
    ``ResidualBlock``, cnn.py:73-145): two k-convs (act+norm each), a 1x1
    strided skip, and a post-addition norm."""

    features: int
    kernel_size: int = 3
    stride: int = 2
    use_bias: bool = False
    activation: Callable = nn.silu
    layernorm: bool = False

    @nn.compact
    def __call__(self, x: Array) -> Array:
        identity = nn.Conv(
            self.features, (1,), strides=(self.stride,), padding="CIRCULAR",
            use_bias=self.use_bias, name="skip",
        )(x)

        out = nn.Conv(
            self.features, (self.kernel_size,), strides=(self.stride,),
            padding="CIRCULAR", use_bias=self.use_bias, name="conv_l1",
        )(x)
        out = self.activation(out)
        if self.layernorm:
            out = SpatialLayerNorm(name="norm_l1")(out)

        out = nn.Conv(
            self.features, (self.kernel_size,), strides=(1,),
            padding="CIRCULAR", use_bias=self.use_bias, name="conv_l2",
        )(out)
        out = self.activation(out)
        if self.layernorm:
            out = SpatialLayerNorm(name="norm_l2")(out)

        out = out + identity
        if self.layernorm:
            out = SpatialLayerNorm(name="norm_skip")(out)
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

    @nn.compact
    def __call__(self, x: Array) -> Array:
        x = jnp.swapaxes(x, -1, -2)  # -> NWC
        for i, block_cls in enumerate(self.blocks):
            kwargs = dict(
                features=self.features[i],
                kernel_size=self._get(self.kernel_size, i, 3),
                stride=self._get(self.stride, i, 1 if block_cls is ConvBlock else 2),
                activation=self._get(self.activation, i, nn.silu),
                layernorm=self._get(self.layernorm, i, False),
            )
            x = block_cls(**kwargs, name=f"block_l{i}")(x)
        return jnp.swapaxes(x, -1, -2)  # -> [B, C, H]


class LinearBlock(nn.Module):
    """Flatten -> Dense -> activation -> reshape (reference ``LinearBlock``,
    fcnn.py:5-29).  ``[B, Cin, Hin] -> [B, Cout, Hout]``."""

    out_channels: int
    out_size: int
    activation: Callable = nn.silu

    @nn.compact
    def __call__(self, x: Array) -> Array:
        b = x.shape[0]
        y = x.reshape(b, -1)
        y = nn.Dense(self.out_channels * self.out_size)(y)
        y = self.activation(y)
        return y.reshape(b, self.out_channels, self.out_size)


class MLP(nn.Module):
    """Sequence of LinearBlocks."""

    sizes: Sequence[Tuple[int, int]]  # per layer: (out_channels, out_size)
    activations: Sequence[Callable]

    @nn.compact
    def __call__(self, x: Array) -> Array:
        for i, ((c, h), act) in enumerate(zip(self.sizes, self.activations)):
            x = LinearBlock(c, h, act, name=f"linear_l{i}")(x)
        return x


class IdentityModule(nn.Module):
    @nn.compact
    def __call__(self, x: Array) -> Array:
        return x


def batched_apply(module: nn.Module, x: Array) -> Array:
    """Fold time into batch for per-frame modules (reference
    ``BatchingWrapper``, surrogates/utils.py:35-47): [B, T, C, H] -> module
    over [B*T, C, H] -> [B, T, C', H']."""
    b, t = x.shape[:2]
    y = module(x.reshape((b * t,) + x.shape[2:]))
    return y.reshape((b, t) + y.shape[1:])


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

    def setup(self):
        # Standard LSTM gate math (torch nn.LSTM parameterisation).
        self.wx = nn.Dense(4 * self.hidden_size)
        self.wh = nn.Dense(4 * self.hidden_size, use_bias=False)

    def step_pre(
        self, carry: Carry, gx: Array, lstate: Array, tf: Array
    ) -> Tuple[Carry, Array]:
        h, c = carry
        b = gx.shape[0]
        forced = lstate.reshape(b, -1)
        h = jnp.where(jnp.reshape(tf, (-1, 1)), forced, h)

        gates = gx + self.wh(h)
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c = nn.sigmoid(f) * c + nn.sigmoid(i) * jnp.tanh(g)
        h = nn.sigmoid(o) * jnp.tanh(c)
        out = h.reshape(b, self.schannels, self.ssize)
        return (h, c), out

    def __call__(
        self, carry: Carry, laction: Array, lstate: Array, tf: Array
    ) -> Tuple[Carry, Array]:
        b = laction.shape[0]
        return self.step_pre(carry, self.wx(laction.reshape(b, -1)),
                             lstate, tf)


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

    def setup(self):
        def conv(feats, **kw):
            return nn.Conv(feats, (self.kernel_size,), padding="CIRCULAR",
                           **kw)

        if self.fused:
            self.wx = conv(4 * self.schannels, use_bias=True,
                           bias_init=_fused_gate_bias(self.schannels))
            self.wh = conv(4 * self.schannels, use_bias=False)
        else:
            zeros, ones = nn.initializers.zeros, nn.initializers.ones
            for g, binit in (("i", zeros), ("f", zeros), ("c", zeros),
                             ("o", ones)):
                setattr(self, f"wx{g}",
                        conv(self.schannels, use_bias=True, bias_init=binit))
                setattr(self, f"wh{g}", conv(self.schannels, use_bias=False))

    def step_pre(
        self, carry: Carry, gx: Array, lstate: Array, tf: Array
    ) -> Tuple[Carry, Array]:
        """One gate update from precomputed NWC x-gates ``gx`` [B, H, 4C]."""
        h, c = carry
        h = jnp.where(jnp.reshape(tf, (-1, 1, 1)), lstate, h)
        h_ = jnp.swapaxes(h, -1, -2)

        gi, gf, gc, go = jnp.split(gx + self.wh(h_), 4, axis=-1)
        ci, cf, co = nn.sigmoid(gi), nn.sigmoid(gf), nn.sigmoid(go)
        cc = cf * jnp.swapaxes(c, -1, -2) + ci * jnp.tanh(gc)
        ch = co * jnp.tanh(cc)
        return (jnp.swapaxes(ch, -1, -2), jnp.swapaxes(cc, -1, -2)), \
            jnp.swapaxes(ch, -1, -2)

    def __call__(
        self, carry: Carry, laction: Array, lstate: Array, tf: Array
    ) -> Tuple[Carry, Array]:
        x_ = jnp.swapaxes(laction, -1, -2)  # NWC for the convs

        if self.fused:
            return self.step_pre(carry, self.wx(x_), lstate, tf)

        h, c = carry
        h = jnp.where(jnp.reshape(tf, (-1, 1, 1)), lstate, h)
        h_ = jnp.swapaxes(h, -1, -2)

        xconv = lambda g: getattr(self, f"wx{g}")(x_)
        hconv = lambda g: getattr(self, f"wh{g}")(h_)
        ci = nn.sigmoid(xconv("i") + hconv("i"))
        cf = nn.sigmoid(xconv("f") + hconv("f"))
        cc = cf * jnp.swapaxes(c, -1, -2) + ci * jnp.tanh(
            xconv("c") + hconv("c")
        )
        co = nn.sigmoid(xconv("o") + hconv("o"))
        ch = co * jnp.tanh(cc)

        return (jnp.swapaxes(ch, -1, -2), jnp.swapaxes(cc, -1, -2)), \
            jnp.swapaxes(ch, -1, -2)


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

    @nn.compact
    def __call__(
        self, carry: Carry, laction: Array, lstate: Array, tf: Array
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
        out = self.fwd(augmented)
        out = out.reshape(b, self.schannels, self.ssize)
        return (sctx, actx), out


class PDESurrogate(nn.Module):
    """One surrogate (encoder + transition cell + decoder) with a fused
    rollout.  ``delta`` is the control-period length (= surrogate step)."""

    state_encoder: nn.Module
    state_decoder: nn.Module
    action_encoder: nn.Module
    cell: TransitionCell
    delta: float
    mode: str = AUTOREG

    def __call__(
        self,
        states: Array,
        actions: Array,
        dscaling: Transform = Identity(),
        hidden: Any = None,
        reencode: Any = None,
    ) -> ModelRollout:
        return self.rollout(states, actions, dscaling, hidden, reencode)

    def rollout(
        self,
        states: Array,
        actions: Array,
        dscaling: Transform = Identity(),
        hidden: Any = None,
        reencode: Any = None,
    ) -> ModelRollout:
        """Teacher-force over ``states`` then free-run to ``actions`` length.

        states  [B, Tw, C, H] — warmup ground truth (Tw may be 1 for pure
                continuation from a given state).
        actions [B, T, Ca, A] with T >= Tw; steps [0, Tw) are teacher-forced,
                [Tw, T) free-run.
        reencode: optional static bool array [T] (or True for all steps).
                At marked free-run steps the model *self-forces*: the hidden
                state is overwritten with the gradient-stopped re-encoding of
                its own previous output, and that output (detached) anchors
                the Euler update.  This reproduces two reference behaviours
                exactly: the world-env's repeated 1-step rollouts (each call
                re-enters the teacher-forcing branch on the previous
                prediction, world/world.py:159-161 -> surrogate.py:97-107)
                and the TBPTT chunk boundaries (detached ``dslast`` fed back
                as the next chunk's warmup, training.py:86-98).
        Returns ``ModelRollout`` with per-step ``outputs``/``deltas``/latents
        (time length T) and the final transition carry.
        """
        b, tw = states.shape[:2]
        t_total = actions.shape[1]
        actions = actions.astype(states.dtype)

        if reencode is None:
            reencode_np = np.zeros(t_total, bool)
        elif reencode is True:
            reencode_np = np.ones(t_total, bool)
        else:
            reencode_np = np.asarray(reencode, bool)
        reencode_any = bool(reencode_np.any())

        lstates = batched_apply(self.state_encoder, states)
        lactions = batched_apply(self.action_encoder, actions)

        pad = t_total - tw
        if pad > 0:
            zpad = lambda x: jnp.concatenate(
                [x, jnp.zeros((b, pad) + x.shape[2:], x.dtype)], axis=1
            )
            states_p, lstates_p = zpad(states), zpad(lstates)
        else:
            states_p, lstates_p = states, lstates

        if hidden is None:
            hidden = self.cell.init_carry(b, states.dtype)

        tf_flags = (jnp.arange(t_total) < tw)[None, :].repeat(b, axis=0)
        re_flags = jnp.asarray(reencode_np)[None, :].repeat(b, axis=0)

        if self.mode == AUTOREG:
            carry0 = (hidden, states[:, 0])

            def step(mdl, carry, xs):
                hidden, prev = carry
                state_gt, lstate_gt, laction, tf, re = xs
                tfb = tf[:, None, None]
                reb = re[:, None, None]

                if reencode_any:
                    # Self-forcing step: detach the carried state/hidden (the
                    # reference detaches dslast and the hidden between TBPTT
                    # chunks, training.py:86-98).
                    prev = jnp.where(reb, jax.lax.stop_gradient(prev), prev)
                    hidden = jax.tree.map(
                        lambda h: jnp.where(
                            re.reshape((-1,) + (1,) * (h.ndim - 1)),
                            jax.lax.stop_gradient(h),
                            h,
                        ),
                        hidden,
                    )

                if mdl.cell.needs_prev_latent or reencode_any:
                    # Two distinct detach semantics from the reference:
                    # self-forcing (TBPTT boundary) encodes the *detached*
                    # output but keeps encoder-weight gradients
                    # (training.py:86-98 -> surrogate.py:80); the plain
                    # free-run `inlast` detaches the encoder *output*
                    # (surrogate.py:103,115).
                    raw = mdl.state_encoder(jax.lax.stop_gradient(prev))
                    prev_lat = jnp.where(reb, raw, jax.lax.stop_gradient(raw))
                    lstate_in = jnp.where(tfb, lstate_gt, prev_lat)
                else:
                    # LSTM-family cells ignore lstate when not forcing
                    # (reference transition() ignores `states`), so skip the
                    # per-step re-encode the reference computes and discards.
                    prev_lat = lstate_gt
                    lstate_in = lstate_gt

                force = jnp.logical_or(tf, re)
                hidden, outlat = mdl.cell(hidden, laction, lstate_in, force)
                outdelta = mdl.state_decoder(outlat)
                base = jnp.where(tfb, state_gt, prev)
                out = base + mdl.delta * dscaling.apply(outdelta)
                inlat = jnp.where(tfb, lstate_gt, prev_lat)
                return (hidden, out), (out, outdelta, outlat, inlat)

            scan = nn.scan(
                step,
                variable_broadcast="params",
                split_rngs={"params": False},
                in_axes=1,
                out_axes=1,
            )
            (hidden, _), (outputs, outdeltas, outlats, inlats) = scan(
                self, carry0, (states_p, lstates_p, lactions, tf_flags, re_flags)
            )
            return ModelRollout(
                outputs=outputs,
                inlatents=inlats,
                outlatents=outlats,
                deltas=outdeltas,
                hidden=hidden,
            )

        elif self.mode == LATENT:
            carry0 = (hidden, lstates[:, 0], states[:, 0])

            def step(mdl, carry, xs):
                hidden, inlatent, prev_out = carry
                lstate_gt, laction, tf, re = xs
                tfb = tf[:, None, None]

                if reencode_any:
                    # Self-forcing: re-anchor the integrated latent on the
                    # (detached) re-encoding of the previous decoded output —
                    # what the reference's repeated 1-step world rollouts do
                    # (surrogate.py:158-160 run the encoder on the previous
                    # outputs at every call).
                    reb = re[:, None, None]
                    relat = mdl.state_encoder(jax.lax.stop_gradient(prev_out))
                    inlatent = jnp.where(reb, relat, inlatent)
                    hidden = jax.tree.map(
                        lambda h: jnp.where(
                            re.reshape((-1,) + (1,) * (h.ndim - 1)),
                            jax.lax.stop_gradient(h),
                            h,
                        ),
                        hidden,
                    )

                lstate_in = jnp.where(tfb, lstate_gt, inlatent)
                force = jnp.logical_or(tf, re)
                hidden, outlat = mdl.cell(hidden, laction, lstate_in, force)
                nxtlatent = inlatent + mdl.delta * outlat
                out = mdl.state_decoder(nxtlatent)
                inlat = jnp.where(tfb, lstate_gt, inlatent)
                return (hidden, nxtlatent, out), (out, outlat, inlat)

            scan = nn.scan(
                step,
                variable_broadcast="params",
                split_rngs={"params": False},
                in_axes=1,
                out_axes=1,
            )
            (hidden, _, _), (outputs, outlats, inlats) = scan(
                self, carry0, (lstates_p, lactions, tf_flags, re_flags)
            )
            # Per-step deltas recovered from the decoded trajectory
            # (surrogate.py:197-198), mapped back through the delta scaling.
            augmented = jnp.concatenate([states[:, :1], outputs], axis=1)
            deltas = dscaling.inverse(jnp.diff(augmented, axis=1) / self.delta)
            return ModelRollout(
                outputs=outputs,
                inlatents=inlats,
                outlatents=outlats,
                deltas=deltas,
                hidden=hidden,
            )

        raise ValueError(f"unknown mode {self.mode!r}")




def _conv_lstm_parts(N: int = 64, **_):
    """Shared encoder/decoder/cell of the conv-LSTM families
    (architectures/autoreg.py:49-101, latent.py:16-60)."""
    lat = N // 4  # two stride-2 stages
    state_encoder = ConvNet(
        blocks=[ResidualBlock] * 3,
        features=[8, 16, 16],
        kernel_size=[3, 3, 3],
        stride=[2, 2, 1],
        activation=[nn.silu] * 3,
        layernorm=[True] * 3,
    )
    action_encoder = ConvNet(
        blocks=[ResidualBlock] * 3,
        features=[2, 4, 4],
        kernel_size=[3, 3, 3],
        stride=[2, 2, 1],
        activation=[nn.silu] * 3,
        layernorm=[True] * 3,
    )
    state_decoder = ConvNet(
        blocks=[DeConvBlock, DeConvBlock, ConvBlock, ConvBlock],
        features=[16, 8, 1, 1],
        kernel_size=[3, 3, 7, 5],
        stride=[2, 2, 1, 1],
        activation=[nn.silu, nn.silu, nn.silu, lambda x: x],
        layernorm=[True, True, True, False],
    )
    cell = CNNLSTMCell(schannels=16, ssize=lat)
    return state_encoder, state_decoder, action_encoder, cell


def ks_autoreg_conv_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Main model (architectures/autoreg.py:44-101)."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )


def ks_latent_conv_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Hard-encoded-IC ablation (architectures/latent.py:10-67)."""
    enc, dec, aenc, cell = _conv_lstm_parts(N=N)
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=LATENT,
    )


def ks_autoreg_fc_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Spatial/temporal locality ablation (architectures/autoreg.py:10-41)."""
    enc = MLP(sizes=[(1, N // 2), (1, N // 4)], activations=[nn.silu, nn.silu])
    dec = MLP(sizes=[(1, N // 2), (1, N)], activations=[nn.silu, nn.tanh])
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=IdentityModule(),
        cell=LSTMCell(schannels=1, ssize=N // 4), delta=delta, mode=AUTOREG,
    )


def ks_latent_lstm(delta: float, N: int = 64, **kwargs) -> PDESurrogate:
    """Fully-connected LSTM baseline (architectures/latent.py:70-101)."""
    enc = MLP(sizes=[(1, N // 2), (1, N // 4)], activations=[nn.elu, nn.elu])
    dec = MLP(sizes=[(1, N // 2), (1, N)], activations=[nn.elu, lambda x: x])
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=IdentityModule(),
        cell=LSTMCell(schannels=1, ssize=N // 4), delta=delta, mode=LATENT,
    )


def ks_delay_cnn(delta: float, N: int = 64, delay: int = 3, **kwargs) -> PDESurrogate:
    """Delay-history model (architectures/delay.py:19-79)."""
    lat = N // 8  # three stride-2 stages
    enc = ConvNet(
        blocks=[ResidualBlock] * 3,
        features=[1, 4, 8],
        kernel_size=[3, 3, 3],
        stride=[2, 2, 2],
        activation=[nn.elu, nn.elu, nn.tanh],
        layernorm=[True, True, False],
    )
    dec = ConvNet(
        blocks=[DeConvBlock, DeConvBlock, DeConvBlock, ConvBlock],
        features=[8, 4, 1, 1],
        kernel_size=[3, 3, 3, 5],
        stride=[2, 2, 2, 1],
        activation=[nn.elu, nn.elu, nn.elu, nn.tanh],
        layernorm=[True, True, False, False],
    )
    aenc = MLP(sizes=[(4, 4), (4, lat)], activations=[nn.elu, nn.tanh])
    fwd = MLP(
        sizes=[(12, lat), (8, lat), (8, lat)],
        activations=[nn.elu, nn.elu, nn.tanh],
    )
    cell = DelayCell(
        schannels=8, ssize=lat, achannels=4, asize=lat, delay=delay, fwd=fwd
    )
    return PDESurrogate(
        state_encoder=enc, state_decoder=dec, action_encoder=aenc,
        cell=cell, delta=delta, mode=AUTOREG,
    )


LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPSILON = 1e-6

_kernel_init = nn.initializers.xavier_uniform()


def _dense(features: int, name: str) -> nn.Dense:
    return nn.Dense(features, kernel_init=_kernel_init,
                    bias_init=nn.initializers.zeros, name=name)


class GaussianPolicy(nn.Module):
    achannels: int
    asize: int
    hidden: int = 256
    action_scale: float = 1.0
    action_bias: float = 0.0

    @nn.compact
    def __call__(self, obs: Array) -> Tuple[Array, Array]:
        b = obs.shape[0]
        x = obs.reshape(b, -1)
        x = nn.relu(_dense(self.hidden, "linear1")(x))
        x = nn.relu(_dense(self.hidden, "linear2")(x))
        mean = _dense(self.achannels * self.asize, "mean")(x)
        log_std = _dense(self.achannels * self.asize, "log_std")(x)
        log_std = jnp.clip(log_std, LOG_SIG_MIN, LOG_SIG_MAX)
        shape = (b, self.achannels, self.asize)
        return mean.reshape(shape), log_std.reshape(shape)

    def sample(self, obs: Array, key: Array) -> Tuple[Array, Array, Array]:
        """Reparameterised sample -> (action, log_prob [B, 1], det_mean)."""
        mean, log_std = self(obs)
        std = jnp.exp(log_std)
        noise = jax.random.normal(key, mean.shape, mean.dtype)
        x_t = mean + std * noise
        y_t = jnp.tanh(x_t)
        action = y_t * self.action_scale + self.action_bias

        # Normal log-prob + tanh-squash correction (policies.py:119-123).
        log_prob = -0.5 * ((x_t - mean) / std) ** 2 - log_std - 0.5 * jnp.log(
            2.0 * jnp.pi
        )
        log_prob = log_prob - jnp.log(
            self.action_scale * (1.0 - y_t**2) + EPSILON
        )
        log_prob = jnp.sum(log_prob, axis=(1, 2)).reshape(-1, 1)

        det = jnp.tanh(mean) * self.action_scale + self.action_bias
        return action, log_prob, det


class QNetwork(nn.Module):
    """Twin Q (policies.py:36-70)."""

    hidden: int = 256

    @nn.compact
    def __call__(self, obs: Array, action: Array) -> Tuple[Array, Array]:
        b = obs.shape[0]
        xu = jnp.concatenate([obs.reshape(b, -1), action.reshape(b, -1)], axis=1)

        x1 = nn.relu(_dense(self.hidden, "linear1")(xu))
        x1 = nn.relu(_dense(self.hidden, "linear2")(x1))
        x1 = _dense(1, "linear3")(x1)

        x2 = nn.relu(_dense(self.hidden, "linear4")(xu))
        x2 = nn.relu(_dense(self.hidden, "linear5")(x2))
        x2 = _dense(1, "linear6")(x2)
        return x1, x2
