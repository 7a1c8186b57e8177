"""Composable, invertible, *stateful* data transforms as immutable pytrees.

Re-designs the reference's mutable ``Transform`` algebra
(``/root/reference/pdegym/common/transforms.py``) for JAX: every transform is
a frozen-dataclass pytree carrying its running statistics as arrays, and

  * ``t.apply(x)``      — forward map (reference ``__call__``),
  * ``t.inverse(x)``    — exact inverse (reference ``.Inverse.__call__``),
  * ``t.update(x)``     — returns a *new* transform with updated running
    statistics (reference ``.update``; a no-op when ``frozen``),
  * ``t.inv``           — an inverted *view* (reference ``.Inverse``): apply
    and inverse swap, and ``update`` maps values through the inverse before
    updating the base statistics (transforms.py:26-28).

Because transforms are pytrees they pass through ``jit``/``scan`` as carries,
which is how frozen=False running statistics live inside the jitted collect
loop (the reference updates them imperatively inside its vec-env wrappers,
``pdegym/common/vec_wrappers.py:157-160``).

Reduction-axis conventions follow transforms.py:71-78: ``aggregate`` and
``batched`` select which leading/trailing axes the statistics pool over.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrol_tpu.utils.pytree import PyTreeNode, field

Array = jax.Array


def _reduce_axes(aggregate: bool, batched: bool, ndim: int) -> Tuple[int, ...]:
    """Reference dim-selection table (transforms.py:71-78, 151-158)."""
    if aggregate and batched:
        return (0, 1, 2)[:ndim]
    if aggregate or batched:
        return (0, 1)[:ndim]
    return (0,)


def _reduced_shape(shape: Sequence[int], axes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(1 if i in axes else s for i, s in enumerate(shape))


class Transform(PyTreeNode):
    """Base: identity with no state."""

    def apply(self, values: Array) -> Array:
        return values

    def inverse(self, values: Array) -> Array:
        return values

    def update(self, values: Array) -> "Transform":
        return self

    def __call__(self, values: Array) -> Array:
        return self.apply(values)

    @property
    def inv(self) -> "Transform":
        return Inverted(base=self)


class Identity(Transform):
    pass


class Inverted(Transform):
    """Inverted view: swaps apply/inverse; ``update`` maps through the
    inverse first, then updates the base (transforms.py:26-28)."""

    base: Transform = None

    def apply(self, values: Array) -> Array:
        return self.base.inverse(values)

    def inverse(self, values: Array) -> Array:
        return self.base.apply(values)

    def update(self, values: Array) -> "Inverted":
        mapped = self.base.inverse(values)
        return self.replace(base=self.base.update(mapped))

    @property
    def inv(self) -> Transform:
        return self.base


class Normalize(Transform):
    """Running mean/variance standardisation (transforms.py:62-138).

    The merge follows the reference's parallel-variance update taken from
    gym's ``NormalizeObservation`` (transforms.py:121-127), including its
    quirks: the sample count increments by the *batch size* (first axis)
    regardless of how many elements the reduction pools, and the batch
    variance uses Bessel's correction (``torch.var`` default).
    """

    mean: Array = None
    var: Array = None
    count: Array = None
    aggregate: bool = field(static=True, default=False)
    batched: bool = field(static=True, default=False)
    frozen: bool = field(static=True, default=False)
    epsilon: float = field(static=True, default=1e-4)

    @classmethod
    def create(
        cls,
        shape: Sequence[int],
        aggregate: bool = False,
        batched: bool = False,
        frozen: bool = False,
        epsilon: float = 1e-4,
        dtype=jnp.float32,
    ) -> "Normalize":
        axes = _reduce_axes(aggregate, batched, len(shape))
        rshape = _reduced_shape(shape, axes)
        return cls(
            mean=jnp.zeros(rshape, dtype),
            var=jnp.zeros(rshape, dtype),
            count=jnp.zeros((), dtype),
            aggregate=aggregate,
            batched=batched,
            frozen=frozen,
            epsilon=epsilon,
        )

    @property
    def axes(self) -> Tuple[int, ...]:
        return _reduce_axes(self.aggregate, self.batched, self.mean.ndim)

    def apply(self, values: Array) -> Array:
        return (values - self.mean) / jnp.sqrt(self.var + self.epsilon)

    def inverse(self, values: Array) -> Array:
        return values * jnp.sqrt(self.var + self.epsilon) + self.mean

    def update(self, values: Array) -> "Normalize":
        if self.frozen:
            return self
        axes = self.axes
        bsize = values.shape[0]
        batch_mean = jnp.mean(values, axis=axes, keepdims=True)
        batch_var = jnp.var(values, axis=axes, keepdims=True, ddof=1)

        delta = batch_mean - self.mean
        tot = self.count + bsize
        mean = self.mean + delta * bsize / tot
        m_a = self.var * self.count
        m_b = batch_var * bsize
        m2 = m_a + m_b + jnp.square(delta) * self.count * bsize / tot
        return self.replace(mean=mean, var=m2 / tot, count=tot)

    def reset(self) -> "Normalize":
        return self.replace(
            mean=jnp.zeros_like(self.mean),
            var=jnp.zeros_like(self.var),
            count=jnp.zeros_like(self.count),
        )


class Scale(Transform):
    """Running min/max rescaling onto ``[lower, upper]`` (transforms.py:141-210)."""

    vmin: Array = None
    vmax: Array = None
    lower: Array = None
    upper: Array = None
    aggregate: bool = field(static=True, default=False)
    batched: bool = field(static=True, default=False)
    frozen: bool = field(static=True, default=False)

    @classmethod
    def create(
        cls,
        shape: Sequence[int],
        scale: Tuple[float, float] = (-1.0, 1.0),
        bounds: Tuple[Any, Any] = (-np.inf, np.inf),
        aggregate: bool = False,
        batched: bool = False,
        frozen: bool = False,
        dtype=jnp.float32,
    ) -> "Scale":
        axes = _reduce_axes(aggregate, batched, len(shape))
        rshape = _reduced_shape(shape, axes)
        vmin = np.broadcast_to(np.asarray(bounds[0], dtype=np.float64), shape)
        vmax = np.broadcast_to(np.asarray(bounds[1], dtype=np.float64), shape)
        # Known bounds are pooled onto the reduced shape (transforms.py:168-170).
        vmin = np.min(vmin, axis=axes, keepdims=True) + np.zeros(rshape)
        vmax = np.max(vmax, axis=axes, keepdims=True) + np.zeros(rshape)
        # Unknown (infinite) bounds become opposite-sign sentinels so the
        # running min/max update can tighten them (transforms.py:186-194).
        vmin = np.where(np.isneginf(vmin), np.inf, vmin)
        vmax = np.where(np.isposinf(vmax), -np.inf, vmax)
        return cls(
            vmin=jnp.asarray(vmin, dtype),
            vmax=jnp.asarray(vmax, dtype),
            lower=jnp.asarray(scale[0], dtype),
            upper=jnp.asarray(scale[1], dtype),
            aggregate=aggregate,
            batched=batched,
            frozen=frozen,
        )

    @property
    def axes(self) -> Tuple[int, ...]:
        return _reduce_axes(self.aggregate, self.batched, self.vmin.ndim)

    def apply(self, values: Array) -> Array:
        return (values - self.vmin) / (self.vmax - self.vmin) * (
            self.upper - self.lower
        ) + self.lower

    def inverse(self, values: Array) -> Array:
        return (values - self.lower) / (self.upper - self.lower) * (
            self.vmax - self.vmin
        ) + self.vmin

    def update(self, values: Array) -> "Scale":
        if self.frozen:
            return self
        axes = self.axes
        vmin = jnp.minimum(jnp.min(values, axis=axes, keepdims=True), self.vmin)
        vmax = jnp.maximum(jnp.max(values, axis=axes, keepdims=True), self.vmax)
        return self.replace(vmin=vmin, vmax=vmax)


class Sensor(Transform):
    """Strided spatial subsampling (transforms.py:231-247).  Invertible only
    for stride 1 (identity), matching the reference."""

    stride: int = field(static=True, default=1)

    def apply(self, values: Array) -> Array:
        return values[..., self.stride // 2 :: self.stride]

    def inverse(self, values: Array) -> Array:
        if self.stride > 1:
            raise NotImplementedError("Sensor inverse undefined for stride > 1")
        return values


class GaussianForcing(Transform):
    """Action coefficients -> spatial forcing field, with exact inverse.

    ``apply(a) = a @ F`` where ``F[j] = exp(-(x - xi_j)^2 / (2 sigma^2)) /
    sqrt(2 pi sigma)`` (transforms.py:258-260 — note the reference's
    ``sqrt(2*pi*sigma)`` normalisation quirk, preserved).  The inverse reads
    the field at the jet centres and multiplies by the inverse of the
    ``[jets, jets]`` sub-matrix (transforms.py:267-279).
    """

    matrix: Array = None  # [jets, N]
    inv_matrix: Array = None  # [jets, jets]
    jet_idx: Array = None  # [jets] int32

    @classmethod
    def create(
        cls,
        n: int,
        length: float,
        xi_rel: Sequence[float],
        sigma: float,
        dtype=jnp.float32,
        zero_mean: bool = False,
    ) -> "GaussianForcing":
        """``zero_mean=True`` subtracts each jet's spatial mean from its
        column of the forcing matrix, making the actuation momentum-
        conserving (used by the Burgers env for well-posedness under
        sustained forcing; the KS env keeps the reference's raw jets).
        The exact inverse is recomputed from the modified matrix."""
        from pdecontrol_tpu.ops.kuramoto import gaussian_forcing_matrix

        x = np.linspace(0.0, length - length / n, n, dtype=np.float64)
        mat = gaussian_forcing_matrix(x, np.asarray(xi_rel), sigma, length)
        if zero_mean:
            mat = mat - mat.mean(axis=1, keepdims=True)
        jet_idx = (n * np.asarray(xi_rel, dtype=np.float64)).astype(np.int64)
        inv = np.linalg.inv(mat[:, jet_idx])
        return cls(
            matrix=jnp.asarray(mat, dtype),
            inv_matrix=jnp.asarray(inv, dtype),
            jet_idx=jnp.asarray(jet_idx, jnp.int32),
        )

    def apply(self, values: Array) -> Array:
        return jnp.matmul(values, self.matrix, precision=jax.lax.Precision.HIGHEST)

    def inverse(self, values: Array) -> Array:
        sampled = values[..., self.jet_idx]
        return jnp.matmul(sampled, self.inv_matrix, precision=jax.lax.Precision.HIGHEST)


class Chain(Transform):
    """Sequential composition (reference ``Operation``, transforms.py:310-341).

    ``apply`` runs left-to-right; ``inverse`` runs the inverses right-to-left;
    ``update`` performs the reference's update-then-apply sweep so that later
    transforms see already-transformed values (transforms.py:322-328).
    """

    transforms: Tuple[Transform, ...] = ()

    def apply(self, values: Array) -> Array:
        for t in self.transforms:
            values = t.apply(values)
        return values

    def inverse(self, values: Array) -> Array:
        for t in reversed(self.transforms):
            values = t.inverse(values)
        return values

    def update(self, values: Array) -> "Chain":
        new = []
        for t in self.transforms:
            t = t.update(values)
            values = t.apply(values)
            new.append(t)
        return self.replace(transforms=tuple(new))


class FuncTransform(Transform):
    """Wraps a pure function pair (reference ``FuncTransform``,
    transforms.py:213-228).  Stateless; stored as static fields."""

    fn: Any = field(static=True, default=None)
    inv_fn: Any = field(static=True, default=None)

    def apply(self, *args):
        return self.fn(*args)

    def inverse(self, *args):
        if self.inv_fn is None:
            raise NotImplementedError
        return self.inv_fn(*args)


class SampleTransform(PyTreeNode):
    """Applies an obs-chain to obs/nxtobs and an action-chain to actions of a
    ``Sample`` pytree (reference transforms.py:344-374)."""

    otransf: Transform = Identity()
    atransf: Transform = Identity()

    def __call__(self, sample):
        return sample.replace(
            obs=self.otransf.apply(sample.obs),
            nxtobs=self.otransf.apply(sample.nxtobs),
            actions=self.atransf.apply(sample.actions),
        )

    def apply(self, sample):
        return self(sample)

    @property
    def inv(self) -> "SampleTransform":
        return SampleTransform(otransf=self.otransf.inv, atransf=self.atransf.inv)
