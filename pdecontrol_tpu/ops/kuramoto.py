"""Kuramoto–Sivashinsky right-hand side and time integration.

Physics reproduced from the reference solver
(``/root/reference/pdegym/kuramoto/kuramoto.py:78-129``):

    u_t = -u_xxxx - u_xx - 0.5 * (u^2)_x + phi

on a periodic domain discretised with

  * 2nd-order-accurate one-sided (upwind) differences on ``u^2`` selected
    per-point by ``sign(u)`` (kuramoto.py:120-122),
  * 6th-order central differences for ``u_xx`` and ``u_xxxx``
    (kuramoto.py:124-125),
  * classic RK4 with ``cfg_steps`` sub-steps per control period
    (kuramoto.py:83-90), and the per-sub-step reward accumulated *before*
    each sub-step and averaged over the period (kuramoto.py:82-96).

All stencils are materialised as circulant matrices and the four derivative
fields are produced by two matmuls per RHS evaluation (``[B, N] @ [N, 2N]``),
so a batch of environments is one batched product.  The ``cfg_steps``
sub-step loop is a ``lax.scan`` (compiled once, no Python).  A fused GPU
kernel for the control period (Pallas through Triton) was measured slower
than this path on an H100 and removed (``PERF.md``); its source is kept,
unimported, in ``records/ks_control_period_triton.py``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrol_tpu.ops import stencils
from pdecontrol_tpu.utils.pytree import PyTreeNode, field

# Reward objectives (see pdegym/kuramoto/kuramoto.py:64-73).
L2CONTROL = "l2control"
DISSIPATION = "dissipation"


class KSOperators(PyTreeNode):
    """Precomputed spectral-free FD operators for one grid resolution.

    ``central``: ``[N, 2N]`` — columns ``[:N]`` give ``u_xx`` (6th-order
    central / dx^2), columns ``[N:]`` give ``u_xxxx`` (6th-order central
    / dx^4).  ``upwind``: ``[N, 2N]`` — forward / backward one-sided first
    derivative / dx, applied to ``u^2``.
    """

    central: jax.Array
    upwind: jax.Array
    # Static (non-pytree) metadata.
    n: int = field(static=True)
    dx: float = field(static=True)
    precision: jax.lax.Precision = field(
        static=True, default=jax.lax.Precision.HIGHEST
    )

    @classmethod
    def create(
        cls,
        n: int,
        length: float,
        dtype=jnp.float32,
        precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    ) -> "KSOperators":
        dx = length / n
        central = stencils.stacked_matrix(
            [stencils.SECOND_DERIV_CENTRAL_6, stencils.FOURTH_DERIV_CENTRAL_6],
            n,
            scales=[1.0 / dx**2, 1.0 / dx**4],
        )
        upwind = stencils.stacked_matrix(
            [stencils.FIRST_DERIV_UPWIND_FWD, stencils.FIRST_DERIV_UPWIND_BWD],
            n,
            scales=[1.0 / dx, 1.0 / dx],
        )
        return cls(
            central=jnp.asarray(central, dtype=dtype),
            upwind=jnp.asarray(upwind, dtype=dtype),
            n=n,
            dx=dx,
            precision=precision,
        )


def ks_derivatives(
    ops: KSOperators, u: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Return ``(u_x, u_xx, u_xxxx)`` with the reference's conventions.

    ``u_x`` is the upwind-selected derivative of ``u**2`` (this mirrors the
    reference where ``rhs`` differentiates ``u**2`` and the dissipation reward
    consumes that same field; kuramoto.py:120-122,67-70).
    """
    cderivs = jnp.matmul(u, ops.central, precision=ops.precision)
    u_xx, u_xxxx = cderivs[..., : ops.n], cderivs[..., ops.n :]

    uderivs = jnp.matmul(u * u, ops.upwind, precision=ops.precision)
    fwd, bwd = uderivs[..., : ops.n], uderivs[..., ops.n :]
    u_x = jnp.where(u < 0, fwd, bwd)
    return u_x, u_xx, u_xxxx


def ks_rhs(ops: KSOperators, u: jax.Array, phi: jax.Array) -> jax.Array:
    """dU/dt = -u_xxxx - u_xx - 0.5 * upwind((u^2)_x) + phi (kuramoto.py:127)."""
    u_x, u_xx, u_xxxx = ks_derivatives(ops, u)
    return -u_xxxx - u_xx - 0.5 * u_x + phi


def ks_reward(
    ops: KSOperators, u: jax.Array, phi: jax.Array, objective: str
) -> jax.Array:
    """Per-sub-step reward on the *pre-step* state (kuramoto.py:64-73,84).

    ``l2control``: ``-(1/N) * ||u||_2^2``.  ``dissipation``:
    ``-(mean(u_xx^2) + mean(u_x^2) + mean(u * phi))`` where ``u_x`` is the
    upwind derivative of ``u^2`` — a reference quirk preserved on purpose.
    """
    if objective == L2CONTROL:
        return -jnp.sum(u * u, axis=-1) / ops.n
    if objective == DISSIPATION:
        u_x, u_xx, _ = ks_derivatives(ops, u)
        return -(
            jnp.mean(u_xx * u_xx, axis=-1)
            + jnp.mean(u_x * u_x, axis=-1)
            + jnp.mean(u * phi, axis=-1)
        )
    raise ValueError(f"unknown objective {objective!r}")


def ks_rk4_substep(
    ops: KSOperators, dt: float, u: jax.Array, phi: jax.Array
) -> jax.Array:
    """One classic RK4 sub-step, arithmetic ordered as kuramoto.py:85-90."""
    k1 = ks_rhs(ops, u, phi)
    k2 = ks_rhs(ops, u + dt * k1 / 2.0, phi)
    k3 = ks_rhs(ops, u + dt * k2 / 2.0, phi)
    k4 = ks_rhs(ops, u + dt * k3, phi)
    return u + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


@functools.partial(jax.jit, static_argnames=("cfg_steps", "objective"))
def ks_control_period(
    ops: KSOperators,
    u: jax.Array,
    phi: jax.Array,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[jax.Array, jax.Array]:
    """Advance one control period (``cfg_steps`` RK4 sub-steps, fixed ``phi``).

    Returns ``(u_next, reward)`` with ``reward`` the period-mean of the
    per-sub-step objective, exactly as kuramoto.py:82-96.
    """

    def body(carry, _):
        u, acc = carry
        acc = acc + ks_reward(ops, u, phi, objective)
        u = ks_rk4_substep(ops, dt, u, phi)
        return (u, acc), None

    zero = jnp.zeros(u.shape[:-1], dtype=u.dtype)
    (u, acc), _ = jax.lax.scan(body, (u, zero), None, length=cfg_steps)
    return u, acc / cfg_steps


def ks_transient(
    ops: KSOperators,
    u: jax.Array,
    dt: float,
    cfg_steps: int,
    periods: int,
) -> jax.Array:
    """No-op (phi = 0) burn-in onto the chaotic attractor (kuramoto.py:103-109)."""
    phi = jnp.zeros_like(u)

    def body(u, _):
        u, _ = ks_control_period(ops, u, phi, dt, cfg_steps, L2CONTROL)
        return u, None

    u, _ = jax.lax.scan(body, u, None, length=periods)
    return u


def gaussian_forcing_matrix(
    x: np.ndarray, xi_rel: np.ndarray, sigma: float, length: float, dtype=np.float64
) -> np.ndarray:
    """Gaussian-jet actuation matrix ``F`` with ``phi = a @ F``.

    Mirrors ``pdegym/common/transforms.py:258-260`` including its
    normalisation quirk ``1 / sqrt(2*pi*sigma)`` (sigma not squared).
    """
    xi = (length * np.asarray(xi_rel, dtype=np.float64)).reshape(-1, 1)
    x = np.asarray(x, dtype=np.float64)
    mat = np.exp(-((x - xi) ** 2) / (2.0 * sigma**2))
    mat = mat / np.sqrt(2.0 * np.pi * sigma)
    return mat.astype(dtype)
