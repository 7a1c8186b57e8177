"""Viscous Burgers equation ops (fills the reference snapshot's gap).

The reference README advertises Burgers control but the ``pdegym/burgers``
package is missing from the snapshot (``pdegym/__init__.py:2`` imports it and
fails).  The only surviving trace is ``BurgersPhyPDELoss``
(``/root/reference/pdecontrol/surrogates/phyloss/phyloss.py:36-89``), which
fixes the numerics we adopt here:

    u_t = nu * u_xx - u * u_x + phi

with a 2nd-order central first derivative, a 4th-order central second
derivative, periodic boundaries, and Heun (improved Euler) time stepping
(``phyevolve``, phyloss.py:83-86).  The episode/actuation structure mirrors
the KS environment (Gaussian jets, ``cfg_steps`` sub-steps per control
period, period-averaged reward).

Same formulation as the KS ops: stencils as circulant matrices, one fused
``[B, N] @ [N, 2N]`` matmul per RHS evaluation, ``lax.scan`` over sub-steps.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from pdecontrol_tpu.ops import stencils
from pdecontrol_tpu.utils.pytree import PyTreeNode, field

L2CONTROL = "l2control"
DISSIPATION = "dissipation"


class BurgersOperators(PyTreeNode):
    """``deriv``: ``[N, 2N]`` — ``u_x`` (central-2 / dx) and ``u_xx``
    (central-4 / dx^2) evaluated in one matmul."""

    deriv: jax.Array
    n: int = field(static=True)
    dx: float = field(static=True)
    nu: float = field(static=True)
    precision: jax.lax.Precision = field(
        static=True, default=jax.lax.Precision.HIGHEST
    )

    @classmethod
    def create(
        cls,
        n: int,
        length: float,
        nu: float,
        dtype=jnp.float32,
        precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    ) -> "BurgersOperators":
        dx = length / n
        deriv = stencils.stacked_matrix(
            [stencils.FIRST_DERIV_CENTRAL_2, stencils.SECOND_DERIV_CENTRAL_4],
            n,
            scales=[1.0 / dx, 1.0 / dx**2],
        )
        return cls(
            deriv=jnp.asarray(deriv, dtype=dtype),
            n=n,
            dx=dx,
            nu=nu,
            precision=precision,
        )


def burgers_derivatives(ops: BurgersOperators, u: jax.Array) -> Tuple[jax.Array, jax.Array]:
    derivs = jnp.matmul(u, ops.deriv, precision=ops.precision)
    return derivs[..., : ops.n], derivs[..., ops.n :]


def burgers_rhs(ops: BurgersOperators, u: jax.Array, phi: jax.Array) -> jax.Array:
    """``nu * u_xx - u * u_x + phi`` (phyloss.py:81, plus actuation)."""
    u_x, u_xx = burgers_derivatives(ops, u)
    return ops.nu * u_xx - u * u_x + phi


def burgers_reward(
    ops: BurgersOperators, u: jax.Array, phi: jax.Array, objective: str
) -> jax.Array:
    if objective == L2CONTROL:
        return -jnp.sum(u * u, axis=-1) / ops.n
    if objective == DISSIPATION:
        u_x, u_xx = burgers_derivatives(ops, u)
        return -(
            jnp.mean(u_xx * u_xx, axis=-1)
            + jnp.mean(u_x * u_x, axis=-1)
            + jnp.mean(u * phi, axis=-1)
        )
    raise ValueError(f"unknown objective {objective!r}")


def burgers_heun_substep(
    ops: BurgersOperators, dt: float, u: jax.Array, phi: jax.Array
) -> jax.Array:
    """Heun / improved-Euler sub-step, ordered as phyloss.py:83-86."""
    utilde = u + 0.5 * dt * burgers_rhs(ops, u, phi)
    return u + dt * burgers_rhs(ops, utilde, phi)


@functools.partial(jax.jit, static_argnames=("cfg_steps", "objective"))
def burgers_control_period(
    ops: BurgersOperators,
    u: jax.Array,
    phi: jax.Array,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[jax.Array, jax.Array]:
    """Advance one control period; returns ``(u_next, period-mean reward)``."""

    def body(carry, _):
        u, acc = carry
        acc = acc + burgers_reward(ops, u, phi, objective)
        u = burgers_heun_substep(ops, dt, u, phi)
        return (u, acc), None

    zero = jnp.zeros(u.shape[:-1], dtype=u.dtype)
    (u, acc), _ = jax.lax.scan(body, (u, zero), None, length=cfg_steps)
    return u, acc / cfg_steps
