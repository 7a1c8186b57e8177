"""Viscous Burgers control environment (batched, functional).

The reference advertises a Burgers environment but the snapshot lacks it
(``/root/reference/pdegym/__init__.py:2`` imports a package that does not
exist).  This module makes the capability real, adopting the numerics fixed
by the surviving ``BurgersPhyPDELoss``
(``/root/reference/pdecontrol/surrogates/phyloss/phyloss.py:36-89``): central
2nd/4th-order stencils, Heun time stepping, periodic domain.  Episode and
actuation structure mirror the KS environment (Gaussian jets, period-averaged
reward, truncation-only episodes) so the whole surrogate/MBRL stack applies
unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrol_tpu.envs.kuramoto import EnvState, StepOut
from pdecontrol_tpu.envs.transforms import GaussianForcing
from pdecontrol_tpu.ops.burgers import (
    DISSIPATION,
    L2CONTROL,
    BurgersOperators,
    burgers_control_period,
    burgers_reward,
)
from pdecontrol_tpu.utils.pytree import PyTreeNode, field

Array = jax.Array


class Burgers(PyTreeNode):
    ops: BurgersOperators
    forcing: GaussianForcing
    length: float = field(static=True, default=16.0)
    n: int = field(static=True, default=64)
    nu: float = field(static=True, default=0.25)
    cfg_steps: int = field(static=True, default=250)
    t_max: float = field(static=True, default=100.0)
    dt: float = field(static=True, default=1e-3)
    sigma: float = field(static=True, default=0.4)
    objective: str = field(static=True, default="dissipation")
    legacy_objective: bool = field(static=True, default=True)
    xi_rel: Tuple[float, ...] = field(
        static=True, default=(0.0, 0.25, 0.5, 0.75)
    )
    ic_modes: int = field(static=True, default=4)

    @classmethod
    def create(
        cls,
        length: float = 16.0,
        n: int = 64,
        nu: float = 0.25,
        cfg_steps: int = 250,
        t_max: float = 100.0,
        dt: float = 1e-3,
        sigma: float = 0.4,
        objective: str = "dissipation",
        legacy_objective: bool = True,
        dtype=jnp.float32,
        precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    ) -> "Burgers":
        xi_rel = (0.0, 0.25, 0.5, 0.75)
        # Zero-mean jets: central-difference Burgers has no damping of the
        # k=0 mode, so raw Gaussian jets inject unbounded mean momentum over
        # a 100-time-unit episode; momentum-conserving actuation keeps the
        # env well-posed for ANY policy.  nu=0.25 keeps the cell Reynolds
        # number u*dx/nu <= ~2 at the attained amplitudes.
        return cls(
            ops=BurgersOperators.create(n, length, nu, dtype=dtype, precision=precision),
            forcing=GaussianForcing.create(n, length, xi_rel, sigma, dtype=dtype,
                                           zero_mean=True),
            length=length,
            n=n,
            nu=nu,
            cfg_steps=cfg_steps,
            t_max=t_max,
            dt=dt,
            sigma=sigma,
            objective=objective,
            legacy_objective=legacy_objective,
            xi_rel=xi_rel,
        )

    @property
    def dtype(self):
        return self.ops.deriv.dtype

    @property
    def max_episode_steps(self) -> int:
        return math.ceil(self.t_max / (self.dt * self.cfg_steps))

    @property
    def delta(self) -> float:
        return self.cfg_steps * self.dt

    @property
    def num_jets(self) -> int:
        return len(self.xi_rel)

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (1, self.n)

    @property
    def action_shape(self) -> Tuple[int, int]:
        return (1, self.num_jets)

    @property
    def action_low(self) -> float:
        return -1.0

    @property
    def action_high(self) -> float:
        return 1.0

    @property
    def effective_objective(self) -> str:
        if self.legacy_objective:
            return L2CONTROL if self.objective else DISSIPATION
        return self.objective or DISSIPATION

    @property
    def scenario(self) -> Dict:
        return {
            "cfg_steps": self.cfg_steps,
            "L": self.length,
            "N": self.n,
            "dx": self.length / self.n,
            "Tmax": self.t_max,
            "dt": self.dt,
            "nu": self.nu,
            "Xi": list(self.xi_rel),
            "objective": self.objective,
        }

    def action_to_phi(self, action: Array) -> Array:
        phi = self.forcing.apply(action.astype(self.dtype))
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = jnp.squeeze(phi, axis=-2)
        return phi

    def reward_fn(self, u: Array, phi: Array) -> Array:
        if u.ndim >= 2 and u.shape[-2] == 1:
            u = jnp.squeeze(u, axis=-2)
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = jnp.squeeze(phi, axis=-2)
        return burgers_reward(self.ops, u, phi.astype(u.dtype), self.effective_objective)

    def sample_ic(self, key: Array, batch_shape: Tuple[int, ...] = ()) -> Array:
        """Random superposition of low-wavenumber Fourier modes (smooth,
        O(1)-amplitude fields on which the advective term matters)."""
        akey, pkey = jax.random.split(key)
        amps = jax.random.uniform(
            akey, batch_shape + (self.ic_modes,), minval=-0.25, maxval=0.25
        )
        phases = jax.random.uniform(
            pkey, batch_shape + (self.ic_modes,), minval=0.0, maxval=2.0 * np.pi
        )
        x = jnp.linspace(0.0, self.length - self.length / self.n, self.n)
        k = jnp.arange(1, self.ic_modes + 1)
        waves = jnp.sin(
            2.0 * np.pi * k[:, None] * x[None, :] / self.length
            + phases[..., None]
        )
        u = jnp.sum(amps[..., None] * waves, axis=-2)
        return u.astype(self.dtype)

    def reset(self, key: Array, batch_shape: Tuple[int, ...] = ()) -> EnvState:
        ic_key, state_key = jax.random.split(key)
        return EnvState(
            u=self.sample_ic(ic_key, batch_shape),
            step=jnp.zeros(batch_shape, jnp.int32),
            key=state_key,
        )

    def reset_from_pool(
        self, key: Array, pool: Array, batch_shape: Tuple[int, ...] = ()
    ) -> EnvState:
        idx_key, state_key = jax.random.split(key)
        idx = jax.random.randint(idx_key, batch_shape, 0, pool.shape[0])
        return EnvState(
            u=pool[idx], step=jnp.zeros(batch_shape, jnp.int32), key=state_key
        )

    def observe(self, state: EnvState) -> Array:
        return state.u[..., None, :]

    def step(self, state: EnvState, action: Array) -> Tuple[EnvState, StepOut]:
        phi = self.action_to_phi(action)
        u, reward = burgers_control_period(
            self.ops, state.u, phi, self.dt, self.cfg_steps, self.effective_objective
        )
        step = state.step + 1
        truncated = step >= self.max_episode_steps
        state = state.replace(u=u, step=step)
        out = StepOut(
            obs=self.observe(state),
            reward=reward,
            terminated=jnp.zeros_like(truncated),
            truncated=truncated,
            info={"step": step},
        )
        return state, out

    def vec_step(
        self, state: EnvState, action: Array, pool: Array
    ) -> Tuple[EnvState, StepOut]:
        state, out = self.step(state, action)
        final_obs = out.obs

        need_reset = out.truncated | out.terminated
        idx_key, next_key = jax.random.split(state.key)
        idx = jax.random.randint(idx_key, need_reset.shape, 0, pool.shape[0])
        fresh_u = pool[idx]

        u = jnp.where(need_reset[..., None], fresh_u, state.u)
        step = jnp.where(need_reset, 0, state.step)
        state = state.replace(u=u, step=step, key=next_key)

        info = dict(out.info)
        info["final_obs"] = final_obs
        info["autoreset"] = need_reset
        return state, out._replace(obs=self.observe(state), info=info)


def make_reset_pool(env: Burgers, key: Array, pool_size: int) -> Array:
    """Burgers ICs are cheap (no chaotic transient); sample directly."""
    return env.sample_ic(key, (pool_size,))
