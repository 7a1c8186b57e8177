"""Kuramoto–Sivashinsky control environment, functional and batched.

Re-designs ``/root/reference/pdegym/kuramoto/kuramoto.py`` as pure functions
over explicit state: ``reset(key) -> EnvState`` and
``step(env, state, action) -> (EnvState, StepOut)``.  No gym, no processes —
the batch axis *is* the vectorisation (one jitted program, ``vmap``-free
because every op is natively batched), and a device mesh shards that axis.

Reference semantics preserved:
  * grid ``N=64`` on ``L=22`` periodic, ``dt=1e-3``, 250 RK4 sub-steps per
    agent step, 400 agent steps per episode (kuramoto.py:29-57).
  * 4 Gaussian jets at relative positions ``[0, .25, .5, .75]`` with width
    ``sigma=0.4`` (kuramoto.py:18,60).
  * reward = per-sub-step objective averaged over the control period
    (kuramoto.py:82-96); the reference's objective-selection quirk — any
    non-empty ``objective`` string selects ``l2control`` — is preserved
    behind ``legacy_objective`` (kuramoto.py:72).
  * reset = ``u ~ U(-0.4, 0.4)`` followed by a 200-time-unit no-op chaotic
    transient (kuramoto.py:100-116).  Because that transient costs 800
    control periods, the vectorised env amortises it through a pre-generated
    *pool* of on-attractor states (see ``make_reset_pool``); an exact
    per-reset transient is still available via ``reset`` for fidelity tests.
  * episodes are truncation-only (terminated is always False,
    kuramoto.py:98).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pdecontrol_tpu.envs.transforms import GaussianForcing
from pdecontrol_tpu.ops.kuramoto import (
    DISSIPATION,
    L2CONTROL,
    KSOperators,
    ks_control_period,
    ks_reward,
    ks_transient,
)
from pdecontrol_tpu.utils.pytree import PyTreeNode, field

Array = jax.Array


class EnvState(PyTreeNode):
    """Per-environment simulator state; all fields have a leading batch shape."""

    u: Array  # [..., N] physical field
    step: Array  # [...] int32 agent-step counter within the episode
    key: Array  # PRNG key driving auto-resets (batched envs)


class StepOut(NamedTuple):
    obs: Array  # [..., C=1, N]
    reward: Array  # [...]
    terminated: Array  # [...] bool (always False for KS)
    truncated: Array  # [...] bool
    info: Dict[str, Array]


class KuramotoSivashinsky(PyTreeNode):
    """Immutable environment definition (parameters + precomputed operators)."""

    ops: KSOperators
    forcing: GaussianForcing
    length: float = field(static=True, default=22.0)
    n: int = field(static=True, default=64)
    cfg_steps: int = field(static=True, default=250)
    t_trans: float = field(static=True, default=40.0)
    t_max: float = field(static=True, default=100.0)
    dt: float = field(static=True, default=1e-3)
    noise: float = field(static=True, default=0.1)
    sigma: float = field(static=True, default=0.4)
    lmbda: float = field(static=True, default=0.0)
    objective: str = field(static=True, default="dissipation")
    legacy_objective: bool = field(static=True, default=True)
    xi_rel: Tuple[float, ...] = field(
        static=True, default=(0.0, 0.25, 0.5, 0.75)
    )
    transient_time: float = field(static=True, default=200.0)

    @classmethod
    def create(
        cls,
        length: float = 22.0,
        n: int = 64,
        cfg_steps: int = 250,
        t_trans: float = 40.0,
        t_max: float = 100.0,
        dt: float = 1e-3,
        noise: float = 0.1,
        sigma: float = 0.4,
        lmbda: float = 0.0,
        objective: str = "dissipation",
        legacy_objective: bool = True,
        dtype=jnp.float32,
        precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    ) -> "KuramotoSivashinsky":
        xi_rel = (0.0, 0.25, 0.5, 0.75)
        return cls(
            ops=KSOperators.create(n, length, dtype=dtype, precision=precision),
            forcing=GaussianForcing.create(n, length, xi_rel, sigma, dtype=dtype),
            length=length,
            n=n,
            cfg_steps=cfg_steps,
            t_trans=t_trans,
            t_max=t_max,
            dt=dt,
            noise=noise,
            sigma=sigma,
            lmbda=lmbda,
            objective=objective,
            legacy_objective=legacy_objective,
            xi_rel=xi_rel,
        )

    # ------------------------------------------------------------------ meta
    @property
    def dtype(self):
        return self.ops.central.dtype

    @property
    def max_episode_steps(self) -> int:
        return math.ceil(self.t_max / (self.dt * self.cfg_steps))

    @property
    def delta(self) -> float:
        """Control-period length in simulation time (= surrogate time step)."""
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
        # kuramoto.py:72 — any truthy objective string selects l2control.
        if self.legacy_objective:
            return L2CONTROL if self.objective else DISSIPATION
        return self.objective or DISSIPATION

    @property
    def scenario(self) -> Dict:
        """Metadata dict splatted into model/loss constructors
        (kuramoto.py:136-150; ``noise``/``lmbda`` literals preserved)."""
        return {
            "cfg_steps": self.cfg_steps,
            "Ttrans": self.t_trans,
            "L": self.length,
            "N": self.n,
            "dx": self.length / self.n,
            "Tmax": self.t_max,
            "dt": self.dt,
            "Xi": list(self.xi_rel),
            "noise": 0.1,
            "lmbda": 1.0,
            "objective": self.objective,
        }

    # --------------------------------------------------------------- physics
    def action_to_phi(self, action: Array) -> Array:
        """[..., C=1, jets] (or [..., jets]) action -> [..., N] forcing field."""
        if action.shape[-1] != self.num_jets:
            raise ValueError(f"expected {self.num_jets} jets, got {action.shape}")
        phi = self.forcing.apply(action.astype(self.dtype))
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = jnp.squeeze(phi, axis=-2)
        return phi

    def reward_fn(self, u: Array, phi: Array) -> Array:
        """Objective on raw field(s); used by the world model to re-score
        imagined states (reference ``env.reward_func``, kuramoto.py:73)."""
        if u.ndim >= 2 and u.shape[-2] == 1:
            u = jnp.squeeze(u, axis=-2)
        if phi.ndim >= 2 and phi.shape[-2] == 1:
            phi = jnp.squeeze(phi, axis=-2)
        return ks_reward(self.ops, u, phi.astype(u.dtype), self.effective_objective)

    # ----------------------------------------------------------------- reset
    def sample_ic(self, key: Array, batch_shape: Tuple[int, ...] = ()) -> Array:
        """Raw initial condition ``u ~ U(-0.4, 0.4)`` (kuramoto.py:106)."""
        return jax.random.uniform(
            key, batch_shape + (self.n,), minval=-0.4, maxval=0.4, dtype=self.dtype
        )

    @property
    def transient_periods(self) -> int:
        return int(self.transient_time / self.dt / self.cfg_steps)

    def reset(self, key: Array, batch_shape: Tuple[int, ...] = ()) -> EnvState:
        """Exact reference reset: random IC + full no-op transient."""
        ic_key, state_key = jax.random.split(key)
        u = self.sample_ic(ic_key, batch_shape)
        u = ks_transient(self.ops, u, self.dt, self.cfg_steps, self.transient_periods)
        return EnvState(
            u=u,
            step=jnp.zeros(batch_shape, jnp.int32),
            key=state_key,
        )

    def reset_from_pool(
        self, key: Array, pool: Array, batch_shape: Tuple[int, ...] = ()
    ) -> EnvState:
        """Draw on-attractor initial states from a pre-generated pool."""
        idx_key, state_key = jax.random.split(key)
        idx = jax.random.randint(idx_key, batch_shape, 0, pool.shape[0])
        return EnvState(
            u=pool[idx],
            step=jnp.zeros(batch_shape, jnp.int32),
            key=state_key,
        )

    # ------------------------------------------------------------------ step
    def observe(self, state: EnvState) -> Array:
        return state.u[..., None, :]

    def step(self, state: EnvState, action: Array) -> Tuple[EnvState, StepOut]:
        """One agent step = one control period (kuramoto.py:78-98).

        Truncation-only episodes; no auto-reset (see ``vec_step``).
        """
        phi = self.action_to_phi(action)
        u, reward = ks_control_period(
            self.ops, state.u, phi, self.dt, self.cfg_steps,
            self.effective_objective,
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
        """Batched step with gym-style auto-reset.

        For sub-envs that truncate, the returned ``obs`` is the first
        observation of a fresh episode (drawn from ``pool``) and the true
        terminal observation is surfaced as ``info["final_obs"]`` — the
        batched equivalent of gym's ``final_observation`` handling that
        the reference's ``StoreNObsVecWrapper`` re-extracts
        (pdegym/common/vec_wrappers.py:21-37).
        """
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


def make_reset_pool(
    env: KuramotoSivashinsky,
    key: Array,
    pool_size: int,
    chains: int = 64,
    decorrelate_periods: int = 40,
) -> Array:
    """Generate a pool of on-attractor states for amortised resets.

    Runs ``chains`` independent fields through the full 200-time-unit no-op
    transient (batched — one compiled program), then keeps snapshotting every
    ``decorrelate_periods`` control periods (10 time units, several Lyapunov
    times, so snapshots are decorrelated) until ``pool_size`` states exist.
    Statistically equivalent to the reference's per-reset transient
    (kuramoto.py:100-116) at a tiny amortised cost.
    """
    chains = min(chains, pool_size)
    u = env.sample_ic(key, (chains,))
    u = ks_transient(env.ops, u, env.dt, env.cfg_steps, env.transient_periods)

    snapshots = [u]
    rounds = math.ceil(pool_size / chains) - 1
    for _ in range(rounds):
        u = ks_transient(env.ops, u, env.dt, env.cfg_steps, decorrelate_periods)
        snapshots.append(u)
    pool = jnp.concatenate(snapshots, axis=0)[:pool_size]
    return pool
