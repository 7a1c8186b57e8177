"""Imagined (world-model) vectorised environment as pure functions.

Re-designs ``/root/reference/pdecontrol/mbrl/world/world.py``: the gym
``VectorEnv`` facade over the surrogate becomes a ``(reset, step)`` pair over
an explicit ``WorldState``; the per-sample Python reward loop
(world.py:170) becomes one batched reward evaluation on device.

Reference semantics preserved:
  * ``reset`` draws a batch of (left-padded) tau-step warmup windows from
    the real replay, teacher-forces every ensemble member over them, and
    returns the elite-selected last prediction (world.py:176-204).
  * ``step`` advances every member one control period on the previous
    *selected* outputs — each step re-enters the teacher-forcing branch on
    the previous prediction (world.py:159-161), i.e. ``reencode=True`` in
    our fused rollout.
  * rewards are computed by inverse-transforming the predicted obs and the
    forcing-field action back to physical space and applying the real env's
    reward function (world.py:164-171).
  * truncation: the whole batch resets only when EVERY sub-env has hit the
    rollout horizon or the env time limit (world.py:122-134); some rollouts
    may exceed the time limit, as the reference notes.
  * ``terminated`` is always False (world.py:133-134).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from pdecontrol_tpu.data import replay as R
from pdecontrol_tpu.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu.models.surrogate import (
    EnsembleState,
    PDESurrogate,
    ensemble_rollout,
    select_elites,
)
from pdecontrol_tpu.utils.pytree import PyTreeNode

Array = jax.Array


class WorldState(PyTreeNode):
    obs: Array  # [B, C, H] last selected prediction (world space)
    hidden: Any  # per-member transition carries, leading axis M
    timesteps: Array  # [B] int32 env-step counter (starts at warmup offset)
    simulated: Array  # [] int32 steps since reset


class WorldModel:
    """Bundles the surrogate module + static config; state is explicit."""

    def __init__(self, module: PDESurrogate, num_envs: int,
                 max_episode_steps: int, reward_fn, tau: int):
        self.module = module
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.reward_fn = reward_fn
        self.tau = tau

    def reset(
        self,
        key: Array,
        ens: EnsembleState,
        replay: R.ReplayState,
        tr: ControllerTransforms,
    ) -> WorldState:
        ksample, kelite = jax.random.split(key)
        batch = R.sample_starting(replay, ksample, self.num_envs, self.tau)
        batch = tr.replay_to_world(batch)
        return self.reset_from_batch(kelite, ens, batch, tr)

    def reset_from_batch(
        self,
        kelite: Array,
        ens: EnsembleState,
        batch,  # Sample already in world space, [B, tau, ...]
        tr: ControllerTransforms,
    ) -> WorldState:
        """Teacher-force every member over an explicit warmup window and
        return the elite-selected last prediction (world.py:176-204).  Used
        by ``reset`` with sampled windows and by the open-loop surrogate
        evaluation with a specific logged episode (mbrl.py:484-496)."""
        roll = ensemble_rollout(
            self.module, ens, batch.obs, batch.actions, dscaling=tr.undscaling.inv
        )
        last = roll.outputs[:, :, -1]  # [M, B, C, H]
        selected, _ = select_elites(kelite, ens, last)
        return WorldState(
            obs=selected,
            hidden=roll.hidden,
            timesteps=batch.steps[:, -1].astype(jnp.int32),
            simulated=jnp.zeros((), jnp.int32),
        )

    def advance(
        self,
        kelite: Array,
        state: WorldState,
        ens: EnsembleState,
        waction: Array,  # [B, C, H] world-space forcing field
        tr: ControllerTransforms,
    ) -> Tuple[WorldState, Array]:
        """The core of one imagined step, without truncation/auto-reset:
        advance every member one control period on the previous *selected*
        outputs, elite-select, and compute the physical-space reward
        (world.py:147-174)."""
        roll = ensemble_rollout(
            self.module,
            ens,
            state.obs[:, None],  # [B, 1, C, H]
            waction[:, None],  # [B, 1, C, H]
            dscaling=tr.undscaling.inv,
            hidden=state.hidden,
        )
        last = roll.outputs[:, :, -1]
        selected, _ = select_elites(kelite, ens, last)

        # Reward on physical-space obs + forcing field (world.py:164-171).
        phys_obs = tr.world_to_raw_obs(selected)
        phys_phi = tr.world_action_to_phys_field(waction)
        reward = self.reward_fn(phys_obs, phys_phi)

        stepped = WorldState(
            obs=selected,
            hidden=roll.hidden,
            timesteps=state.timesteps + 1,
            simulated=state.simulated + 1,
        )
        return stepped, reward

    def step(
        self,
        key: Array,
        state: WorldState,
        ens: EnsembleState,
        agent_action: Array,  # [B, C, A] in [-1, 1]
        tr: ControllerTransforms,
        horizon: Array,
        replay: R.ReplayState,
    ) -> Tuple[WorldState, Tuple[Array, Array, Array, Array, Array]]:
        """One imagined step + batch auto-reset.

        Returns ``(state, (obs, reward, terminated, truncated, final_obs))``
        with obs in world space (what the imagined replay stores).
        """
        kelite, kreset = jax.random.split(key)

        env_action = tr.agent_to_env_action(agent_action)
        waction = tr.env_action_to_world(env_action)  # [B, C, H] field

        stepped, reward = self.advance(kelite, state, ens, waction, tr)
        selected = stepped.obs

        env_limit = stepped.timesteps >= self.max_episode_steps
        rll_limit = jnp.broadcast_to(stepped.simulated >= horizon,
                                     env_limit.shape)
        all_done = jnp.all(env_limit | rll_limit)
        truncated = jnp.broadcast_to(all_done, env_limit.shape)
        terminated = jnp.zeros_like(truncated)

        fresh = self.reset(kreset, ens, replay, tr)
        state = jax.lax.cond(all_done, lambda: fresh, lambda: stepped)
        return state, (state.obs, reward, terminated, truncated, selected)
