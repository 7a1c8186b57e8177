"""Soft Actor-Critic, fully jitted (reference ``pdecontrol/sac/sac.py``).

One ``update`` = the reference's exact sequence (sac.py:58-132): min-double-Q
entropy-regularised target (timeout-truncation ignored in the mask —
``mask = 1 - terminated`` with terminated always False in this suite,
sac.py:69-73), two MSE critic losses and an Adam step, reparameterised policy
loss against the *updated* critic, optional automatic entropy tuning, and a
Polyak soft target update every ``target_update_interval`` updates
(sac.py:129-130).  Everything is a pure function over a ``SACState`` pytree;
``n_updates`` chained updates run as one ``lax.scan`` with on-device batch
sampling — the on-device replacement for the reference's DataLoader loop
(mbrl.py:554-564).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from pdecontrol_tpu.sac.nets import GaussianPolicy, QNetwork
from pdecontrol_tpu.utils.pytree import PyTreeNode, field

Array = jax.Array


class SACConfig(NamedTuple):
    gamma: float = 0.99
    tau: float = 0.005
    alpha: float = 0.2
    lr: float = 3e-4
    hidden: int = 256
    target_update_interval: int = 1
    automatic_entropy_tuning: bool = False
    target_entropy: float = -4.0  # -dim(A); overridden at agent creation
    # Reward scaling inside the soft-Q update (the classic SAC temperature
    # knob, Haarnoja et al. 2018 §D).  alpha=0.2 is tuned for KS's ~O(1)
    # per-step rewards; environments with much smaller rewards (Burgers:
    # ~500x smaller — the field damps to ~0) let the entropy term dominate
    # the Q landscape unless rewards are rescaled into the same regime.
    # Only the update sees scaled rewards; logged metrics stay unscaled.
    reward_scale: float = 1.0


class SACState(PyTreeNode):
    policy_params: Any
    critic_params: Any
    target_params: Any
    policy_opt: Any
    critic_opt: Any
    log_alpha: Array
    alpha_opt: Any
    updates: Array
    config: SACConfig = field(static=True)


class SAC:
    """Agent definition: network modules + pure update/select functions."""

    def __init__(self, obs_shape, action_shape, config: SACConfig = SACConfig(),
                 action_low: float = -1.0, action_high: float = 1.0):
        self.obs_shape = tuple(obs_shape)
        self.action_shape = tuple(action_shape)
        self.config = config._replace(
            target_entropy=-float(action_shape[0] * action_shape[1])
            if config.automatic_entropy_tuning else config.target_entropy
        )
        scale = (action_high - action_low) / 2.0
        bias = (action_high + action_low) / 2.0
        self.policy = GaussianPolicy(
            achannels=action_shape[0], asize=action_shape[1],
            hidden=config.hidden, action_scale=scale, action_bias=bias,
        )
        self.critic = QNetwork(hidden=config.hidden)
        self.optimizer = optax.adam(config.lr)

    # ------------------------------------------------------------------ init
    def init(self, key: Array) -> SACState:
        kp, kc = jax.random.split(key)
        obs = jnp.zeros((1,) + self.obs_shape)
        act = jnp.zeros((1,) + self.action_shape)
        policy_params = self.policy.init(kp, obs)["params"]
        critic_params = self.critic.init(kc, obs, act)["params"]
        log_alpha = jnp.zeros(())
        return SACState(
            policy_params=policy_params,
            critic_params=critic_params,
            target_params=jax.tree.map(jnp.copy, critic_params),
            policy_opt=self.optimizer.init(policy_params),
            critic_opt=self.optimizer.init(critic_params),
            log_alpha=log_alpha,
            alpha_opt=self.optimizer.init(log_alpha),
            updates=jnp.zeros((), jnp.int32),
            config=self.config,
        )

    # --------------------------------------------------------------- actions
    def select_action(
        self, state: SACState, obs: Array, key: Array, deterministic: bool = False
    ) -> Array:
        action, _, det = self.policy.apply(
            {"params": state.policy_params}, obs, key, method=GaussianPolicy.sample
        )
        return det if deterministic else action

    # ---------------------------------------------------------------- update
    def _alpha(self, state: SACState) -> Array:
        if self.config.automatic_entropy_tuning:
            return jnp.exp(state.log_alpha)
        return jnp.asarray(self.config.alpha)

    def update(
        self, state: SACState, batch, key: Array
    ) -> Tuple[SACState, Dict[str, Array]]:
        cfg = self.config
        obs, actions, nxtobs, rewards = batch.obs, batch.actions, batch.nxtobs, batch.rewards
        rewards = rewards.reshape(-1, 1) * cfg.reward_scale
        mask = 1.0 - batch.terminated.astype(jnp.float32).reshape(-1, 1)

        knext, kpi = jax.random.split(key)
        alpha = self._alpha(state)

        # ---- critic target (sac.py:75-84)
        next_action, next_log_pi, _ = self.policy.apply(
            {"params": state.policy_params}, nxtobs, knext,
            method=GaussianPolicy.sample,
        )
        q1_t, q2_t = self.critic.apply(
            {"params": state.target_params}, nxtobs, next_action
        )
        min_q_t = jnp.minimum(q1_t, q2_t) - alpha * next_log_pi
        next_q = jax.lax.stop_gradient(rewards + mask * cfg.gamma * min_q_t)

        # ---- critic step (sac.py:86-99)
        def critic_loss_fn(params):
            q1, q2 = self.critic.apply({"params": params}, obs, actions)
            l1 = jnp.mean((q1 - next_q) ** 2)
            l2 = jnp.mean((q2 - next_q) ** 2)
            return l1 + l2, (l1, l2)

        (qf_loss, (qf1_loss, qf2_loss)), cgrad = jax.value_and_grad(
            critic_loss_fn, has_aux=True
        )(state.critic_params)
        cupd, critic_opt = self.optimizer.update(cgrad, state.critic_opt)
        critic_params = optax.apply_updates(state.critic_params, cupd)

        # ---- policy step against the updated critic (sac.py:101-112)
        def policy_loss_fn(params):
            pi, log_pi, _ = self.policy.apply(
                {"params": params}, obs, kpi, method=GaussianPolicy.sample
            )
            q1_pi, q2_pi = self.critic.apply({"params": critic_params}, obs, pi)
            min_q_pi = jnp.minimum(q1_pi, q2_pi)
            return jnp.mean(alpha * log_pi - min_q_pi), log_pi

        (policy_loss, log_pi), pgrad = jax.value_and_grad(
            policy_loss_fn, has_aux=True
        )(state.policy_params)
        pupd, policy_opt = self.optimizer.update(pgrad, state.policy_opt)
        policy_params = optax.apply_updates(state.policy_params, pupd)

        # ---- optional automatic entropy tuning (sac.py:114-123)
        log_alpha, alpha_opt = state.log_alpha, state.alpha_opt
        alpha_loss = jnp.zeros(())
        if cfg.automatic_entropy_tuning:
            def alpha_loss_fn(la):
                return -jnp.mean(
                    la * jax.lax.stop_gradient(log_pi + cfg.target_entropy)
                )

            alpha_loss, agrad = jax.value_and_grad(alpha_loss_fn)(log_alpha)
            aupd, alpha_opt = self.optimizer.update(agrad, alpha_opt)
            log_alpha = optax.apply_updates(log_alpha, aupd)

        # ---- Polyak soft update every interval (sac.py:129-130)
        updates = state.updates + 1
        do_soft = (state.updates % cfg.target_update_interval) == 0
        target_params = jax.tree.map(
            lambda t, s: jnp.where(do_soft, t * (1.0 - cfg.tau) + s * cfg.tau, t),
            state.target_params,
            critic_params,
        )

        new_state = state.replace(
            policy_params=policy_params,
            critic_params=critic_params,
            target_params=target_params,
            policy_opt=policy_opt,
            critic_opt=critic_opt,
            log_alpha=log_alpha,
            alpha_opt=alpha_opt,
            updates=updates,
        )
        metrics = {
            "qf_loss": qf_loss,
            "qf1_loss": qf1_loss,
            "qf2_loss": qf2_loss,
            "policy_loss": policy_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "reward_mean": jnp.mean(rewards),
        }
        return new_state, metrics

    def update_many(self, state: SACState, batches, key: Array):
        """Run ``T`` chained updates over pre-gathered batches [T, B, ...]
        as one scan (reference loop mbrl.py:562-564)."""

        def body(carry, xs):
            st, k = carry
            k, ku = jax.random.split(k)
            batch = xs
            st, metrics = self.update(st, batch, ku)
            return (st, k), metrics

        (state, _), metrics = jax.lax.scan(body, (state, key), batches)
        return state, metrics
