"""Model-free SAC baseline on the real PDE env.

The ECC'24 paper compares MBPO against a model-free SAC agent (README.md:19);
the reference repo exposes an SB3-compatible env for that but no trainer.
This module provides the end-to-end on-device baseline: jitted
collect-then-update iterations over the batched env — the framework's
"minimum slice" (env + agent + replay all on the device).

    python -m pdecontrol_tpu.sac.train --total_timesteps 50000 \
        --learning_starts 5000 --num_envs 10 --updates_per_step 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import jax
import jax.numpy as jnp

from pdecontrol_tpu.data import replay as R
from pdecontrol_tpu.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu.sac.sac import SAC, SACConfig
from pdecontrol_tpu.utils import runtime
from pdecontrol_tpu.utils.logging import MetricsLogger


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", type=str, default=None)
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--run_dir", type=str, default="runs/sac")
    p.add_argument("--env_id", type=str, default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--env_config", type=str, default="{}")
    p.add_argument("--num_envs", type=int, default=10)
    p.add_argument("--total_timesteps", type=int, default=1_000_000)
    p.add_argument("--learning_starts", type=int, default=20_000)
    p.add_argument("--updates_per_step", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--capacity", type=int, default=1_000_000)
    p.add_argument("--pool_size", type=int, default=256)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--tau", type=float, default=0.005)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--automatic_entropy_tuning", action="store_true")
    p.add_argument("--reward_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_freq", type=int, default=2000,
                   help="eval every N env steps")
    p.add_argument("--num_eval_episodes", type=int, default=10)
    p.add_argument("--chunk", type=int, default=100,
                   help="env steps fused per jitted chunk")
    return p


class SACTrainer:
    def __init__(self, args):
        from pdecontrol_tpu.mbrl.controller import ENVS

        self.args = args
        env_cls, make_pool = ENVS[args.env_id]
        self.env = env_cls.create(**json.loads(args.env_config))
        self.key = jax.random.PRNGKey(args.seed)

        self.tr = ControllerTransforms.create(self.env, dtype=self.env.dtype)
        self.key, kp = jax.random.split(self.key)
        self.pool = make_pool(self.env, kp, args.pool_size)

        sac_cfg = SACConfig(
            gamma=args.gamma, tau=args.tau, alpha=args.alpha, lr=args.lr,
            hidden=args.hidden_size,
            automatic_entropy_tuning=args.automatic_entropy_tuning,
            reward_scale=args.reward_scale,
        )
        self.sac = SAC(self.env.obs_shape, self.env.action_shape, sac_cfg,
                       self.env.action_low, self.env.action_high)
        self.key, ks = jax.random.split(self.key)
        self.sac_state = self.sac.init(ks)

        rows = max(args.capacity // self.env.max_episode_steps,
                   args.num_envs + 2)
        self.replay = R.create(rows, self.env.max_episode_steps,
                               args.num_envs, self.env.obs_shape,
                               self.env.action_shape, self.env.dtype)
        self.key, kr = jax.random.split(self.key)
        self.env_state = self.env.reset_from_pool(kr, self.pool,
                                                  (args.num_envs,))
        self.tr = self.tr.replace(
            oscaling=self.tr.oscaling.update(self.env.observe(self.env_state))
        )
        self._chunk_jit = {}

    def _chunk_fn(self, nsteps: int, random: bool, updates_per_step: int):
        key_ = (nsteps, random, updates_per_step)
        if key_ in self._chunk_jit:
            return self._chunk_jit[key_]
        env, sac, args = self.env, self.sac, self.args

        @jax.jit
        def run(env_state, tr, sac_state, replay, pool, key):
            def body(carry, _):
                env_state, tr, sac_state, replay, key = carry
                key, ka, ku = jax.random.split(key, 3)
                raw_obs = env.observe(env_state)
                if random:
                    action = jax.random.uniform(
                        ka, (raw_obs.shape[0],) + env.action_shape,
                        minval=env.action_low, maxval=env.action_high,
                        dtype=raw_obs.dtype,
                    )
                else:
                    agent_obs = tr.raw_to_agent_obs(raw_obs)
                    action = sac.select_action(sac_state, agent_obs, ka)
                env_action = tr.agent_to_env_action(action)
                env_state, out = env.vec_step(env_state, env_action, pool)
                osc = tr.oscaling.update(out.obs).update(out.info["final_obs"])
                tr = tr.replace(oscaling=osc)
                replay = R.write_step(
                    replay, raw_obs, env_action, out.reward, out.terminated,
                    out.truncated, out.info["final_obs"],
                    out.info["step"].astype(jnp.int32),
                )

                def do_update(carry, _):
                    sac_state, key = carry
                    key, kb, kup = jax.random.split(key, 3)
                    batch = tr.replay_to_agent(
                        R.sample_transitions(replay, kb, args.batch_size)
                    )
                    batch = jax.tree.map(
                        lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        batch,
                    )
                    sac_state, m = sac.update(sac_state, batch, kup)
                    return (sac_state, key), m

                if updates_per_step and not random:
                    (sac_state, key), m = jax.lax.scan(
                        do_update, (sac_state, key), None,
                        length=updates_per_step,
                    )
                    qf = m["qf_loss"][-1]
                else:
                    qf = jnp.zeros(())
                return (env_state, tr, sac_state, replay, key), (
                    out.reward, qf
                )

            carry = (env_state, tr, sac_state, replay, key)
            carry, (rewards, qf) = jax.lax.scan(body, carry, None,
                                                length=nsteps)
            env_state, tr, sac_state, replay, _ = carry
            return env_state, tr, sac_state, replay, rewards, qf[-1]

        self._chunk_jit[key_] = run
        return run

    def evaluate(self) -> Dict[str, float]:
        env, sac = self.env, self.sac
        n = self.args.num_eval_episodes

        self.key, k1, k2 = jax.random.split(self.key, 3)
        state = env.reset_from_pool(k1, self.pool, (n,))

        def body(carry, _):
            state, key = carry
            key, ka = jax.random.split(key)
            obs = self.tr.raw_to_agent_obs(env.observe(state))
            action = sac.select_action(self.sac_state, obs, ka,
                                       deterministic=True)
            state, out = env.step(state, self.tr.agent_to_env_action(action))
            return (state, key), out.reward

        (_, _), rewards = jax.lax.scan(
            body, (state, k2), None, length=env.max_episode_steps
        )
        returns = jnp.sum(rewards, axis=0)
        return {
            "eval_return_mean": float(jnp.mean(returns)),
            "eval_return_std": float(jnp.std(returns)),
        }

    def learn(self, logger: MetricsLogger) -> None:
        args = self.args
        start = time.time()
        steps_done = 0

        warmup = max(args.learning_starts // args.num_envs, 1)
        run = self._chunk_fn(warmup, True, 0)
        self.key, k = jax.random.split(self.key)
        (self.env_state, self.tr, self.sac_state, self.replay, rew, _) = run(
            self.env_state, self.tr, self.sac_state, self.replay, self.pool, k
        )
        steps_done += warmup * args.num_envs

        chunk = args.chunk
        run = self._chunk_fn(chunk, False, args.updates_per_step)
        next_eval = steps_done
        while steps_done < args.total_timesteps:
            self.key, k = jax.random.split(self.key)
            (self.env_state, self.tr, self.sac_state, self.replay, rew,
             qf) = run(self.env_state, self.tr, self.sac_state, self.replay,
                       self.pool, k)
            steps_done += chunk * args.num_envs

            record = {
                "num_steps_sampled": steps_done,
                "collect_reward_mean": float(jnp.mean(rew)),
                "sac_qf_loss": float(qf),
                "time": time.time() - start,
            }
            if steps_done >= next_eval:
                record.update(self.evaluate())
                next_eval += args.eval_freq
            logger.log(record, commit=True)
            print(f"[sac] steps={steps_done} "
                  f"eval={record.get('eval_return_mean', float('nan')):.2f} "
                  f"rew={record['collect_reward_mean']:.3f}", flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    runtime.setup("sac")
    logger = MetricsLogger(args.run_dir, config=vars(args))
    trainer = SACTrainer(args)
    trainer.learn(logger)
    logger.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
