"""Offline dataset generation CLI (reference
``pdecontrol/surrogates/evaluation/generate.py``): roll ``--episodes``
random-action episodes of the chosen env and save the batched trajectory
tensors.  The per-episode Python loop of the reference becomes one batched
jitted rollout — all episodes advance together.

Output: an ``.npz`` with obs/actions/nxtobs/rewards/terminated/truncated/
steps arrays of shape ``[episodes, T, ...]`` (the reference's TensorDataset
layout, generate.py:40-63).

    python -m pdecontrol_tpu.evaluation.generate --env KuramotoSivashinskyEnv-v0 \
        --episodes 100 --output ks_attractor.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from pdecontrol_tpu.utils import runtime


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", type=str, default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--config", type=str, default="{}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", type=str, default=None)
    return p


def generate(env_id: str, episodes: int, config: dict, seed: int = 0):
    import jax

    from pdecontrol_tpu.mbrl.controller import ENVS

    env_cls, make_pool = ENVS[env_id]
    env = env_cls.create(**config)
    key = jax.random.PRNGKey(seed)
    key, kpool, kreset = jax.random.split(key, 3)
    pool = make_pool(env, kpool, max(episodes, 8))
    state = env.reset_from_pool(kreset, pool, (episodes,))

    nsteps = env.max_episode_steps

    @jax.jit
    def rollout(state, key):
        def body(carry, _):
            state, key = carry
            key, ka = jax.random.split(key)
            action = jax.random.uniform(
                ka, (episodes,) + env.action_shape,
                minval=env.action_low, maxval=env.action_high,
                dtype=env.dtype,
            )
            obs = env.observe(state)
            state, out = env.step(state, action)
            return (state, key), (obs, action, out.obs, out.reward,
                                  out.terminated, out.truncated,
                                  out.info["step"])

        (_, _), traj = jax.lax.scan(body, (state, key), None, length=nsteps)
        return traj

    obs, actions, nxt, rewards, term, trunc, steps = jax.device_get(
        rollout(state, key)
    )
    # time-major -> episode-major
    swap = lambda x: np.swapaxes(np.asarray(x), 0, 1)
    return {
        "obs": swap(obs).astype(np.float32),
        "actions": swap(actions).astype(np.float32),
        "nxtobs": swap(nxt).astype(np.float32),
        "rewards": swap(rewards).astype(np.float32),
        "terminated": swap(term),
        "truncated": swap(trunc),
        "steps": swap(steps).astype(np.int32),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    runtime.setup("generate")
    data = generate(args.env, args.episodes, json.loads(args.config), args.seed)
    np.savez_compressed(args.output, **data)
    print(f"wrote {args.output}: obs {data['obs'].shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
