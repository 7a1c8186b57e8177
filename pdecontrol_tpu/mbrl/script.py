"""MBPO CLI entry point (reference ``pdecontrol/mbrl/script.py``).

Same flag surface: JSON-dict-valued flags for model/surrogate/training/
curriculum/trainer are deep-merged over the factory defaults; component
selection is by registry name.  Run e.g.:

    python -m pdecontrol_tpu.mbrl.script \
        --env_id KuramotoSivashinskyEnv-v0 \
        --factory KSAutoRegConvolutionalLSTM \
        --training '{"tau": 5, "initial": {"tbtt": 10, "patience": 10,
                     "batch_size": 64},
                     "iterations": {"tbtt": 10, "patience": 5,
                     "batch_size": 64}}' \
        --trainer '{"initial": {"min_steps": 250, "max_steps": 2000},
                    "iterations": {"min_steps": 50, "max_steps": 250}}' \
        --curriculum '{"scheduler": "LinearScheduler", "steptype":
                       "iteration", "start": 0, "stop": 10, "vmin": 15,
                       "vmax": 15}' \
        --loss MSELoss --learning_starts 5000 \
        --rollout_length_schedule '{"scheduler": "LinearScheduler",
            "steptype": "iteration", "start": 0, "stop": 200, "vmin": 3,
            "vmax": 7}' \
        --policy_train_steps_per_sample 10 --surrogate_train_freq 500
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from pdecontrol_tpu.mbrl.config import MBPOConfig
from pdecontrol_tpu.models.factories import REGISTRY
from pdecontrol_tpu.utils import runtime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", type=str, default=None,
                   help="force a JAX platform (e.g. 'cpu' for smoke runs); "
                        "must be applied before first backend use")
    p.add_argument("--debug_nans", action="store_true",
                   help="crash on the first NaN produced by any jitted "
                        "program (the reference's np.seterr(over='raise') "
                        "tripwire, kuramoto.py:12). NOTE: may false-positive "
                        "on XLA-fused masked branches (jax_debug_nans "
                        "limitation) — use for debugging, not production")
    # Logging & evaluation
    p.add_argument("--project", type=str, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--run_dir", type=str, default="runs/mbpo")
    p.add_argument("--offline", action="store_true",
                   help="disable wandb (local JSONL logging only)")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--agent_eval_freq", type=int, default=50)
    p.add_argument("--num_eval_episodes", type=int, default=10)
    p.add_argument("--surrogate_eval_horizon", type=int, default=30)
    p.add_argument("--status_report_freq", type=int, default=5)
    p.add_argument("--logging_freq", type=int, default=10)
    p.add_argument("--checkpoint_freq", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a jax.profiler trace of iteration 1 here")
    p.add_argument("--no_fuse_iteration", action="store_true",
                   help="dispatch collect/imagine/SAC as separate programs "
                        "(per-phase t_* timings; slower per iteration)")
    p.add_argument("--no_fuse_fit", action="store_true",
                   help="run surrogate retrains as a per-epoch host loop "
                        "with blocking val pulls (per-epoch t_fit_val "
                        "timings) instead of one on-device while_loop")
    # General
    p.add_argument("--total_timesteps", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    # Device mesh (replaces the reference's env subprocess pool)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="mesh size sharding env/training batches (DP)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="mesh size sharding ensemble members (EP)")
    # Multi-process (multi-host) runtime — opt-in; one process per host of
    # a pod slice.  See parallel/distributed.py for the host-boundary rules
    # (primary-only file I/O, process-identical seeds, replicated pulls).
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="jax.distributed coordinator (host:port); enables "
                        "multi-process initialisation")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    # Env & rollouts
    p.add_argument("--env_id", default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--env_config", type=str, default="{}")
    p.add_argument("--num_envs", "--cpus", dest="num_envs", type=int, default=10)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--capacity", type=int, default=1_000_000)
    p.add_argument("--rollout_length", type=int, default=1)
    p.add_argument("--pool_size", type=int, default=256)
    p.add_argument("--agent_stride", type=int, default=1,
                   help="sensor stride on the SAC agent's observations "
                        "(strided-observation ablation; reference "
                        "setup_transforms, mbrl.py:170-175)")
    p.add_argument("--world_stride", type=int, default=1,
                   help="sensor stride on the surrogate's world space "
                        "(>1 rejected: reward recomputation needs the "
                        "inverse sensor, undefined when strided)")
    # MBPO
    p.add_argument("--learning_starts", type=int, default=20_000)
    p.add_argument("--policy_train_steps_per_sample", type=int, default=5)
    p.add_argument("--model_buffer_store_iterations", type=int, default=30)
    p.add_argument("--model_rollouts_per_sample", type=int, default=100)
    p.add_argument("--model_rollouts_batch_size", type=int, default=100)
    p.add_argument("--model_buffer_max_capacity", type=int, default=1_000_000)
    p.add_argument("--val_split_ratio", type=float, default=0.1)
    p.add_argument("--rollout_length_schedule", type=str, default="{}")
    # Surrogate training
    p.add_argument("--surrogate_train_freq", type=int, default=500)
    p.add_argument("--loss", type=str, default="MSELoss")
    p.add_argument("--factory", type=str, default="KSAutoRegConvolutionalLSTM",
                   choices=sorted(REGISTRY))
    p.add_argument("--model", type=str, default="{}")
    p.add_argument("--surrogate", type=str, default="{}")
    p.add_argument("--training", type=str, default="{}")
    p.add_argument("--curriculum", type=str, default="{}")
    p.add_argument("--trainer", type=str, default="{}")
    # Ensemble
    p.add_argument("--num_dynamics_models", type=int, default=3)
    p.add_argument("--num_elite_models", type=int, default=3)
    p.add_argument("--sequential_member_training", action="store_true")
    # SAC
    p.add_argument("--policy", type=str, default="Gaussian")
    p.add_argument("--policy_batch_size", type=int, default=256)
    p.add_argument("--tau", dest="sac_tau", type=float, default=0.005)
    p.add_argument("--target_entropy", type=float, default=-3.0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--target_update_interval", type=int, default=1)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--automatic_entropy_tuning", action="store_true")
    p.add_argument("--reward_scale", type=float, default=1.0,
                   help="SAC-update reward scaling (classic SAC knob; "
                        "alpha=0.2 is tuned for KS's O(1) per-step rewards)")
    return p


def config_from_args(args: argparse.Namespace) -> MBPOConfig:
    cfg = MBPOConfig(
        project=args.project,
        name=args.name,
        run_dir=args.run_dir,
        use_wandb=args.wandb and not args.offline,
        agent_eval_freq=args.agent_eval_freq,
        num_eval_episodes=args.num_eval_episodes,
        surrogate_eval_horizon=args.surrogate_eval_horizon,
        status_report_freq=args.status_report_freq,
        logging_freq=args.logging_freq,
        checkpoint_freq=args.checkpoint_freq,
        resume=args.resume,
        profile_dir=args.profile_dir,
        fuse_iteration=not args.no_fuse_iteration,
        fuse_fit=not args.no_fuse_fit,
        total_timesteps=args.total_timesteps,
        seed=args.seed,
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
        env_id=args.env_id,
        env_config=json.loads(args.env_config),
        num_envs=args.num_envs,
        gamma=args.gamma,
        capacity=args.capacity,
        rollout_length=args.rollout_length,
        pool_size=args.pool_size,
        agent_stride=args.agent_stride,
        world_stride=args.world_stride,
        learning_starts=args.learning_starts,
        policy_train_steps_per_sample=args.policy_train_steps_per_sample,
        model_buffer_store_iterations=args.model_buffer_store_iterations,
        model_rollouts_per_sample=args.model_rollouts_per_sample,
        model_rollouts_batch_size=args.model_rollouts_batch_size,
        model_buffer_max_capacity=args.model_buffer_max_capacity,
        val_split_ratio=args.val_split_ratio,
        rollout_length_schedule=json.loads(args.rollout_length_schedule),
        surrogate_train_freq=args.surrogate_train_freq,
        loss=args.loss,
        factory=args.factory,
        model=json.loads(args.model),
        surrogate=json.loads(args.surrogate),
        training=json.loads(args.training),
        curriculum=json.loads(args.curriculum),
        trainer=json.loads(args.trainer),
        num_dynamics_models=args.num_dynamics_models,
        num_elite_models=args.num_elite_models,
        vmap_ensemble_training=not args.sequential_member_training,
        policy=args.policy,
        policy_batch_size=args.policy_batch_size,
        sac_tau=args.sac_tau,
        target_entropy=args.target_entropy,
        lr=args.lr,
        alpha=args.alpha,
        target_update_interval=args.target_update_interval,
        hidden_size=args.hidden_size,
        automatic_entropy_tuning=args.automatic_entropy_tuning,
        reward_scale=args.reward_scale,
    )
    defaults = REGISTRY[args.factory].defaults
    return cfg.merged_with_factory_defaults(defaults)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if args.coordinator_address:
        # Multi-process runtime (one process per host).  Must precede any
        # backend use; the mesh then spans jax.devices() globally.
        from pdecontrol_tpu.parallel import distributed

        distributed.initialize(args.coordinator_address, args.num_processes,
                               args.process_id)
    runtime.setup("mbpo")
    config = config_from_args(args)

    from pdecontrol_tpu.mbrl.controller import PDEModelBasedController

    mbpo = PDEModelBasedController(config)
    try:
        mbpo.learn()
    except Exception:
        print(traceback.format_exc(), file=sys.stderr)
        return 1
    finally:
        mbpo.logger.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
