"""Typed MBPO configuration with the reference's CLI defaults
(``/root/reference/pdecontrol/mbrl/script.py:16-74``) and its JSON-dict
override ergonomics (factory defaults deep-merged under CLI JSON,
script.py:100-108)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class MBPOConfig:
    # ---- logging & evaluation (script.py:18-24)
    project: Optional[str] = None
    name: Optional[str] = None
    run_dir: str = "runs/mbpo"
    use_wandb: bool = False
    agent_eval_freq: int = 50
    num_eval_episodes: int = 10
    surrogate_eval_horizon: int = 30  # open-loop eval steps (mbrl.py:474)
    status_report_freq: int = 5
    logging_freq: int = 10
    checkpoint_freq: int = 0  # iterations between snapshots (0 = off)
    resume: bool = False
    profile_dir: Optional[str] = None  # capture a jax.profiler device trace
    # of iteration 1 into this directory (TensorBoard/Perfetto viewable)
    # Fuse collect -> imagined rollouts -> SAC updates (plus the packed log
    # scalars) into ONE jitted program on non-retrain iterations.  Each
    # separate dispatch-after-a-sync pays a host round trip; fusing removes
    # three of the four.
    # RNG streams are split identically to the unfused path, so results are
    # identical (tested: replay bit-equal, params/metrics to 1e-12).  Set
    # False to get per-phase t_* timings instead of the single t_fused.
    fuse_iteration: bool = True

    # Fuse each surrogate retrain's ENTIRE early-stopped fit into one
    # program (lax.while_loop over fused epochs, early-stopping counters on
    # device, ONE final device_get) — removes the per-epoch blocking
    # val-loss pull.  Requires
    # an iteration-typed curriculum (constant window length within a fit);
    # other curricula fall back to the per-epoch host loop automatically.
    # The early-stopping decision trajectory is identical to the host
    # loop; params match to rounding level (see train/trainer.py).  Set
    # False to recover the per-epoch t_fit_val timing breakdown.
    fuse_fit: bool = True

    # Warm the XLA compilation cache for every (horizon, rounds) program the
    # rollout-length schedule will visit, on a background thread launched at
    # the start of learn() — the compiles overlap warmup collection and the
    # early iterations instead of stalling the first retrain at each new
    # horizon.  Requires the persistent compilation cache (enabled by every
    # entry point, utils/runtime.py) to hand the warmed executables to the
    # training loop's own jit calls.
    precompile_horizons: bool = True

    # ---- general (script.py:27-29)
    total_timesteps: int = 1_000_000
    seed: int = 0

    # ---- device mesh (replaces the reference's env subprocess
    # pool, mbrl.py:81-86).  data_parallel shards env batches / training
    # batches over the ``data`` mesh axis; model_parallel shards ensemble
    # members over ``model``.  1x1 (default) bypasses the mesh entirely so
    # single-chip behavior is bit-identical.
    data_parallel: int = 1
    model_parallel: int = 1

    # ---- simulation env & rollouts (script.py:32-36)
    env_id: str = "KuramotoSivashinskyEnv-v0"
    env_config: Dict = dataclasses.field(default_factory=dict)
    num_envs: int = 10  # reference --cpus (one subprocess each; here a batch axis)
    gamma: float = 0.99
    capacity: int = 1_000_000
    rollout_length: int = 1
    pool_size: int = 256  # amortised-reset pool (addition to the reference)
    # Sensor strides (reference setup_transforms, mbrl.py:170-175 — wired
    # but fixed to 1 there; exposed here as the strided-observation
    # ablation).  agent_stride subsamples the SAC agent's observations;
    # world_stride subsamples the surrogate's world space (>1 is rejected by
    # the controller: the world reward recomputation needs the inverse, which
    # is undefined for strided sensors in the reference too).
    agent_stride: int = 1
    world_stride: int = 1

    # ---- MBPO (script.py:39-46)
    learning_starts: int = 20_000
    policy_train_steps_per_sample: int = 5
    model_buffer_store_iterations: int = 30
    model_rollouts_per_sample: int = 100
    model_rollouts_batch_size: int = 100
    model_buffer_max_capacity: int = 1_000_000
    val_split_ratio: float = 0.1
    rollout_length_schedule: Dict = dataclasses.field(default_factory=dict)

    # ---- surrogate training (script.py:49-57)
    surrogate_train_freq: int = 500
    loss: str = "MSELoss"
    factory: str = "KSAutoRegConvolutionalLSTM"
    model: Dict = dataclasses.field(default_factory=dict)
    surrogate: Dict = dataclasses.field(default_factory=dict)
    training: Dict = dataclasses.field(default_factory=dict)
    curriculum: Dict = dataclasses.field(default_factory=dict)
    trainer: Dict = dataclasses.field(default_factory=dict)

    # ---- ensemble (script.py:60-61)
    num_dynamics_models: int = 3
    num_elite_models: int = 3
    vmap_ensemble_training: bool = True  # train all members in one vmapped
    # program (per-member early-stop masks); False = sequential per-member
    # fits as in the reference

    # ---- SAC (script.py:64-72)
    policy: str = "Gaussian"
    policy_batch_size: int = 256
    sac_tau: float = 0.005
    target_entropy: float = -3.0
    lr: float = 3e-4
    alpha: float = 0.2
    target_update_interval: int = 1
    hidden_size: int = 256
    automatic_entropy_tuning: bool = False
    reward_scale: float = 1.0  # SAC-update reward scaling (sac.py docstring)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def merged_with_factory_defaults(self, defaults: Dict) -> "MBPOConfig":
        """Factory defaults under CLI JSON overrides (script.py:100-108)."""
        out = dataclasses.replace(self)
        for field in ("model", "surrogate", "training", "curriculum", "trainer"):
            out_field = {**defaults.get(field, {}), **getattr(self, field)}
            setattr(out, field, out_field)
        return out
