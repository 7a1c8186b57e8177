"""MBPO-style model-based controller: the ``learn()`` loop on device.

Re-designs ``/root/reference/pdecontrol/mbrl/mbrl.py`` (PDEModelBasedController)
without gym/Lightning/subprocesses: each stage of the loop — experience
collection, surrogate retraining, imagined rollouts, SAC updates, evaluation
— is a jitted program over pytree state; the Python level only sequences
stages and applies host-side schedules/early stopping.

Loop structure (reference ``learn``, mbrl.py:384-449):
  warmup with random actions (``learning_starts``) ->
  iterate: collect ``num_envs x rollout_length`` real samples ->
    every ``surrogate_train_freq`` samples: refit the delta Normalize over
    the whole replay (mbrl.py:597-602), retrain every ensemble member with
    early stopping on the unscaled free-run val loss, update elites ->
    imagined rollouts from replay starting states at the scheduled horizon ->
    ``policy_train_steps_per_sample x samples`` SAC updates on a uniform
    mixture of real + imagined transitions (mbrl.py:529-566) ->
    periodic policy / surrogate evaluation + status table.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrol_tpu import viz
from pdecontrol_tpu.data import replay as R
from pdecontrol_tpu.envs import burgers as burgers_env
from pdecontrol_tpu.envs import kuramoto as ks_env
from pdecontrol_tpu.mbrl.config import MBPOConfig
from pdecontrol_tpu.mbrl.transform_sets import ControllerTransforms
from pdecontrol_tpu.mbrl.world import WorldModel
from pdecontrol_tpu.models import factories
from pdecontrol_tpu.models.surrogate import (
    EnsembleState,
    init_ensemble,
    update_elites,
)
from pdecontrol_tpu.sac.sac import SAC, SACConfig
from pdecontrol_tpu.train.losses import make_loss
from pdecontrol_tpu.train.schedulers import Scheduler
from pdecontrol_tpu.train.trainer import SurrogateTrainer, TrainConfig, TrainerState
from pdecontrol_tpu.utils import profiling
from pdecontrol_tpu.utils.asyncviz import BackgroundRenderer
from pdecontrol_tpu.utils.logging import MetricsLogger

Array = jax.Array

ENVS = {
    "KuramotoSivashinskyEnv-v0": (ks_env.KuramotoSivashinsky, ks_env.make_reset_pool),
    "BurgersEnv-v0": (burgers_env.Burgers, burgers_env.make_reset_pool),
}

STATUS_HEADERS = [
    "iteration", "time", "num_ensemble_updates", "num_pol_updates",
    "num_steps_sampled", "eval_return_mean", "world_return_mean", "horizon",
    "world_buffer_samples", "train_loss", "val_loss", "sac_qf_loss",
    "sac_policy_loss",
]

# Per-iteration log scalars, packed into ONE device buffer so logging costs
# a single transport round trip (order matches _pack_scalars call sites).
LOG_SCALARS = ("world_buffer_samples", "collect_reward_mean",
               "imagined_reward_mean", "sac_qf_loss", "sac_policy_loss",
               "total_steps")


def _pack_scalars(xs):
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return jnp.stack([jnp.asarray(x).astype(dt) for x in xs])


class PDEModelBasedController:
    def __init__(self, config: MBPOConfig, logger: Optional[MetricsLogger] = None):
        self.config = config
        cfg = config

        env_cls, make_pool = ENVS[cfg.env_id]
        self.env = env_cls.create(**cfg.env_config)
        self.key = jax.random.PRNGKey(cfg.seed)

        # Device mesh: the replacement for the reference's env
        # subprocess pool (mbrl.py:81-86).  A 1x1 request bypasses the mesh
        # so single-chip behavior (and results) are untouched.
        self.mesh = None
        if cfg.data_parallel * cfg.model_parallel > 1:
            from pdecontrol_tpu.parallel import mesh as meshlib

            n_dev = cfg.data_parallel * cfg.model_parallel
            if len(jax.devices()) < n_dev:
                raise ValueError(
                    f"mesh {cfg.data_parallel}x{cfg.model_parallel} needs "
                    f"{n_dev} devices, found {len(jax.devices())}"
                )
            for name, val, axis in (
                ("num_envs", cfg.num_envs, cfg.data_parallel),
                ("model_rollouts_batch_size", cfg.model_rollouts_batch_size,
                 cfg.data_parallel),
                ("policy_batch_size", cfg.policy_batch_size,
                 cfg.data_parallel),
                ("num_dynamics_models", cfg.num_dynamics_models,
                 cfg.model_parallel),
            ):
                if val % axis != 0:
                    raise ValueError(
                        f"{name}={val} not divisible by its mesh axis "
                        f"size {axis}"
                    )
            self.mesh = meshlib.make_mesh(
                n_dev, model_parallel=cfg.model_parallel
            )

        # Runtime accounting (mbrl.py:88-97).
        self.samples_per_iteration = cfg.num_envs * cfg.rollout_length
        self.num_pol_updates_per_iteration = int(
            cfg.policy_train_steps_per_sample * self.samples_per_iteration
        )
        self.sur_train_freq = max(
            int(cfg.surrogate_train_freq / self.samples_per_iteration), 1
        )
        self.iteration = 0
        self.num_ensemble_updates = 0
        self.num_pol_updates = 0

        self.schedule = Scheduler.factory(cfg.rollout_length_schedule)
        self.curriculum = Scheduler.factory(cfg.curriculum)

        # Transforms + reset pool.
        if cfg.world_stride > 1:
            raise ValueError(
                "world_stride > 1 is not runnable: the world env recomputes "
                "rewards through the inverse world sensor, which is undefined "
                "for strided subsampling (reference SensorTransform._Inverse "
                "raises NotImplementedError too, transforms.py:240-247)"
            )
        self.tr = ControllerTransforms.create(
            self.env, agent_stride=cfg.agent_stride,
            world_stride=cfg.world_stride, dtype=self.env.dtype,
        )
        self.key, kpool = jax.random.split(self.key)
        self.pool = make_pool(self.env, kpool, cfg.pool_size)

        # Space shapes downstream of the sensor strides, derived by tracing
        # the transform paths on dummies (exact for any stride/offset).
        dummy_obs = jnp.zeros((1,) + tuple(self.env.obs_shape), self.env.dtype)
        dummy_act = jnp.zeros((1,) + tuple(self.env.action_shape),
                              self.env.dtype)
        self.world_obs_shape = tuple(
            jax.eval_shape(self.tr.raw_to_world_obs, dummy_obs).shape[1:]
        )
        self.agent_obs_shape = tuple(
            jax.eval_shape(self.tr.raw_to_agent_obs, dummy_obs).shape[1:]
        )
        self.world_action_shape = tuple(
            jax.eval_shape(self.tr.env_action_to_world, dummy_act).shape[1:]
        )

        # Surrogate ensemble + per-member trainers.
        delta = self.env.delta
        self.module = factories.make(
            cfg.factory, delta=delta, **{**self.env.scenario, **cfg.model}
        )
        self.loss_fn = make_loss(cfg.loss, self.env.scenario)
        tau = cfg.training.get("tau", 5)
        self.tau = tau

        ex_states = jnp.zeros((1, tau, *self.world_obs_shape), self.env.dtype)
        ex_actions = jnp.zeros(
            (1, tau + 1, *self.world_action_shape), self.env.dtype
        )
        self.key, kens = jax.random.split(self.key)
        self.ensemble: EnsembleState = init_ensemble(
            self.module, kens, cfg.num_dynamics_models, ex_states, ex_actions,
            cfg.num_elite_models,
        )
        # NOTE: ensemble params stay replicated on the mesh — the rollout
        # path vmaps members into grouped convolutions, whose GSPMD
        # member-axis partitioning miscompiles (see trainer/sharded.py);
        # member-sharded EP happens inside fit_ensemble via shard_map.
        self.train_cfgs = {
            phase: self._phase_train_config(phase) for phase in ("initial", "iterations")
        }
        self.trainer = SurrogateTrainer(
            self.module, self.loss_fn, self.train_cfgs["initial"]
        )
        self.trainer.mesh = self.mesh
        self.trainer.fuse_fit = cfg.fuse_fit
        self.member_states: List[TrainerState] = [
            TrainerState(
                params=jax.tree.map(lambda x: x[m], self.ensemble.params),
                opt_state=None,
                global_step=jnp.zeros((), jnp.int32),
            )
            for m in range(cfg.num_dynamics_models)
        ]
        for m, st in enumerate(self.member_states):
            self.member_states[m] = st.replace(
                opt_state=self.trainer.opt.init(st.params)
            )

        # Replays.
        ep_len = self.env.max_episode_steps
        rows = max(cfg.capacity // ep_len, cfg.num_envs + 2)
        self.replay = R.create(rows, ep_len, cfg.num_envs, self.env.obs_shape,
                               self.env.action_shape, self.env.dtype)
        h_max = self._max_horizon()
        w_rows = min(
            cfg.model_buffer_store_iterations
            * cfg.model_rollouts_per_sample
            * self.samples_per_iteration,
            max(cfg.model_buffer_max_capacity // max(h_max, 1), 1),
        )
        w_rows = max(w_rows, cfg.model_rollouts_batch_size + 2)
        self.world_replay = R.create(
            w_rows, h_max + 2, cfg.model_rollouts_batch_size,
            self.world_obs_shape, self.env.action_shape, self.env.dtype,
        )

        # SAC agent.
        sac_cfg = SACConfig(
            gamma=cfg.gamma, tau=cfg.sac_tau, alpha=cfg.alpha, lr=cfg.lr,
            hidden=cfg.hidden_size,
            target_update_interval=cfg.target_update_interval,
            automatic_entropy_tuning=cfg.automatic_entropy_tuning,
            reward_scale=cfg.reward_scale,
        )
        self.sac = SAC(self.agent_obs_shape, self.env.action_shape, sac_cfg,
                       self.env.action_low, self.env.action_high)
        self.key, ksac = jax.random.split(self.key)
        self.sac_state = self.sac.init(ksac)

        # World model.
        self.world = WorldModel(
            self.module, cfg.model_rollouts_batch_size,
            self.env.max_episode_steps, self.env.reward_fn, tau,
        )

        # Env states (collect + eval).
        self.key, k1, k2 = jax.random.split(self.key, 3)
        self.env_state = self._shard_env_state(
            self.env.reset_from_pool(k1, self.pool, (cfg.num_envs,))
        )
        # Initial reset updates the running obs scaling (vec_wrappers.py:181-184).
        self.tr = self.tr.replace(
            oscaling=self.tr.oscaling.update(self.env.observe(self.env_state))
        )

        self._collect_jit = {}
        self._world_jit = {}
        self._policy_jit = {}
        self._eval_jit = None
        self._sur_eval_jit = {}
        self._log_pack_jit = None
        # Jitted member stack/unstack + world-return reduction: the eager
        # per-leaf versions cost hundreds of dispatches per retrain.
        self._stack_members_fn = None
        self._unstack_members_fn = None
        self._world_ret_jit = None
        self._fused_jit = {}
        # Pipelined metrics flush: on back-to-back fused iterations the
        # packed log scalars of iteration i-1 are pulled while iteration
        # i executes, hiding the fetch round trip behind device work.
        self._pending_log = None
        # Plot renders / npz writes / wandb uploads run on one background
        # thread (drained at the end of learn()) so the eval block's
        # host-side work overlaps the next iterations' device
        # execution instead of stalling the loop.
        # Multi-process runs (parallel/distributed.py): file I/O — metrics
        # stream, checkpoints, plots/artifacts — happens on the primary
        # process only; compute and the in-memory status summary run
        # everywhere.  Single-process runs are always primary.
        self.primary = jax.process_index() == 0
        self.viz = BackgroundRenderer(enabled=self.primary)
        self.plots = viz.available()
        if self.primary and cfg.logging_freq > 0 and not self.plots:
            print("[viz] matplotlib/pillow not installed: plots are off",
                  flush=True)
        self._train_vis_jit = {}
        self._start_time = time.time()
        self.throughput = profiling.Throughput()
        self.gc_monitor = profiling.GCMonitor()

        # Checkpoint / resume (a subsystem the reference lacks; SURVEY §5).
        self.ckpt = None
        restored = False
        if cfg.checkpoint_freq or cfg.resume:
            from pdecontrol_tpu.utils.checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(f"{cfg.run_dir}/checkpoints")
            if cfg.resume and self.ckpt.latest_step() is not None:
                from pdecontrol_tpu.utils import checkpoint as C

                state = self.ckpt.restore(C.controller_state(self))
                C.load_controller_state(self, state)
                # Restore mesh placements lost through the checkpoint.
                self.env_state = self._shard_env_state(self.env_state)
                restored = True
                print(f"[resume] restored iteration {self.iteration}")

        # Metrics sink is created LAST so append mode tracks whether a
        # checkpoint was actually restored — `--resume` with nothing to
        # restore starts a fresh stream (the old one is backed up by the
        # logger) instead of appending a restarted run onto it.
        self.logger = logger or MetricsLogger(config.run_dir, config.use_wandb,
                                              config.project, config.name,
                                              config.to_dict(),
                                              append=restored,
                                              enabled=self.primary)

    # ------------------------------------------------------------- plumbing
    def _shard_env_state(self, state):
        """Place the per-env leaves of an ``EnvState`` over the ``data``
        mesh axis (the shared auto-reset PRNG key is replicated); identity
        without a mesh so the single-chip path is untouched."""
        if self.mesh is None:
            return state
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pdecontrol_tpu.parallel.mesh import DATA_AXIS

        data = NamedSharding(self.mesh, P(DATA_AXIS))
        repl = NamedSharding(self.mesh, P())
        return state.replace(
            u=jax.device_put(state.u, data),
            step=jax.device_put(state.step, data),
            key=jax.device_put(state.key, repl),
        )

    def _shard_members(self, tree):
        """Place leading (ensemble-member) axes over the ``model`` axis."""
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pdecontrol_tpu.parallel.mesh import MODEL_AXIS

        s = NamedSharding(self.mesh, P(MODEL_AXIS))
        return jax.tree.map(lambda x: jax.device_put(x, s), tree)

    def _constrain_data(self, tree):
        """In-jit sharding constraint: leading axis over ``data``."""
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pdecontrol_tpu.parallel.mesh import DATA_AXIS

        s = NamedSharding(self.mesh, P(DATA_AXIS))
        return jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, s), tree
        )

    def _constrain_world_state(self, wstate):
        """In-jit constraints for the imagined-rollout carry: batch over
        ``data``; the member axis of the hidden carries stays UNSHARDED
        (member-sharded grouped convs miscompile under GSPMD — see
        trainer._ensemble_batch_fns)."""
        if self.mesh is None:
            return wstate
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pdecontrol_tpu.parallel.mesh import DATA_AXIS

        md = NamedSharding(self.mesh, P(None, DATA_AXIS))
        return wstate.replace(
            obs=self._constrain_data(wstate.obs),
            timesteps=self._constrain_data(wstate.timesteps),
            hidden=jax.tree.map(
                lambda h: jax.lax.with_sharding_constraint(h, md),
                wstate.hidden,
            ),
        )

    def _phase_train_config(self, phase: str) -> TrainConfig:
        cfg = self.config
        base = {k: v for k, v in cfg.training.items()
                if k not in ("initial", "iterations")}
        base.update(cfg.training.get(phase, {}))
        trainer_base = {k: v for k, v in cfg.trainer.items()
                        if k not in ("initial", "iterations")}
        trainer_base.update(cfg.trainer.get(phase, {}))
        merged = {**base, **trainer_base}
        fields = TrainConfig._fields
        return TrainConfig(**{k: v for k, v in merged.items() if k in fields})

    def _max_horizon(self) -> int:
        h = 1
        total_iters = max(
            int(self.config.total_timesteps / max(self.samples_per_iteration, 1)),
            1,
        )
        for it in (0, total_iters // 2, total_iters):
            h = max(h, int(self.schedule(iteration=it)))
        return h

    @property
    def num_world_rollouts(self) -> int:
        return int(self.config.model_rollouts_per_sample * self.samples_per_iteration)

    @property
    def num_steps_sampled(self) -> int:
        return self.iteration * self.samples_per_iteration

    # ------------------------------------------------------------ collection
    def _collect_fn(self, nsteps: int, random: bool, update_scaling: bool = True):
        key_ = (nsteps, random, update_scaling)
        if key_ in self._collect_jit:
            return self._collect_jit[key_]

        env, sac = self.env, self.sac

        @jax.jit
        def run(env_state, tr, sac_state, replay, pool, key):
            def body(carry, _):
                env_state, tr, replay, key = carry
                key, ka, ks = jax.random.split(key, 3)
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
                if update_scaling:
                    # update-then-apply ordering preserved: the *next* loop
                    # iteration reads obs through the updated scaling
                    # (vec_wrappers.py:157-160); running min/max updates are
                    # idempotent so the extra finals update is exact.
                    osc = tr.oscaling.update(out.obs)
                    osc = osc.update(out.info["final_obs"])
                    tr = tr.replace(oscaling=osc)
                replay = R.write_step(
                    replay, raw_obs, env_action, out.reward, out.terminated,
                    out.truncated, out.info["final_obs"],
                    out.info["step"].astype(jnp.int32),
                )
                return (env_state, tr, replay, key), out.reward

            (env_state, tr, replay, key), rewards = jax.lax.scan(
                body, (env_state, tr, replay, key), None, length=nsteps
            )
            # The per-iteration log mean is computed in-program: an eager
            # jnp.mean at logging time is a full dispatch round trip.
            return env_state, tr, replay, rewards, jnp.mean(rewards)

        self._collect_jit[key_] = run
        return run

    def collect(self, nsteps: int, random: bool = False) -> Tuple[Array, Array]:
        """Returns (per-step rewards [nsteps, B], on-device scalar mean)."""
        self.key, k = jax.random.split(self.key)
        run = self._collect_fn(nsteps, random)
        self.env_state, self.tr, self.replay, rewards, rmean = run(
            self.env_state, self.tr, self.sac_state, self.replay, self.pool, k
        )
        return rewards, rmean

    # ------------------------------------------------------ surrogate train
    def update_delta_transform(self) -> None:
        """Refit the delta Normalize over the whole replay (mbrl.py:597-602)."""
        otransf = self.tr.replay_to_world.otransf
        mean, var = R.delta_statistics(self.replay, otransf, self.env.delta)
        und = self.tr.undscaling.reset()
        und = und.replace(
            mean=und.mean + mean.astype(und.mean.dtype),
            var=und.var + var.astype(und.var.dtype),
            count=und.count + 1,
        )
        self.tr = self.tr.replace(undscaling=und)

    def update_surrogates(self) -> Dict[str, float]:
        cfg = self.config
        phase = "initial" if self.iteration <= 0 else "iterations"
        tc = self.train_cfgs[phase]
        self.trainer.config = self.train_cfgs[phase]
        t_split0 = time.perf_counter()

        # Train/val split over episodes with any data (mbrl.py:570-573).
        # fill + every member's global_step come back in ONE pull (each
        # separate device_get is a blocking host round trip).
        fill, gsteps = jax.device_get((
            self.replay.fill,
            tuple(st.global_step for st in self.member_states),
        ))
        fill = np.asarray(fill)
        rows = np.where(fill > 0)[0]
        rng = np.random.default_rng(self.iteration)
        rng.shuffle(rows)
        # The val split must be able to produce at least one window at the
        # fit's starting length, else validation (and hence elite scores and
        # early stopping) would silently run on all-zero gathers.  Short
        # in-progress episodes stay in train, where the window-count weights
        # already exclude them from sampling.
        # Same step basis as fit/fit_ensemble (cumulative optimizer steps),
        # so a steptype='step' curriculum validates the split at the length
        # the fit will actually start from, not the stale step-0 length.
        start_step = int(max(int(g) for g in np.asarray(gsteps)))
        length0 = tc.tau + int(self.curriculum(iteration=self.iteration,
                                               epoch=0, step=start_step))
        ok = rows[fill[rows] >= length0]
        short = rows[fill[rows] < length0]
        if len(ok) == 0:
            raise ValueError(
                f"no episode long enough for a length-{length0} window "
                f"(fills={fill[rows].tolist()})"
            )
        if len(ok) == 1:
            # Degenerate: the single trainable episode serves both splits
            # (train must keep at least one window-bearing row or the fit's
            # window guard would refuse it).
            val_rows = ok
            train_rows = np.concatenate([ok, short])
        else:
            n_val = max(int(len(rows) * cfg.val_split_ratio), 1)
            n_val = min(n_val, len(ok) - 1)
            val_rows = ok[:n_val]
            train_rows = np.concatenate([ok[n_val:], short])
        # Build the masks host-side and ship one fixed-shape bool vector.
        # An eager ``jnp.zeros(...).at[rows].set(True)`` scatter compiles a
        # fresh executable for every new index-array LENGTH — and the row
        # count changes exactly when freshly completed episodes enter the
        # replay (every episode boundary), so each boundary's first retrain
        # would pay a compile.  NumPy writes make the transfer shape-stable
        # and compile-free.
        train_np_mask = np.zeros((self.replay.num_rows,), bool)
        train_np_mask[train_rows] = True
        val_np_mask = np.zeros((self.replay.num_rows,), bool)
        val_np_mask[val_rows] = True
        train_mask = jnp.asarray(train_np_mask)
        val_mask = jnp.asarray(val_np_mask)
        t_split = time.perf_counter() - t_split0

        scores, logs = [], {}
        if cfg.vmap_ensemble_training:
            # All members advance in one vmapped program (ensemble
            # parallelism; per-member early stopping preserved by masking).
            # With a mesh the stacked member axis is sharded over ``model``.
            self.key, k = jax.random.split(self.key)
            # Stack the full member TrainerStates in ONE jitted program:
            # the eager per-leaf jnp.stack was ~280 separate dispatches
            # per retrain, all landing in the unmeasured gap between
            # t_split and t_fit.  Mesh runs keep the eager path
            # so the member-axis shardings are placed exactly as before.
            if self.mesh is None:
                if self._stack_members_fn is None:
                    self._stack_members_fn = jax.jit(
                        lambda sts: jax.tree.map(
                            lambda *xs: jnp.stack(xs), *sts)
                    )
                stacked_in = self._stack_members_fn(
                    tuple(self.member_states))
            else:
                stacked_in = self._shard_members(
                    jax.tree.map(lambda *xs: jnp.stack(xs),
                                 *self.member_states)
                )
            t_fit0 = time.perf_counter()
            stacked_states, val_losses, logs = self.trainer.fit_ensemble(
                stacked_in, self.replay, train_mask, val_mask,
                self.tr.undscaling, self.tr.replay_to_world, self.curriculum,
                self.iteration, k,
                min_steps=tc.min_steps, max_steps=tc.max_steps,
                patience=tc.patience,
                host_hints={"fill": fill, "train_np": train_np_mask,
                            "val_np": val_np_mask, "start_step": start_step},
            )
            logs["t_fit_total"] = round(time.perf_counter() - t_fit0, 4)
            # Unstack in one jitted program (same dispatch-count argument
            # as the stack above; slicing is exact, so results are
            # bit-identical to the eager per-leaf version).
            if self.mesh is None:
                if self._unstack_members_fn is None:
                    M = cfg.num_dynamics_models
                    self._unstack_members_fn = jax.jit(
                        lambda st: tuple(
                            jax.tree.map(lambda x: x[m], st)
                            for m in range(M)
                        )
                    )
                self.member_states = list(
                    self._unstack_members_fn(stacked_states))
            else:
                self.member_states = [
                    jax.tree.map(lambda x: x[m], stacked_states)
                    for m in range(cfg.num_dynamics_models)
                ]
            scores = [float(v) for v in np.asarray(jax.device_get(val_losses))]
        else:
            for m in range(cfg.num_dynamics_models):
                self.key, k = jax.random.split(self.key)
                state, val_loss, mlogs = self.trainer.fit(
                    self.member_states[m], self.replay, train_mask, val_mask,
                    self.tr.undscaling, self.tr.replay_to_world,
                    self.curriculum, self.iteration, k,
                    min_steps=tc.min_steps, max_steps=tc.max_steps,
                    patience=tc.patience,
                    # Per-member start_step from the fused pull above —
                    # without it each fit re-pulled state.global_step, one
                    # blocking round trip per member per retrain.
                    host_hints={"fill": fill, "train_np": train_np_mask,
                                "val_np": val_np_mask,
                                "start_step": int(np.asarray(gsteps)[m])},
                )
                self.member_states[m] = state
                scores.append(val_loss)
                logs = mlogs
        # Write member params back into the stacked ensemble + elites
        # (replicated: rollout-path convs must not be member-sharded).
        t_post0 = time.perf_counter()
        if cfg.vmap_ensemble_training and self.mesh is None:
            # Single-chip vmapped path: the fit returned the stacked params
            # already — the eager per-leaf restack was ~90 dispatches of
            # pure overhead per retrain.
            stacked = stacked_states.params
        else:
            stacked = jax.tree.map(
                lambda *leaves: jnp.stack(leaves),
                *[st.params for st in self.member_states],
            )
        self.ensemble = self.ensemble.replace(params=stacked)
        self.ensemble = update_elites(self.ensemble, jnp.asarray(scores))
        self.num_ensemble_updates += 1
        self._train_vis(train_mask, val_mask, length0)
        return {"val_loss": float(np.mean(scores)), **logs,
                "elite_scores": scores,
                "t_split": round(t_split, 4),
                "t_post": round(time.perf_counter() - t_post0, 4)}

    def _train_vis_fn(self, length: int):
        """Jitted window-draw + free-run reconstruction for the train-time
        plots; cached per window length."""
        if length in self._train_vis_jit:
            return self._train_vis_jit[length]
        module, tau = self.trainer.module, self.trainer.config.tau

        @jax.jit
        def run(key, params, replay, mask, und, stransf):
            kb, ki = jax.random.split(key)
            batch = R.sample_windows(replay, kb, 4, length, rows_mask=mask)
            batch = stransf(batch)
            states, actions = batch.obs, batch.actions
            roll = module.apply(
                {"params": params}, states[:, :tau], actions, dscaling=und.inv
            )
            decoded = jnp.concatenate(
                [states[:, :1], roll.outputs[:, :-1]], axis=1
            )
            # Random sequence of the batch (callbacks.py:62), unscaled to
            # physical space before plotting (callbacks.py:67-72).
            i = jax.random.randint(ki, (), 0, states.shape[0])
            return (
                stransf.otransf.inverse(states[i]),
                stransf.otransf.inverse(decoded[i]),
                stransf.atransf.inverse(actions[i]),
            )

        self._train_vis_jit[length] = run
        return self._train_vis_jit[length]

    def _train_vis(self, train_mask, val_mask, length: int) -> None:
        """Train-time plotting (reference VisCallback, callbacks.py:13-81):
        after each surrogate retrain (at ``logging_freq`` cadence) plot a
        random train and val window against its free-run reconstruction —
        the PDE comparison panels plus the delta heatmaps."""
        cfg = self.config
        if not self.plots or cfg.logging_freq <= 0 or (
            (self.num_ensemble_updates - 1) % cfg.logging_freq
        ):
            return
        try:
            import os

            d = os.path.join(cfg.run_dir, "plots")
            params0 = jax.tree.map(lambda x: x[0], self.ensemble.params)
            run = self._train_vis_fn(length)
            iteration = self.iteration
            for stage, mask in (("train", train_mask), ("val", val_mask)):
                self.key, k = jax.random.split(self.key)
                # Dispatch on the main thread; the worker pulls + renders.
                handles = run(
                    k, params0, self.replay, mask,
                    self.tr.undscaling, self.tr.replay_to_world,
                )

                def job(stage=stage, handles=handles):
                    from pdecontrol_tpu.viz import plots

                    os.makedirs(d, exist_ok=True)
                    obs, opred, acts = (
                        np.asarray(x) for x in jax.device_get(handles)
                    )
                    img = plots.pdeplot(obs, opred, acts)
                    img.save(os.path.join(
                        d, f"{stage}_vis_iter{iteration}.png"))
                    heat = plots.spatial({
                        "deltas": np.diff(obs, axis=0),
                        "outdeltas": np.diff(opred, axis=0),
                    })
                    heat.save(os.path.join(
                        d, f"{stage}_spatial_iter{iteration}.png"))
                    if self.logger.wandb is not None:
                        self.logger.wandb.log(
                            {f"{stage}_vis": self.logger.wandb.Image(img),
                             f"{stage}_spatial": self.logger.wandb.Image(heat)},
                            commit=False,
                        )

                self.viz.submit(job)
        except Exception:  # plotting must never kill training
            pass

    # -------------------------------------------------------- world rollouts
    def _world_fn(self, horizon: int, rounds: int):
        """One jitted program for the WHOLE imagine phase: an outer
        ``lax.scan`` over the ``rounds`` batches of imagined rollouts, each
        an inner horizon-scan.  A host loop over rounds costs one
        dispatch per round (they are carry-dependent through the world
        replay, so they serialise); at ~100-rollout batches the per-round
        device work is small enough that dispatch latency would dominate
        the phase."""
        if (horizon, rounds) in self._world_jit:
            return self._world_jit[(horizon, rounds)]
        sac, world = self.sac, self.world

        @jax.jit
        def run(key, ens, sac_state, replay, world_replay, tr):
            def one_round(world_replay, kround):
                kreset, kloop = jax.random.split(kround)
                wstate = self._constrain_world_state(
                    world.reset(kreset, ens, replay, tr)
                )

                def body(carry, _):
                    wstate, world_replay, key = carry
                    key, ka, ks = jax.random.split(key, 3)
                    prev_obs = wstate.obs
                    prev_t = wstate.timesteps
                    agent_obs = tr.world_to_agent_obs(prev_obs)
                    action = sac.select_action(sac_state, agent_obs, ka)
                    wstate, (obs, reward, term, trunc, final_obs) = world.step(
                        ks, wstate, ens, action, tr, jnp.asarray(horizon),
                        replay
                    )
                    world_replay = R.write_step(
                        world_replay, prev_obs, action, reward, term, trunc,
                        final_obs, (prev_t + 1).astype(jnp.int32),
                    )
                    return (wstate, world_replay, key), reward

                (wstate, world_replay, _), rewards = jax.lax.scan(
                    body, (wstate, world_replay, kloop), None, length=horizon
                )
                return world_replay, rewards

            world_replay, rewards = jax.lax.scan(
                one_round, world_replay, jax.random.split(key, rounds)
            )
            # [rounds, horizon, B] -> [rounds * horizon, B], the concat
            # order of the former per-round host loop.  The log mean is
            # computed in-program (see _collect_fn).
            rewards = rewards.reshape((-1,) + rewards.shape[2:])
            return world_replay, rewards, jnp.mean(rewards)

        self._world_jit[(horizon, rounds)] = run
        return run

    def imagine(self, horizon: int) -> Tuple[Array, Array]:
        """Returns (imagined rewards [rounds*horizon, B], scalar mean)."""
        rounds = max(
            math.ceil(self.num_world_rollouts / self.config.model_rollouts_batch_size),
            1,
        )
        run = self._world_fn(horizon, rounds)
        self.key, k = jax.random.split(self.key)
        self.world_replay, rewards, rmean = run(
            k, self.ensemble, self.sac_state, self.replay,
            self.world_replay, self.tr,
        )
        return rewards, rmean

    # --------------------------------------------------------- policy update
    def _policy_fn(self, n_updates: int):
        if n_updates in self._policy_jit:
            return self._policy_jit[n_updates]
        sac, batch_size = self.sac, self.config.policy_batch_size

        @jax.jit
        def run(sac_state, replay, world_replay, tr, key):
            p_imag = world_replay.ntimesteps.astype(jnp.float32) / jnp.maximum(
                world_replay.ntimesteps + replay.ntimesteps, 1
            ).astype(jnp.float32)

            def body(carry, _):
                sac_state, key = carry
                key, k1, k2, k3, ku = jax.random.split(key, 5)
                real = tr.replay_to_agent(
                    R.sample_transitions(replay, k1, batch_size)
                )
                imag = tr.world_replay_to_agent(
                    R.sample_transitions(world_replay, k2, batch_size)
                )
                pick = jax.random.uniform(k3, (batch_size,)) < p_imag

                def sel(a, b):
                    m = pick.reshape((-1,) + (1,) * (a.ndim - 1))
                    return jnp.where(m, a, b)

                batch = self._constrain_data(jax.tree.map(sel, imag, real))
                batch = batch.replace(
                    obs=batch.obs.astype(jnp.float32),
                    actions=batch.actions.astype(jnp.float32),
                    nxtobs=batch.nxtobs.astype(jnp.float32),
                    rewards=batch.rewards.astype(jnp.float32),
                )
                sac_state, metrics = sac.update(sac_state, batch, ku)
                return (sac_state, key), metrics

            (sac_state, _), metrics = jax.lax.scan(
                body, (sac_state, key), None, length=n_updates
            )
            return sac_state, jax.tree.map(lambda x: x[-1], metrics)

        self._policy_jit[n_updates] = run
        return run

    def update_policy(self) -> Dict[str, Array]:
        n = self.num_pol_updates_per_iteration
        run = self._policy_fn(n)
        self.key, k = jax.random.split(self.key)
        self.sac_state, metrics = run(
            self.sac_state, self.replay, self.world_replay, self.tr, k
        )
        self.num_pol_updates += n
        return metrics

    # ------------------------------------------------------ fused iteration
    def _fused_iteration_fn(self, nsteps: int, horizon: int, rounds: int,
                            n_updates: int):
        """ONE jitted program for a whole non-retrain MBPO iteration:
        collect -> imagined rollouts -> chained SAC updates, plus the packed
        per-iteration log scalars.  Each separate dispatch-after-a-sync pays
        a full host round trip; the phase programs are
        pure, so composing them inside one jit is semantics-preserving, and
        the RNG keys are split host-side exactly as the unfused path splits
        them (identical results — tested in
        tests/test_mbrl_smoke.py::test_fused_iteration_matches_unfused)."""
        key_ = (nsteps, horizon, rounds, n_updates)
        if key_ in self._fused_jit:
            return self._fused_jit[key_]
        collect = self._collect_fn(nsteps, random=False)
        world = self._world_fn(horizon, rounds)
        policy = self._policy_fn(n_updates)

        @jax.jit
        def run(env_state, tr, sac_state, replay, world_replay, ens, pool,
                kc, kw, kp):
            env_state, tr, replay, _, c_mean = collect(
                env_state, tr, sac_state, replay, pool, kc
            )
            world_replay, _, i_mean = world(
                kw, ens, sac_state, replay, world_replay, tr
            )
            sac_state, metrics = policy(sac_state, replay, world_replay, tr, kp)
            packed = _pack_scalars((
                world_replay.ntimesteps, c_mean, i_mean,
                metrics["qf_loss"], metrics["policy_loss"],
                replay.total_steps,
            ))
            return env_state, tr, replay, world_replay, sac_state, packed

        self._fused_jit[key_] = run
        return run

    # ------------------------------------------------------------ evaluation
    def evaluate_policy(self) -> Dict[str, float]:
        """10 deterministic episodes on fresh envs with frozen scaling
        (mbrl.py:462-465); episode trajectories are persisted as an npz
        artifact (mbrl.py:467-472)."""
        if self._eval_jit is None:
            env, sac = self.env, self.sac
            nsteps = self.env.max_episode_steps

            @jax.jit
            def run(key, sac_state, tr, pool, n_eval_key):
                state = env.reset_from_pool(n_eval_key, pool,
                                            (self.config.num_eval_episodes,))

                def body(carry, _):
                    state, key = carry
                    key, ka = jax.random.split(key)
                    raw = env.observe(state)
                    obs = tr.raw_to_agent_obs(raw)
                    action = sac.select_action(sac_state, obs, ka,
                                               deterministic=True)
                    env_action = tr.agent_to_env_action(action)
                    state, out = env.step(state, env_action)
                    return (state, key), (out.reward, raw, env_action)

                (_, _), (rewards, obs, actions) = jax.lax.scan(
                    body, (state, key), None, length=nsteps
                )
                returns = jnp.sum(rewards, axis=0)
                return jnp.mean(returns), jnp.std(returns), obs, actions, rewards

            self._eval_jit = run
        self.key, k1, k2 = jax.random.split(self.key, 3)
        mean, std, obs, actions, rewards = self._eval_jit(
            k1, self.sac_state, self.tr, self.pool, k2
        )
        self._save_eval_artifact(obs, actions, rewards)
        mean, std = (float(x) for x in jax.device_get((mean, std)))
        return {"eval_return_mean": mean, "eval_return_std": std}

    def _sur_eval_fn(self, horizon: int):
        """Jitted open-loop rollout of one logged episode's actions through
        the world model, keyed on the (static) horizon."""
        if horizon in self._sur_eval_jit:
            return self._sur_eval_jit[horizon]
        from pdecontrol_tpu.data.types import Sample
        from pdecontrol_tpu.mbrl.agents import ActionRepeatAgent

        tau, world = self.tau, self.world

        @jax.jit
        def run(key, ens, replay, tr, row, start):
            idx = start + jnp.arange(tau + horizon)
            one = lambda x: x[row, idx][None]
            sample = Sample(
                obs=one(replay.obs_seq),
                actions=one(replay.actions),
                nxtobs=replay.obs_seq[row, idx + 1][None],
                rewards=one(replay.rewards),
                terminated=one(replay.terminated),
                truncated=one(replay.truncated),
                steps=one(replay.steps),
            )
            wsample = tr.replay_to_world(sample)

            # Warm-start on the tau-step window (mbrl.py:484-496), then
            # replay the episode's own logged actions open-loop
            # (ActionRepeatAgent, mbrl.py:498-506).
            kwarm, kloop = jax.random.split(key)
            warm = jax.tree.map(lambda x: x[:, :tau], wsample)
            state = world.reset_from_batch(kwarm, ens, warm, tr)
            agent = ActionRepeatAgent(tr.env_action_to_agent(sample.actions))

            def body(carry, t):
                state, key = carry
                key, ke = jax.random.split(key)
                env_action = tr.agent_to_env_action(agent.action_at(t))
                waction = tr.env_action_to_world(env_action)
                # Emit the PRE-advance obs: prediction i is the model's
                # frame tau+i, starting with the warm-start reset prediction
                # (frame tau) — the reference worker stores the world env's
                # pre-step obs the same way (reset output first), so
                # prediction i and truth frame tau+i align (mbrl.py:508-517).
                prev_obs = state.obs[0]
                state, reward = world.advance(ke, state, ens, waction, tr)
                return (state, key), (prev_obs, reward[0])

            (_, _), (preds, rpred) = jax.lax.scan(
                body, (state, kloop), tau + jnp.arange(horizon)
            )

            truth = wsample.obs[0, tau:]  # [h, C, Hw] world space
            sq = (preds - truth) ** 2
            rtrue = sample.rewards[0, tau:]
            return {
                "err": jnp.mean(sq),
                "hstep": jnp.mean(sq, axis=(1, 2)),
                # Imagined-vs-true reward error (the LogRewardDiff diagnostic,
                # mbrl/callbacks.py:57-70, here vs the logged ground truth).
                "reward_err": jnp.mean(jnp.abs(rpred - rtrue)),
                "truth": truth,
                "preds": preds,
                "actions": wsample.actions[0, tau:],
                "rtrue": rtrue,
                "rpred": rpred,
            }

        self._sur_eval_jit[horizon] = run
        return run

    def evaluate_surrogate(self, horizon: Optional[int] = None) -> Dict[str, float]:
        """Open-loop replay of one logged episode's actions through the world
        model stack vs the logged truth (mbrl.py:474-527): a random completed
        episode, a random start, tau-step warmup, then ``ActionRepeatAgent``
        replays the episode's actions for ``horizon`` steps.  Scores the MSE
        in world space plus the imagined-vs-true reward L1 error."""
        horizon = self.config.surrogate_eval_horizon if horizon is None else horizon
        tau = self.tau
        # Distinct host-side streams for episode/start choice and the device
        # rollout (elite selection) — keys are never reused across purposes.
        # The row/start choice maps two uniforms instead of two dependent
        # randints so both draws come back in a single pull; same
        # uniform-over-episodes/starts semantics as the reference's
        # np.random.randint pair (mbrl.py:483-485).  ONE fused pull for the
        # replay summaries AND the uniforms (each separate device_get is a
        # blocking host round trip; 4 -> 1 per eval).
        # The split now precedes the (extremely rare) no-eligible-row early
        # return, so that edge consumes the key — uniform-equivalent.
        self.key, kr, kd = jax.random.split(self.key, 3)
        fill, complete, u = (np.asarray(x) for x in jax.device_get(
            (self.replay.fill, self.replay.complete,
             jax.random.uniform(kr, (2,)))
        ))
        rows = np.where(complete & (fill >= tau + horizon))[0]
        if len(rows) == 0:
            return {}

        row = int(rows[min(int(u[0] * len(rows)), len(rows) - 1)])
        # Exclusive upper bound matches the reference's
        # np.random.randint(0, length - tau - horizon) (mbrl.py:485);
        # the max(., 1) guard admits rows with exactly tau+horizon steps.
        hi = max(int(fill[row]) - tau - horizon, 1)
        start = min(int(u[1] * hi), hi - 1)

        out = self._sur_eval_fn(horizon)(
            kd, self.ensemble, self.replay, self.tr,
            jnp.asarray(row, jnp.int32), jnp.asarray(start, jnp.int32),
        )
        out = jax.device_get(out)  # one pull for the whole metric dict
        self._save_plots(out["truth"], out["preds"], out["actions"],
                         out["hstep"], out["rtrue"], out["rpred"])
        self._save_surrogate_artifact(out)
        return {
            "surrogate_open_loop_mse": float(out["err"]),
            "reward_model_error": float(out["reward_err"]),
        }

    def _save_plots(self, truth, pred, acts, hstep, rtrue=None,
                    rpred=None) -> None:
        """wandb-callback analogue: persist open-loop comparison plots
        (reference VisPDECallback / evaluate_surrogate pdeplot,
        mbrl.py:519-527), including the reward curves (VisRewardDiff
        analogue, mbrl/callbacks.py:72-106)."""
        if not self.plots or self.config.logging_freq <= 0:
            return
        import os

        d = os.path.join(self.config.run_dir, "plots")
        iteration = self.iteration

        def job():
            from pdecontrol_tpu.viz import plots

            os.makedirs(d, exist_ok=True)
            img = plots.pdeplot(truth, pred, acts, rewards=rtrue, rpred=rpred)
            img.save(os.path.join(d, f"surrogate_iter{iteration}.png"))
            plots.hstepplot(hstep).save(
                os.path.join(d, f"hstep_iter{iteration}.png")
            )
            if self.logger.wandb is not None:
                self.logger.wandb.log(
                    {"surrogate_open_loop": self.logger.wandb.Image(img)},
                    commit=False,
                )

        self.viz.submit(job)

    def _save_surrogate_artifact(self, out: Dict) -> None:
        """Per-eval h-step battery artifact (reference EvalLogCallback,
        callbacks.py:102-134): ground truth, open-loop predictions, actions,
        reward curves, and the h-step loss curve as one npz."""
        if self.config.logging_freq <= 0:
            return
        import os

        d = os.path.join(self.config.run_dir, "evaluation")
        iteration = self.iteration

        def job():
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"surrogate_eval_{iteration}.npz")
            np.savez_compressed(
                path,
                states=np.asarray(out["truth"]),
                outputs=np.asarray(out["preds"]),
                actions=np.asarray(out["actions"]),
                rewards=np.asarray(out["rtrue"]),
                rpred=np.asarray(out["rpred"]),
                hstep_mse=np.asarray(out["hstep"]),
            )
            self._upload_artifact(path, "surrogate-eval", iteration)
            # wandb Table of the h-step battery (EvalLogCallback,
            # callbacks.py:118-134).
            if self.logger.wandb is not None:
                wb = self.logger.wandb
                table = wb.Table(
                    columns=["h", "open_loop_mse"],
                    data=[[int(h), float(v)]
                          for h, v in enumerate(np.asarray(out["hstep"]))],
                )
                wb.log({"surrogate_hstep_battery": table}, commit=False)

        self.viz.submit(job)

    def _save_eval_artifact(self, obs, actions, rewards) -> None:
        """Eval-episode trajectories as an npz artifact (mbrl.py:467-472)."""
        if self.config.logging_freq <= 0:
            return
        import os

        d = os.path.join(self.config.run_dir, "evaluation")
        iteration = self.iteration

        def job():
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"eval_{iteration}.npz")
            # [T, B, ...] -> [B, T, ...] episode-major like the reference
            # dataset; the device_get happens on the worker thread too.
            np.savez_compressed(
                path,
                obs=np.swapaxes(np.asarray(jax.device_get(obs)), 0, 1),
                actions=np.swapaxes(np.asarray(jax.device_get(actions)), 0, 1),
                rewards=np.swapaxes(np.asarray(jax.device_get(rewards)), 0, 1),
            )
            self._upload_artifact(path, "eval-episodes", iteration)

        self.viz.submit(job)

    def _upload_artifact(self, path: str, kind: str,
                         iteration: Optional[int] = None) -> None:
        """wandb Artifact upload of an eval npz (reference EvalLogCallback,
        callbacks.py:112-117 and mbrl.py:467-472); no-op without wandb."""
        if self.logger.wandb is None:
            return
        if iteration is None:
            iteration = self.iteration
        try:
            wb = self.logger.wandb
            art = wb.Artifact(
                name=f"{wb.run.id}-{kind}-{iteration}", type="dataset"
            )
            art.add_file(path)
            wb.run.log_artifact(art)
        except Exception:  # artifact logging must never kill training
            pass

    # ------------------------------------------------------------------ main
    def _warm_args(self):
        """ShapeDtypeStruct argument tuples for the AOT cache warm, built
        to mirror the REAL call sites exactly: ``imagine()`` passes
        (key, ensemble, sac_state, replay, world_replay, tr) and the fused
        iteration passes (env_state, tr, sac_state, replay, world_replay,
        ensemble, pool, kc, kw, kp).  tests/test_mbrl_smoke.py asserts this
        structure against an independent re-derivation from those call
        sites, so signature drift fails the suite instead of silently
        warming a program the loop never looks up."""
        def absify(tree):
            return jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
                if hasattr(x, "shape") else x,
                tree,
            )

        key = absify(self.key)
        world_args = absify((key, self.ensemble, self.sac_state, self.replay,
                             self.world_replay, self.tr))
        fused_args = absify((self.env_state, self.tr, self.sac_state,
                             self.replay, self.world_replay, self.ensemble,
                             self.pool)) + (key, key, key)
        return world_args, fused_args

    def _precompile_horizon_ladder(self) -> None:
        """Warm the persistent compilation cache for every (horizon, rounds)
        program the rollout-length schedule will visit — the imagine-phase
        and fused-iteration programs recompile at each new horizon value
        (several seconds each on a cold cache, concentrated in the first
        retrains of a fresh run).  A daemon
        thread AOT-lowers and compiles them from ShapeDtypeStructs (no device
        buffers touched), overlapping the compiles with warmup collection;
        the training loop's own jit calls then hit the compilation cache."""
        cfg = self.config
        if self.mesh is not None:
            # Mesh runs carry arg shardings the ShapeDtypeStructs would
            # drop; the warmed executable would never be looked up.
            return
        if not getattr(jax.config, "jax_compilation_cache_dir", None):
            # The warmed executables are discarded (.compile() results are
            # not kept); the training loop only benefits through the
            # persistent compilation cache.  Without it every compile
            # would run twice for zero gain.
            print("[precompile] skipped: jax_compilation_cache_dir unset "
                  "(utils/runtime.enable_compile_cache sets it)",
                  flush=True)
            return
        total_iters = max(
            int((cfg.total_timesteps - cfg.learning_starts)
                / max(self.samples_per_iteration, 1)),
            1,
        )
        horizons = sorted({
            int(self.schedule(iteration=i)) for i in range(total_iters + 1)
        })
        rounds = max(
            math.ceil(self.num_world_rollouts / cfg.model_rollouts_batch_size),
            1,
        )
        n_updates = self.num_pol_updates_per_iteration
        world_args, fused_args = self._warm_args()

        # Build the memoized jit wrappers on the MAIN thread so the daemon
        # never mutates the shared _world_jit/_fused_jit dicts concurrently
        # with the training loop; the thread only lowers/compiles.
        work = [(h, self._world_fn(h, rounds), world_args) for h in horizons]
        if cfg.fuse_iteration:
            work += [
                (h,
                 self._fused_iteration_fn(cfg.rollout_length, h, rounds,
                                          n_updates),
                 fused_args)
                for h in horizons
            ]

        def job():
            for h, fn, fn_args in work:
                try:
                    fn.lower(*fn_args).compile()
                except Exception as e:  # warming must never kill training;
                    # later horizons' compiles are independent — keep going.
                    print(f"[precompile] horizon {h} skipped: {e!r}",
                          flush=True)
                    continue

        import threading

        threading.Thread(target=job, name="precompile", daemon=True).start()

    def learn(self) -> None:
        cfg = self.config
        self.logger.log({"start": self._start_time}, commit=False)
        if cfg.precompile_horizons and jax.default_backend() != "cpu":
            # The ladder hides the per-horizon compile latency behind the
            # device's work; on CPU the thread would only steal cores from
            # the loop it's meant to speed up.
            self._precompile_horizon_ladder()

        # Random warmup (mbrl.py:388-391).  Timed so the run's wall-time
        # waterfall attributes every second: t_warmup_collect includes the
        # collect program's compile.
        t0 = time.perf_counter()
        warmup_steps = max(cfg.learning_starts // cfg.num_envs, 1)
        _, rmean = self.collect(warmup_steps, random=True)
        jax.block_until_ready(rmean)
        t_warmup = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.logger.log(self.evaluate_policy(), commit=False)
        self.logger.log(
            {"t_warmup_collect": round(t_warmup, 4),
             "t_warmup_eval": round(time.perf_counter() - t0, 4)},
            commit=False,
        )

        total_iters = max(
            int((cfg.total_timesteps - cfg.learning_starts)
                / max(self.samples_per_iteration, 1)),
            0,
        )

        while self.num_steps_sampled < cfg.total_timesteps - cfg.learning_starts:
            # Capture a device trace of one representative iteration
            # (jax.profiler; view in TensorBoard/Perfetto).
            stack = contextlib.ExitStack()
            if cfg.profile_dir and self.iteration == 1:
                stack.enter_context(profiling.trace(cfg.profile_dir))
            with stack:
                self._run_iteration()

            if self.iteration % cfg.status_report_freq == 0:
                print(self.logger.table(STATUS_HEADERS), flush=True)

            if self.ckpt is not None and cfg.checkpoint_freq and (
                self.iteration % cfg.checkpoint_freq == 0
            ):
                self.save_checkpoint()

        self._flush_pending_log()
        if self.ckpt is not None and cfg.checkpoint_freq:
            self.save_checkpoint()
        if self.ckpt is not None:
            self.ckpt.wait()  # async writes must be durable before exit
        self.viz.drain()  # plot/artifact files must exist before exit

    def _commit_record(self, rec: Dict, pulled: Dict) -> None:
        rec = dict(rec)
        rec.update({
            "world_buffer_samples": int(pulled["world_buffer_samples"]),
            "collect_reward_mean": float(pulled["collect_reward_mean"]),
            "imagined_reward_mean": float(pulled["imagined_reward_mean"]),
            "sac_qf_loss": float(pulled["sac_qf_loss"]),
            "sac_policy_loss": float(pulled["sac_policy_loss"]),
            "env_steps_per_sec": self.throughput.update(
                int(pulled["total_steps"])
            ),
        })
        self.logger.log(rec, commit=True)

    def _flush_pending_log(self) -> None:
        """Pull + commit the previous fused iteration's deferred metrics
        record.  Called one iteration behind (the fetch overlaps the next
        program's execution), and synchronously before anything that must
        observe an ordered, complete metrics stream (eval/retrain
        iterations, checkpoints, end of learn())."""
        if self._pending_log is None:
            return
        rec, packed, t0 = self._pending_log
        self._pending_log = None
        pulled = dict(zip(LOG_SCALARS, np.asarray(jax.device_get(packed))))
        # dispatch -> results drained; includes the deliberate one-iteration
        # overlap, so it upper-bounds (not measures) the device time.
        rec["t_ready"] = round(time.perf_counter() - t0, 4)
        self._commit_record(rec, pulled)

    def _run_iteration(self) -> None:
        cfg = self.config
        # Per-phase wall timings.  Under --no_fuse_iteration every phase
        # blocks on its primary output before the clock stops, so the
        # numbers are honest device time.  In the default fused mode the
        # retrain iterations skip those barriers (each block is a full
        # host round trip — 3 per retrain);
        # phase fields then measure dispatch time and the device wait
        # surfaces at the first data-dependent pull (t_surrogate's split /
        # t_pull), keeping the waterfall's total attribution exact.
        retrain = self.iteration % self.sur_train_freq == 0
        eval_iter = self.iteration % cfg.agent_eval_freq == 0
        horizon = int(self.schedule(iteration=self.iteration))
        n_updates = self.num_pol_updates_per_iteration
        rounds = max(
            math.ceil(self.num_world_rollouts
                      / cfg.model_rollouts_batch_size),
            1,
        )
        timings: Dict[str, float] = {}
        t = time.perf_counter()

        if cfg.fuse_iteration and not retrain:
            # Fast path: the whole iteration is ONE program (see
            # _fused_iteration_fn).  Keys are split exactly as the unfused
            # path's collect()/imagine()/update_policy() split them.
            run = self._fused_iteration_fn(
                cfg.rollout_length, horizon, rounds, n_updates
            )
            self.key, kc = jax.random.split(self.key)
            self.key, kw = jax.random.split(self.key)
            self.key, kp = jax.random.split(self.key)
            (self.env_state, self.tr, self.replay, self.world_replay,
             self.sac_state, packed) = run(
                self.env_state, self.tr, self.sac_state, self.replay,
                self.world_replay, self.ensemble, self.pool, kc, kw, kp,
            )
            self.num_pol_updates += n_updates
            timings["t_dispatch"] = round(time.perf_counter() - t, 4)

            if not eval_iter:
                # Pipelined: defer this iteration's pull, flush the
                # previous one (its program has finished; the fetch
                # overlaps this iteration's device execution).
                rec = {
                    "iteration": self.iteration,
                    "num_steps_sampled": self.num_steps_sampled
                    + cfg.learning_starts,
                    "horizon": horizon,
                    "num_pol_updates": self.num_pol_updates,
                    **timings,
                    "time": time.time() - self._start_time,
                }
                self._flush_pending_log()
                self._pending_log = (rec, packed, time.perf_counter())
                self.iteration += 1
                return

            self._flush_pending_log()
            pulled = dict(zip(LOG_SCALARS, np.asarray(jax.device_get(packed))))
            timings["t_fused"], t = (
                round(time.perf_counter() - t, 4), time.perf_counter()
            )
        else:
            self._flush_pending_log()
            _, collect_rmean = self.collect(cfg.rollout_length, random=False)
            if not cfg.fuse_iteration:
                jax.block_until_ready(collect_rmean)
            timings["t_collect"], t = (
                round(time.perf_counter() - t, 4), time.perf_counter()
            )

            if retrain:
                self.gc_monitor.drain()  # reset the window to this retrain
                t_delta0 = time.perf_counter()
                self.update_delta_transform()
                t_delta = time.perf_counter() - t_delta0
                logs = self.update_surrogates()
                gc_pause, gc_max, gc_counts = self.gc_monitor.drain()
                self.logger.log(
                    {"num_ensemble_updates": self.num_ensemble_updates,
                     **logs,
                     "t_delta": round(t_delta, 4),
                     "t_gc": round(gc_pause, 4),
                     "gc_max_pause": round(gc_max, 4),
                     "n_gc2": gc_counts[2]},
                    commit=False,
                )
                timings["t_surrogate"], t = (
                    round(time.perf_counter() - t, 4), time.perf_counter()
                )

            _, imag_rmean = self.imagine(horizon)
            if not cfg.fuse_iteration:
                jax.block_until_ready(imag_rmean)
            timings["t_imagine"], t = (
                round(time.perf_counter() - t, 4), time.perf_counter()
            )

            pol_metrics = self.update_policy()
            if not cfg.fuse_iteration:
                jax.block_until_ready(pol_metrics["qf_loss"])
            timings["t_policy"], t = (
                round(time.perf_counter() - t, 4), time.perf_counter()
            )

            if self._log_pack_jit is None:
                self._log_pack_jit = jax.jit(_pack_scalars)
            packed = jax.device_get(self._log_pack_jit((
                self.world_replay.ntimesteps, collect_rmean, imag_rmean,
                pol_metrics["qf_loss"], pol_metrics["policy_loss"],
                self.replay.total_steps,
            )))
            pulled = dict(zip(LOG_SCALARS, np.asarray(packed)))
            timings["t_pull"], t = (
                round(time.perf_counter() - t, 4), time.perf_counter()
            )

        if self.iteration % cfg.agent_eval_freq == 0:
            self.logger.log(self.evaluate_policy(), commit=False)
            self.logger.log(self.evaluate_surrogate(), commit=False)
            # Jitted reduction + one fused pull (the eager version was ~6
            # dispatches and two blocking round trips per eval).
            if self._world_ret_jit is None:
                self._world_ret_jit = jax.jit(R.episode_returns)
            wmean, wstd = jax.device_get(
                self._world_ret_jit(self.world_replay))
            self.logger.log(
                {"world_return_mean": float(wmean),
                 "world_return_std": float(wstd)},
                commit=False,
            )
            timings["t_eval"], t = (
                round(time.perf_counter() - t, 4), time.perf_counter()
            )

        self.logger.log(
            {
                "iteration": self.iteration,
                "num_steps_sampled": self.num_steps_sampled
                + cfg.learning_starts,
                "horizon": horizon,
                "world_buffer_samples": int(pulled["world_buffer_samples"]),
                "collect_reward_mean": float(pulled["collect_reward_mean"]),
                "imagined_reward_mean": float(pulled["imagined_reward_mean"]),
                "num_pol_updates": self.num_pol_updates,
                "sac_qf_loss": float(pulled["sac_qf_loss"]),
                "sac_policy_loss": float(pulled["sac_policy_loss"]),
                "env_steps_per_sec": self.throughput.update(
                    int(pulled["total_steps"])
                ),
                **timings,
                "time": time.time() - self._start_time,
            },
            commit=True,
        )
        self.iteration += 1

    def save_checkpoint(self) -> None:
        from pdecontrol_tpu.utils import checkpoint as C

        self._flush_pending_log()
        state = C.controller_state(self)
        if jax.process_count() > 1:
            # Collective: EVERY process gathers sharded leaves to
            # replicated (else the primary's host pull would hit
            # non-addressable shards — dryrun stage 6).
            state = C.replicate_for_snapshot(state)
        if not self.primary:
            return  # restore runs everywhere; writes are primary-only
        self.ckpt.save(self.iteration, state)
