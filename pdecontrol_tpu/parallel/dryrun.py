"""Multi-chip dry run: ONE sharded step of the FULL training pipeline on
tiny shapes.

Used by ``__graft_entry__.dryrun_multichip`` and the CPU-mesh tests.  The
mesh is ``(data, model)``; the step exercises all three sharded hot paths —
vectorised env collection (env batch over ``data``), a vmapped gradient step
for the whole surrogate ensemble (members over ``model``, batches over
``data``), and a SAC update (batch over ``data``, replicated params with the
gradient all-reduce inserted by the partitioner).
"""

from __future__ import annotations

import os
import sys


def provision_virtual_devices(n_devices: int) -> None:
    """Force a CPU backend with ``n_devices`` virtual devices.

    Must run before first backend use.  Backends initialise lazily, so
    flipping the config flag (plus XLA_FLAGS, which XLA reads at
    backend-init time) selects an ``n_devices``-wide CPU mesh even when
    jax was already imported with another platform configured.
    """
    import re

    flags = os.environ.get("XLA_FLAGS", "")
    # Replace any pre-existing count rather than silently keeping it — a
    # parent shell exporting a smaller count would otherwise produce an
    # opaque device-count mismatch when the mesh is built.
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


import jax
import jax.numpy as jnp

from pdecontrol_tpu.parallel import mesh as meshlib
from pdecontrol_tpu.parallel.sharded import (
    sharded_collect_fn,
    sharded_ensemble_train_fn,
    sharded_sac_update_fn,
)


def run(n_devices: int) -> None:
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = meshlib.make_mesh(n_devices, model_parallel=model_parallel)
    data_size = n_devices // model_parallel

    from pdecontrol_tpu.data.types import Sample
    from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky
    from pdecontrol_tpu.envs.transforms import Identity
    from pdecontrol_tpu.models import factories
    from pdecontrol_tpu.sac.sac import SAC, SACConfig
    from pdecontrol_tpu.train.losses import mse_loss
    from pdecontrol_tpu.train.trainer import SurrogateTrainer, TrainConfig

    key = jax.random.PRNGKey(0)
    env = KuramotoSivashinsky.create(n=16, cfg_steps=4, dtype=jnp.float32)
    batch = 2 * data_size
    members = 2 * model_parallel

    # ---- 1. sharded env collection -------------------------------------
    pool = jax.random.uniform(key, (8, env.n), minval=-0.4, maxval=0.4)
    state = env.reset_from_pool(key, pool, batch_shape=(batch,))
    actions = jnp.zeros((3, batch, 1, 4))
    collect, place_c = sharded_collect_fn(mesh, env, nsteps=3)
    state, actions, pool = place_c(state, actions, pool)
    state, rewards = collect(state, actions, pool)
    jax.block_until_ready(rewards)
    assert rewards.shape == (3, batch)
    print(f"[dryrun] env collect OK on {n_devices} devices "
          f"(data={data_size}, model={model_parallel})")

    # ---- 2. vmapped + sharded ensemble gradient step -------------------
    module = factories.make("KSAutoRegConvolutionalLSTM", delta=env.delta,
                            N=env.n)
    trainer = SurrogateTrainer(module, mse_loss,
                               TrainConfig(tau=2, tbtt=3, batch_size=batch))
    tw, t = 2, 5
    ex_s = jnp.zeros((1, tw, 1, env.n))
    ex_a = jnp.zeros((1, t, 1, env.n))
    stacked = jax.vmap(
        lambda k: trainer.init(k, ex_s, ex_a)
    )(jax.random.split(key, members))

    bs = jax.random.normal(key, (members, batch, t, 1, env.n))
    ba = jax.random.uniform(key, (members, batch, t, 1, env.n))
    train, place_t = sharded_ensemble_train_fn(mesh, trainer)
    stacked, bs, ba = place_t(stacked, bs, ba)
    stacked, metrics = train(stacked, bs, ba, Identity(), jnp.asarray(1e-3))
    jax.block_until_ready(metrics["train_loss"])
    assert metrics["train_loss"].shape == (members,)
    print(f"[dryrun] ensemble train step OK ({members} members sharded "
          f"over model axis)")

    # ---- 3. sharded SAC update -----------------------------------------
    sac = SAC((1, env.n), (1, 4), SACConfig())
    sac_state = sac.init(key)
    sbatch = Sample(
        obs=jax.random.normal(key, (batch * 4, 1, env.n)),
        actions=jax.random.uniform(key, (batch * 4, 1, 4), minval=-1, maxval=1),
        nxtobs=jax.random.normal(key, (batch * 4, 1, env.n)),
        rewards=jax.random.normal(key, (batch * 4,)),
        terminated=jnp.zeros((batch * 4,), bool),
        truncated=jnp.zeros((batch * 4,), bool),
        steps=jnp.zeros((batch * 4,), jnp.int32),
    )
    update, place_s = sharded_sac_update_fn(mesh, sac)
    sac_state, sbatch = place_s(sac_state, sbatch)
    sac_state, m = update(sac_state, sbatch, key)
    jax.block_until_ready(m["qf_loss"])
    print(f"[dryrun] SAC update OK (qf_loss={float(m['qf_loss']):.4f})")

    # ---- 4. full MBPO iterations THROUGH THE PRODUCT PATH ----------------
    # The controller itself builds the (data, model) mesh from the config
    # (--data_parallel/--model_parallel) and shards env batch, stacked
    # ensemble params, imagined world rollouts, and SAC batches; this runs
    # warmup -> collect -> surrogate retrain -> imagine -> SAC update ->
    # eval end-to-end on the mesh.
    import tempfile

    from pdecontrol_tpu.mbrl.config import MBPOConfig
    from pdecontrol_tpu.mbrl.controller import PDEModelBasedController

    with tempfile.TemporaryDirectory() as tmp:
        cfg = MBPOConfig(
            run_dir=tmp,
            env_config={"n": 16, "cfg_steps": 5, "t_max": 0.04},
            data_parallel=data_size,
            model_parallel=model_parallel,
            num_envs=2 * data_size,
            total_timesteps=8 * data_size + 4 * data_size,
            learning_starts=8 * data_size,
            capacity=512,
            pool_size=8,
            surrogate_train_freq=4 * data_size,
            policy_train_steps_per_sample=1,
            model_rollouts_per_sample=2,
            model_rollouts_batch_size=2 * data_size,
            model_buffer_store_iterations=2,
            model_buffer_max_capacity=64,
            num_dynamics_models=2 * model_parallel,
            num_elite_models=2 * model_parallel,
            policy_batch_size=4 * data_size,
            agent_eval_freq=1,
            num_eval_episodes=2,
            surrogate_eval_horizon=3,
            logging_freq=0,
            status_report_freq=100,
            rollout_length_schedule={
                "scheduler": "ConstantLengthScheduler", "length": 2
            },
            training={"tau": 2, "tbtt": 4, "patience": 1, "batch_size": 4,
                      "min_steps": 1, "max_steps": 2},
            curriculum={"scheduler": "ConstantLengthScheduler", "length": 3},
        )
        ctl = PDEModelBasedController(cfg)
        assert ctl.mesh is not None
        ctl.learn()
        assert ctl.iteration >= 2
        assert int(jax.device_get(ctl.world_replay.ntimesteps)) > 0
    print(f"[dryrun] full MBPO iterations OK on the mesh "
          f"(imagined rollouts + SAC + eval; {ctl.iteration} iterations)")

    # ---- 5. multi-process readiness --------------------------------------
    # 2 OS processes x 4 virtual devices: one sharded collect + ensemble
    # train step over the GLOBAL mesh via jax.distributed + Gloo CPU
    # collectives, with the host-boundary assumptions (process-identical
    # RNG, replicated-only metric pulls, primary-only file I/O) asserted
    # loudly.  See parallel/dryrun_mp.py.
    run_multiprocess()

    # ---- 6. multi-process FULL learn() -----------------------------------
    # The complete product loop (warmup -> collect -> retrain -> imagine ->
    # SAC -> eval -> checkpoint) on 2 processes x 4 devices, with the
    # primary-only I/O rule made falsifiable (per-process run_dirs) and the
    # primary's metrics stream checked against a single-process run of the
    # same seed over the same 8-device mesh.  See dryrun_mp.child_learn.
    run_multiprocess_learn()
    print(f"[dryrun] full training step validated on {n_devices}-device mesh")


def run_multiprocess(num_processes: int = 2, local_devices: int = 4) -> None:
    """Spawn the stage-5 children and verify their cross-process receipts."""
    import json
    import subprocess
    import tempfile

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = 12000 + (os.getpid() % 20000)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        # The children pick their own virtual-device count; a parent-forced
        # count would make the global mesh the wrong size.
        env.pop("XLA_FLAGS", None)
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "pdecontrol_tpu.parallel.dryrun_mp",
                 str(i), str(num_processes), str(port), tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for i in range(num_processes)
        ]
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"[dryrun-mp] process {i} failed "
                    f"(rc={p.returncode}):\n{out}"
                )
        recs = [
            json.load(open(os.path.join(tmp, f"proc{i}.json")))
            for i in range(num_processes)
        ]
        # Replicated pulls agree bitwise across processes (same-seed RNG +
        # same global program), sharded pulls raised everywhere, exactly
        # one primary wrote the metrics file exactly once.
        assert len({r["rmean"] for r in recs}) == 1, recs
        assert len({r["train_loss_mean"] for r in recs}) == 1, recs
        assert all(r["sharded_pull_raised"] for r in recs), recs
        assert [r["primary"] for r in recs].count(True) == 1, recs
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            assert len(f.readlines()) == 1
        assert all(r["global_devices"] == num_processes * local_devices
                   for r in recs)
    print(f"[dryrun] stage 5 OK: {num_processes} processes x "
          f"{local_devices} devices, collectives over the global mesh, "
          "host-boundary assumptions verified")


def run_multiprocess_learn(num_processes: int = 2,
                           local_devices: int = 4) -> None:
    """Stage 6: the FULL ``learn()`` loop under the multi-process runtime.
    Asserts (a) both processes finish the same
    number of iterations, (b) ONLY the primary touched the filesystem —
    each process writes into its own run_dir, so a stray non-primary write
    is visible, (c) the primary's metrics stream matches a single-process
    run of the same seed/mesh on every non-timing field."""
    import json
    import subprocess
    import tempfile

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = 12000 + ((os.getpid() + 7) % 20000)

    def spawn(nprocs, local, tmp):
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("XLA_FLAGS", None)
        # NOTE: deliberately NO shared persistent compile cache here — a
        # shared cache makes one child skip compiles the other still pays,
        # and the resulting skew across the many per-program Gloo rendezvous
        # was observed to wedge the pair on this host.  Keep the children
        # timing-symmetric.
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        procs = [
            subprocess.Popen(
                [sys.executable, "-c",
                 "import sys; from pdecontrol_tpu.parallel.dryrun_mp "
                 "import child_learn; child_learn(int(sys.argv[1]), "
                 "int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], "
                 "int(sys.argv[5]))",
                 str(i), str(nprocs), str(port), tmp, str(local)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for i in range(nprocs)
        ]
        outs = [p.communicate(timeout=1200)[0].decode() for p in procs]
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"[dryrun-learn] process {i} failed "
                    f"(rc={p.returncode}):\n{out}"
                )
        return [
            json.load(open(os.path.join(tmp, f"learn_proc{i}.json")))
            for i in range(nprocs)
        ]

    def metrics_lines(run_dir):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            return [json.loads(l) for l in f]

    TIMING = ("time", "_time", "env_steps_per_sec")

    def strip_timing(rec):
        # Drop host-environment telemetry (phase timings, GC pauses) —
        # everything else (returns, losses, counters) must agree.
        return {k: v for k, v in rec.items()
                if not (k.startswith(("t_", "gc_", "n_gc")) or k in TIMING)}

    with tempfile.TemporaryDirectory() as tmp:
        recs = spawn(num_processes, local_devices, tmp)
        assert [r["primary"] for r in recs].count(True) == 1, recs
        assert len({r["iteration"] for r in recs}) == 1, recs
        assert all(r["iteration"] >= 2 for r in recs), recs
        # Checkpoint round-trip: EVERY process restored the primary's
        # snapshot (after a durability barrier) and matched the live state.
        assert all(r["restore_ok"] for r in recs), recs
        primary = next(r for r in recs if r["primary"])
        for r in recs:
            if r["primary"]:
                # The primary owns ALL artifacts: metrics stream, config
                # snapshot, and at least one checkpoint.
                assert "metrics.jsonl" in r["files"], r
                assert "config.json" in r["files"], r
                assert any(f.startswith("checkpoints") for f in r["files"]), r
            else:
                # Non-primary processes must leave the filesystem untouched.
                assert r["files"] == [], (
                    f"non-primary process {r['process_id']} wrote files: "
                    f"{r['files']}"
                )
        mp_metrics = metrics_lines(primary["run_dir"])

        # Same seed, same 8-device mesh, ONE process: the metrics stream
        # must agree on every non-timing field (collectives may reduce in a
        # different order across runtimes -> allclose, not bitwise).
        single = spawn(1, num_processes * local_devices, tmp)
        sp_metrics = metrics_lines(single[0]["run_dir"])
        assert len(mp_metrics) == len(sp_metrics) > 0
        for a, b in zip(mp_metrics, sp_metrics):
            a, b = strip_timing(a), strip_timing(b)
            assert a.keys() == b.keys(), (a.keys(), b.keys())
            for k in a:
                va, vb = a[k], b[k]
                if isinstance(va, float) and isinstance(vb, float):
                    import math

                    assert math.isclose(va, vb, rel_tol=1e-4, abs_tol=1e-6), \
                        (k, va, vb)
                else:
                    assert va == vb, (k, va, vb)
    print(f"[dryrun] stage 6 OK: full learn() on {num_processes} processes "
          f"({primary['iteration']} iterations, primary-only I/O, metrics "
          "== single-process run)")


if __name__ == "__main__":
    _n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    provision_virtual_devices(_n)
    run(_n)
