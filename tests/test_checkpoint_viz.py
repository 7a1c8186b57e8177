"""Checkpoint/resume round-trip + viz smoke tests."""

import numpy as np
import pytest


@pytest.mark.slow
def test_controller_checkpoint_roundtrip(tmp_path):
    import jax

    from pdecontrol_tpu.mbrl.config import MBPOConfig
    from pdecontrol_tpu.mbrl.controller import PDEModelBasedController

    def make_cfg(run_dir, resume=False):
        return MBPOConfig(
            run_dir=str(run_dir),
            env_config={"n": 16, "cfg_steps": 5, "t_max": 0.04},
            num_envs=2, total_timesteps=16, learning_starts=8, capacity=256,
            pool_size=8, surrogate_train_freq=8,
            policy_train_steps_per_sample=1, model_rollouts_per_sample=2,
            model_rollouts_batch_size=4, model_buffer_store_iterations=2,
            model_buffer_max_capacity=64, num_dynamics_models=2,
            policy_batch_size=8, agent_eval_freq=100, num_eval_episodes=2,
            rollout_length_schedule={"scheduler": "ConstantLengthScheduler",
                                     "length": 2},
            training={"tau": 2, "initial": {"tbtt": 4, "patience": 1,
                                            "batch_size": 4},
                      "iterations": {"tbtt": 4, "patience": 1,
                                     "batch_size": 4}},
            trainer={"initial": {"min_steps": 1, "max_steps": 2},
                     "iterations": {"min_steps": 1, "max_steps": 2}},
            checkpoint_freq=2, resume=resume, precompile_horizons=False,
        )

    run_dir = tmp_path / "run"
    ctl = PDEModelBasedController(make_cfg(run_dir))
    ctl.learn()
    it_done = ctl.iteration
    assert ctl.ckpt.latest_step() == it_done

    # Fresh controller restores the snapshot.
    ctl2 = PDEModelBasedController(make_cfg(run_dir, resume=True))
    assert ctl2.iteration == it_done
    np.testing.assert_allclose(
        np.asarray(jax.device_get(ctl2.replay.fill)),
        np.asarray(jax.device_get(ctl.replay.fill)),
    )
    a = jax.tree.leaves(ctl.sac_state.policy_params)
    b = jax.tree.leaves(ctl2.sac_state.policy_params)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y))
    # And it can continue learning.
    ctl2.config = ctl2.config.__class__(**{
        **ctl2.config.to_dict(), "total_timesteps": 20,
    })
    ctl2.learn()
    assert ctl2.iteration > it_done


def test_metrics_append_tracks_actual_restore(tmp_path):
    """`--resume` with nothing to restore must NOT append a restarted run
    onto an old metrics stream, and a fresh rerun into an existing run_dir
    backs the old stream up instead of destroying it (advisor r2)."""
    import os

    from pdecontrol_tpu.utils.logging import MetricsLogger

    run_dir = tmp_path / "run"
    lg = MetricsLogger(str(run_dir))
    lg.log({"iteration": 7})
    lg.close() if hasattr(lg, "close") else lg._file.close()

    # Fresh rerun into the same dir: old stream preserved as a backup.
    lg2 = MetricsLogger(str(run_dir))
    lg2._file.close()
    baks = [f for f in os.listdir(run_dir) if f.startswith("metrics.jsonl.bak")]
    assert len(baks) == 1
    assert os.path.getsize(run_dir / "metrics.jsonl") == 0
    assert b'"iteration": 7' in open(run_dir / baks[0], "rb").read()

    # Actual-restore append mode keeps the existing stream.
    lg3 = MetricsLogger(str(run_dir), append=True)
    lg3.log({"iteration": 8})
    lg3._file.close()
    assert len([f for f in os.listdir(run_dir)
                if f.startswith("metrics.jsonl.bak")]) == 1


def test_viz_smoke():
    from pdecontrol_tpu.viz import plots

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(20, 1, 16))
    pred = obs + 0.1 * rng.normal(size=obs.shape)
    actions = rng.normal(size=(20, 1, 4))
    rewards = rng.normal(size=(20,))

    img = plots.pdeplot(obs, pred, actions, rewards, rewards * 1.1)
    assert img.size[0] > 100
    assert plots.spatial({"outdeltas": obs, "deltas": pred}).size[0] > 100
    assert plots.epplot(obs, actions[:, 0], rewards).size[0] > 100
    assert plots.hstepplot(np.abs(rng.normal(size=10))).size[0] > 100
    assert plots.trisurf(obs, dt=0.25, length=22.0).size[0] > 100


def test_checkpoint_failure_is_not_silent(tmp_path):
    """Background checkpoint saves must re-raise at the next save()/wait()
    instead of silently dropping the snapshot (checkpoint.py contract)."""
    import pytest

    from pdecontrol_tpu.utils.checkpoint import CheckpointManager

    ckpt = CheckpointManager(str(tmp_path / "ck"))
    # A lambda cannot be pulled to the host as an array -> the worker job
    # fails; wait() must surface it.
    ckpt.save(0, {"bad": lambda: None})
    with pytest.raises(Exception):
        ckpt.wait()
    # The manager stays usable afterwards: a good save round-trips.
    ckpt.save(1, {"x": np.arange(4)}, wait=True)
    assert ckpt.latest_step() == 1
    out = ckpt.restore({"x": np.zeros(4, dtype=np.int64)})
    np.testing.assert_array_equal(out["x"], np.arange(4))
