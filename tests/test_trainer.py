"""Trainer tests: fused TBPTT == chunked reference pattern, fit/early-stop,
losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdecontrol_tpu.data import replay as R
from pdecontrol_tpu.envs.transforms import Identity, Normalize, SampleTransform
from pdecontrol_tpu.models import factories
from pdecontrol_tpu.train.losses import BurgersPhyPDELoss, make_loss, mse_loss
from pdecontrol_tpu.train.schedulers import ConstantLengthScheduler, LinearScheduler
from pdecontrol_tpu.train.trainer import (
    SurrogateTrainer,
    TrainConfig,
    tbtt_reencode_mask,
)


def _data(key, b=2, t=8, n=64):
    k1, k2 = jax.random.split(key)
    states = jax.random.normal(k1, (b, t, 1, n), jnp.float32)
    actions = jax.random.uniform(k2, (b, t, 1, 4), dtype=jnp.float32, minval=-1, maxval=1)
    return states, actions


def test_reencode_mask():
    np.testing.assert_array_equal(
        tbtt_reencode_mask(8, 4), [0, 0, 0, 0, 1, 0, 0, 0, ][:8]
    )
    assert not tbtt_reencode_mask(8, 1000).any()


@pytest.mark.slow
def test_fused_tbtt_matches_chunked_reference_pattern():
    """Fused single-scan TBPTT loss/grads == the reference's explicit chunk
    loop (training.py:69-112): warmup rollout, then per-chunk rollouts
    teacher-forced on the detached last output with detached hidden."""
    key = jax.random.PRNGKey(0)
    tau, tbtt, t = 2, 4, 8
    model = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25)
    states, actions = _data(key, t=t)
    params = model.init(key, states[:, :tau], actions)
    und = Identity()

    def fused_loss(p):
        mask = tbtt_reencode_mask(t, tbtt)
        roll = model.apply({"params": p}, states[:, :tau], actions,
                           dscaling=und, reencode=mask)
        out = roll.deltas[:, :-1]
        target = jnp.diff(states, axis=1) / model.delta
        return jnp.mean(mse_loss(out, target))

    def chunked_loss(p):
        outdeltas = []
        roll = model.apply({"params": p}, states[:, :tau], actions[:, :tbtt],
                           dscaling=und)
        outdeltas.append(roll.deltas)
        hidden = jax.tree.map(jax.lax.stop_gradient, roll.hidden)
        last = jax.lax.stop_gradient(roll.outputs[:, -1:])
        for c in range(tbtt, t, tbtt):
            roll = model.apply({"params": p}, last, actions[:, c : c + tbtt],
                               dscaling=und, hidden=hidden)
            outdeltas.append(roll.deltas)
            hidden = jax.tree.map(jax.lax.stop_gradient, roll.hidden)
            last = jax.lax.stop_gradient(roll.outputs[:, -1:])
        out = jnp.concatenate(outdeltas, axis=1)[:, :-1]
        target = jnp.diff(states, axis=1) / model.delta
        return jnp.mean(mse_loss(out, target))

    lf, gf = jax.value_and_grad(fused_loss)(params["params"])
    lc, gc = jax.value_and_grad(chunked_loss)(params["params"])
    np.testing.assert_allclose(float(lf), float(lc), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(gf), jax.tree.leaves(gc)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-5)


def _ks_replay(key, episodes=6, ep_len=24, n=32):
    """Fill a replay with short KS episodes (small grid for speed)."""
    from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky

    env = KuramotoSivashinsky.create(n=n, length=22.0, cfg_steps=25,
                                     t_max=ep_len * 25 * 1e-3,
                                     dtype=jnp.float32)
    # 2x rows: every episode completes on the final write, so each env claims
    # a fresh row — with fewer rows the ring wraps and wipes rows 0..3,
    # leaving the train split silently empty (now a hard error in fit).
    rep = R.create(2 * episodes + 2, ep_len, episodes, (1, n), (1, 4),
                   dtype=jnp.float32)
    pool = jax.random.uniform(key, (episodes, n), minval=-0.4, maxval=0.4,
                              dtype=jnp.float32)
    state = env.reset_from_pool(key, pool, (episodes,))
    writer = jax.jit(R.write_step)
    stepper = jax.jit(lambda s, a, p: env.vec_step(s, a, p))
    for t in range(ep_len):
        key, ka = jax.random.split(key)
        actions = jax.random.uniform(ka, (episodes, 1, 4), minval=-1, maxval=1,
                                     dtype=jnp.float32)
        obs = env.observe(state)
        state, out = stepper(state, actions, pool)
        rep = writer(rep, obs, actions, out.reward, out.terminated,
                     out.truncated, out.info["final_obs"], out.info["step"])
    return env, rep


@pytest.mark.slow
def test_fit_learns_and_early_stops():
    key = jax.random.PRNGKey(1)
    env, rep = _ks_replay(key)

    model = factories.make("KSAutoRegConvolutionalLSTM", delta=env.delta, N=32)
    cfg = TrainConfig(tau=2, tbtt=5, lr=2e-3, batch_size=16, patience=3,
                      max_epochs=40, max_steps=150)
    trainer = SurrogateTrainer(model, mse_loss, cfg)

    states = jnp.zeros((1, 2, 1, 32))
    actions = jnp.zeros((1, 7, 1, 4))
    tstate = trainer.init(key, states, actions)

    und = Normalize.create((1, 1, 32), aggregate=True, batched=True,
                           dtype=jnp.float32)
    mean, var = R.delta_statistics(rep, Identity(), env.delta)
    und = und.replace(mean=und.mean + mean, var=und.var + var,
                      count=und.count + 1)

    train_mask = (jnp.arange(rep.num_rows) < 4)
    val_mask = (jnp.arange(rep.num_rows) >= 4) & (rep.fill > 0)

    stransf = SampleTransform()  # identity transforms; und handles scaling
    sched = ConstantLengthScheduler(length=5)

    tstate1, val1, logs1 = trainer.fit(
        tstate, rep, train_mask, val_mask, und, stransf, sched,
        iteration=0, key=key,
    )
    assert logs1["steps"] > 0
    assert np.isfinite(val1)

    tstate2, val2, logs2 = trainer.fit(
        tstate1, rep, train_mask, val_mask, und, stransf, sched,
        iteration=1, key=jax.random.PRNGKey(2), max_steps=300,
    )
    # Training reduces the free-run validation loss vs the untrained model,
    # scored on the SAME val batch (fit's internal val draws use other keys).
    vfn = trainer._val_batch_fn(5)
    v0 = vfn(tstate.params, rep, val_mask, und, stransf, jax.random.PRNGKey(3))
    v1 = vfn(tstate2.params, rep, val_mask, und, stransf, jax.random.PRNGKey(3))
    assert float(v1["val_loss"]) < float(v0["val_loss"]), (
        float(v1["val_loss"]), float(v0["val_loss"]))


def test_fit_respects_max_steps():
    key = jax.random.PRNGKey(4)
    env, rep = _ks_replay(key, episodes=4, ep_len=12)
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=env.delta, N=32)
    cfg = TrainConfig(tau=2, tbtt=4, batch_size=8, patience=100,
                      max_epochs=100, max_steps=7)
    trainer = SurrogateTrainer(model, mse_loss, cfg)
    tstate = trainer.init(key, jnp.zeros((1, 2, 1, 32)), jnp.zeros((1, 4, 1, 4)))
    mask = rep.fill > 0
    tstate, _, logs = trainer.fit(
        tstate, rep, mask, mask, Identity(), SampleTransform(),
        ConstantLengthScheduler(length=2), iteration=0, key=key,
    )
    assert logs["steps"] <= 8  # max_steps + at most one epoch-boundary step


def test_schedulers():
    lin = LinearScheduler(steptype="iteration", start=0, stop=10, vmin=3, vmax=7)
    assert lin(iteration=0) == 3
    assert lin(iteration=10) == 7
    assert lin(iteration=5) == 5
    assert lin(iteration=20) == 7

    from pdecontrol_tpu.train.schedulers import Scheduler
    s = Scheduler.factory({"scheduler": "LinearScheduler", "steptype": "epoch",
                           "start": 0, "stop": 100, "vmin": 25, "vmax": 50})
    assert s(epoch=0) == 25 and s(epoch=100) == 50


def test_burgers_phy_loss():
    loss = make_loss("BurgersPhyPDELoss", {"dx": 0.25, "dt": 1e-3, "nu": 0.05, "N": 64})
    assert isinstance(loss, BurgersPhyPDELoss)
    u = jax.random.normal(jax.random.PRNGKey(0), (2, 5, 1, 64))
    out = loss(u)
    assert out.shape == (2, 5, 1, 64)
    assert np.isfinite(np.asarray(out)).all()


def test_phy_loss_registry_dispatch():
    """`--loss PhyPDELoss` is reachable by name (reference getattr lookup,
    mbrl.py:213) and dispatches on the scenario's PDE family; the KS
    physics loss runs and is zero on a state evolved by its own Heun step."""
    from pdecontrol_tpu.train.losses import KSPhyPDELoss

    ks_scn = {"L": 22.0, "N": 64, "dt": 5e-3, "Tmax": 0.25, "Xi": [0.2]}
    bg_scn = {**ks_scn, "dx": 22.0 / 64, "nu": 0.05}
    assert isinstance(make_loss("PhyPDELoss", ks_scn), KSPhyPDELoss)
    assert isinstance(make_loss("PhyPDELoss", bg_scn), BurgersPhyPDELoss)
    assert isinstance(make_loss("KSPhyPDELoss", ks_scn), KSPhyPDELoss)
    assert make_loss("MSELoss", ks_scn) is mse_loss

    loss = make_loss("PhyPDELoss", ks_scn)
    u0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (3, 1, 1, 64))
    # Build a trajectory whose frame t+1 IS the Heun evolution of frame t:
    # the physics loss must then vanish on every frame but the first
    # (which is compared against the wrapped-around last frame).
    frames = [u0]
    for _ in range(4):
        frames.append(loss.phyevolve(frames[-1]))
    traj = jnp.concatenate(frames, axis=1)
    out = loss(traj)
    assert out.shape == traj.shape
    np.testing.assert_allclose(np.asarray(out[:, 1:]), 0.0, atol=1e-10)

    with pytest.raises(KeyError, match="unknown loss"):
        make_loss("NoSuchLoss", ks_scn)


def test_fit_ensemble_vmapped():
    """Vmapped multi-member fit: members learn, per-member early stopping,
    and member params diverge (independent batch streams)."""
    import jax

    key = jax.random.PRNGKey(7)
    env, rep = _ks_replay(key, episodes=4, ep_len=16)
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=env.delta, N=32)
    cfg = TrainConfig(tau=2, tbtt=4, lr=2e-3, batch_size=8, patience=2,
                      max_epochs=10, max_steps=30)
    trainer = SurrogateTrainer(model, mse_loss, cfg)

    states = [
        trainer.init(jax.random.PRNGKey(i), jnp.zeros((1, 2, 1, 32)),
                     jnp.zeros((1, 5, 1, 4)))
        for i in range(3)
    ]
    mask = rep.fill > 0
    stacked, val_losses, logs = trainer.fit_ensemble(
        states, rep, mask, mask, Identity(), SampleTransform(),
        ConstantLengthScheduler(length=3), iteration=0, key=key,
    )
    assert val_losses.shape == (3,)
    assert np.isfinite(val_losses).all()
    assert logs["steps"] > 0
    p0 = jax.tree.leaves(jax.tree.map(lambda x: x[0], stacked.params))
    p1 = jax.tree.leaves(jax.tree.map(lambda x: x[1], stacked.params))
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b)) for a, b in zip(p0, p1)
    )


def test_fit_ensemble_fused_epoch_matches_dispatch_loop():
    """The fused-epoch fit (one jitted fori_loop program per epoch) replays
    the per-batch dispatch loop's exact PRNG split sequence, so params, val
    losses, and early-stopping trajectories must be bit-identical."""
    import jax

    key = jax.random.PRNGKey(11)
    env, rep = _ks_replay(key, episodes=4, ep_len=16)
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=env.delta, N=32)
    cfg = TrainConfig(tau=2, tbtt=4, lr=2e-3, batch_size=8, patience=2,
                      max_epochs=8, max_steps=21)
    states = [
        SurrogateTrainer(model, mse_loss, cfg).init(
            jax.random.PRNGKey(i), jnp.zeros((1, 2, 1, 32)),
            jnp.zeros((1, 5, 1, 4)))
        for i in range(2)
    ]
    mask = rep.fill > 0

    outs = {}
    for fused in (True, False):
        trainer = SurrogateTrainer(model, mse_loss, cfg)
        trainer.fuse_epoch = fused
        trainer.fuse_fit = False  # isolate epoch fusion (bitwise); the
        # whole-fit while_loop is rounding-level and tested separately
        outs[fused] = trainer.fit_ensemble(
            states, rep, mask, mask, Identity(), SampleTransform(),
            ConstantLengthScheduler(length=3), iteration=0,
            key=jax.random.PRNGKey(5),
        )
    (st_f, vl_f, logs_f), (st_u, vl_u, logs_u) = outs[True], outs[False]
    np.testing.assert_array_equal(np.asarray(vl_f), np.asarray(vl_u))
    assert logs_f["steps"] == logs_u["steps"]
    assert logs_f["epochs"] == logs_u["epochs"]
    for a, b in zip(jax.tree.leaves(st_f.params), jax.tree.leaves(st_u.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # Single-member fit: same guarantee through the offline-eval path.
    fouts = {}
    for fused in (True, False):
        trainer = SurrogateTrainer(model, mse_loss, cfg)
        trainer.fuse_epoch = fused
        fouts[fused] = trainer.fit(
            states[0], rep, mask, mask, Identity(), SampleTransform(),
            ConstantLengthScheduler(length=3), iteration=0,
            key=jax.random.PRNGKey(6),
        )
    (fst_f, fvl_f, flogs_f), (fst_u, fvl_u, flogs_u) = fouts[True], fouts[False]
    assert fvl_f == fvl_u
    assert flogs_f["steps"] == flogs_u["steps"]
    for a, b in zip(jax.tree.leaves(fst_f.params), jax.tree.leaves(fst_u.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize(
    "stop_by",
    ["patience", "max_steps"],
)
def test_fit_ensemble_whole_fit_fusion_matches_epoch_loop(stop_by):
    """The whole-fit while_loop program (on-device early stopping, one final
    pull) must match the per-epoch host loop: the early-stopping decision
    trajectory (steps, epochs, per-member stop points, lr ladder) exactly,
    and params/losses to rounding level — XLA compiles the identical epoch
    body 1-2 ulp differently inside a while_loop context (measured 3e-8 abs
    after a single epoch with bit-identical inputs), so bitwise equality is
    not achievable across the program boundary."""
    key = jax.random.PRNGKey(13)
    env, rep = _ks_replay(key, episodes=4, ep_len=16)
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=env.delta,
                           N=32)
    if stop_by == "patience":
        cfg = TrainConfig(tau=2, tbtt=4, lr=2e-3, lr_gamma=0.7, step_size=2,
                          batch_size=8, patience=1, max_epochs=12)
    else:
        cfg = TrainConfig(tau=2, tbtt=4, lr=2e-3, batch_size=8, patience=50,
                          max_epochs=12, min_steps=4, max_steps=7)
    states = [
        SurrogateTrainer(model, mse_loss, cfg).init(
            jax.random.PRNGKey(i), jnp.zeros((1, 2, 1, 32)),
            jnp.zeros((1, 5, 1, 4)))
        for i in range(2)
    ]
    mask = rep.fill > 0

    outs = {}
    for whole in (True, False):
        trainer = SurrogateTrainer(model, mse_loss, cfg)
        trainer.fuse_fit = whole  # both sides keep fuse_epoch=True
        outs[whole] = trainer.fit_ensemble(
            states, rep, mask, mask, Identity(), SampleTransform(),
            ConstantLengthScheduler(length=3), iteration=0,
            key=jax.random.PRNGKey(5),
        )
    (st_w, vl_w, logs_w), (st_e, vl_e, logs_e) = outs[True], outs[False]
    assert "t_fit_ready" in logs_w and "t_fit_val" in logs_e
    np.testing.assert_allclose(np.asarray(vl_w), np.asarray(vl_e),
                               rtol=1e-4, atol=1e-9)
    for f in ("steps", "epochs", "curriculum_K", "lr"):
        assert logs_w[f] == logs_e[f], f
    np.testing.assert_allclose(logs_w["train_loss"], logs_e["train_loss"],
                               rtol=1e-4, atol=1e-9)
    for a, b in zip(jax.tree.leaves(st_w.params),
                    jax.tree.leaves(st_e.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(st_w.global_step),
                                  np.asarray(st_e.global_step))


def test_fit_host_hints_bitwise_identical():
    """``host_hints`` only replaces device pulls with host copies of the
    SAME values (fill / split masks / start_step) — the controller passes
    them to save 3-4 blocking host round trips per retrain — so results
    must be bit-identical with and without them, for both fit paths."""
    key = jax.random.PRNGKey(23)
    env, rep = _ks_replay(key, episodes=4, ep_len=16)
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=env.delta,
                           N=32)
    cfg = TrainConfig(tau=2, tbtt=4, lr=2e-3, batch_size=8, patience=2,
                      max_epochs=6, max_steps=18)
    states = [
        SurrogateTrainer(model, mse_loss, cfg).init(
            jax.random.PRNGKey(i), jnp.zeros((1, 2, 1, 32)),
            jnp.zeros((1, 5, 1, 4)))
        for i in range(2)
    ]
    mask = rep.fill > 0
    fill_np = np.asarray(jax.device_get(rep.fill))
    mask_np = np.asarray(jax.device_get(mask)).astype(bool)
    hints = {"fill": fill_np, "train_np": mask_np, "val_np": mask_np,
             "start_step": 0}

    outs = {}
    for use in (False, True):
        trainer = SurrogateTrainer(model, mse_loss, cfg)
        outs[use] = trainer.fit_ensemble(
            states, rep, mask, mask, Identity(), SampleTransform(),
            ConstantLengthScheduler(length=3), iteration=0,
            key=jax.random.PRNGKey(5),
            host_hints=hints if use else None,
        )
    (st_a, vl_a, lg_a), (st_b, vl_b, lg_b) = outs[False], outs[True]
    np.testing.assert_array_equal(np.asarray(vl_a), np.asarray(vl_b))
    assert lg_a["steps"] == lg_b["steps"] and lg_a["epochs"] == lg_b["epochs"]
    for a, b in zip(jax.tree.leaves(st_a.params), jax.tree.leaves(st_b.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    fouts = {}
    for use in (False, True):
        trainer = SurrogateTrainer(model, mse_loss, cfg)
        fouts[use] = trainer.fit(
            states[0], rep, mask, mask, Identity(), SampleTransform(),
            ConstantLengthScheduler(length=3), iteration=0,
            key=jax.random.PRNGKey(6),
            host_hints={k: hints[k] for k in ("fill", "train_np", "val_np")}
            if use else None,
        )
    (fst_a, fvl_a, _), (fst_b, fvl_b, _) = fouts[False], fouts[True]
    assert fvl_a == fvl_b
    for a, b in zip(jax.tree.leaves(fst_a.params),
                    jax.tree.leaves(fst_b.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_whole_fit_fusion_requires_iteration_curriculum():
    """Epoch-typed curricula grow the window per epoch; the whole-fit
    program can't represent that and fit_ensemble must fall back to the
    host loop (detectable by the t_fit_val timing field it emits)."""
    key = jax.random.PRNGKey(17)
    env, rep = _ks_replay(key, episodes=4, ep_len=16)
    model = factories.make("KSAutoRegFullyConnectedLSTM", delta=env.delta,
                           N=32)
    cfg = TrainConfig(tau=2, tbtt=4, lr=2e-3, batch_size=8, patience=50,
                      max_epochs=3, max_steps=6)
    states = [
        SurrogateTrainer(model, mse_loss, cfg).init(
            jax.random.PRNGKey(i), jnp.zeros((1, 2, 1, 32)),
            jnp.zeros((1, 5, 1, 4)))
        for i in range(2)
    ]
    mask = rep.fill > 0
    trainer = SurrogateTrainer(model, mse_loss, cfg)
    grow = LinearScheduler(steptype="epoch", start=0, stop=2, vmin=3, vmax=5)
    stacked, vls, logs = trainer.fit_ensemble(
        states, rep, mask, mask, Identity(), SampleTransform(), grow,
        iteration=0, key=jax.random.PRNGKey(5),
    )
    assert "t_fit_val" in logs and "t_fit_ready" not in logs
    assert np.isfinite(np.asarray(vls)).all()
