"""Offline K-fold surrogate benchmark CLI (reference
``pdecontrol/surrogates/evaluation/evaluate.py``).

Protocol (evaluate.py:73-216): K-fold CV over the episodes of an offline
dataset (optionally a ``--total`` fraction); per fold, Normalize transforms
are fitted on the train split (obs scaling, action scaling or
forcing+field scaling when transformed, delta scaling), the surrogate
factory's model is trained with early stopping + constant-length curriculum,
and the full metric battery (``training.py:176-271``) runs on the held-out
fold at a ``--target_length``-step open-loop horizon.  Results are written
as ``.npz`` + a JSON summary per fold.

    python -m pdecontrol_tpu.evaluation.evaluate --env_id KuramotoSivashinskyEnv-v0 \
        --data ks_attractor.npz --factory KSAutoRegConvolutionalLSTM \
        --training '{"tbtt": 1000000, "tau": 10, "batch_size": 64, "patience": 50}' \
        --trainer '{"max_epochs": 250, "gradient_clip_val": 0.5}' --target_length 30
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict

import numpy as np

from pdecontrol_tpu.utils import runtime


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env_id", type=str, default="KuramotoSivashinskyEnv-v0")
    p.add_argument("--env_config", type=str, default="{}")
    p.add_argument("--factory", type=str, default="KSAutoRegConvolutionalLSTM")
    p.add_argument("--untransformed", action="store_true")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--target_length", type=int, default=30)
    p.add_argument("--splits", type=int, default=5)
    p.add_argument("--total", type=float, default=1.0)
    p.add_argument("--val", type=float, default=0.2)
    p.add_argument("--loss", type=str, default="MSELoss")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--store", action="store_true")
    p.add_argument("--output", type=str, default="offline_eval")
    p.add_argument("--model", type=str, default="{}")
    p.add_argument("--surrogate", type=str, default="{}")
    p.add_argument("--training", type=str, default="{}")
    p.add_argument("--curriculum", type=str, default="{}")
    p.add_argument("--trainer", type=str, default="{}")
    p.add_argument("--max_folds", type=int, default=None)
    p.add_argument("--platform", type=str, default=None)
    return p


def make_curriculum(curriculum_json: str, target_length: int):
    """Honor --curriculum when given (reference offline.sh grows the window
    25->50 over 100 epochs); the default is a constant window of
    ``target_length`` — one compiled program per fold (each distinct
    window length is a recompile)."""
    from pdecontrol_tpu.train.schedulers import (
        ConstantLengthScheduler, Scheduler,
    )

    cfg = json.loads(curriculum_json)
    if cfg:
        return Scheduler.factory(cfg)
    return ConstantLengthScheduler(length=target_length)


def kfold_indices(n: int, splits: int, seed: int):
    """sklearn-KFold(shuffle=True) equivalent: shuffled indices split into
    ``splits`` contiguous folds."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    sizes = np.full(splits, n // splits)
    sizes[: n % splits] += 1
    folds, start = [], 0
    for s in sizes:
        test = idx[start : start + s]
        train = np.concatenate([idx[:start], idx[start + s :]])
        folds.append((train, test))
        start += s
    return folds


def run_fold(args, data: Dict[str, np.ndarray], train_idx, val_idx, test_idx,
             fold: int) -> Dict:
    import jax
    import jax.numpy as jnp

    from pdecontrol_tpu.data import replay as R
    from pdecontrol_tpu.data.types import Sample
    from pdecontrol_tpu.envs.transforms import (
        Chain, Normalize, SampleTransform,
    )
    from pdecontrol_tpu.mbrl.controller import ENVS
    from pdecontrol_tpu.models import factories
    from pdecontrol_tpu.train.losses import make_loss
    from pdecontrol_tpu.train.metrics import surrogate_metric_battery
    from pdecontrol_tpu.train.trainer import SurrogateTrainer, TrainConfig

    env_cls, _ = ENVS[args.env_id]
    env = env_cls.create(**json.loads(args.env_config))
    delta = env.delta

    episodes, t = data["obs"].shape[:2]
    obs_shape = data["obs"].shape[2:]
    act_shape = data["actions"].shape[2:]

    # Dense replay view of the offline dataset (all episodes complete).
    rep = R.create(episodes, t, 1, obs_shape, act_shape)
    rep = rep.replace(
        obs_seq=jnp.asarray(
            np.concatenate([data["obs"], data["nxtobs"][:, -1:]], axis=1),
            jnp.float32,
        ),
        actions=jnp.asarray(data["actions"], jnp.float32),
        rewards=jnp.asarray(data["rewards"], jnp.float32),
        terminated=jnp.asarray(data["terminated"]),
        truncated=jnp.asarray(data["truncated"]),
        steps=jnp.asarray(data["steps"], jnp.int32),
        fill=jnp.full((episodes,), t, jnp.int32),
        complete=jnp.ones((episodes,), bool),
    )

    # ---- fit Normalize transforms on the train fold (evaluate.py:85-112).
    flat = lambda x: jnp.asarray(
        x.reshape((-1,) + x.shape[2:]), jnp.float32
    )
    obs_train = flat(data["obs"][train_idx])
    act_train = flat(data["actions"][train_idx])
    nxt_train = flat(data["nxtobs"][train_idx])

    # Reference fits scalar stats: aggregate+batched pools all axes
    # of the flat [N, C, H] arrays (evaluate.py:86-90).
    oscaling = Normalize.create(obs_train.shape, aggregate=True, batched=True)
    oscaling = oscaling.update(obs_train)

    forcing = env.forcing
    if args.untransformed:
        ascaling = Normalize.create(act_train.shape, aggregate=True, batched=True).update(act_train)
        atransf = ascaling
    else:
        fields = forcing.apply(act_train)
        pdescaling = Normalize.create(fields.shape, aggregate=True, batched=True).update(fields)
        atransf = Chain(transforms=(forcing, pdescaling))

    deltas = (oscaling.apply(nxt_train) - oscaling.apply(obs_train)) / delta
    undscaling = Normalize.create(deltas.shape, aggregate=True, batched=True).update(deltas)

    stransf = SampleTransform(otransf=oscaling, atransf=atransf)

    # ---- build + train the surrogate.
    model_cfg = json.loads(args.model)
    training = json.loads(args.training)
    trainer_cfg = json.loads(args.trainer)
    merged = {**training, **trainer_cfg}
    tc = TrainConfig(**{k: v for k, v in merged.items() if k in TrainConfig._fields})

    module = factories.make(args.factory, delta=delta,
                            **{**env.scenario, **model_cfg})
    loss_fn = make_loss(args.loss, env.scenario)
    trainer = SurrogateTrainer(module, loss_fn, tc)

    key = jax.random.PRNGKey(args.seed + fold)
    key, kinit = jax.random.split(key)
    tau = tc.tau
    ex_s = jnp.zeros((1, tau) + obs_shape, jnp.float32)
    wa_shape = act_shape if args.untransformed else obs_shape
    ex_a = jnp.zeros((1, tau + 1) + wa_shape, jnp.float32)
    tstate = trainer.init(kinit, ex_s, ex_a)

    nrows = rep.num_rows
    train_mask = jnp.zeros((nrows,), bool).at[jnp.asarray(train_idx)].set(True)
    val_mask = jnp.zeros((nrows,), bool).at[jnp.asarray(val_idx)].set(True)

    curriculum = make_curriculum(args.curriculum, args.target_length)
    t0 = time.time()
    tstate, val_loss, logs = trainer.fit(
        tstate, rep, train_mask, val_mask, undscaling, stransf, curriculum,
        iteration=0, key=key,
    )
    train_time = time.time() - t0

    # ---- test battery on held-out episodes: ALL non-bootstrap stride-tau
    # windows, deterministically enumerated (datamodule.py:100-117).
    length = tau + args.target_length
    batch = R.enumerate_windows(
        rep, length, stride=tau,
        rows_mask=jnp.zeros((nrows,), bool).at[jnp.asarray(test_idx)].set(True),
    )
    if batch.obs.shape[0] == 0:
        raise ValueError(
            f"fold {fold}: no test episode admits a length-{length} window "
            f"(tau={tau} + target_length={args.target_length}); the metric "
            "battery would be NaN — lower --target_length or the budget"
        )
    batch = stransf(batch)
    metrics = surrogate_metric_battery(
        module, tstate.params, batch, stransf, undscaling, env, tau
    )
    metrics = {k: np.asarray(jax.device_get(v)) for k, v in metrics.items()}

    result = {
        "fold": fold,
        "val_loss": val_loss,
        "train_time": train_time,
        "train_steps": logs.get("steps"),
        "MSE": float(metrics["MSE"]),
        "nrmse_final": float(metrics["nrmse"][-1]),
        "l2_loss_scaled_final": float(metrics["l2_loss_scaled"][-1]),
    }

    os.makedirs(args.output, exist_ok=True)
    np.savez_compressed(
        os.path.join(args.output, f"fold{fold}_metrics.npz"), **metrics
    )
    if args.store:
        import pickle

        with open(os.path.join(args.output, f"fold{fold}_model.pkl"), "wb") as f:
            pickle.dump(
                {
                    "params": jax.device_get(tstate.params),
                    "oscaling": jax.device_get(oscaling),
                    "undscaling": jax.device_get(undscaling),
                    "factory": args.factory,
                },
                f,
            )
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    runtime.setup("evaluate")

    data = dict(np.load(args.data))
    episodes = data["obs"].shape[0]
    n_used = math.ceil(args.total * episodes)
    # The data budget restricts the FOLD INDICES, not the array shapes: the
    # dense replay keeps every episode and the train/val/test row masks
    # select the first n_used, so every budget of a sweep reuses the same
    # compiled programs (static shapes; a 6-budget sweep compiles once).
    folds = kfold_indices(n_used, args.splits, args.seed)
    if args.max_folds:
        folds = folds[: args.max_folds]

    results = []
    for fold, (train_idx, test_idx) in enumerate(folds):
        train_size = math.ceil((1.0 - args.val) * len(train_idx))
        train_idx, val_idx = train_idx[:train_size], train_idx[train_size:]
        if len(val_idx) == 0:
            val_idx = train_idx[-1:]
        res = run_fold(args, data, train_idx, val_idx, test_idx, fold)
        results.append(res)
        print(json.dumps(res))

    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
