"""Surrogate training: fused-TBPTT train step, free-run validation, early
stopping, curriculum — the jitted re-design of the reference's
pytorch-lightning harness.

Reference mapping:
  * ``train_step`` == ``PDETrainingModule.training_step`` (training.py:64-130)
    with the chunked TBPTT Python loop replaced by ONE fused rollout whose
    per-step ``reencode`` schedule self-forces (and gradient-stops) at every
    chunk boundary — the scan-with-stop_gradient equivalent of detaching
    ``dslast``/hidden between chunks (training.py:86-98).  Loss on per-step
    deltas ("delta" mode, AutoReg) or decoded states ("decoded" mode,
    Latent) (training.py:49-55,106-109).
  * ``val_step`` == ``validation_step`` (training.py:132-174): full free-run
    from a tau warmup; the early-stopping / elite score is the MSE in
    *unscaled* space (training.py:157-164).
  * ``fit`` == ``pl.Trainer.fit`` + ``EarlyStopping`` + curriculum
    datamodule reload (mbrl.py:344-382, datamodule.py:48-98): epochs re-draw
    windows of length ``tau + K(curriculum)`` from the replay; early
    stopping on "Val. Loss" with patience, bounded by min/max optimizer
    steps (the two-phase initial/iterations trainer configs,
    mbrl.py:369-382).
  * optimizer == Adam + StepLR(step_size, gamma) per epoch
    (training.py:273-278) + optional global-norm gradient clipping
    (``gradient_clip_val``, runscripts/offline.sh).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pdecontrol_tpu.data import replay as R
from pdecontrol_tpu.envs.transforms import Normalize, SampleTransform
from pdecontrol_tpu.models.surrogate import AUTOREG, PDESurrogate
from pdecontrol_tpu.utils.pytree import PyTreeNode

Array = jax.Array


class TrainConfig(NamedTuple):
    tau: int = 5
    tbtt: int = 10
    lr: float = 1e-3
    lr_gamma: float = 1.0
    step_size: int = 25
    batch_size: int = 64
    patience: int = 10
    gradient_clip_val: float = 0.0
    max_epochs: int = 1000
    min_steps: int = 0
    max_steps: int = 0


class TrainerState(PyTreeNode):
    params: Any
    opt_state: Any
    global_step: Array  # int32 optimizer steps taken (across retrains)


def tbtt_reencode_mask(t_total: int, tbtt: int) -> np.ndarray:
    """Self-forcing steps at TBPTT chunk boundaries (training.py:71-75)."""
    idx = np.arange(t_total)
    return (idx >= tbtt) & (idx % tbtt == 0)


def _check_windows(fill: np.ndarray, train_np: np.ndarray, val_np: np.ndarray,
                   length: int) -> None:
    """Guard the degenerate zero-weight sampling case: with no row holding a
    length-``length`` window, ``R.sample_windows`` would silently draw
    uniform rows and train/validate on all-zero gathers."""
    for name, mask in (("train", train_np), ("val", val_np)):
        if int(np.sum(np.maximum(fill[mask] - length + 1, 0))) == 0:
            raise ValueError(
                f"no length-{length} windows available in the {name} split "
                f"(fill={fill[mask].tolist()}); replay too small or split "
                "empty"
            )


class SurrogateTrainer:
    def __init__(
        self,
        module: PDESurrogate,
        loss_fn: Callable,
        config: TrainConfig,
    ):
        assert config.tbtt > config.tau, (
            "Chunk size of TBPTT must be larger than warm-up length."
        )
        self.module = module
        self.loss_fn = loss_fn
        self.config = config
        tx = [optax.scale_by_adam()]
        if config.gradient_clip_val:
            tx = [optax.clip_by_global_norm(config.gradient_clip_val)] + tx
        self.opt = optax.chain(*tx)
        self.mode = "delta" if module.mode == AUTOREG else "decoded"
        self.mesh = None  # optional Mesh: fit_ensemble shards the member
        # axis (stacked params + per-member PRNG keys) over ``model``
        # Fuse each fit_ensemble epoch (all train batches + the val step)
        # into ONE jitted program (lax.fori_loop with a *dynamic* trip count,
        # so the growing per-epoch batch count never recompiles).  Same PRNG
        # split sequence as the per-batch dispatch loop -> bit-identical
        # training; equivalence-tested in tests/test_trainer.py.
        self.fuse_epoch = True
        # Fuse the ENTIRE early-stopped fit (all epochs) into one program
        # when the curriculum is iteration-typed (window length constant
        # within a fit): a lax.while_loop over fused epochs carrying the
        # per-member best/wait/stopped early-stopping counters ON DEVICE.
        # This removes the per-epoch blocking device_get of val_loss that
        # the reference delegates to a Lightning EarlyStopping callback
        # (mbrl.py:351-354) and that costs ~2000 synchronous device->host
        # round trips per 50k-step run (t_fit_val).
        # Same PRNG split sequence and update order as the per-epoch host
        # loop; the early-stopping decision trajectory replays exactly,
        # while params/losses agree to rounding level only (XLA compiles
        # the identical epoch body 1-2 ulp differently inside a while_loop
        # context — measured 3e-8 after ONE epoch on bit-identical inputs).
        # Equivalence-tested in tests/test_trainer.py.
        self.fuse_fit = True
        self._train_jit = {}
        self._val_jit = {}

    def _member_keys(self, key: Array, m: int) -> Array:
        keys = jax.random.split(key, m)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from pdecontrol_tpu.parallel.mesh import MODEL_AXIS

            keys = jax.device_put(keys, NamedSharding(self.mesh, P(MODEL_AXIS)))
        return keys

    # ------------------------------------------------------------------ init
    def init(self, key: Array, example_states: Array, example_actions: Array,
             params: Any = None) -> TrainerState:
        if params is None:
            params = self.module.init(key, example_states, example_actions)["params"]
        return TrainerState(
            params=params,
            opt_state=self.opt.init(params),
            global_step=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------- core math
    def _losses(self, params, states, actions, und: Normalize):
        """Elementwise training loss tensor [B, T-1, C, H]."""
        cfg = self.config
        mask = tbtt_reencode_mask(actions.shape[1], cfg.tbtt)
        roll = self.module.apply(
            {"params": params},
            states[:, : cfg.tau],
            actions,
            dscaling=und.inv,
            reencode=mask,
        )
        if self.mode == "delta":
            out = roll.deltas[:, :-1]
            target = und.apply(jnp.diff(states, axis=1) / self.module.delta)
            elems = self.loss_fn(out, target)
        else:
            decoded = jnp.concatenate([states[:, :1], roll.outputs[:, :-1]], axis=1)
            elems = self.loss_fn(decoded, states)
        return elems, roll

    def train_step(
        self,
        state: TrainerState,
        states: Array,
        actions: Array,
        und: Normalize,
        lr: Array,
    ) -> Tuple[TrainerState, Dict[str, Array]]:
        def loss_fn(params):
            elems, roll = self._losses(params, states, actions, und)
            return jnp.mean(elems), (elems, roll)

        (loss, (elems, roll)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = self.opt.update(grads, state.opt_state, state.params)
        updates = jax.tree.map(lambda u: -lr * u, updates)
        params = optax.apply_updates(state.params, updates)
        metrics = {
            "train_loss": loss,
            "hstep_loss": jnp.mean(elems, axis=(0, 2, 3)),
            "mean_delta_output": jnp.mean(roll.deltas),
            "std_delta_output": jnp.std(roll.deltas),
        }
        return (
            state.replace(params=params, opt_state=opt_state,
                          global_step=state.global_step + 1),
            metrics,
        )

    def val_step(
        self, params, states, actions, und: Normalize, stransf: SampleTransform
    ) -> Dict[str, Array]:
        cfg = self.config
        roll = self.module.apply(
            {"params": params}, states[:, : cfg.tau], actions, dscaling=und.inv
        )
        decoded = jnp.concatenate([states[:, :1], roll.outputs[:, :-1]], axis=1)

        outdeltas = roll.deltas[:, :-1]
        target = und.apply(jnp.diff(states, axis=1) / self.module.delta)
        delta_loss = jnp.mean(self.loss_fn(outdeltas, target))
        scaled_loss = jnp.mean(self.loss_fn(decoded, states))

        # Unscale before the early-stopping metric (training.py:157-164).
        states_u = stransf.otransf.inverse(states)
        decoded_u = stransf.otransf.inverse(decoded)
        elems = self.loss_fn(decoded_u, states_u)
        return {
            "val_loss": jnp.mean(elems),
            "val_hstep_loss": jnp.mean(elems, axis=(0, 2, 3)),
            "val_delta_loss": delta_loss,
            "val_scaled_loss": scaled_loss,
        }

    # ------------------------------------------------- jitted epoch plumbing
    def _train_batch_fn(self, length: int):
        cfg = self.config
        key_ = (length, cfg.tau, cfg.tbtt, cfg.batch_size)
        if key_ not in self._train_jit:

            @jax.jit
            def run(state, replay, rows_mask, und, stransf, lr, key):
                batch = R.sample_windows(
                    replay, key, cfg.batch_size, length, rows_mask
                )
                batch = stransf(batch)
                return self.train_step(state, batch.obs, batch.actions, und, lr)

            self._train_jit[key_] = run
        return self._train_jit[key_]

    def _val_batch_fn(self, length: int):
        cfg = self.config
        key_ = (length, cfg.tau, cfg.batch_size)
        if key_ not in self._val_jit:

            @jax.jit
            def run(params, replay, rows_mask, und, stransf, key):
                batch = R.sample_windows(
                    replay, key, cfg.batch_size, length, rows_mask
                )
                batch = stransf(batch)
                return self.val_step(params, batch.obs, batch.actions, und, stransf)

            self._val_jit[key_] = run
        return self._val_jit[key_]

    def _epoch_fn(self, length: int):
        """Single-member analogue of ``_ensemble_epoch_fn``: one jitted
        program per epoch (``nb`` train batches via a dynamic-trip-count
        fori_loop + the val batch), bit-identical to the dispatch loop."""
        cfg = self.config
        key_ = ("epoch", length, cfg.tau, cfg.tbtt, cfg.batch_size)
        if key_ not in self._train_jit:

            @jax.jit
            def epoch(state, replay, train_mask, val_mask, und, stransf, lr,
                      key, nb):
                def body(_, carry):
                    state, key, _ = carry
                    key, kb = jax.random.split(key)
                    batch = R.sample_windows(
                        replay, kb, cfg.batch_size, length, train_mask
                    )
                    batch = stransf(batch)
                    state, tm = self.train_step(
                        state, batch.obs, batch.actions, und, lr
                    )
                    return state, key, tm["train_loss"]

                init = (state, key, jnp.full((), jnp.nan, jnp.float32))
                state, key, train_loss = jax.lax.fori_loop(0, nb, body, init)
                key, kv = jax.random.split(key)
                batch = R.sample_windows(
                    replay, kv, cfg.batch_size, length, val_mask
                )
                batch = stransf(batch)
                vm = self.val_step(
                    state.params, batch.obs, batch.actions, und, stransf
                )
                return state, key, train_loss, vm

            self._train_jit[key_] = epoch
        return self._train_jit[key_]

    # ------------------------------------------------------------------- fit
    def fit(
        self,
        state: TrainerState,
        replay: R.ReplayState,
        train_mask: Array,
        val_mask: Array,
        und: Normalize,
        stransf: SampleTransform,
        curriculum,
        iteration: int,
        key: Array,
        min_steps: Optional[int] = None,
        max_steps: Optional[int] = None,
        patience: Optional[int] = None,
        max_epochs: Optional[int] = None,
        host_hints: Optional[Dict] = None,
    ) -> Tuple[TrainerState, float, Dict[str, float]]:
        """Host-side fit loop (one ensemble member).  Returns the final
        state, the last 'Val. Loss' (the elite score, mbrl.py:595), and logs.

        ``host_hints`` may carry host copies of values the fit otherwise has
        to pull from the device (``fill``, ``train_np``, ``val_np``,
        ``start_step``).  The controller already holds all four when it
        calls us (it built the split masks host-side); re-pulling them here
        costs 3-4 blocking host round trips per retrain.
        """
        cfg = self.config
        min_steps = cfg.min_steps if min_steps is None else min_steps
        max_steps = cfg.max_steps if max_steps is None else max_steps
        patience = cfg.patience if patience is None else patience
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        hints = host_hints or {}
        # Hints are trusted copies of device values; a caller passing stale
        # or mismatched arrays would silently desynchronise the host
        # window-count logic from the device-side gathers —
        # shape checks catch the cheap-to-catch class of that bug.
        for hk, dev in (("fill", replay.fill), ("train_np", train_mask),
                        ("val_np", val_mask)):
            if hk in hints and np.shape(hints[hk]) != dev.shape:
                raise ValueError(
                    f"host_hints[{hk!r}] shape {np.shape(hints[hk])} != "
                    f"device shape {dev.shape}"
                )

        fill = (np.asarray(hints["fill"]) if "fill" in hints
                else np.asarray(jax.device_get(replay.fill)))
        train_np = (np.asarray(hints["train_np"]).astype(bool)
                    if "train_np" in hints
                    else np.asarray(jax.device_get(train_mask)).astype(bool))
        val_np = (np.asarray(hints["val_np"]).astype(bool)
                  if "val_np" in hints
                  else np.asarray(jax.device_get(val_mask)).astype(bool))

        start_step = (int(hints["start_step"]) if "start_step" in hints
                      else int(jax.device_get(state.global_step)))
        best, wait = math.inf, 0
        val_loss = math.nan
        logs: Dict[str, float] = {}
        epoch = 0
        stop = False
        steps_taken = 0  # host-side mirror of global_step (avoids per-batch
        # device syncs; the array counter remains authoritative in the state)

        while not stop and epoch < max_epochs:
            k = int(curriculum(iteration=iteration, epoch=epoch,
                               step=start_step + steps_taken))
            length = cfg.tau + k
            lr = cfg.lr * (cfg.lr_gamma ** (epoch // cfg.step_size))
            _check_windows(fill, train_np, val_np, length)

            # Epoch size = non-overlapping window count over train episodes
            # (SubSeqDataset default stride == length, dataset.py:54-58).
            nwin = int(np.sum(np.maximum((fill[train_np] - length) // length + 1, 0)))
            nb = max(nwin // cfg.batch_size, 1)

            if self.fuse_epoch:
                nb_eff = nb
                if max_steps:
                    nb_eff = max(0, min(nb, max_steps - steps_taken))
                state, key, tl, vm = self._epoch_fn(length)(
                    state, replay, train_mask, val_mask, und, stransf,
                    jnp.asarray(lr), key, jnp.asarray(nb_eff),
                )
                steps_taken += nb_eff
                if max_steps and nb_eff < nb:
                    stop = True
                train_loss = float(jax.device_get(tl))
            else:
                run = self._train_batch_fn(length)
                for b in range(nb):
                    if max_steps and steps_taken >= max_steps:
                        stop = True
                        break
                    key, kb = jax.random.split(key)
                    state, tm = run(state, replay, train_mask, und, stransf,
                                    jnp.asarray(lr), kb)
                    steps_taken += 1
                train_loss = float(jax.device_get(tm["train_loss"]))

                key, kv = jax.random.split(key)
                vm = self._val_batch_fn(length)(
                    state.params, replay, val_mask, und, stransf, kv
                )
            val_loss = float(jax.device_get(vm["val_loss"]))
            logs = {
                "train_loss": train_loss,
                "val_loss": val_loss,
                "val_delta_loss": float(jax.device_get(vm["val_delta_loss"])),
                "epochs": epoch + 1,
                "curriculum_K": k,
                "lr": lr,
            }

            # Lightning-style EarlyStopping on "Val. Loss" (mbrl.py:351-354),
            # gated by the min-steps window (mbrl.py:379-380).
            if val_loss < best:
                best, wait = val_loss, 0
            else:
                wait += 1
                if wait >= patience and steps_taken >= min_steps:
                    stop = True
            if max_steps and steps_taken >= max_steps:
                stop = True
            epoch += 1

        logs["steps"] = steps_taken
        return state, val_loss, logs

    # ------------------------------------------------- vmapped ensemble fit
    def _member_fns(self, length: int):
        """Unjitted vmapped (train, val) member functions for one window
        length (shard_map-wrapped over ``model`` when a mesh is set)."""
        key_ = ("memfns", length, self.config.tau, self.config.tbtt,
                self.config.batch_size, self.mesh is not None)
        if key_ not in self._train_jit:
            cfg = self.config

            def one_train(state, replay, rows_mask, und, stransf, lr, key,
                          active):
                batch = R.sample_windows(replay, key, cfg.batch_size, length,
                                         rows_mask)
                batch = stransf(batch)
                new_state, metrics = self.train_step(
                    state, batch.obs, batch.actions, und, lr
                )
                # Early-stopped members freeze: keep the old state.
                merged = jax.tree.map(
                    lambda n, o: jnp.where(active, n, o), new_state, state
                )
                return merged, metrics

            def one_val(params, replay, rows_mask, und, stransf, key):
                batch = R.sample_windows(replay, key, cfg.batch_size, length,
                                         rows_mask)
                batch = stransf(batch)
                return self.val_step(params, batch.obs, batch.actions, und,
                                     stransf)

            vtrain = jax.vmap(
                one_train, in_axes=(0, None, None, None, None, None, 0, 0)
            )
            vval = jax.vmap(one_val, in_axes=(0, None, None, None, None, 0))
            if self.mesh is not None:
                # Ensemble parallelism over the ``model`` axis via shard_map:
                # each device trains its local members with plain (local)
                # convolutions and no collectives — member training is
                # embarrassingly parallel.  NOT plain GSPMD sharding of the
                # stacked member axis: partitioning the member-grouped
                # convolutions that vmap emits miscompiles (verified: O(1)
                # deterministic numeric divergence on the CPU backend), while
                # shard_map keeps every conv unpartitioned.
                from jax.sharding import PartitionSpec as P

                from pdecontrol_tpu.parallel.mesh import MODEL_AXIS

                m, r = P(MODEL_AXIS), P()
                vtrain = jax.shard_map(
                    vtrain, mesh=self.mesh,
                    in_specs=(m, r, r, r, r, r, m, m),
                    out_specs=(m, m), check_vma=False,
                )
                vval = jax.shard_map(
                    vval, mesh=self.mesh,
                    in_specs=(m, r, r, r, r, m),
                    out_specs=m, check_vma=False,
                )
            self._train_jit[key_] = (vtrain, vval)
        return self._train_jit[key_]

    def _ensemble_batch_fns(self, length: int):
        key_ = ("ens", length, self.config.tau, self.config.tbtt,
                self.config.batch_size, self.mesh is not None)
        if key_ not in self._train_jit:
            vtrain, vval = self._member_fns(length)
            self._train_jit[key_] = (jax.jit(vtrain), jax.jit(vval))
        return self._train_jit[key_]

    def _ensemble_epoch_fn(self, length: int, m: int):
        """One fused fit_ensemble epoch: ``nb`` train batches (dynamic trip
        count — no recompile as the replay grows) followed by the epoch's
        validation batch, all in a single jitted program.  Replays the exact
        PRNG split sequence of the per-batch dispatch loop, so the result is
        bit-identical to ``fuse_epoch=False``; the fusion removes the
        per-batch host dispatch gaps that dominated retrain wall time."""
        key_ = ("ens_epoch", length, m, self.config.tau, self.config.tbtt,
                self.config.batch_size, self.mesh is not None)
        if key_ not in self._train_jit:
            vtrain, vval = self._member_fns(length)

            @jax.jit
            def epoch(stacked, replay, train_mask, val_mask, und, stransf,
                      lr, key, active, nb):
                def body(_, carry):
                    stacked, key, _ = carry
                    key, kb = jax.random.split(key)
                    member_keys = jax.random.split(kb, m)
                    stacked, tm = vtrain(stacked, replay, train_mask, und,
                                         stransf, lr, member_keys, active)
                    return stacked, key, jnp.mean(tm["train_loss"])

                init = (stacked, key, jnp.full((), jnp.nan, jnp.float32))
                stacked, key, train_loss = jax.lax.fori_loop(
                    0, nb, body, init
                )
                key, kv = jax.random.split(key)
                vm = vval(stacked.params, replay, val_mask, und, stransf,
                          jax.random.split(kv, m))
                return stacked, key, train_loss, vm

            self._train_jit[key_] = epoch
        return self._train_jit[key_]

    def _ensemble_fit_fn(self, length: int, m: int):
        """The WHOLE early-stopped ensemble fit as one jitted program: a
        ``lax.while_loop`` over fused epochs whose carry holds the
        per-member early-stopping state (best/wait/stopped/steps) on
        device.  Exactly replays the host loop's PRNG split sequence and
        bookkeeping order — the early-stopping decision trajectory is
        identical, params/losses match to rounding level (1-2 ulp: XLA
        compiles the same epoch body slightly differently inside the
        while_loop) — and the only host sync left is ONE device_get of the
        final (val_losses, train_loss, steps, epochs) after the fit.

        Requires a constant window length across epochs — ``fit_ensemble``
        only routes here for iteration-typed curricula.  ``nb``, the lr
        ladder, patience/min/max_steps/max_epochs are all traced, so replay
        growth and the initial/iterations trainer phases never recompile
        (the lr ladder's length pins ``max_epochs`` per executable)."""
        key_ = ("ens_fit", length, m, self.config.tau, self.config.tbtt,
                self.config.batch_size, self.mesh is not None)
        if key_ not in self._train_jit:
            vtrain, vval = self._member_fns(length)

            @jax.jit
            def fused_fit(stacked, replay, train_mask, val_mask, und,
                          stransf, key, nb, lrs, patience, min_steps,
                          max_steps, best, wait, stopped, steps, vls,
                          last_tl):
                has_max = max_steps > 0
                max_epochs = lrs.shape[0]

                def cond(carry):
                    stopped, epoch = carry[4], carry[6]
                    return jnp.logical_and(~jnp.all(stopped),
                                           epoch < max_epochs)

                def body(carry):
                    (stacked, key, best, wait, stopped, steps, epoch, vls,
                     last_tl) = carry
                    lr = lrs[epoch]
                    nb_eff = jnp.where(
                        has_max,
                        jnp.clip(max_steps - jnp.max(steps), 0, nb), nb
                    )
                    active = ~stopped

                    def bstep(_, c):
                        stacked, key, _ = c
                        key, kb = jax.random.split(key)
                        member_keys = jax.random.split(kb, m)
                        stacked, tm = vtrain(stacked, replay, train_mask,
                                             und, stransf, lr, member_keys,
                                             active)
                        return stacked, key, jnp.mean(tm["train_loss"])

                    init = (stacked, key,
                            jnp.full((), jnp.nan, jnp.float32))
                    stacked, key, tl = jax.lax.fori_loop(0, nb_eff, bstep,
                                                         init)
                    key, kv = jax.random.split(key)
                    vm = vval(stacked.params, replay, val_mask, und,
                              stransf, jax.random.split(kv, m))
                    vl = vm["val_loss"]

                    # Host-loop bookkeeping, same order (fit_ensemble).
                    steps = jnp.where(stopped, steps, steps + nb_eff)
                    stopped = stopped | (has_max & (nb_eff < nb))
                    last_tl = jnp.where(nb_eff > 0, tl, last_tl)
                    vls = jnp.where(stopped, vls, vl)
                    improved = vl < best
                    wait = jnp.where(stopped | improved,
                                     jnp.where(improved, 0, wait), wait + 1)
                    best = jnp.minimum(best, jnp.where(stopped, best, vl))
                    newly = ((~stopped) & (wait >= patience)
                             & (steps >= min_steps))
                    stopped = stopped | newly
                    stopped = stopped | (has_max
                                         & (jnp.max(steps) >= max_steps))
                    return (stacked, key, best, wait, stopped, steps,
                            epoch + 1, vls, last_tl)

                carry = (stacked, key, best, wait, stopped, steps,
                         jnp.zeros((), jnp.int32), vls, last_tl)
                carry = jax.lax.while_loop(cond, body, carry)
                (stacked, _, _, _, _, steps, epoch, vls, last_tl) = carry
                return stacked, vls, last_tl, steps, epoch

            self._train_jit[key_] = fused_fit
        return self._train_jit[key_]

    def fit_ensemble(
        self,
        states,  # list[TrainerState] or stacked TrainerState (leading M axis)
        replay: R.ReplayState,
        train_mask: Array,
        val_mask: Array,
        und: Normalize,
        stransf: SampleTransform,
        curriculum,
        iteration: int,
        key: Array,
        min_steps: Optional[int] = None,
        max_steps: Optional[int] = None,
        patience: Optional[int] = None,
        max_epochs: Optional[int] = None,
        host_hints: Optional[Dict] = None,
    ):
        """Train ALL ensemble members in lock-step with per-member early
        stopping masks — the vmapped re-design of the reference's sequential
        per-member ``trainer.fit`` loop (mbrl.py:408).  Each member draws its
        own batches (independent PRNG streams, the bootstrap-resampling
        analogue); a member that trips early stopping freezes while the rest
        continue, preserving per-member stopping semantics.

        ``host_hints`` — see :meth:`fit`; skips up to four blocking
        device->host round trips when the caller already holds the values.

        Returns (stacked TrainerState, per-member val losses, logs).
        """
        cfg = self.config
        min_steps = cfg.min_steps if min_steps is None else min_steps
        max_steps = cfg.max_steps if max_steps is None else max_steps
        patience = cfg.patience if patience is None else patience
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        hints = host_hints or {}

        t_prep0 = time.perf_counter()
        if isinstance(states, list):
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        else:
            stacked = states
        m = int(jax.tree.leaves(stacked.params)[0].shape[0])

        fill = (np.asarray(hints["fill"]) if "fill" in hints
                else np.asarray(jax.device_get(replay.fill)))
        train_np = (np.asarray(hints["train_np"]).astype(bool)
                    if "train_np" in hints
                    else np.asarray(jax.device_get(train_mask)).astype(bool))
        val_np = (np.asarray(hints["val_np"]).astype(bool)
                  if "val_np" in hints
                  else np.asarray(jax.device_get(val_mask)).astype(bool))
        # Cumulative step basis so a steptype='step' curriculum advances
        # across retrains (matches fit's start_step + steps_taken).
        start_step = (
            int(hints["start_step"]) if "start_step" in hints
            else int(np.max(np.asarray(jax.device_get(stacked.global_step))))
        )

        # Whole-fit fusion: iteration-typed curricula hold the window length
        # constant within a fit, so every epoch runs the same program and
        # the early-stopping loop itself can live on device (one
        # lax.while_loop, one final pull).  Epoch/step-typed curricula grow
        # the window per epoch (new shapes) and keep the host loop below.
        if (self.fuse_epoch and self.fuse_fit and max_epochs > 0
                and getattr(curriculum, "steptype", None) == "iteration"):
            k = int(curriculum(iteration=iteration, epoch=0, step=start_step))
            length = cfg.tau + k
            _check_windows(fill, train_np, val_np, length)
            nwin = int(np.sum(
                np.maximum((fill[train_np] - length) // length + 1, 0)
            ))
            nb = max(nwin // cfg.batch_size, 1)
            # The lr ladder, precomputed on host so the fused fit's per-epoch
            # lr is bit-identical to the host loop's ``jnp.asarray(lr)``.
            lrs = jnp.asarray([
                cfg.lr * (cfg.lr_gamma ** (e // cfg.step_size))
                for e in range(max_epochs)
            ])
            # Probe the val-loss dtype (f32 on device, f64 under x64 tests) so
            # the best/val_losses carries match the host loop's precision;
            # cached — the abstract trace of vval is not free.
            vdt_key = ("vdt", length, m, self.mesh is not None)
            if vdt_key not in self._train_jit:
                _, vval = self._member_fns(length)
                abs_ = lambda t: jax.tree.map(  # noqa: E731
                    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
                    if hasattr(x, "shape") else x, t)
                self._train_jit[vdt_key] = jax.eval_shape(
                    vval, abs_(stacked.params), abs_(replay),
                    abs_(train_mask), abs_(und), abs_(stransf),
                    abs_(jax.random.split(key, m)),
                )["val_loss"].dtype
            vdt = self._train_jit[vdt_key]
            t_prep = time.perf_counter() - t_prep0
            t0 = time.perf_counter()
            stacked, vls, tl, steps, epochs_run = self._ensemble_fit_fn(
                length, m
            )(
                stacked, replay, train_mask, val_mask, und, stransf, key,
                jnp.asarray(nb, jnp.int32), lrs,
                jnp.asarray(patience, jnp.int32),
                jnp.asarray(min_steps, jnp.int32),
                jnp.asarray(max_steps, jnp.int32),
                jnp.full((m,), jnp.inf, vdt),
                jnp.zeros((m,), jnp.int32),
                jnp.zeros((m,), bool),
                jnp.zeros((m,), jnp.int32),
                jnp.full((m,), jnp.nan, vdt),
                jnp.full((), jnp.nan, jnp.float32),
            )
            t_dispatch = time.perf_counter() - t0
            t0 = time.perf_counter()
            val_losses, last_tl, steps_np, nep = jax.device_get(
                (vls, tl, steps, epochs_run)
            )
            t_ready = time.perf_counter() - t0
            nep = int(nep)
            logs = {
                "train_loss": float(last_tl),
                "val_loss": float(np.mean(val_losses)),
                "epochs": nep,
                "curriculum_K": k,
                "lr": float(cfg.lr * (cfg.lr_gamma
                                      ** (max(nep - 1, 0) // cfg.step_size))),
                "steps": int(np.max(steps_np)),
                "t_fit_prep": round(t_prep, 4),
                "t_fit_dispatch": round(t_dispatch, 4),
                # One blocking pull for the whole fit: device execution time
                # surfaces here (the per-epoch t_fit_val syncs are gone).
                "t_fit_ready": round(t_ready, 4),
            }
            return stacked, np.asarray(val_losses), logs

        best = np.full(m, np.inf)
        wait = np.zeros(m, int)
        stopped = np.zeros(m, bool)
        val_losses = np.full(m, np.nan)
        steps_taken = np.zeros(m, int)
        epoch = 0
        last_tl: Optional[float] = float("nan")
        logs: Dict[str, float] = {}
        # Wall-time breakdown of the retrain (logged per retrain row):
        # prep = host pulls of fill/masks/step, dispatch = the async train
        # step dispatch loop, val = per-epoch validation incl. its blocking
        # device_get (where device compute time surfaces on the host clock).
        t_prep = time.perf_counter() - t_prep0
        t_dispatch_acc = 0.0
        t_val_acc = 0.0

        while not stopped.all() and epoch < max_epochs:
            k = int(curriculum(iteration=iteration, epoch=epoch,
                               step=start_step + int(steps_taken.max())))
            length = cfg.tau + k
            lr = cfg.lr * (cfg.lr_gamma ** (epoch // cfg.step_size))
            _check_windows(fill, train_np, val_np, length)
            nwin = int(np.sum(np.maximum((fill[train_np] - length) // length + 1, 0)))
            nb = max(nwin // cfg.batch_size, 1)

            if self.fuse_epoch:
                # Whole epoch (nb train batches + val) in one jitted program;
                # the trip count is a traced scalar so replay growth between
                # retrains never recompiles.
                epoch_fn = self._ensemble_epoch_fn(length, m)
                nb_eff = nb
                if max_steps:
                    nb_eff = max(0, min(nb, max_steps - int(steps_taken.max())))
                t0 = time.perf_counter()
                stacked, key, tl, vm = epoch_fn(
                    stacked, replay, train_mask, val_mask, und, stransf,
                    jnp.asarray(lr), key, jnp.asarray(~stopped),
                    jnp.asarray(nb_eff),
                )
                steps_taken[~stopped] += nb_eff
                if max_steps and nb_eff < nb:
                    stopped[:] = True
                t_dispatch_acc += time.perf_counter() - t0
                t0 = time.perf_counter()
                vl = np.asarray(jax.device_get(vm["val_loss"]))
                if nb_eff > 0:
                    last_tl = float(jax.device_get(tl))
                t_val_acc += time.perf_counter() - t0
            else:
                train, val = self._ensemble_batch_fns(length)
                active = jnp.asarray(~stopped)
                t0 = time.perf_counter()
                for b in range(nb):
                    if max_steps and steps_taken.max() >= max_steps:
                        stopped[:] = True
                        break
                    key, kb = jax.random.split(key)
                    member_keys = self._member_keys(kb, m)
                    stacked, tm = train(stacked, replay, train_mask, und,
                                        stransf, jnp.asarray(lr), member_keys,
                                        active)
                    steps_taken[~stopped] += 1
                    last_tl = None  # pulled lazily at logs time below
                t_dispatch_acc += time.perf_counter() - t0

                t0 = time.perf_counter()
                key, kv = jax.random.split(key)
                vm = val(stacked.params, replay, val_mask, und, stransf,
                         self._member_keys(kv, m))
                vl = np.asarray(jax.device_get(vm["val_loss"]))
                t_val_acc += time.perf_counter() - t0
                if last_tl is None:
                    last_tl = float(jnp.mean(tm["train_loss"]))
            val_losses = np.where(stopped, val_losses, vl)

            improved = vl < best
            wait = np.where(stopped | improved, np.where(improved, 0, wait),
                            wait + 1)
            best = np.minimum(best, np.where(stopped, best, vl))
            newly = (~stopped) & (wait >= patience) & (steps_taken >= min_steps)
            stopped |= newly
            if max_steps and steps_taken.max() >= max_steps:
                stopped[:] = True
            epoch += 1
            logs = {
                "train_loss": last_tl,
                "val_loss": float(np.mean(val_losses)),
                "epochs": epoch,
                "curriculum_K": k,
                "lr": lr,
            }

        logs["steps"] = int(steps_taken.max())
        logs["t_fit_prep"] = round(t_prep, 4)
        logs["t_fit_dispatch"] = round(t_dispatch_acc, 4)
        logs["t_fit_val"] = round(t_val_acc, 4)
        return stacked, val_losses, logs
