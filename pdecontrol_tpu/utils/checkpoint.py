"""Checkpoint / resume subsystem.

The reference can only persist an offline surrogate state_dict
(``evaluate.py:210-214``); its MBRL loop cannot resume (SURVEY §5).  Here the
*entire* training state — ensemble params + optimizer states, SAC state,
running transforms, replay buffers, env/world state, RNG key and host
counters — is one pytree snapshot, so a 50k-step run survives preemption.

Design:

* ``save()`` only captures *references* to the (immutable) jax arrays and
  returns; ONE worker thread performs the batched device->host pull and the
  write, so a save overlaps training instead of stalling it.  The snapshot
  is consistent because the controller rebinds new arrays instead of
  mutating old ones.
* The serializer is a flat **uncompressed npz** written to a temp file and
  atomically renamed: cheap in host CPU, with no per-leaf machinery.
* Restore requires a ``target`` pytree (the freshly constructed controller
  state) — leaves are matched positionally by flatten order, with a
  leaf-count guard.
* Failed background saves re-raise at the next ``save()`` / ``wait()`` —
  checkpoint loss must never be silent.  A crash mid-write leaves only a
  ``.tmp`` file, never a step that ``restore()`` would accept.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import jax
import numpy as np

# Device->host pulls larger than this are sliced into row chunks with a
# pause between them, so one large snapshot transfer does not hold up the
# training loop's own dispatch/result traffic.
_CHUNK_BYTES = 16 << 20
_CHUNK_PAUSE_S = 0.05


def _pull_throttled(x: Any) -> np.ndarray:
    nbytes = getattr(x, "nbytes", 0)
    shape = getattr(x, "shape", ())
    if nbytes <= _CHUNK_BYTES or not shape or shape[0] < 2:
        return np.asarray(jax.device_get(x))
    rows = max(int(shape[0] * _CHUNK_BYTES / nbytes), 1)
    parts = []
    for i in range(0, shape[0], rows):
        parts.append(np.asarray(jax.device_get(x[i : i + rows])))
        time.sleep(_CHUNK_PAUSE_S)
    return np.concatenate(parts, axis=0)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending: List = []

    # ----------------------------------------------------------- internals
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.npz")

    def _steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.endswith(".npz") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[:-4]))
                except ValueError:
                    pass
        return sorted(set(steps))

    def _raise_pending(self, wait: bool) -> None:
        done, live = [], []
        for f in self._pending:
            (done if (wait or f.done()) else live).append(f)
        self._pending = live
        for f in done:
            f.result()  # re-raises a failed save

    def _write(self, step: int, state: Any) -> None:
        flat, _ = jax.tree.flatten(state)
        flat = [_pull_throttled(x) for x in flat]
        # Hidden tmp name ends in .npz (np.savez keeps it verbatim) and is
        # invisible to _steps(), so a crash mid-write never surfaces as a
        # restorable step; os.replace makes publication atomic.
        tmp = os.path.join(self.directory, f".tmp-{step}.npz")
        np.savez(tmp, *flat)
        os.replace(tmp, self._path(step))
        for old in self._steps()[: -self.max_to_keep]:
            p = self._path(old)
            if os.path.exists(p):
                os.remove(p)

    # ----------------------------------------------------------------- api
    def save(self, step: int, state: Any, wait: bool = False) -> None:
        self._raise_pending(wait=False)
        self._pending.append(self._pool.submit(self._write, step, state))
        if wait:
            self.wait()

    def wait(self) -> None:
        """Block until all in-flight saves are durable on disk."""
        self._raise_pending(wait=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        self.wait()  # an in-process save may be in flight
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        flat_t, treedef = jax.tree.flatten(target)
        with np.load(self._path(step)) as z:
            if len(z.files) != len(flat_t):
                raise ValueError(
                    f"checkpoint step {step} holds {len(z.files)} leaves, "
                    f"target expects {len(flat_t)} — incompatible snapshot"
                )
            flat = [z[f"arr_{i}"] for i in range(len(flat_t))]
        return jax.tree.unflatten(treedef, flat)


def replicate_for_snapshot(state: Any) -> Any:
    """Reshard every non-fully-addressable leaf to fully-replicated.

    In a multi-process run the snapshot holds data-sharded arrays (env
    state, replay buffers) whose shards live on OTHER processes' devices;
    ``device_get`` on those raises (found by dryrun stage 6).  The
    fix is a device-side all-gather: one jitted identity with
    replicated ``out_shardings``, dispatched by EVERY process (it is a
    collective), after which the primary's host pull touches only
    addressable data.  Single-process runs: every leaf is fully
    addressable and this is the identity.
    """
    leaves, treedef = jax.tree.flatten(state)
    idx = [
        i for i, x in enumerate(leaves)
        if isinstance(x, jax.Array) and not x.sharding.is_fully_addressable
    ]
    if not idx:
        return state
    from jax.sharding import NamedSharding, PartitionSpec

    rep = tuple(
        NamedSharding(leaves[i].sharding.mesh, PartitionSpec()) for i in idx
    )
    gathered = jax.jit(lambda *xs: xs, out_shardings=rep)(
        *[leaves[i] for i in idx]
    )
    for i, g in zip(idx, gathered):
        leaves[i] = g
    return jax.tree.unflatten(treedef, leaves)


def controller_state(ctl) -> Dict[str, Any]:
    """Snapshot pytree of a PDEModelBasedController."""
    return {
        "ensemble": ctl.ensemble,
        "member_states": list(ctl.member_states),
        "sac_state": ctl.sac_state,
        "transforms": ctl.tr,
        "replay": ctl.replay,
        "world_replay": ctl.world_replay,
        "env_state": ctl.env_state,
        "pool": ctl.pool,
        "key": ctl.key,
        "counters": {
            "iteration": np.asarray(ctl.iteration),
            "num_ensemble_updates": np.asarray(ctl.num_ensemble_updates),
            "num_pol_updates": np.asarray(ctl.num_pol_updates),
        },
    }


def load_controller_state(ctl, state: Dict[str, Any]) -> None:
    """Restore a snapshot into a freshly constructed controller."""
    ctl.ensemble = state["ensemble"]
    ctl.member_states = list(state["member_states"])
    ctl.sac_state = state["sac_state"]
    ctl.tr = state["transforms"]
    ctl.replay = state["replay"]
    ctl.world_replay = state["world_replay"]
    ctl.env_state = state["env_state"]
    ctl.pool = state["pool"]
    ctl.key = state["key"]
    ctl.iteration = int(state["counters"]["iteration"])
    ctl.num_ensemble_updates = int(state["counters"]["num_ensemble_updates"])
    ctl.num_pol_updates = int(state["counters"]["num_pol_updates"])
