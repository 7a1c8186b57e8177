"""Episodic experience replay living in device memory (HBM).

Re-designs the reference's host-side ragged deque store
(``/root/reference/pdecontrol/mbrl/replay.py``) as dense fixed-shape arrays:
episodes are rows of ``[num_rows, ep_len, ...]`` tensors with a per-row fill
counter, so every operation — the per-iteration write of one vectorised env
step, window sampling for surrogate training, uniform transition sampling
for SAC — is a jitted gather/scatter.  KS episodes are truncation-only and
fixed-length (SURVEY §7 "hard parts"), which makes this layout exact rather
than an approximation; imagined rollouts use a second instance with
``ep_len = max horizon``.

Eviction is a ring over episode rows (FIFO by whole episodes, matching
``replay.resize``'s oldest-episode eviction, replay.py:98-110).

``obs_seq`` holds ``ep_len + 1`` frames per row: frame ``t`` is the obs
before step ``t`` and frame ``t+1`` the obs after it, so ``nxtobs`` is a
shifted view and terminal observations need no special "final_observation"
channel (the reference reconstructs them through StoreNObsVecWrapper +
info dicts, vec_wrappers.py:21-37, worker.py:68-84).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pdecontrol_tpu.data.types import Sample
from pdecontrol_tpu.utils.pytree import PyTreeNode

Array = jax.Array


class ReplayState(PyTreeNode):
    obs_seq: Array  # [E, T+1, C, H]
    actions: Array  # [E, T, Ca, A]
    rewards: Array  # [E, T]
    terminated: Array  # [E, T] bool
    truncated: Array  # [E, T] bool
    steps: Array  # [E, T] int32 (env step counter as reported in infos)
    fill: Array  # [E] int32 — timesteps written in each row
    complete: Array  # [E] bool — episode finished (terminated | truncated)
    row_of_env: Array  # [N] int32 — row each live sub-env writes to
    next_row: Array  # int32 — ring allocation cursor (monotone; row = mod E)
    total_steps: Array  # int32 — total timesteps ever written

    @property
    def num_rows(self) -> int:
        return self.obs_seq.shape[0]

    @property
    def ep_len(self) -> int:
        return self.actions.shape[1]

    @property
    def num_envs(self) -> int:
        return self.row_of_env.shape[0]

    @property
    def ntimesteps(self) -> Array:
        return jnp.sum(self.fill)

    @property
    def ncomplete(self) -> Array:
        return jnp.sum(self.complete.astype(jnp.int32))


def create(
    num_rows: int,
    ep_len: int,
    num_envs: int,
    obs_shape: Tuple[int, int],
    action_shape: Tuple[int, int],
    dtype=jnp.float32,
) -> ReplayState:
    return ReplayState(
        obs_seq=jnp.zeros((num_rows, ep_len + 1) + tuple(obs_shape), dtype),
        actions=jnp.zeros((num_rows, ep_len) + tuple(action_shape), dtype),
        rewards=jnp.zeros((num_rows, ep_len), dtype),
        terminated=jnp.zeros((num_rows, ep_len), bool),
        truncated=jnp.zeros((num_rows, ep_len), bool),
        steps=jnp.zeros((num_rows, ep_len), jnp.int32),
        fill=jnp.zeros((num_rows,), jnp.int32),
        complete=jnp.zeros((num_rows,), bool),
        row_of_env=jnp.arange(num_envs, dtype=jnp.int32),
        next_row=jnp.asarray(num_envs, jnp.int32),
        total_steps=jnp.zeros((), jnp.int32),
    )


def write_step(
    replay: ReplayState,
    obs: Array,  # [N, C, H] obs *before* the step (raw / pre-transform)
    actions: Array,  # [N, Ca, A] raw env-space actions
    rewards: Array,  # [N]
    terminated: Array,  # [N] bool
    truncated: Array,  # [N] bool
    nxtobs: Array,  # [N, C, H] obs *after* the step (terminal obs if done)
    steps: Array,  # [N] int32 step counter from the env info
) -> ReplayState:
    """Record one vectorised env transition; advance rows on episode end.

    The worker stores *raw* (pre-transform) observations/actions
    (reference worker.py:68-84); transforms are applied at sampling time via
    ``SampleTransform``, exactly like ``SubSeqDataset(stransf=...)``.
    """
    rows = replay.row_of_env % replay.num_rows
    cols = replay.fill[rows]

    # Cast at the write boundary: under jax_enable_x64 callers hand float64
    # leaves, and scatter dtype mismatch is a FutureWarning today, an error
    # in a future JAX release.
    obs_seq = replay.obs_seq.at[rows, cols].set(
        obs.astype(replay.obs_seq.dtype)
    )
    obs_seq = obs_seq.at[rows, cols + 1].set(
        nxtobs.astype(replay.obs_seq.dtype)
    )

    done = jnp.logical_or(terminated, truncated)
    replay = replay.replace(
        obs_seq=obs_seq,
        actions=replay.actions.at[rows, cols].set(
            actions.astype(replay.actions.dtype)
        ),
        rewards=replay.rewards.at[rows, cols].set(
            rewards.astype(replay.rewards.dtype)
        ),
        terminated=replay.terminated.at[rows, cols].set(terminated),
        truncated=replay.truncated.at[rows, cols].set(truncated),
        steps=replay.steps.at[rows, cols].set(
            steps.astype(replay.steps.dtype)
        ),
        fill=replay.fill.at[rows].set(cols + 1),
        complete=replay.complete.at[rows].set(done),
        total_steps=replay.total_steps + obs.shape[0],
    )

    # Allocate fresh rows for envs whose episode just ended (ring FIFO).
    offsets = (jnp.cumsum(done.astype(jnp.int32)) - 1).astype(jnp.int32)
    new_rows = (replay.next_row + offsets).astype(jnp.int32)
    row_of_env = jnp.where(done, new_rows, replay.row_of_env).astype(jnp.int32)
    next_row = (
        replay.next_row + jnp.sum(done.astype(jnp.int32))
    ).astype(jnp.int32)

    # Wipe the fill/complete flags of newly claimed (recycled) rows.  Only
    # done envs scatter: not-done envs are routed to an out-of-bounds index
    # and dropped, so they can never collide with a freshly claimed row and
    # resurrect its stale fill/complete (offsets gives them a real row id).
    claimed = jnp.where(done, new_rows % replay.num_rows, replay.num_rows)
    fill = replay.fill.at[claimed].set(0, mode="drop")
    complete = replay.complete.at[claimed].set(False, mode="drop")
    return replay.replace(
        row_of_env=row_of_env, next_row=next_row, fill=fill, complete=complete
    )


def _gather_window(replay: ReplayState, rows: Array, starts: Array, length: int) -> Sample:
    """Gather [B, length, ...] windows; ``starts`` may be negative — indices
    clamp to 0, reproducing the repeat-first-element left padding of
    ``PDEDataLoader.padding_collate`` (dataset.py:190-205)."""
    t_idx = jnp.clip(starts[:, None] + jnp.arange(length)[None, :], 0, None)
    r = rows[:, None]
    return Sample(
        obs=replay.obs_seq[r, t_idx],
        actions=replay.actions[r, t_idx],
        nxtobs=replay.obs_seq[r, t_idx + 1],
        rewards=replay.rewards[r, t_idx],
        terminated=replay.terminated[r, t_idx],
        truncated=replay.truncated[r, t_idx],
        steps=replay.steps[r, t_idx],
    )


def _row_weights(replay: ReplayState, length: int, rows_mask: Array = None) -> Array:
    """Number of stride-1 windows of ``length`` per row (0 if too short)."""
    w = jnp.maximum(replay.fill - length + 1, 0).astype(jnp.float32)
    if rows_mask is not None:
        w = w * rows_mask.astype(jnp.float32)
    return w


def sample_windows(
    replay: ReplayState,
    key: Array,
    batch: int,
    length: int,
    rows_mask: Array = None,
) -> Sample:
    """Bootstrap-sample [B, L, ...] subsequence windows, uniform over all
    stride-1 windows across episodes — the sampling distribution of
    ``SubSeqDataset`` with ``bootstrapping=True`` (dataset.py:59-79).
    ``rows_mask`` restricts to an episode subset (train/val split)."""
    kr, ks = jax.random.split(key)
    weights = _row_weights(replay, length, rows_mask)
    logits = jnp.log(weights + 1e-30)
    rows = jax.random.categorical(kr, logits, shape=(batch,))
    max_start = jnp.maximum(replay.fill[rows] - length, 0)
    u = jax.random.uniform(ks, (batch,))
    starts = jnp.floor(u * (max_start + 1).astype(jnp.float32)).astype(jnp.int32)
    return _gather_window(replay, rows, starts, length)


def enumerate_windows(
    replay: ReplayState,
    length: int,
    stride: int = None,
    rows_mask: Array = None,
) -> Sample:
    """Every strided window, deterministically ordered — the reference's
    non-bootstrap ``SubSeqDataset`` enumeration (dataset.py:54-76; window
    ``i`` of a row starts at ``i * stride``).  ``stride=None`` means
    non-overlapping windows (``stride=length``), the dataset's own default
    (dataset.py:54-55); the offline test battery uses ``stride=tau``
    (datamodule.py:100-108).

    Counts are data-dependent, so enumeration happens host-side (this is a
    data-prep entry point like the torch Dataset, not a jit region); the
    gather itself runs on device.
    """
    import numpy as np

    stride = length if stride is None else stride
    fill = np.asarray(jax.device_get(replay.fill))
    if rows_mask is None:
        mask = np.ones_like(fill, dtype=bool)
    else:
        mask = np.asarray(jax.device_get(rows_mask)).astype(bool)
    rows_l, starts_l = [], []
    for r in np.nonzero(mask)[0]:
        n = max((int(fill[r]) - length) // stride + 1, 0)
        rows_l.extend([r] * n)
        starts_l.extend(i * stride for i in range(n))
    rows = jnp.asarray(np.asarray(rows_l, np.int32))
    starts = jnp.asarray(np.asarray(starts_l, np.int32))
    return _gather_window(replay, rows, starts, length)


def sample_starting(
    replay: ReplayState, key: Array, batch: int, tau: int
) -> Sample:
    """Warmup windows for the world env: length-``tau`` windows anywhere in
    an episode PLUS shorter prefixes at episode starts, left-padded by
    repeating the first frame — the ``StartingStateDataset`` semantics
    (dataset.py:119-160).  Negative starts implement the short prefixes."""
    kr, ks = jax.random.split(key)
    # Rows weighted by number of admissible starts: fill windows + (tau - 1)
    # prefix windows (lengths 1..tau-1), matching the concat dataset sizes.
    w = jnp.maximum(replay.fill - tau + 1, 0) + jnp.minimum(replay.fill, tau - 1)
    logits = jnp.log(w.astype(jnp.float32) + 1e-30)
    rows = jax.random.categorical(kr, logits, shape=(batch,))

    lo = -jnp.minimum(replay.fill[rows], tau - 1)
    hi = jnp.maximum(replay.fill[rows] - tau, 0)
    u = jax.random.uniform(ks, (batch,))
    starts = lo + jnp.floor(u * (hi - lo + 1).astype(jnp.float32)).astype(jnp.int32)
    return _gather_window(replay, rows, starts, tau)


def sample_transitions(replay: ReplayState, key: Array, batch: int) -> Sample:
    """Uniform single transitions across all stored timesteps (the SAC batch
    source; reference SubSeqDataset(length=1) + RandomSampler,
    mbrl.py:531-552)."""
    sample = sample_windows(replay, key, batch, length=1)
    return jax.tree.map(lambda x: jnp.squeeze(x, axis=1), sample)


def episode_returns(replay: ReplayState) -> Tuple[Array, Array]:
    """Mean/std of summed rewards over completed episodes
    (reference ``statistics``, replay.py:112-117)."""
    mask = replay.complete.astype(jnp.float32)
    trange = jnp.arange(replay.ep_len)[None, :] < replay.fill[:, None]
    returns = jnp.sum(replay.rewards * trange, axis=1)
    n = jnp.maximum(jnp.sum(mask), 1.0)
    mean = jnp.sum(returns * mask) / n
    var = jnp.sum(mask * (returns - mean) ** 2) / n
    return mean, jnp.sqrt(var)


def delta_statistics(
    replay: ReplayState, otransf, delta: float
) -> Tuple[Array, Array]:
    """Mean/variance (ddof=1) of per-step obs deltas in transformed space,
    over all valid timesteps — the ``update_delta_transform`` fit
    (mbrl.py:597-602: reset + one Welford update over the whole dataset,
    which equals plain batch statistics)."""
    obs = otransf.apply(replay.obs_seq[:, :-1])
    nxt = otransf.apply(replay.obs_seq[:, 1:])
    deltas = (nxt - obs) / delta
    valid = (jnp.arange(replay.ep_len)[None, :] < replay.fill[:, None]).astype(
        deltas.dtype
    )[..., None, None]
    valid = jnp.broadcast_to(valid, deltas.shape)
    n = jnp.maximum(jnp.sum(valid), 1.0)
    mean = jnp.sum(deltas * valid) / n
    var = jnp.sum(valid * (deltas - mean) ** 2) / jnp.maximum(n - 1.0, 1.0)
    return mean, var
