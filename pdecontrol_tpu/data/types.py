"""Core data pytrees (reference: ``/root/reference/pdecontrol/mbrl/types.py``).

``Sample`` holds a (possibly batched / time-majored) transition record;
``ModelRollout`` holds surrogate rollout products.  Both are pytrees so
they move through ``jit``/``scan``/``shard_map`` and device placement freely —
the reference's ``totorch``/``tonumpy`` conversions disappear.
"""

from __future__ import annotations

from typing import Any, Optional

import jax

from pdecontrol_tpu.utils.pytree import PyTreeNode

Array = jax.Array


class Sample(PyTreeNode):
    obs: Array = None
    actions: Array = None
    nxtobs: Array = None
    rewards: Array = None
    terminated: Array = None
    truncated: Array = None
    steps: Array = None

    def apply(self, fn) -> "Sample":
        return jax.tree.map(fn, self)

    def __iter__(self):
        return iter(
            (
                self.obs,
                self.actions,
                self.nxtobs,
                self.rewards,
                self.terminated,
                self.truncated,
                self.steps,
            )
        )


class ModelRollout(PyTreeNode):
    """Surrogate rollout products (reference types.py:73-82)."""

    outputs: Array = None  # predicted states [B, T, C, H]
    inlatents: Array = None
    outlatents: Array = None
    deltas: Array = None  # decoded per-step deltas (pre-scaling)
    hidden: Any = None  # transition-model carry


class TrainBatch(PyTreeNode):
    """Fixed-shape windowed training batch with a validity mask along time."""

    sample: Sample = None
    mask: Optional[Array] = None  # [B, T] 1.0 where the window is valid
