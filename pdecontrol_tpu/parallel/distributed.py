"""Multi-process (multi-host) runtime initialisation.

The reference has no distributed backend at all — its only inter-process
surface is gym's AsyncVectorEnv subprocess pipes (SURVEY §2.5).  The
JAX equivalent for scaling past one host is ``jax.distributed``: one
process per host, each owning its local GPUs, with a coordinator service
for device enumeration and XLA collectives (NCCL between GPUs).  One
process drives every GPU of a host, so a single-host run never needs it.

This module is the single opt-in entry point (``--coordinator_address``
etc. on the MBRL CLI).  Single-process runs never touch it.

Host-boundary rules the rest of the framework follows (validated by
``parallel/dryrun_mp.py``, the 2-process CPU dry run):

  * every process calls the same jitted programs over the same GLOBAL
    mesh (built from ``jax.devices()``, not ``jax.local_devices()``);
  * host-side PRNG state (``controller.key``) is derived from the same
    seed on every process, so traced key arguments stay identical;
  * only fully-REPLICATED outputs may be pulled to the host (metrics
    scalars); pulling a data-sharded array raises on non-addressable
    shards — deliberately loud, never silently local;
  * file I/O (metrics.jsonl, checkpoints, plots, wandb) happens on the
    primary process only (``is_primary``).  Checkpoint RESTORE runs on
    every process (all read the same snapshot; single-host-per-process
    deployments need the run_dir on a shared filesystem).

Known caveat (documented, not yet supported): the MBRL controller's
replay/world buffers are materialised as global arrays addressable from
every process only through jit programs; host-side mutation paths
(e.g. numpy-built split masks) assume the fill metadata is replicated —
true today because ``replay.fill`` is replicated by construction.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
) -> None:
    """Opt-in ``jax.distributed.initialize`` wrapper.

    On the CPU backend (tests / dry runs) cross-process collectives need
    the Gloo implementation — select it before backend init.  On GPUs XLA
    runs its collectives through NCCL and the flag is irrelevant.  The
    multi-process path is tested on the CPU only.
    """
    if jax.config.jax_platforms == "cpu" or local_device_count is not None:
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # older jaxlib: single-implementation build
    kwargs = {}
    if local_device_count is not None:
        # Virtual CPU devices for the multi-process dry run.
        import os
        import re

        flags = os.environ.get("XLA_FLAGS", "")
        flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                       flags)
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={local_device_count}"
        ).strip()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def is_primary() -> bool:
    """True on the process that owns file I/O (metrics, checkpoints,
    plots).  Single-process runs are always primary."""
    return jax.process_index() == 0


def shutdown() -> None:
    try:
        jax.distributed.shutdown()
    except Exception:
        pass
