"""Background renderer for plots and npz artifacts.

The eval block's host-side work — matplotlib rendering, compressed npz
writes, wandb image/table uploads — would otherwise leave the device
idle (visible in the ``t_eval`` field).  None of it feeds back into
training, so it is submitted to ONE worker thread here and overlaps the device execution
of the following iterations: the main thread spends its time blocked in
``device_get``/dispatch waits (GIL released), which is exactly when the
worker can render.

A single worker also serialises all matplotlib use in the training
process (``viz/plots.py`` uses the pyplot API, which is not safe across
concurrent threads).

Jobs are exception-guarded: a failed render prints a warning and never
kills training (same contract as the previous inline try/excepts).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List


class BackgroundRenderer:
    def __init__(self, enabled: bool = True) -> None:
        # enabled=False on non-primary processes of a multi-process run:
        # plots/artifacts are file I/O, which is primary-only
        # (parallel/distributed.py host-boundary rules).
        self.enabled = enabled
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="viz")
        self._pending: List = []

    def submit(self, fn: Callable[[], None]) -> None:
        """Queue a no-arg job; capture loop state (iteration numbers,
        arrays) by value in the closure before submitting."""
        if not self.enabled:
            return

        def guarded() -> None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — must never kill training
                print(f"[viz] background render failed: {e!r}", flush=True)

        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(guarded))

    def drain(self) -> None:
        """Block until every submitted job has finished (jobs swallow their
        own exceptions).  Called before anything that expects the artifact
        files on disk — end of learn(), test assertions."""
        for f in self._pending:
            f.result()
        self._pending.clear()
