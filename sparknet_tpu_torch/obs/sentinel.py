"""Capture sentinel: count CUDA graph captures per process and per thread.

Counterpart of ``sparknet_tpu/obs/sentinel.py``.  The JAX sentinel counts
XLA backend compilations through jax's monitoring hooks, so a live run
can flag a program that compiled again.  On the card the counterpart of
a compiled program is a captured CUDA graph (``serve/graphs.py``: one per
serving bucket), and an eager step compiles nothing, so this sentinel
counts captures: ``BucketProgram`` calls :meth:`RecompileSentinel.note_capture`
once per graph it records, on the thread that recorded it.  A ``round``
record's ``compiles`` and a ``recompile`` event's ``count`` are these
captures.

Per-thread attribution is the serving loop's proof obligation
(``sparknet_tpu_torch/loop``): a rollout captures a candidate's bucket
graphs on its BUILDER thread while the serving thread's own count must not
move.  A process-wide total cannot tell those apart; :meth:`thread_count`
can, and the engine's ``serve_path_compiles`` is the delta of the serving
thread's count across each graph replay.

Nothing here touches torch.  Captures are counted by their maker, not
through a monitoring hook as JAX's are, so there is nothing to install
(no ``install``/``available``) and the count is kept whether or not a
journal is armed (the engine's gate reads it either way), at the cost of
one lock and one dict update a capture.
"""

from __future__ import annotations

import threading

__all__ = ["RecompileSentinel", "get_sentinel"]


class RecompileSentinel:
    """Process-wide CUDA-graph capture counter, total and per thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._by_thread: dict[int, int] = {}

    def note_capture(self) -> None:
        """One graph captured on the calling thread."""
        tid = threading.get_ident()
        with self._lock:
            self._count += 1
            self._by_thread[tid] = self._by_thread.get(tid, 0) + 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def thread_count(self, tid: int | None = None) -> int:
        """Captures made on one thread (default: the calling thread).  A
        serving thread that never captures reads 0 here even while a
        concurrent rollout builder's count climbs."""
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            return self._by_thread.get(tid, 0)


_sentinel: RecompileSentinel | None = None
_sentinel_lock = threading.Lock()


def get_sentinel() -> RecompileSentinel:
    global _sentinel
    with _sentinel_lock:
        if _sentinel is None:
            _sentinel = RecompileSentinel()
        return _sentinel
