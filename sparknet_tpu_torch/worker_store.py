"""Per-process persistent object store.

Counterpart of ``sparknet_tpu/worker_store.py``, the parity surface of
``WorkerStore`` (ref: src/main/scala/libs/WorkerStore.scala:5-25): the
JVM-singleton mutable map each Spark executor kept its CaffeNet and
CaffeLibrary in across the driver's loop iterations.  A process here can
pin its own objects (built nets, data streams, native handles) across
outer-loop closures, keyed the same way.  A ``threading.Lock`` guards it.
"""

from __future__ import annotations

import threading
from typing import Any


class WorkerStore:
    def __init__(self):
        self._store: dict[str, Any] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._store[key] = value

    def get(self, key: str) -> Any:
        """KeyError, the reference's contract: getting a missing key is a
        programming error, not a None."""
        with self._lock:
            return self._store[key]

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def remove(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


# the per-process singleton, as the Scala `object workerStore`
worker_store = WorkerStore()
