"""Checkpoint watcher: the serving half's view of the training half.

Counterpart of ``sparknet_tpu/loop/watcher.py``.  A decoupled deployment
(trainer and server in different processes, or a server restarted mid-run)
discovers new checkpoints by POLLING the snapshot directory.  That works
because ``Solver.save`` commits npz archives atomically (a temp file, then
``os.replace`` in the same directory): any file the watcher lists is
complete, so "visible" equals "loadable" and no sidecar or lockfile is
needed.
"""

from __future__ import annotations

import os

__all__ = ["CheckpointWatcher"]


class CheckpointWatcher:
    """Tracks unseen ``*.solverstate.npz`` files in one directory.

    ``poll()`` returns newly-visible checkpoint paths in sorted-name order
    (the loop names snapshots ``round{N:05d}.…``, so sorted order is
    training order) and never returns the same path twice.
    """

    def __init__(self, directory: str, suffix: str = ".solverstate.npz"):
        self.directory = directory
        self.suffix = suffix
        self._seen: set[str] = set()

    def poll(self) -> list[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        fresh = []
        for name in sorted(names):
            if not name.endswith(self.suffix):
                continue
            path = os.path.join(self.directory, name)
            if path not in self._seen:
                self._seen.add(path)
                fresh.append(path)
        return fresh
