"""Wall-clock event log for training drivers.

Equivalent of the reference apps' driver-side log — every step appends
"elapsed: message, i=N" lines to ``training_log_<timestamp>.txt`` (ref:
src/main/scala/apps/CifarApp.scala:36-46 ``log()``).  Copy of
``sparknet_tpu/utils/event_log.py``.
"""

from __future__ import annotations

import os
import time


class EventLogger:
    def __init__(self, directory: str = ".", prefix: str = "training_log", echo: bool = True):
        os.makedirs(directory, exist_ok=True)
        ts = int(time.time())
        self._t0 = time.time()
        self._echo = echo
        # 'x' + nanosecond suffix on collision: two runs in the same second
        # must not truncate each other's logs
        for suffix in (str(ts), f"{ts}_{time.time_ns() % 1_000_000_000}"):
            self.path = os.path.join(directory, f"{prefix}_{suffix}.txt")
            try:
                with open(self.path, "x") as f:
                    f.write(f"start {ts}\n")
                return
            except FileExistsError:
                continue
        raise OSError(f"cannot create unique log file under {directory!r}")

    def log(self, message: str, i: int = -1) -> None:
        elapsed = time.time() - self._t0
        line = f"{elapsed:.3f}: {message}" + (f", i = {i}" if i != -1 else "")
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self._echo:
            print(line, flush=True)

    __call__ = log
