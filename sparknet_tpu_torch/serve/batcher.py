"""The request handle of the serving plane.

Counterpart of ``sparknet_tpu/serve/batcher.py``, ``Ticket`` only, with a
plain ``threading.Lock`` in place of the JAX package's chaos-schedulable
lock, and without the batch bookkeeping fields (bucket, batch size,
flush times) that only ``DynamicBatcher`` writes; that batcher is ROADMAP
Queue A7.
"""

from __future__ import annotations

import threading

__all__ = ["Ticket"]


class Ticket:
    """One in-flight request: submit-side handle + result rendezvous.

    The rendezvous Event is created lazily on the first ``wait``: pump-loop
    consumers (the decoders, the router) poll ``done()`` without ever
    blocking on it.
    """

    __slots__ = ("id", "payload", "t_submit", "result", "error", "_done",
                 "_done_flag")

    # guards lazy event creation against a concurrent resolve
    _lock = threading.Lock()

    def __init__(self, rid: int, payload, t_submit: float):
        self.id = rid
        self.payload = payload
        self.t_submit = t_submit
        self.result = None
        self.error: BaseException | None = None
        self._done: threading.Event | None = None
        self._done_flag = False

    def done(self) -> bool:
        return self._done_flag

    def resolve(self, result=None, error: BaseException | None = None):
        # result/error land before the flag store; _event() re-checks the
        # flag under the lock, so the event is set exactly once either way
        self.result = result
        self.error = error
        self._done_flag = True
        ev = self._done
        if ev is not None:
            ev.set()

    def _event(self) -> threading.Event:
        with Ticket._lock:
            if self._done is None:
                self._done = threading.Event()
                if self._done_flag:
                    self._done.set()
            return self._done

    def wait(self, timeout: float | None = None):
        """Block for the result (raises the execution error, if any)."""
        if not self._done_flag and not self._event().wait(timeout):
            raise TimeoutError(f"request {self.id} still pending after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result
