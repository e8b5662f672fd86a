"""Request queue and dynamic batcher: coalesce single requests into buckets.

Counterpart of ``sparknet_tpu/serve/batcher.py``, every rule of it, with
plain ``threading`` locks in place of the JAX package's chaos-schedulable
ones.  The batching policy:

* A flush picks the SMALLEST bucket >= the pending count: padding is
  wasted device work, so a trickle of 3 requests rides the 8-bucket,
  never the 256-bucket.
* The queue flushes when it can fill the LARGEST bucket (throughput
  case) or when the OLDEST pending request has waited ``max_wait_ms``
  (the deadline case: tail latency under trickle load is bounded by
  max_wait_ms + one bucket's device time, never by traffic).
* More than one largest-bucket's worth of pending requests drains as
  several batches in one pump: overload parks requests in the queue, not
  in half-full buckets.
* ``close(drain=True)`` hands every in-flight request to the caller as
  final batches: shutdown loses zero requests.
* ``shed()`` is the overload valve: the batcher keeps a drain-rate EWMA
  from its own take() history and REJECTS a submit whose projected queue
  wait (pending / drained rows per second, plus one take period for the
  flush cut) already exceeds ``max_wait_ms`` + one pump tick.  Below one
  largest-bucket quantum nothing is ever shed (one pump visit clears
  it), and before the first drain sample exists pending is capped at two
  quanta.
* ``submit_many()`` admits a whole arrival chunk under one lock with one
  timestamp, applying the same shed rule vectorized: earlier arrivals
  admitted first, the over-deadline tail rejected.
* ``steal()`` / ``adopt()`` move pending tickets between batchers WITHOUT
  resolving or re-stamping them: the router's zero-drop re-route when a
  replica dies (``serve/router.py``).  The same Ticket objects keep their
  original ``t_submit``.

Payloads are opaque to the batcher (the engine owns device work) and the
clock is injectable (``clock=``), so the deadline tests advance time
without sleeping.  The module imports neither torch nor numpy.
"""

from __future__ import annotations

import itertools
import threading
import time

__all__ = ["DynamicBatcher", "Ticket"]


class Ticket:
    """One in-flight request: submit-side handle + result rendezvous.

    The rendezvous Event is created lazily on the first ``wait``: pump-loop
    consumers (the decoders, the routers) poll ``done()`` without ever
    blocking on it.  ``bucket``, ``batch_n``, ``t_batch``, ``t_done`` and
    ``deadline_flush`` are the batch bookkeeping that only the batcher
    (at ``take``) and the engine (at execution) write.
    """

    __slots__ = ("id", "payload", "t_submit", "t_batch", "t_done", "bucket",
                 "batch_n", "deadline_flush", "result", "error", "_done",
                 "_done_flag")

    # guards lazy event creation against a concurrent resolve
    _lock = threading.Lock()

    def __init__(self, rid: int, payload, t_submit: float):
        self.id = rid
        self.payload = payload
        self.t_submit = t_submit
        self.t_batch: float | None = None
        self.t_done: float | None = None
        self.bucket: int | None = None
        self.batch_n: int | None = None
        self.deadline_flush = False
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


class DynamicBatcher:
    """FIFO queue with bucket-quantized, deadline-bounded flushes.

    Thread-safe: ``submit`` may be called from any number of client threads
    while one pump loop (the engine worker, or a test calling :meth:`take`
    directly) drains batches.  Time enters ONLY through the injected
    ``clock``.
    """

    _WIN_S = 0.05  # min sampling window (s): spans several pod sweeps
    _ALPHA_DOWN = 0.5  # sample below the estimate: adopt quickly
    _ALPHA_UP = 0.2    # sample above the estimate: adopt reluctantly

    def __init__(self, buckets=(1, 8, 64, 256), max_wait_ms: float = 5.0,
                 clock=time.monotonic):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_wait_ms = float(max_wait_ms)
        self.clock = clock
        self._q: list[Ticket] = []
        self._ids = itertools.count()
        self._cv = threading.Condition()
        self.closed = False
        self._drains = 0  # hot-swap drains so far: each wakes wait_due
        # drain-rate EWMA (rows/s), sampled over >= _WIN_S windows of take()
        # history during which a backlog persisted throughout: a pod pump
        # drains one replica in a burst of back-to-back takes and then
        # sweeps the others, so per-take intervals would measure the
        # burst's rate, several times this queue's real share.  Smoothing
        # is asymmetric (fast down, slow up), so the shed projection errs
        # toward over-predicting waits.
        self._ewma_rate: float | None = None
        self._ewma_take_ms = 0.0
        self._win_t0: float | None = None
        self._win_rows = 0
        self._win_takes = 0
        self.shed_count = 0
        self.last_projected_ms = 0.0

    # -- submit side -------------------------------------------------------

    def submit(self, payload) -> Ticket:
        """Enqueue one request; returns its Ticket immediately."""
        with self._cv:
            if self.closed:
                raise RuntimeError("batcher is closed")
            t = Ticket(next(self._ids), payload, self.clock())
            self._q.append(t)
            self._cv.notify_all()
            return t

    def _projected_wait_ms_locked(self) -> float:
        if self._ewma_rate is None or self._ewma_rate <= 0.0:
            return 0.0
        return len(self._q) / self._ewma_rate * 1e3 + self._ewma_take_ms

    def projected_wait_ms(self) -> float:
        """Projected queue wait for a request submitted NOW: pending rows
        over the drain-rate EWMA, plus one take period (its own flush must
        be cut too).  0.0 until the first drain sample exists."""
        with self._cv:
            return self._projected_wait_ms_locked()

    def projected_wait_snapshot(self) -> float:
        """Lock-free :meth:`projected_wait_ms` for the router's pick loop:
        a stale read mis-ranks one chunk by one position, it never
        corrupts state."""
        rate = self._ewma_rate
        if rate is None or rate <= 0.0:
            return 0.0
        return len(self._q) / rate * 1e3 + self._ewma_take_ms

    def shed(self, payload, tick_ms: float = 0.0) -> Ticket | None:
        """Deadline-aware admission: enqueue like :meth:`submit`, or return
        None WITHOUT enqueueing when the projected queue wait already
        exceeds ``max_wait_ms + tick_ms``.  A shed request never enters the
        queue, so the p99 of ADMITTED requests stays inside the deadline
        bound under any offered rate."""
        with self._cv:
            if self.closed:
                raise RuntimeError("batcher is closed")
            projected = self._projected_wait_ms_locked()
            # two guard rails around the projection: below one take's
            # quantum the queue drains in a single pump visit whatever the
            # EWMA claims (admission never starves its own evidence); with
            # no rate evidence yet, pending is held to two take quanta
            if ((projected > self.max_wait_ms + float(tick_ms)
                 and len(self._q) >= self.buckets[-1])
                    or (self._ewma_rate is None
                        and len(self._q) >= 2 * self.buckets[-1])):
                self.shed_count += 1
                self.last_projected_ms = projected
                return None
            t = Ticket(next(self._ids), payload, self.clock())
            self._q.append(t)
            self._cv.notify_all()
            return t

    def submit_many(self, payloads: list, shed: bool = False,
                    tick_ms: float = 0.0) -> tuple[list[Ticket], int]:
        """Chunked admission: one lock, one timestamp, the whole arrival
        chunk.  Returns ``(tickets, shed_n)``.  With ``shed=True`` the
        queue admits arrivals IN ORDER up to the pending depth whose
        projected wait reaches ``max_wait_ms + tick_ms`` (floored at one
        largest-bucket quantum) and rejects the tail; with no rate evidence
        the cold-start cap of two quanta applies, as in :meth:`shed`."""
        with self._cv:
            if self.closed:
                raise RuntimeError("batcher is closed")
            k = len(payloads)
            if shed:
                if self._ewma_rate is not None and self._ewma_rate > 0.0:
                    bound_s = max(0.0, self.max_wait_ms + float(tick_ms)
                                  - self._ewma_take_ms) / 1e3
                    cap = max(int(self._ewma_rate * bound_s), self.buckets[-1])
                else:
                    cap = 2 * self.buckets[-1]  # cold-start cap
                k = min(k, max(0, cap - len(self._q)))
            now = self.clock()
            tickets = [Ticket(next(self._ids), p, now) for p in payloads[:k]]
            if tickets:
                self._q.extend(tickets)
                self._cv.notify_all()
            n_shed = len(payloads) - k
            if n_shed:
                self.shed_count += n_shed
                self.last_projected_ms = self._projected_wait_ms_locked()
            return tickets, n_shed

    def pending(self) -> int:
        with self._cv:
            return len(self._q)

    # -- re-route side (serve/router.py) -----------------------------------

    def steal(self) -> list[Ticket]:
        """Remove and return every pending ticket WITHOUT stamping or
        resolving it: the dying replica's queue, headed for a survivor's
        :meth:`adopt`.  Distinct from :meth:`drain`, which stamps batch
        geometry for immediate execution."""
        with self._cv:
            stolen, self._q = self._q, []
            return stolen

    def adopt(self, tickets: list[Ticket]) -> int:
        """Enqueue stolen tickets, merged by original submit time so FIFO
        deadline accounting survives the re-route."""
        with self._cv:
            if self.closed:
                raise RuntimeError("batcher is closed")
            if tickets:
                self._q.extend(tickets)
                self._q.sort(key=lambda t: t.t_submit)
                self._cv.notify_all()
            return len(tickets)

    # -- pump side ---------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` requests; the largest bucket when
        ``n`` overflows every bucket."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _due(self, now: float) -> bool:
        if not self._q:
            return False
        if len(self._q) >= self.buckets[-1]:
            return True
        return (now - self._q[0].t_submit) * 1e3 >= self.max_wait_ms

    def take(self, force: bool = False) -> list[Ticket] | None:
        """One batch, if a flush is due (or ``force``); else None.  The
        returned tickets are stamped with their batch geometry (bucket,
        batch_n, deadline_flush) and ``t_batch``; resolving them is the
        caller's job."""
        with self._cv:
            now = self.clock()
            if not self._q or not (force or self._due(now)):
                return None
            n = min(len(self._q), self.buckets[-1])
            batch, self._q = self._q[:n], self._q[n:]
            # drain-rate sampling: a window OPENS at a take that leaves
            # backlog behind, accumulates the rows of later takes, and
            # CLOSES into a rate sample once >= _WIN_S has elapsed.  A take
            # that empties the queue invalidates the window: the gap after
            # it would measure idle time, not drain capability.
            if not self._q:
                self._win_t0 = None
            elif self._win_t0 is None:
                self._win_t0 = now
                self._win_rows = 0
                self._win_takes = 0
            else:
                self._win_rows += len(batch)
                self._win_takes += 1
                dt = now - self._win_t0
                if dt >= self._WIN_S:
                    rate = self._win_rows / dt
                    if self._ewma_rate is None:
                        self._ewma_rate = rate
                    else:
                        a = (self._ALPHA_DOWN if rate < self._ewma_rate
                             else self._ALPHA_UP)
                        self._ewma_rate = a * rate + (1.0 - a) * self._ewma_rate
                    # take period (ms), the projection's additive term;
                    # the same asymmetry, mirrored: longer is the slowdown
                    period = dt / self._win_takes * 1e3
                    a = (self._ALPHA_DOWN if period > self._ewma_take_ms
                         else self._ALPHA_UP)
                    self._ewma_take_ms = a * period + (1.0 - a) * self._ewma_take_ms
                    self._win_t0 = now
                    self._win_rows = 0
                    self._win_takes = 0
            deadline = len(batch) < self.buckets[-1]
            bucket = self.bucket_for(len(batch))
            for t in batch:
                t.t_batch = now
                t.bucket = bucket
                t.batch_n = len(batch)
                t.deadline_flush = deadline
            return batch

    def wait_due(self, timeout: float | None = None) -> bool:
        """Worker-loop helper: block until a flush is due or the batcher
        closes.  Wakes at the oldest request's deadline without polling,
        and at once when a hot swap drains this batcher: new submits then
        go to the next generation's batcher, which the worker loop must
        wait on instead.  Only meaningful with a real clock."""
        with self._cv:
            deadline = None if timeout is None else self.clock() + timeout
            drains = self._drains
            while not self.closed:
                now = self.clock()
                if self._due(now):
                    return True
                if self._drains != drains:
                    return False
                waits = []
                if self._q:
                    waits.append(self._q[0].t_submit + self.max_wait_ms / 1e3 - now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return self._due(now)
                    waits.append(remaining)
                self._cv.wait(timeout=min(waits) if waits else None)
            return self._due(self.clock())

    def drain(self) -> list[list[Ticket]]:
        """Every pending request as final batches WITHOUT closing: the
        hot-swap drain (``ServeEngine.swap_model``), so a later rollback
        can route new submits through this batcher again.  The caller
        holds whatever lock keeps new submits away (the engine's pump
        lock)."""
        batches: list[list[Ticket]] = []
        while (batch := self.take(force=True)) is not None:
            batches.append(batch)
        with self._cv:
            self._drains += 1
            self._cv.notify_all()
        return batches

    def close(self, drain: bool = True) -> list[list[Ticket]]:
        """Refuse new submits; return every in-flight request as final
        batches (``drain=True``, the zero-loss contract) or fail them with
        RuntimeError (``drain=False``)."""
        with self._cv:
            self.closed = True
            self._cv.notify_all()
        batches: list[list[Ticket]] = []
        while (batch := self.take(force=True)) is not None:
            if drain:
                batches.append(batch)
            else:
                for t in batch:
                    t.resolve(error=RuntimeError("batcher closed without drain"))
        return batches
