"""Streaming SLO burn-rate engine: the batch ``slo`` verdict as a live
signal.

Counterpart of ``sparknet_tpu/obs/burn.py``, copied whole.  ``obs/slo.py``
answers "did this journal burn?" once, after the run; this module answers
"is the run burning NOW?" continuously, the way an SRE burn-rate alert
does (multi-window: a FAST window catches the spike, a SLOW window proves
it is not a blip; both must burn before anyone is paged).  The reference
steered itself off per-round scalars its master collected (ref:
src/main/scala/apps/CifarApp.scala:136); here the scalars are the obs
journal's own events, folded incrementally so the controller
(``loop/autoctl.py``) can act mid-run.

Gate semantics mirror ``obs/slo.py``: the same manifest
(``docs/slo_manifest.json``), the same warmup skip, the same disturbance
suspension, evaluated over sliding time windows, and suspension EXPIRES
(``suspend_s``) instead of condemning the rest of the run.  Burn rate is
``value / bound`` for bounded gates (burning when >= 1.0 in BOTH windows)
and a raw in-window count for the zero-tolerance gates (burning on any
occurrence).  Recovery is hysteretic: tripping needs BOTH windows over
the level, clearing needs only the FAST window back under
``clear_ratio`` x the trip level.

Event sources: feed events directly (``observe``/``feed``), or tail a
live journal through the torn-line-safe ``metrics.JournalTail``
(``feed_tail``).  The clock is injectable, so a replay runs on virtual
time.

Deliberately stdlib-only.
"""

from __future__ import annotations

import time
from collections import deque

from sparknet_tpu_torch.obs import slo as _slo

__all__ = ["BurnEngine", "GateState"]

DEFAULT_FAST_S = 1.0
DEFAULT_SLOW_S = 30.0
DEFAULT_CLEAR_RATIO = 0.9
# settle period after a mid-traffic disturbance before the latency gate
# re-arms (the streaming analog of slo.py's journal-wide suspension)
DEFAULT_SUSPEND_S = 5.0
# hard cap per window: burn math must stay O(1)-ish per event even if a
# scenario floods one window (oldest samples age out first anyway)
_MAX_SAMPLES = 4096


class _Window:
    """(t, value) samples pruned to a fixed duration."""

    __slots__ = ("dur", "_q")

    def __init__(self, dur: float):
        self.dur = float(dur)
        self._q: deque = deque(maxlen=_MAX_SAMPLES)

    def add(self, t: float, value: float) -> None:
        self._q.append((float(t), float(value)))

    def prune(self, now: float) -> None:
        q = self._q
        cutoff = now - self.dur
        while q and q[0][0] < cutoff:
            q.popleft()

    def values(self, now: float) -> list[float]:
        self.prune(now)
        return [v for _, v in self._q]

    def total(self, now: float) -> float:
        self.prune(now)
        return sum(v for _, v in self._q)


def _p99(values: list[float]) -> float:
    """Nearest-rank p99 over raw in-window samples (windows are small
    and bounded; the hub's log-bucket histogram cannot age samples
    out, so the streaming path keeps the raw deque instead)."""
    s = sorted(values)
    rank = max(0, min(len(s) - 1, int(0.99 * len(s) + 0.5) - 1))
    return s[rank]


class GateState:
    """One manifest gate's streaming state: a fast and a slow window of
    observations plus the hysteretic burning latch."""

    __slots__ = ("spec", "gate_id", "kind", "bound", "fast", "slow",
                 "burning", "suspended_until", "_warm_seen")

    def __init__(self, spec: dict, fast_s: float, slow_s: float):
        self.spec = spec
        self.kind = spec.get("kind")
        self.gate_id = spec.get("id", self.kind)
        if self.kind == "warm_queue_p99":
            self.bound = float(spec.get("max_ms", 40.0))
        elif self.kind == "ttft_p99":
            self.bound = float(spec.get("max_ms", 250.0))
        elif self.kind == "feed_stage_share":
            self.bound = float(spec.get("max_share", 0.05))
        elif self.kind == "bench_roofline":
            self.bound = 1.0
        else:  # zero-tolerance ledgers: compiles_zero / dropped_zero
            self.bound = 0.0
        self.fast = _Window(fast_s)
        self.slow = _Window(slow_s)
        self.burning = False
        self.suspended_until = float("-inf")
        self._warm_seen: dict = {}

    # -- folding -----------------------------------------------------------

    def fold(self, event: str, fields: dict, t: float) -> None:
        kind = self.kind
        if kind == "warm_queue_p99":
            if event != "request":
                return
            key = (fields.get("model"), fields.get("bucket"))
            n = self._warm_seen.get(key, 0)
            self._warm_seen[key] = n + 1
            warmup = int(self.spec.get("warmup_requests", 8))
            wait = fields.get("queue_wait_ms")
            if n >= warmup and isinstance(wait, (int, float)):
                self.fast.add(t, wait)
                self.slow.add(t, wait)
        elif kind == "ttft_p99":
            if event != "token" or fields.get("kind") != "request":
                return
            n = self._warm_seen.get("token", 0)
            self._warm_seen["token"] = n + 1
            warmup = int(self.spec.get("warmup_requests", 8))
            ttft = fields.get("ttft_ms")
            if n >= warmup and isinstance(ttft, (int, float)):
                self.fast.add(t, ttft)
                self.slow.add(t, ttft)
        elif kind == "feed_stage_share":
            if event != "feed":
                return
            stages = fields.get("stages")
            if not isinstance(stages, dict):
                return
            stage = str(self.spec.get("stage", "slot_wait"))
            total = sum(v for v in stages.values()
                        if isinstance(v, (int, float)))
            part = stages.get(stage)
            if total > 0 and isinstance(part, (int, float)):
                share = part / total
                self.fast.add(t, share)
                self.slow.add(t, share)
        elif kind == "compiles_zero":
            n = 0
            if event == "recompile" and not fields.get("expected"):
                n = int(fields.get("count", 1))
            elif event in ("serve", "loop") and \
                    fields.get("kind") == "summary" and \
                    isinstance(fields.get("compiles"), int):
                n = fields["compiles"]
            if n > 0:
                self.fast.add(t, n)
                self.slow.add(t, n)
        elif kind == "dropped_zero":
            if event in ("serve", "replica", "loop") and \
                    isinstance(fields.get("dropped"), int) and \
                    fields["dropped"] > 0:
                self.fast.add(t, fields["dropped"])
                self.slow.add(t, fields["dropped"])
        elif kind == "bench_roofline":
            if event != "bench" or not fields.get("measured"):
                return
            record = fields.get("record")
            if not isinstance(record, dict):
                return
            value = record.get("value")
            bound = record.get("roofline_img_s_upper_bound")
            if isinstance(value, (int, float)) and \
                    isinstance(bound, (int, float)) and bound > 0:
                frac = value / bound
                self.fast.add(t, frac)
                self.slow.add(t, frac)

    # -- evaluation --------------------------------------------------------

    def _rate(self, window: _Window, now: float) -> float | None:
        """Normalized burn rate for one window: > 1.0 means burning for
        bounded gates; any positive count burns a zero-bound ledger.
        None when the window holds no subject observations."""
        if self.bound == 0.0:
            # zero-tolerance ledgers are applicable by absence: no
            # occurrence in the window IS the healthy reading
            return window.total(now)
        values = window.values(now)
        if not values:
            return None
        if self.kind in ("warm_queue_p99", "ttft_p99"):
            return _p99(values) / self.bound
        if self.kind == "bench_roofline":
            return max(values)  # already value/roofline fractions
        return max(values) / self.bound  # share-style gates

    def evaluate(self, now: float) -> dict:
        suspended = now < self.suspended_until
        fast = self._rate(self.fast, now)
        slow = self._rate(self.slow, now)
        trip = 1.0 if self.bound else 0.0
        if suspended and self.kind in ("warm_queue_p99", "ttft_p99"):
            self.burning = False
        elif self.burning:
            # hysteretic clear on the FAST window only: the short window
            # proves recovery.  The slow window's 30 s memory holds the
            # burn-era samples long after the backlog drained — clearing
            # on both would latch the alarm ~slow_s past recovery and
            # drive the controller into overshoot (extra joins against a
            # queue that no longer exists).
            clear = (self.spec.get("_clear_ratio") or
                     DEFAULT_CLEAR_RATIO) * trip
            if fast is None or fast <= clear:
                self.burning = False
        else:
            if fast is not None and slow is not None and \
                    fast > trip and slow > trip:
                self.burning = True
        return {
            "id": self.gate_id,
            "fast": None if fast is None else round(fast, 4),
            "slow": None if slow is None else round(slow, 4),
            "burning": self.burning,
            "suspended": bool(suspended),
        }


class BurnEngine:
    """Multi-window burn evaluation over every manifest gate.

    Single-threaded by contract: fold and evaluate from ONE thread (the
    controller's step loop or the scenario tick loop) — the engine owns
    no lock, so it can never deadlock a pump.
    """

    def __init__(self, manifest: dict | None = None, *,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 suspend_s: float = DEFAULT_SUSPEND_S,
                 clock=None):
        if manifest is None:
            manifest = _slo.load_manifest()
        self.manifest = manifest
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.suspend_s = float(suspend_s)
        self._clock = clock or time.perf_counter
        self.gates = [GateState(spec, fast_s, slow_s)
                      for spec in manifest["slos"]]

    # -- event intake ------------------------------------------------------

    def observe(self, event: str, fields: dict,
                t: float | None = None) -> None:
        """Fold one event (same shape the Recorder journals: event name
        + its fields dict)."""
        now = self._clock() if t is None else float(t)
        kinds = _slo._DISTURBANCES.get(event)
        if kinds and fields.get("kind") in kinds:
            until = now + self.suspend_s
            for g in self.gates:
                if g.kind in ("warm_queue_p99", "ttft_p99"):
                    g.suspended_until = max(g.suspended_until, until)
        for g in self.gates:
            g.fold(event, fields, now)

    def feed(self, events, t: float | None = None) -> int:
        """Fold an iterable of journal-line dicts (each carries its
        ``event`` name inline).  Returns the number folded."""
        n = 0
        for ev in events:
            name = ev.get("event")
            if isinstance(name, str):
                self.observe(name, ev, t=t)
                n += 1
        return n

    def feed_tail(self, tail, t: float | None = None) -> int:
        """Drain a ``metrics.JournalTail`` into the engine (the live
        out-of-process path: the controller tails the journal the
        serving stack is writing)."""
        return self.feed(tail.poll(), t=t)

    # -- evaluation --------------------------------------------------------

    def evaluate(self, t: float | None = None) -> list[dict]:
        """One multi-window evaluation pass: per-gate ``{id, fast,
        slow, burning, suspended}`` (the ``ctl`` observe payload)."""
        now = self._clock() if t is None else float(t)
        return [g.evaluate(now) for g in self.gates]

    def burning(self, t: float | None = None) -> list[str]:
        """Gate ids currently burning (both windows over trip level)."""
        return [r["id"] for r in self.evaluate(t) if r["burning"]]
