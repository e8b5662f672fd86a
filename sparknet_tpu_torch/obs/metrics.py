"""Streaming metrics: counters, gauges, and log-bucket histograms.

Counterpart of ``sparknet_tpu/obs/metrics.py``, copied whole (the same
buckets, percentiles and snapshots, so the two packages' metrics events
merge exactly).  SparkNet surfaced one runtime signal, the master
printing each round's loss (ref: src/main/scala/apps/CifarApp.scala:136).
A :class:`MetricsHub` folds Recorder events into counters, gauges, and
fixed-boundary log-bucket histograms as they are emitted, and flushes the
cumulative state periodically as schema-valid ``metrics`` snapshot
events, so a reader needs the LAST snapshot per run, not every raw
``request`` line.

Histogram contract:

- Boundaries are FIXED and deterministic: bucket ``i`` covers
  ``[10**(i/40), 10**((i+1)/40))`` (40 buckets per decade, ~5.93%
  relative width), so two histograms built anywhere bucket identically
  and their snapshots merge EXACTLY.
- ``percentile`` is nearest-rank over bucket counts, reporting the
  bucket's UPPER boundary clamped into ``[min, max]``: it never
  under-reports a tail latency, is exact for a single sample and for
  the distribution's extremes, and is otherwise within one bucket
  width (<= ~5.93% relative) of the exact nearest-rank percentile.
- Values ``<= 0`` land in a dedicated zero bucket represented as 0.0.

Deliberately stdlib-only (no torch, no numpy).
"""

from __future__ import annotations

import json
import math
from typing import Iterator

__all__ = [
    "BUCKETS_PER_DECADE",
    "bucket_index",
    "bucket_lower",
    "Histogram",
    "merge_snapshots",
    "percentile",
    "MetricsHub",
    "JournalTail",
]

# fixed log-bucket resolution: 40 buckets per decade -> boundary ratio
# 10**(1/40) ~= 1.0593, i.e. percentile estimates within ~5.93%
BUCKETS_PER_DECADE = 40

# the zero/underflow bucket key (values <= 0); JSON object keys are
# strings, so snapshot bucket keys are str(int) and this sentinel
_ZERO_KEY = "z"


def bucket_lower(i: int) -> float:
    """The inclusive lower boundary of bucket ``i``."""
    return 10.0 ** (i / BUCKETS_PER_DECADE)


def bucket_index(value: float) -> int:
    """The bucket holding ``value`` (> 0): largest ``i`` with
    ``bucket_lower(i) <= value``.  The float-log guess is corrected
    against the actual boundaries so values sitting exactly ON a
    boundary land deterministically in the bucket they open."""
    i = math.floor(math.log10(value) * BUCKETS_PER_DECADE)
    while value < bucket_lower(i):
        i -= 1
    while value >= bucket_lower(i + 1):
        i += 1
    return i


class Histogram:
    """Sparse fixed-boundary log-bucket histogram (see module doc)."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self.buckets: dict[str, int] = {}

    def observe(self, value: float) -> None:
        value = float(value)
        key = _ZERO_KEY if value <= 0.0 else str(bucket_index(value))
        self.buckets[key] = self.buckets.get(key, 0) + 1
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def snapshot(self) -> dict:
        """A JSON-ready cumulative snapshot (the ``metrics`` event
        payload per histogram): exact integer bucket counts, so two
        snapshots of disjoint observation sets merge exactly."""
        return {"count": self.count, "sum": round(self.sum, 6),
                "min": self.min, "max": self.max,
                "buckets": dict(self.buckets)}


def merge_snapshots(a: dict, b: dict) -> dict:
    """Merge two histogram snapshots exactly (bucket counts add;
    associative and commutative on counts/buckets/min/max)."""
    buckets = dict(a.get("buckets", {}))
    for key, n in b.get("buckets", {}).items():
        buckets[key] = buckets.get(key, 0) + n
    mins = [m for m in (a.get("min"), b.get("min")) if m is not None]
    maxs = [m for m in (a.get("max"), b.get("max")) if m is not None]
    return {
        "count": a.get("count", 0) + b.get("count", 0),
        "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "buckets": buckets,
    }


def percentile(snap: dict, q: float) -> float | None:
    """Nearest-rank percentile estimate from a snapshot (upper bucket
    boundary, clamped into ``[min, max]``; ``None`` when empty).  The
    same nearest-rank convention as ``serve.engine.percentile`` — the
    estimate differs from the exact value by at most one bucket width."""
    n = int(snap.get("count", 0))
    if n <= 0:
        return None
    rank = max(1, math.ceil(q / 100.0 * n))
    buckets = snap.get("buckets", {})
    ordered: list[tuple[float, int]] = []
    if _ZERO_KEY in buckets:
        ordered.append((0.0, buckets[_ZERO_KEY]))
    for key in sorted((k for k in buckets if k != _ZERO_KEY), key=int):
        ordered.append((bucket_lower(int(key) + 1), buckets[key]))
    seen = 0
    estimate = 0.0
    for upper, count in ordered:
        seen += count
        if seen >= rank:
            estimate = upper
            break
    lo, hi = snap.get("min"), snap.get("max")
    if lo is not None:
        estimate = max(estimate, lo)
    if hi is not None:
        estimate = min(estimate, hi)
    return estimate


class MetricsHub:
    """Folds Recorder events into bounded metric state, in-process.

    :meth:`observe_event` is called by ``Recorder.emit`` for every
    journaled event (except ``metrics`` itself); every ``flush_every``
    observations it returns the fields of one cumulative ``metrics``
    snapshot event for the Recorder to journal.  State is cumulative —
    the LAST snapshot of a run supersedes the earlier ones, so readers
    never need to merge within a run (merging is for ACROSS runs).
    """

    def __init__(self, flush_every: int = 256):
        self.flush_every = max(1, int(flush_every))
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Histogram] = {}
        self.seq = 0
        self._since_flush = 0
        self._dirty = False

    # -- primitive sinks ---------------------------------------------------

    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        hist = self.hists.get(name)
        if hist is None:
            hist = self.hists[name] = Histogram()
        hist.observe(value)

    # -- the event fold ----------------------------------------------------

    def observe_event(self, event: str, fields: dict) -> dict | None:
        """Fold one Recorder event; returns ``metrics`` event fields
        when a flush is due, else None.  Unknown events only tick the
        flush clock — the vocabulary below is the aggregation policy,
        not a schema (schema.py is the schema)."""
        if event == "metrics":
            return None
        if event == "request":
            model = fields.get("model", "?")
            bucket = fields.get("bucket", 0)
            grp = f"{model}/b{bucket}"
            self.inc("serve/requests")
            self.observe(f"serve/total_ms/{grp}", fields.get("total_ms", 0.0))
            self.observe(f"serve/queue_ms/{grp}",
                         fields.get("queue_wait_ms", 0.0))
            self.observe(f"serve/device_ms/{grp}",
                         fields.get("device_ms", 0.0))
        elif event == "feed":
            name = fields.get("name", "?")
            stages = fields.get("stages") or {}
            for stage, secs in stages.items():
                if isinstance(secs, (int, float)):
                    self.inc(f"feed/{name}/stage_s/{stage}", secs)
            for field in ("batches", "images", "wall_s"):
                value = fields.get(field)
                if isinstance(value, (int, float)):
                    self.inc(f"feed/{name}/{field}", value)
        elif event == "round":
            mode = fields.get("mode", "?")
            self.observe(f"round/{mode}/wall_s", fields.get("wall_s", 0.0))
            iters = fields.get("iters", 0)
            batch = fields.get("batch", 0)
            if isinstance(iters, int) and isinstance(batch, int):
                self.inc(f"round/{mode}/images", iters * batch)
            ema = fields.get("loss_ema")
            if isinstance(ema, (int, float)):
                self.set_gauge(f"round/{mode}/loss_ema", ema)
        elif event == "recompile":
            self.inc("recompiles", fields.get("count", 1))
        elif event in ("serve", "replica"):
            for field in ("shed", "dropped", "rerouted", "drained"):
                value = fields.get(field)
                if isinstance(value, (int, float)):
                    self.inc(f"{event}/{field}", value)
        elif event == "ctl":
            # control-plane stream (obs/burn.py + loop/autoctl.py):
            # count each lifecycle kind; observe events also carry the
            # per-gate burn rates, folded as gauges so `obs top` can
            # render live burn dials without replaying the journal
            kind = fields.get("kind", "?")
            self.inc(f"ctl/{kind}")
            if kind == "observe":
                for gate in fields.get("gates") or ():
                    if not isinstance(gate, dict):
                        continue
                    gid = gate.get("id", "?")
                    for win in ("fast", "slow"):
                        rate = gate.get(win)
                        if isinstance(rate, (int, float)):
                            self.set_gauge(f"ctl/burn/{gid}/{win}", rate)
        self._dirty = True
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            return self.flush_fields()
        return None

    def flush_fields(self) -> dict | None:
        """The cumulative snapshot as ``metrics`` event fields (None
        when nothing was observed since the last flush)."""
        if not self._dirty:
            return None
        self._dirty = False
        self._since_flush = 0
        self.seq += 1
        fields: dict = {
            "seq": self.seq,
            "counters": {k: round(v, 6) if isinstance(v, float) else v
                         for k, v in sorted(self.counters.items())},
            "hists": {k: h.snapshot()
                      for k, h in sorted(self.hists.items())},
        }
        if self.gauges:
            fields["gauges"] = {k: round(v, 6) if isinstance(v, float)
                                else v for k, v in sorted(self.gauges.items())}
        return fields


class JournalTail:
    """Incremental reader for a GROWING journal (``obs top``, and the
    burn engine mid-run): each :meth:`poll` parses only the complete
    lines appended since the last call, never re-reading the file.
    Torn trailing lines (a writer mid-append) are left for the next
    poll.  A journal that SHRINKS between polls (rotated or truncated
    by a fresh run re-arming the same path) resets the cursor to 0 and
    re-reads from the top — the old cursor would otherwise sit past
    EOF and read empty forever."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0

    def poll(self) -> Iterator[dict]:
        try:
            with open(self.path, encoding="utf-8") as f:
                f.seek(0, 2)
                if f.tell() < self._pos:
                    self._pos = 0  # rotated/truncated underneath us
                f.seek(self._pos)
                chunk = f.read()
        except OSError:
            return
        if not chunk:
            return
        keep = chunk.rfind("\n") + 1
        self._pos += keep
        for line in chunk[:keep].splitlines():
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                yield obj
