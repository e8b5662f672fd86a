"""The obs Recorder: off-by-default JSONL runtime telemetry.

Counterpart of ``sparknet_tpu/obs/recorder.py``.  Arm it with
``SPARKNET_OBS=<path>.jsonl`` (the literal ``1`` means
``./obs_journal.jsonl``); anything else (unset, empty, ``0``) keeps it OFF.
The off state is a hard contract: instrumented call sites (``Solver.step``,
the trainers' rounds, the serving engine) guard every obs touch behind
``if rec:`` and take their walls, fences and payloads only inside that
guard, so with obs off the hot path adds no host sync, no kernel launch,
no device allocation and no graph capture (the tests pin it).

Walls are only evidence when they are FENCE-STAMPED.  A span that encloses
device work closes through :meth:`Span.fence`, which reads the VALUE of the
work's own output scalar to the host (``.item()`` of the step's loss, the
one read the caller would make anyway): the device must have run the work
to hand over that value.  The port never fences with a
``torch.cuda.synchronize()`` of the whole device.  A span that never
touches the device declares ``host=True`` instead; spans that do neither
are journaled with ``fenced: false``.

In a pool of ranks only rank 0 writes.  Every rank replays the same
``FaultPlan``, so rank 0 knows the whole membership; on every other rank
:meth:`Recorder.from_env` returns a disabled recorder, and
``parallel.initialize_distributed`` drops an env-built singleton
(:func:`rebuild_from_env`) so the next :func:`get_recorder` is built for
the rank this process now holds.

Left out of the JAX recorder: ``bench`` (it waits for the port's bench,
ROADMAP Queue A6) and the bank observer with ``detach`` (``common.
bank_guard`` has no counterpart in the port).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from sparknet_tpu_torch.obs import schema
from sparknet_tpu_torch.obs.metrics import MetricsHub
from sparknet_tpu_torch.obs.sentinel import get_sentinel

__all__ = ["Recorder", "Span", "get_recorder", "set_recorder"]

_ENV = "SPARKNET_OBS"

# loss EMA decay for per-round records: ~"average of the last 10 rounds",
# the observability analog of SolverParameter.average_loss
_EMA_DECAY = 0.9


class Span:
    """One fenced wall.  Use as a context manager off :meth:`Recorder.span`;
    close device-work spans with :meth:`fence` (or :meth:`fence_value` when
    the caller already read the work's own output to the host)."""

    __slots__ = ("_rec", "name", "host", "note", "_t0", "_fenced",
                 "_fence_value")

    def __init__(self, rec: "Recorder | None", name: str,
                 host: bool = False, note: str | None = None):
        self._rec = rec if (rec is not None and rec.enabled) else None
        self.name = name
        self.host = bool(host)
        self.note = note
        self._t0 = 0.0
        self._fenced = False
        self._fence_value: float | None = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def fence(self, out) -> float | None:
        """Fence-stamp this span on the VALUE of ``out``, the enclosed
        work's own output scalar (a one-element tensor, read with
        ``.item()``).  A no-op that never reads ``out`` when obs is off,
        so a guarded call site adds no sync."""
        if self._rec is None:
            return None
        self._fence_value = float(out.item())
        self._fenced = True
        return self._fence_value

    def fence_value(self, value: float) -> float:
        """Fence-stamp with an ALREADY-READ value.  Caller contract:
        ``value`` was read from the enclosed work's own output (e.g.
        ``loss.item()`` of the step's loss); a host-computed number here
        forges the stamp."""
        self._fence_value = float(value)
        self._fenced = True
        return self._fence_value

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._rec is None:
            return
        wall = time.perf_counter() - self._t0
        fields: dict = {
            "name": self.name,
            "wall_s": round(wall, 6),
            "fenced": self._fenced and not self.host,
        }
        if self.host:
            fields["host"] = True
        if self._fence_value is not None:
            fields["fence_value"] = self._fence_value
        if self.note:
            fields["note"] = self.note
        self._rec._emit_span(fields)


class Recorder:
    """Append-only JSONL journal of schema-validated obs events."""

    def __init__(self, path: str | None, run_id: str | None = None,
                 metrics_flush_every: int = 256):
        self.path = path
        self.enabled = bool(path)
        self._lock = threading.Lock()
        self._started = False
        self._file = None
        # every journaled event folds into bounded counters/histograms, and
        # the cumulative state flushes as a periodic ``metrics`` event
        self._hub = MetricsHub(metrics_flush_every) if path else None
        self._n_rounds = 0
        self._n_spans = 0
        self._ema: dict[str, float] = {}
        self._warm_modes: set[str] = set()
        self._last_compiles = 0
        self._compiles0 = 0
        self.sentinel = get_sentinel()
        if self.enabled:
            self.run_id = run_id or f"{os.getpid():x}-{time.time_ns() & 0xFFFFFF:06x}"
            self._compiles0 = self._last_compiles = self.sentinel.count
        else:
            self.run_id = run_id or "off"

    @classmethod
    def from_env(cls) -> "Recorder":
        """The recorder ``SPARKNET_OBS`` asks for; disabled on a rank other
        than 0 of an initialized process group."""
        raw = os.environ.get(_ENV, "").strip()
        if raw in ("", "0"):
            return cls(None)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
            return cls(None)
        return cls("obs_journal.jsonl" if raw == "1" else raw)

    def __bool__(self) -> bool:
        return self.enabled

    # -- low-level emit ----------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        """Validate against the schema and append one journal line.  Never
        raises out of an armed run: a schema bug or a read-only disk prints
        to stderr and drops the line."""
        if not self.enabled:
            return
        try:
            line = schema.make_event(event, run_id=self.run_id, **fields)
        except ValueError as e:
            print(f"obs: dropped invalid event: {e}", file=sys.stderr)
            return
        payload = json.dumps(line)
        with self._lock:
            if not self._started:
                self._started = True
                start = schema.make_event(
                    "run_start", run_id=self.run_id, pid=os.getpid(),
                    argv=list(sys.argv))
                self._write(json.dumps(start))
            self._write(payload)
            self._fold_locked(event, fields)

    def _fold_locked(self, event: str, fields: dict) -> None:
        """Fold one just-journaled event into the metrics hub and write the
        periodic ``metrics`` snapshot when one is due (caller holds the
        lock)."""
        if self._hub is None or event == "metrics":
            return
        try:
            snap = self._hub.observe_event(event, fields)
            if snap:
                mline = schema.make_event("metrics", run_id=self.run_id, **snap)
                self._write(json.dumps(mline))
        except Exception as e:  # telemetry must not take the run down
            print(f"obs: metrics fold failed: {e}", file=sys.stderr)

    def _write(self, payload: str) -> None:
        # one handle a run, flushed line by line (a live ``top`` reads every
        # line): reopening the journal for each line held the serving pump
        # thread up on a slow filesystem (ROADMAP Queue C, C18)
        try:
            if self._file is None:
                self._file = open(self.path, "a", encoding="utf-8")
            self._file.write(payload + "\n")
            self._file.flush()
        except OSError as e:
            print(f"obs: could not append to {self.path}: {e}", file=sys.stderr)

    def _emit_span(self, fields: dict) -> None:
        self._n_spans += 1
        self.emit("span", **fields)

    # -- public surface ----------------------------------------------------

    def span(self, name: str, host: bool = False, note: str | None = None) -> Span:
        """A fenced-wall context manager (a no-op when obs is off).
        ``host=True`` declares the span never encloses device work."""
        return Span(self, name, host=host, note=note)

    def round(self, *, mode: str, tau: int, devices: int, iters: int,
              batch: int, wall_s: float, loss: float, fenced: bool,
              comm: dict | None = None, iteration: int | None = None,
              workers: int | None = None, lineage: dict | None = None,
              expected_compiles: bool = False) -> None:
        """One per-round training record.  ``batch`` is images per step over
        the workers; throughput is ``iters * batch / wall_s``.  Also drives
        the capture sentinel: a graph captured between rounds of an
        already-warm mode is journaled as a ``recompile`` event
        (``expected`` when the caller knows this round captured on
        purpose)."""
        if not self.enabled:
            return
        loss = float(loss)
        ema = self._ema.get(mode)
        ema = loss if ema is None else _EMA_DECAY * ema + (1.0 - _EMA_DECAY) * loss
        self._ema[mode] = ema

        total = self.sentinel.count
        compiles = total - self._last_compiles
        self._last_compiles = total
        if compiles > 0 and mode in self._warm_modes:
            self.emit("recompile", count=compiles, total=total - self._compiles0,
                      where=mode, expected=bool(expected_compiles))
        self._warm_modes.add(mode)

        images_per_sec = (iters * batch / wall_s) if wall_s > 0 else 0.0
        fields: dict = {
            "mode": mode, "tau": int(tau), "devices": int(devices),
            "iters": int(iters), "batch": int(batch),
            "wall_s": round(float(wall_s), 6),
            "images_per_sec": round(images_per_sec, 1),
            "loss": loss, "loss_ema": round(ema, 6),
            "fenced": bool(fenced), "compiles": compiles,
        }
        if comm is not None:
            fields["comm"] = comm
        if iteration is not None:
            fields["iteration"] = int(iteration)
        if workers is not None:
            fields["workers"] = int(workers)
        if lineage is not None:
            fields["lineage"] = lineage
        self._n_rounds += 1
        self.emit("round", **fields)

    def absorb_compiles(self, where: str) -> int:
        """Fold captures since the last round record into the by-design
        ledger: a candidate build between training rounds captures on
        purpose, and without this the NEXT round's record would claim those
        captures as its own.  Journals the delta as an ``expected``
        recompile event; returns the delta."""
        if not self.enabled:
            return 0
        total = self.sentinel.count
        n = total - self._last_compiles
        self._last_compiles = total
        if n > 0:
            self.emit("recompile", count=n, total=total - self._compiles0,
                      where=where, expected=True)
        return n

    def close(self) -> None:
        """Emit the final metrics snapshot and the run summary."""
        if not self.enabled or not self._started:
            return
        if self._hub is not None:
            snap = self._hub.flush_fields()
            if snap:
                self.emit("metrics", **snap)
        self.emit("run_end", rounds=self._n_rounds, spans=self._n_spans,
                  compiles=self.sentinel.count - self._compiles0)
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_recorder: Recorder | None = None
_from_env = False


def get_recorder() -> Recorder:
    """The process singleton, built from ``SPARKNET_OBS`` on first use."""
    global _recorder, _from_env
    if _recorder is None:
        _recorder = Recorder.from_env()
        _from_env = True
    return _recorder


def set_recorder(rec: Recorder | None) -> Recorder | None:
    """Replace the singleton (tests; the dryrun CLI).  ``None`` resets to
    lazy env-driven construction."""
    global _recorder, _from_env
    _recorder = rec
    _from_env = False
    return rec


def rebuild_from_env() -> None:
    """Drop an env-built singleton so the next :func:`get_recorder` reads
    the environment again (a process that joined a process group may no
    longer be rank 0; the CLI's ``--obs`` sets the variable); an explicitly
    set recorder stays."""
    global _recorder
    if _from_env:
        _recorder = None
