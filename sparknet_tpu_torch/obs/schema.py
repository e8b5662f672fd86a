"""The one journal-line schema: window-runner events + obs runtime events.

Counterpart of ``sparknet_tpu/obs/schema.py``, copied whole: the line
format is the JAX package's, so a journal the port writes validates under
either package's :func:`validate_journal`, and one validator audits both.
Every line is one JSON object with an ``event`` discriminator, a ``utc``
wall stamp, and per-event required/optional fields.  Writers build lines
through :func:`make_event` (validates before the bytes hit disk); readers
validate through :func:`validate_line` / :func:`validate_journal`.

Two event families share the format: the TPU window runner's host-side
ledger (dials, jobs; written by the JAX package's tools) and the obs
Recorder's runtime telemetry (spans, rounds, capture counts, membership,
serving, the production loop, the control plane).  No event is narrowed
or widened here.

Deliberately stdlib-only: importing it loads neither torch nor any
backend.

Legacy journals: lines that predate the schema are NOT silently skipped.
:data:`LEGACY_ALLOWLIST` names each known-deviant (journal, event,
error) triple with the reason; the validator forgives exactly those and
reports everything else.
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Iterator

__all__ = [
    "SCHEMA_VERSION",
    "EVENTS",
    "LEGACY_ALLOWLIST",
    "utc_now",
    "make_event",
    "validate_line",
    "validate_journal",
    "load_journal",
    "stream_journal",
]

SCHEMA_VERSION = 1

# the journal's wall-stamp format, shared verbatim with the window
# runner's historical lines: "2026-07-31 15:35:45Z"
_UTC_FMT = "%Y-%m-%d %H:%M:%SZ"
_UTC_RE = re.compile(r"^\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}Z$")

_NUM = (int, float)
_OPT_STR = (str, type(None))

# event name -> (required {field: type(s)}, optional {field: type(s)}).
# ``event`` and ``utc`` are implicit on every line.  Unknown events and
# unknown fields are validation errors: both writers live in this repo,
# so drift is a bug, not forward compatibility.
EVENTS: dict[str, tuple[dict, dict]] = {
    # -- tools/tpu_window_runner.py (host-side evidence ledger) ---------
    "runner_start": ({"queue": str, "jobs": list}, {}),
    "dial_start": ({"probe": int}, {}),
    "dial_end": (
        {"probe": int, "ok": bool, "dt_s": _NUM},
        {"platform": _OPT_STR, "error": _OPT_STR},
    ),
    # post-hoc adjudication of a dial whose runner died mid-flight
    "dial_abandoned": ({"probe": int, "note": str}, {}),
    "job_start": (
        {"job": str, "argv": list, "deadline_s": _NUM},
        {"setup": bool},
    ),
    "job_end": (
        {"job": str, "rc": (int, type(None)), "dt_s": _NUM,
         "timed_out": bool},
        {"window_death": bool, "setup": bool},
    ),
    "queue_reload_failed": ({"error": str}, {}),
    # the memcheck queue pre-flight refused a job whose predicted
    # per-device footprint exceeds the chip (analysis/mem_model
    # preflight_job against docs/mem_contracts/batch_fit.json): the job
    # is marked dead WITHOUT burning a dial — the refusal, not a 25-min
    # OOM-then-wedge, is the round's record of it
    "preflight_oom": (
        {"job": str, "model": str, "batch": int, "dtype": str,
         "predicted_bytes": int, "budget_bytes": int},
        {"note": str},
    ),
    "setup_failed": ({"job": str, "note": str}, {}),
    # the runner's per-job SLO verdict (obs/slo.py evaluated against the
    # obs journal(s) a drained job produced): ``gates`` is the manifest
    # size, ``applicable`` how many gates had subject events in the
    # journal (the rest pass vacuously), ``burned`` the failing gate ids
    "slo": (
        {"job": str, "ok": bool, "gates": int, "applicable": int},
        {"burned": list, "vacuous": list, "journal": str,
         "manifest": str, "note": str},
    ),
    "runner_done": ({"reason": str}, {"blocked_jobs": list}),
    # one survival-policy scheduling decision (tools/window_policy.py;
    # only written under ``--policy survival`` — the default runner path
    # stays byte-compatible).  ``kind`` discriminates: "fit" (model
    # summary at runner start), "pick" (value x P(survive) argmax inside
    # a window), "window_summary" (per-window expected-vs-banked
    # evidence reconciliation), "redial_backoff" (survival-seeded
    # deferred dial while the relay is wedged)
    "sched": (
        {"kind": str},
        {"policy": str, "job": str, "probe": int, "window_age_s": _NUM,
         "est_runtime_s": _NUM, "p_survive": _NUM, "value": _NUM,
         "score": _NUM, "candidates": int, "expected_value": _NUM,
         "banked_value": _NUM, "jobs_banked": int, "delay_s": _NUM,
         "consecutive_dead": int, "heal_median_s": _NUM,
         "windows": int, "window_deaths": int, "median_window_s": _NUM,
         "heals": int, "heals_observed": int, "sources": list,
         "note": str},
    ),
    # -- sparknet_tpu/obs Recorder (runtime telemetry) ------------------
    "run_start": ({"run_id": str}, {"pid": int, "argv": list, "note": str}),
    # a fenced wall around arbitrary work; ``fenced`` False means the
    # wall is NOT evidence (the report refuses it) unless ``host`` says
    # the span never enclosed device work
    "span": (
        {"run_id": str, "name": str, "wall_s": _NUM, "fenced": bool},
        {"host": bool, "fence_value": _NUM, "note": str},
    ),
    # one training round: tau local steps (tau=1 sync SGD degenerate
    # case included), with the comm_model-predicted collective budget
    # attached so measured rounds carry their analytic expectation
    "round": (
        {"run_id": str, "mode": str, "tau": int, "devices": int,
         "iters": int, "batch": int, "wall_s": _NUM,
         "images_per_sec": _NUM, "loss": _NUM, "loss_ema": _NUM,
         "fenced": bool},
        {"comm": dict, "compiles": int, "iteration": int, "workers": int,
         "lineage": dict},
    ),
    # the recompile sentinel fired: ``count`` backend compilations since
    # the previous round of an already-warm mode
    "recompile": (
        {"run_id": str, "count": int, "total": int},
        {"where": str, "expected": bool},
    ),
    # -- elastic membership (parallel/elastic.py) -----------------------
    # a worker left the averaging pool: killed by fault/plan, parked as
    # a straggler, or dropped past the staleness bound.  ``width`` is
    # the pool width AFTER the event; ``worker`` the stable worker id.
    "worker_lost": (
        {"run_id": str, "worker": int, "round": int, "width": int},
        {"reason": str, "staleness": int},
    ),
    # a worker entered the pool: fresh join (adopting the consensus
    # params+slots) or a straggler rejoining with its contribution
    # damped to ``weight`` = staleness_decay ** staleness
    "worker_joined": (
        {"run_id": str, "worker": int, "round": int, "width": int},
        {"staleness": int, "weight": _NUM, "reason": str},
    ),
    # the mesh re-formed at a new width (the membership changes above
    # say why); the elastic trainer re-places surviving replicas and
    # swaps to the cached per-width round program
    "mesh_resize": (
        {"run_id": str, "round": int, "from_width": int, "to_width": int},
        {"devices": int, "reason": str},
    ),
    # per-stage host-feed telemetry (data/pipeline.py): one aggregated
    # record per reporting window, ``stages`` mapping a stage name from
    # the docs/OBSERVABILITY.md "Feed stages" vocabulary (slot_wait /
    # source / decode / transform / write / put) to its summed wall
    # seconds — ``decode`` is the in-worker record/JPEG decode split out
    # of ``source`` so ring scaling is attributable per stage.
    # Entirely HOST-side work — feed walls carry span ``host`` semantics
    # (no fence stamp exists or is needed), and a feed stall in the
    # journal is attributable to exactly one stage.
    "feed": (
        {"run_id": str, "name": str, "batches": int, "images": int,
         "wall_s": _NUM, "stages": dict},
        {"images_per_sec": _NUM, "workers": int, "note": str,
         "lineage": dict},
    ),
    # a bench.py measurement, embedded whole under ``record`` (the
    # record's own keys are bench.py's contract, not re-specified here)
    "bench": (
        {"run_id": str, "metric": str, "measured": bool, "fenced": bool},
        {"record": dict, "wall_s": _NUM, "fence_value": _NUM},
    ),
    # one common.bank_guard write (the blessed evidence sink); measured
    # False means the payload was diverted to a temporary file with a rehearsal stamp
    "bank": (
        {"run_id": str, "path": str, "measured": bool},
        {"metric": str, "value": (int, float, type(None)),
         "rehearsal": bool},
    ),
    # one streaming-metrics snapshot (obs/metrics.py MetricsHub): the
    # hub folds every Recorder event into bounded-memory counters /
    # gauges / fixed-boundary log-bucket histograms and flushes the
    # CUMULATIVE state every ``flush_every`` observations — so the
    # report's p50/p99 and stage shares come from the LAST snapshot per
    # run, never from buffering raw ``request`` lines.  ``hists`` maps
    # metric name -> Histogram.snapshot() (count/sum/min/max/buckets);
    # snapshots of the same metric are exactly mergeable bucket-wise.
    "metrics": (
        {"run_id": str, "seq": int, "counters": dict, "hists": dict},
        {"gauges": dict, "note": str},
    ),
    "run_end": (
        {"run_id": str, "rounds": int, "spans": int, "compiles": int}, {},
    ),
    # -- serving engine (sparknet_tpu/serve) ----------------------------
    # one engine lifecycle event, discriminated by ``kind``:
    # model_loaded / load_refused (the priced-residency admission gate,
    # serve/residency.py — the serving twin of ``preflight_oom``) /
    # model_unloaded / shutdown / summary (a load-run roll-up) /
    # candidate_built / rollout / rollback (the hot-reload protocol,
    # sparknet_tpu/loop: ``version`` is the swap generation, ``drained``
    # the retiring model's in-flight requests served by its OWN
    # executables during the swap — the zero-dropped-tickets ledger)
    # ``shed`` events are THROTTLED: the engine aggregates rejected
    # tickets and emits one line per reporting interval with ``shed``
    # the count since the last line and ``projected_wait_ms`` the EWMA
    # queue-wait projection that tripped the gate — one line per
    # rejected ticket under saturation would swamp the journal.
    "serve": (
        {"run_id": str, "kind": str},
        {"model": str, "family": str, "arm": str, "buckets": list,
         "predicted_bytes": int, "resident_bytes": int,
         "budget_bytes": int, "requests": int, "batches": int,
         "padded": int, "compiles": int, "p50_ms": _NUM, "p99_ms": _NUM,
         "rps": _NUM, "wall_s": _NUM, "version": int, "drained": int,
         "shed": int, "projected_wait_ms": _NUM, "tick_ms": _NUM,
         "replicas": int, "dropped": int, "note": str, "lineage": dict},
    ),
    # -- replica router (sparknet_tpu/serve/router.py) ------------------
    # one pod-scale membership/lifecycle event, discriminated by
    # ``kind``: replica_up (a ServedModel copy joined the pool — fresh
    # boot or elastic join copying the live weights) / replica_down
    # (killed or drained; ``rerouted`` counts the in-flight tickets
    # stolen from its batcher and adopted by a survivor — the
    # zero-dropped-tickets ledger at pod scope) / resize (the serving
    # mesh re-cut via sized_data_mesh, mirroring elastic's mesh_resize)
    # / rollout (per-replica hot-swap under load, the engine's candidate
    # protocol) / summary (an aggregate load-run roll-up: ``rps`` is
    # pod throughput, ``shed`` the deadline-shed total, ``dropped``
    # MUST be 0).
    "replica": (
        {"run_id": str, "kind": str},
        {"replica": int, "model": str, "family": str, "arm": str,
         "width": int, "from_width": int, "to_width": int,
         "rerouted": int, "outstanding": int, "version": int,
         "drained": int, "requests": int, "shed": int, "dropped": int,
         "predicted_bytes": int, "resident_bytes": int, "rps": _NUM,
         "p50_ms": _NUM, "p99_ms": _NUM, "wall_s": _NUM, "note": str,
         "lineage": dict},
    ),
    # -- production loop (sparknet_tpu/loop) ----------------------------
    # one train-to-serve loop lifecycle event, discriminated by
    # ``kind``: checkpoint (atomic solverstate write after
    # sync_to_solver) / candidate (deploy-arm variables read back from
    # the checkpoint artifact) / rollout / rollback (mirrors of the
    # engine's serve events, carrying the loop's round/iteration
    # provenance) / refused (AdmissionRefused candidate — incumbent
    # keeps serving, journaled not fatal) / summary (a loop-run
    # roll-up).  ``version`` is the serve-side swap generation;
    # ``path`` the checkpoint artifact a candidate was built from.
    "loop": (
        {"run_id": str, "kind": str},
        {"model": str, "family": str, "arm": str, "round": int,
         "iteration": int, "version": int, "path": str,
         "loss": _NUM, "wall_s": _NUM, "drained": int, "requests": int,
         "compiles": int, "rollouts": int, "rollbacks": int,
         "checkpoints": int, "note": str, "lineage": dict},
    ),
    # -- control plane (sparknet_tpu/loop/autoctl.py + obs/burn.py) -----
    # one burn-engine / SLOController lifecycle event, discriminated by
    # ``kind``: observe (a multi-window burn evaluation — ``gates`` is
    # the per-gate list of {id, fast, slow, burning, suspended} dicts) /
    # decide (a proposed action with its triggering gate + burn rates) /
    # act (the action EXECUTED through the control plane, with the
    # width/replica/version outcome) / cooldown (a decision suppressed
    # by hysteresis — at most one line per cooldown window) / summary
    # (a controller-run roll-up).  ``t`` is the controller clock
    # (virtual seconds in scenario replay, perf_counter live).
    "ctl": (
        {"run_id": str, "kind": str},
        {"gate": str, "gates": list, "burning": list, "action": str,
         "reason": str, "fast": _NUM, "slow": _NUM, "value": _NUM,
         "bound": _NUM, "t": _NUM, "cooldown_s": _NUM, "scenario": str,
         "replicas": int, "replica": int, "width": int,
         "from_width": int, "to_width": int, "count": int, "round": int,
         "fits": bool, "rerouted": int, "version": int, "ok": bool,
         "observes": int, "decides": int, "acts": int, "cooldowns": int,
         "refused": int, "predicted_bytes": int, "budget_bytes": int,
         "note": str, "lineage": dict},
    ),
    # -- token serving (sparknet_tpu/serve/paged.py) --------------------
    # one paged-decode lifecycle event, discriminated by ``kind``:
    # prefill (one ladder-bucket prompt forward — ``rows`` live rows
    # riding ``bucket``, block-pool gauges after the K/V writes) /
    # request (one drained generation's latency decomposition: ttft_ms
    # is submit -> first token, inter_token_* the per-step cadence the
    # flat-±20% acceptance gate reads) / admission_refused (the decode
    # plane priced itself out of HBM BEFORE any compile — the
    # serve/residency.py stance) / summary (a drained-run roll-up:
    # ``compiles`` MUST be 0 post-warmup, ``leaked`` and ``dropped``
    # MUST be 0 — the zero-leak ledger).
    "token": (
        {"run_id": str, "kind": str},
        {"tokens": int, "prompt_tokens": int, "rows": int, "bucket": int,
         "requests": int, "steps": int, "prefills": int, "compiles": int,
         "ttft_ms": _NUM, "total_ms": _NUM, "inter_token_p50_ms": _NUM,
         "inter_token_max_ms": _NUM, "wall_ms": _NUM, "wall_s": _NUM,
         "tokens_per_sec": _NUM, "occupancy": int, "replicas": int,
         "allocated": int, "freed": int, "leaked": int, "dropped": int,
         "blocks_free": int, "blocks_total": int,
         "predicted_bytes": int, "budget_bytes": int,
         "note": str, "lineage": dict},
    ),
    # one served request's latency decomposition (the p50/p99 material):
    # queue_wait (submit -> flush) + batch_assembly (pad/fill) + device
    # (executable call, fence included) = total.  ``bucket`` is the
    # ladder bucket the request rode; ``padded`` whether the batch
    # carried dead rows; ``deadline_flush`` whether max_wait_ms (not a
    # full bucket) triggered the flush.
    "request": (
        {"run_id": str, "model": str, "bucket": int,
         "queue_wait_ms": _NUM, "batch_assembly_ms": _NUM,
         "device_ms": _NUM, "total_ms": _NUM},
        {"batch_n": int, "padded": bool, "deadline_flush": bool,
         "note": str, "lineage": dict},
    ),
}

# Known-deviant legacy lines, forgiven explicitly (never silently): each
# entry names the journal (path suffix), the event, the exact error
# prefix being excused, and why.
LEGACY_ALLOWLIST: tuple[dict, ...] = (
    {
        "journal": "docs/evidence_r3/journal.jsonl",
        "event": "dial_start",
        "error": "missing required field 'probe'",
        "reason": "round-3 journal predates per-dial probe ids "
                  "(introduced for r4 provenance matching)",
    },
    {
        "journal": "docs/evidence_r3/journal.jsonl",
        "event": "dial_end",
        "error": "missing required field 'probe'",
        "reason": "round-3 journal predates per-dial probe ids "
                  "(introduced for r4 provenance matching)",
    },
)


def utc_now() -> str:
    """The journal wall stamp, in the format every round has used."""
    return time.strftime(_UTC_FMT, time.gmtime())


def _type_name(spec) -> str:
    types = spec if isinstance(spec, tuple) else (spec,)
    return "|".join("null" if t is type(None) else t.__name__
                    for t in types)


def _check_fields(event: str, obj: dict) -> list[str]:
    required, optional = EVENTS[event]
    errors: list[str] = []
    for field, spec in required.items():
        if field not in obj:
            errors.append(f"missing required field {field!r}")
        elif not isinstance(obj[field], spec):
            errors.append(
                f"field {field!r} is {type(obj[field]).__name__}, "
                f"schema wants {_type_name(spec)}")
    for field, value in obj.items():
        if field in ("event", "utc") or field in required:
            continue
        if field not in optional:
            errors.append(f"unknown field {field!r} for event {event!r}")
        elif not isinstance(value, optional[field]):
            errors.append(
                f"field {field!r} is {type(value).__name__}, "
                f"schema wants {_type_name(optional[field])}")
    return errors


def validate_line(obj: Any) -> list[str]:
    """Schema errors for one parsed journal line (empty list = valid)."""
    if not isinstance(obj, dict):
        return ["line is not a JSON object"]
    event = obj.get("event")
    if not isinstance(event, str):
        return ["missing 'event' discriminator"]
    if event not in EVENTS:
        return [f"unknown event {event!r}"]
    errors = _check_fields(event, obj)
    utc = obj.get("utc")
    if not isinstance(utc, str) or not _UTC_RE.match(utc):
        errors.append("missing or malformed 'utc' stamp "
                      "(want 'YYYY-MM-DD HH:MM:SSZ')")
    return errors


def make_event(event: str, **fields) -> dict:
    """Build one validated journal line (stamps ``utc``; raises
    ValueError on any schema violation — writers fail loudly at build
    time instead of banking unreadable evidence)."""
    line = {"event": event, **fields}
    line.setdefault("utc", utc_now())
    errors = validate_line(line)
    if errors:
        raise ValueError(
            f"journal line for event {event!r} violates the obs schema: "
            + "; ".join(errors))
    return line


def _allowlisted(path: str, event: str, error: str,
                 allowlist: tuple) -> bool:
    norm = path.replace("\\", "/")
    for entry in allowlist:
        if (norm.endswith(entry["journal"]) and event == entry["event"]
                and error.startswith(entry["error"])):
            return True
    return False


def validate_journal(
    path: str, allowlist: tuple = LEGACY_ALLOWLIST,
) -> tuple[int, int, list[str]]:
    """Validate every line of a journal file.

    Returns ``(n_lines, n_allowlisted, errors)`` where ``errors`` holds
    one ``"path:lineno: message"`` string per non-allowlisted violation.
    Unparseable lines are errors too — the runner appends atomically
    enough that a torn line means something worth knowing about.
    """
    n_lines = 0
    n_allowlisted = 0
    errors: list[str] = []
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, start=1):
            if not raw.strip():
                continue
            n_lines += 1
            try:
                obj = json.loads(raw)
            except ValueError as e:
                errors.append(f"{path}:{lineno}: unparseable JSON ({e})")
                continue
            line_errors = validate_line(obj)
            if not line_errors:
                continue
            event = obj.get("event") if isinstance(obj, dict) else None
            kept = [e for e in line_errors
                    if not _allowlisted(path, str(event), e, allowlist)]
            if len(kept) < len(line_errors):
                n_allowlisted += 1
            errors.extend(f"{path}:{lineno}: [{event}] {e}" for e in kept)
    return n_lines, n_allowlisted, errors


def load_journal(path: str) -> list[dict]:
    """Parse a journal into event dicts, best-effort (renderers want
    whatever landed; use :func:`validate_journal` for the strict view).
    Unparseable lines are dropped here — and counted as errors there."""
    events: list[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict):
                    events.append(obj)
    except OSError:
        pass
    return events


def stream_journal(path: str) -> Iterator[dict]:
    """Event dicts in file order WITHOUT buffering the file (the
    bounded-memory twin of :func:`load_journal` — ``obs top`` and the
    report's request aggregation ride this).  Best-effort like
    :func:`load_journal`: torn lines are skipped here, counted by
    :func:`validate_journal`."""
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict):
                    yield obj
    except OSError:
        return


def iter_events(path: str, event: str) -> Iterator[dict]:
    """Events of one kind from a journal, in file order."""
    for obj in stream_journal(path):
        if obj.get("event") == event:
            yield obj
