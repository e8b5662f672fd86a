"""Declarative SLOs: the repo's health gates as one checked-in manifest.

Counterpart of ``sparknet_tpu/obs/slo.py``, copied whole.  It loads the
repo's ``docs/slo_manifest.json`` (a file of the repo, read at its path
from this checkout's root, not a module of the JAX package) and evaluates
each gate against a journal's events: warm queue p99 under its deadline
bound, a feed stage's share of the staged wall, post-warmup compiles ==
0 (on the port: CUDA graph captures on the request path), the zero-drop
ledger == 0, measured throughput under its stated roofline, and TTFT p99.

Gates are VACUOUS (pass, not applicable) when the journal has no subject
events, and the verdict says so.

Deliberately stdlib-only.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

from sparknet_tpu_torch.obs import metrics as _metrics

__all__ = [
    "DEFAULT_MANIFEST",
    "default_manifest_path",
    "load_manifest",
    "evaluate",
    "evaluate_journal",
    "verdict_fields",
]

DEFAULT_MANIFEST = os.path.join("docs", "slo_manifest.json")


def default_manifest_path() -> str:
    """The checked-in manifest, resolved relative to the repo root
    (this file lives at ``sparknet_tpu_torch/obs/slo.py``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, DEFAULT_MANIFEST)


def load_manifest(path: str | None = None) -> dict:
    with open(path or default_manifest_path(), encoding="utf-8") as f:
        manifest = json.load(f)
    if not isinstance(manifest.get("slos"), list):
        raise ValueError("SLO manifest must carry a 'slos' list")
    return manifest


# -- gate evaluators ----------------------------------------------------
# Each takes (spec, events) and returns (applicable, ok, value, bound,
# detail).  "applicable" False means no subject events: the gate passes
# vacuously and the verdict says so.


# lifecycle kinds that re-cut the pool or stall the pump mid-traffic:
# a journal containing any of these is a FAULT/ROLLOUT specimen, not a
# steady-state latency specimen — its promises are the zero-drop ledger
# and the compile sentinel, and queue waits around the disturbance are
# elevated BY DESIGN (the injected kill's backlog, the checkpoint's
# host-side AOT build sharing the core with the pump)
_DISTURBANCES = {
    "replica": ("replica_down", "replica_up", "resize", "rollout"),
    "serve": ("rollout", "rollback", "candidate_built"),
    "loop": ("checkpoint", "candidate", "rollout", "rollback",
             "refused"),
}


def _gate_warm_queue_p99(spec: dict, events: list[dict]):
    """Warm queue-wait p99 ≤ the deadline bound, on STEADY-STATE
    journals only.  "Warm" skips each (model, bucket) group's first
    ``warmup_requests`` tickets — load compiles are by design; what
    must hold the bound is steady traffic.  A journal carrying
    mid-traffic disturbances (kill/join/swap/checkpoint) suspends this
    gate: those legs elevate queue waits by design and are held to the
    zero-drop and compiles-zero gates instead.  Aggregated through the
    same fixed-boundary histogram the metrics hub uses (≤ ~5.93%
    conservative-side estimate error)."""
    warmup = int(spec.get("warmup_requests", 8))
    bound = float(spec.get("max_ms", 40.0))
    for ev in events:
        kinds = _DISTURBANCES.get(ev.get("event"))
        if kinds and ev.get("kind") in kinds:
            return False, True, None, bound, (
                f"{ev.get('event')}/{ev.get('kind')} disturbance "
                "mid-traffic — steady-state latency gate suspended "
                "(fault legs answer to zero-drop and compiles-zero)")
    seen: dict[tuple, int] = {}
    hist = _metrics.Histogram()
    for ev in events:
        if ev.get("event") != "request":
            continue
        key = (ev.get("model"), ev.get("bucket"))
        n = seen.get(key, 0)
        seen[key] = n + 1
        if n < warmup:
            continue
        wait = ev.get("queue_wait_ms")
        if isinstance(wait, (int, float)):
            hist.observe(wait)
    if hist.count == 0:
        return False, True, None, bound, "no post-warmup request events"
    p99 = _metrics.percentile(hist.snapshot(), 99.0)
    return True, p99 <= bound, round(p99, 3), bound, (
        f"warm queue p99 {p99:.3f} ms over {hist.count} requests")


def _gate_feed_stage_share(spec: dict, events: list[dict]):
    """One feed stage's share of total staged wall ≤ ``max_share``
    (the on-chip starvation gate: ``slot_wait`` ≤ 5%)."""
    stage = str(spec.get("stage", "slot_wait"))
    bound = float(spec.get("max_share", 0.05))
    stage_s = 0.0
    total_s = 0.0
    for ev in events:
        if ev.get("event") != "feed":
            continue
        stages = ev.get("stages")
        if not isinstance(stages, dict):
            continue
        for name, secs in stages.items():
            if not isinstance(secs, (int, float)):
                continue
            total_s += secs
            if name == stage:
                stage_s += secs
    if total_s <= 0.0:
        return False, True, None, bound, "no staged feed events"
    share = stage_s / total_s
    return True, share <= bound, round(share, 4), bound, (
        f"{stage} {stage_s:.3f}s of {total_s:.3f}s staged wall")


def _gate_compiles_zero(spec: dict, events: list[dict]):
    """Post-warmup compiles == 0: no unexpected ``recompile`` events
    and every serve/loop summary's post-warmup compile counter is 0
    (load/AOT compiles are by design and never counted here)."""
    recompiles = 0
    summary_compiles = 0
    applicable = False
    for ev in events:
        kind = ev.get("event")
        if kind == "recompile":
            applicable = True
            if not ev.get("expected"):
                recompiles += ev.get("count", 1)
        elif kind in ("serve", "loop", "token") and \
                ev.get("kind") == "summary":
            c = ev.get("compiles")
            if isinstance(c, int):
                applicable = True
                summary_compiles += c
        elif kind == "round":
            # rounds exist -> the sentinel was live; zero recompile
            # events is then a real (not vacuous) pass
            applicable = True
    total = recompiles + summary_compiles
    if not applicable:
        return False, True, None, 0, "no compile-sentinel events"
    return True, total == 0, total, 0, (
        f"{recompiles} unexpected recompiles, "
        f"{summary_compiles} post-warmup summary compiles")


def _gate_dropped_zero(spec: dict, events: list[dict]):
    """The zero-drop ledger: every serve/replica/loop event carrying
    ``dropped`` (submitted − resolved) must say 0."""
    total = 0
    applicable = False
    for ev in events:
        if ev.get("event") in ("serve", "replica", "loop", "token"):
            dropped = ev.get("dropped")
            if isinstance(dropped, int):
                applicable = True
                total += dropped
    if not applicable:
        return False, True, None, 0, "no drop-ledger events"
    return True, total == 0, total, 0, "summed over drop-ledger events"


def _gate_bench_roofline(spec: dict, events: list[dict]):
    """Measured throughput ≤ its own stated roofline bound (never a
    value above its own bound, machine-checked): every measured bench
    record carrying both ``value`` and ``roofline_img_s_upper_bound``
    must sit at or under the bound."""
    burns: list[str] = []
    applicable = False
    worst = None
    for ev in events:
        if ev.get("event") != "bench":
            continue
        record = ev.get("record")
        if not isinstance(record, dict) or not ev.get("measured"):
            continue
        value = record.get("value")
        bound = record.get("roofline_img_s_upper_bound")
        if not isinstance(value, (int, float)) or \
                not isinstance(bound, (int, float)):
            continue
        applicable = True
        frac = value / bound if bound > 0 else float("inf")
        worst = frac if worst is None else max(worst, frac)
        if value > bound:
            burns.append(f"{record.get('metric', '?')}: "
                         f"{value} > roofline {bound}")
    if not applicable:
        return False, True, None, 1.0, "no bounded measured bench events"
    detail = "; ".join(burns) if burns else "all measured values under bound"
    return True, not burns, round(worst, 4), 1.0, detail


def _gate_ttft_p99(spec: dict, events: list[dict]):
    """Time-to-first-token p99 ≤ its bound over paged token serving
    (serve/paged.py ``token`` request events).  "Warm" skips the first
    ``warmup_requests`` generations — their TTFT includes admission
    backlog behind the cold start; what must hold the bound is steady
    token traffic.  Vacuous on journals with no token events (every
    pre-existing specimen).  Same fixed-boundary histogram as the
    queue-wait gate (≤ ~5.93% conservative-side estimate error)."""
    warmup = int(spec.get("warmup_requests", 8))
    bound = float(spec.get("max_ms", 250.0))
    hist = _metrics.Histogram()
    seen = 0
    for ev in events:
        if ev.get("event") != "token" or ev.get("kind") != "request":
            continue
        seen += 1
        if seen <= warmup:
            continue
        ttft = ev.get("ttft_ms")
        if isinstance(ttft, (int, float)):
            hist.observe(ttft)
    if hist.count == 0:
        return False, True, None, bound, "no post-warmup token requests"
    p99 = _metrics.percentile(hist.snapshot(), 99.0)
    return True, p99 <= bound, round(p99, 3), bound, (
        f"TTFT p99 {p99:.3f} ms over {hist.count} generations")


_GATES = {
    "warm_queue_p99": _gate_warm_queue_p99,
    "ttft_p99": _gate_ttft_p99,
    "feed_stage_share": _gate_feed_stage_share,
    "compiles_zero": _gate_compiles_zero,
    "dropped_zero": _gate_dropped_zero,
    "bench_roofline": _gate_bench_roofline,
}


def evaluate(events: Iterable[dict], manifest: dict) -> list[dict]:
    """Evaluate every manifest gate against one journal's events.
    Returns one result dict per gate: ``{"id", "kind", "ok",
    "applicable", "value", "bound", "detail"}``."""
    events = list(events)
    results: list[dict] = []
    for spec in manifest["slos"]:
        kind = spec.get("kind")
        gate = _GATES.get(kind)
        if gate is None:
            results.append({
                "id": spec.get("id", "?"), "kind": kind, "ok": False,
                "applicable": True, "value": None, "bound": None,
                "detail": f"unknown gate kind {kind!r} "
                          "(manifest newer than evaluator?)"})
            continue
        applicable, ok, value, bound, detail = gate(spec, events)
        if not applicable and ok:
            # vacuous-pass visibility: a subject-free journal must not
            # read identically to a measured green when cited as
            # evidence
            detail = f"vacuous pass — {detail}"
        results.append({
            "id": spec.get("id", kind), "kind": kind, "ok": bool(ok),
            "applicable": bool(applicable), "value": value,
            "bound": bound, "detail": detail})
    return results


def evaluate_journal(path: str,
                     manifest: dict | None = None) -> list[dict]:
    from sparknet_tpu_torch.obs import schema

    if manifest is None:
        manifest = load_manifest()
    return evaluate(schema.stream_journal(path), manifest)


def verdict_fields(job: str, results: list[dict], *,
                   journal: str | None = None,
                   manifest_path: str | None = None) -> dict:
    """The ``slo`` journal event's fields for one evaluated job (the
    window runner writes this through schema.make_event)."""
    burned = [r["id"] for r in results if not r["ok"]]
    vacuous = [r["id"] for r in results
               if r["ok"] and not r["applicable"]]
    fields: dict = {
        "job": job,
        "ok": not burned,
        "gates": len(results),
        "applicable": sum(1 for r in results if r["applicable"]),
    }
    if burned:
        fields["burned"] = burned
    if vacuous:
        # name the gates that passed with zero subject events so the
        # verdict line itself says which greens are unmeasured
        fields["vacuous"] = vacuous
    if journal:
        fields["journal"] = journal
    if manifest_path:
        fields["manifest"] = manifest_path
    return fields
