"""Render an obs journal into a markdown run report.

Counterpart of ``sparknet_tpu/obs/report.py``, copied whole: the port
writes the JAX package's journal format (``obs/schema.py``), and this
renderer gives the same bytes as the JAX one for the same journal, its
header line included (it names the renderer and the schema the format is
defined by).  Deterministic markdown from JSONL, safe to regenerate,
honest about what is and is not evidence.  Two refusals are
load-bearing:

* **Unstamped walls are refused.**  A span or round journaled with
  ``fenced: false`` (and not declared ``host``) renders with its wall
  withheld: a wall that no value read fenced can be the host's enqueue,
  not the device's work.
* **No throughput above its stated roofline bound.**  A bench record
  whose value exceeds its own ``roofline_img_s_upper_bound`` (or that
  carries a ``bound_inconsistency``) renders as a named conflict, never
  as a headline number.

Memory is bounded: ``request`` events are folded into fixed-boundary
log-bucket histograms (``obs/metrics.py``) as they stream past, so the
latency table is O(models x buckets), never O(requests).  Every event
name in the schema vocabulary renders somewhere in this module, the
TPU window runner's ledger events included.  ``lineage=True`` adds the
causal waterfall (``obs/lineage.py``): the last round and the last
request walked up their parent edges to a root.

Deliberately stdlib-only.
"""

from __future__ import annotations

from typing import Iterable

from sparknet_tpu_torch.obs import metrics as obs_metrics
from sparknet_tpu_torch.obs import schema

__all__ = ["render", "render_path"]

# window-runner events carry no run_id: they are the host-side evidence
# ledger (tools/tpu_window_runner.py) and render as one flat timeline
_RUNNER_EVENTS = ("runner_start", "dial_start", "dial_end",
                  "dial_abandoned", "job_start", "job_end",
                  "queue_reload_failed", "preflight_oom", "setup_failed",
                  "slo", "sched", "runner_done")


def _fmt_comm(comm: dict) -> str:
    """One cell for the round's comm_model-predicted budget."""
    predicted = comm.get("predicted") or {}
    parts = []
    for kind in sorted(predicted):
        window = predicted[kind]
        if window is None:
            parts.append(f"{kind} (presence)")
        else:
            lo, hi = window
            parts.append(f"{kind} {lo:,}–{hi:,} B")
    return "; ".join(parts) if parts else "—"


def _round_rows(rounds: list[dict]) -> list[str]:
    lines = [
        "| # | mode | tau | devices | iters | batch | wall s | img/s "
        "| loss | loss EMA | predicted comm | compiles |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, ev in enumerate(rounds, start=1):
        if ev.get("fenced"):
            wall = f"{ev.get('wall_s', 0):.3f}"
            ips = f"{ev.get('images_per_sec', 0):,.1f}"
        else:
            # an unstamped wall is not evidence on relay backends
            wall = "REFUSED"
            ips = "REFUSED (unfenced)"
        lines.append(
            f"| {i} | {ev.get('mode', '?')} | {ev.get('tau', '?')} "
            f"| {ev.get('devices', '?')} | {ev.get('iters', '?')} "
            f"| {ev.get('batch', '?')} | {wall} | {ips} "
            f"| {ev.get('loss', float('nan')):.4f} "
            f"| {ev.get('loss_ema', float('nan')):.4f} "
            f"| {_fmt_comm(ev.get('comm') or {})} "
            f"| {ev.get('compiles', 0)} |")
    return lines


def _span_rows(spans: list[dict]) -> list[str]:
    lines = [
        "| span | wall s | fence |",
        "|---|---|---|",
    ]
    for ev in spans:
        name = ev.get("name", "?")
        if ev.get("host"):
            wall = f"{ev.get('wall_s', 0):.3f}"
            fence = "host-side (no device work)"
        elif ev.get("fenced"):
            wall = f"{ev.get('wall_s', 0):.3f}"
            fv = ev.get("fence_value")
            fence = "value-stamped" if fv is None else f"value={fv:g}"
        else:
            wall = "—"
            fence = "REFUSED: span closed without a fence stamp"
        lines.append(f"| {name} | {wall} | {fence} |")
    return lines


def _feed_rows(feeds: list[dict]) -> list[str]:
    """Per-stage feed telemetry (host-side walls — no fence applies;
    the table's value is ATTRIBUTION: which stage ate the wall)."""
    stage_names = ["slot_wait", "source", "decode", "transform", "write",
                   "put"]
    lines = [
        "| feed | batches | images | wall s | img/s | "
        + " | ".join(f"{s} s" for s in stage_names) + " |",
        "|---|---|---|---|---|" + "---|" * len(stage_names),
    ]
    for ev in feeds:
        stages = ev.get("stages") or {}
        ips = ev.get("images_per_sec")
        ips_cell = f"{ips:,.1f}" if isinstance(ips, (int, float)) else "—"
        cells = " | ".join(
            f"{stages[s]:.3f}" if isinstance(stages.get(s), (int, float))
            else "—" for s in stage_names)
        lines.append(
            f"| {ev.get('name', '?')} | {ev.get('batches', '?')} "
            f"| {ev.get('images', '?')} | {ev.get('wall_s', 0):.3f} "
            f"| {ips_cell} | {cells} |")
    return lines


def _member_rows(members: list[dict]) -> list[str]:
    """Elastic membership timeline (parallel/elastic.py): every pool
    change with its reason — a journal reader can reconstruct the mesh
    width at any round from this table alone."""
    lines = [
        "| round | event | worker | width | detail |",
        "|---|---|---|---|---|",
    ]
    for ev in members:
        kind = ev.get("event", "?")
        if kind == "mesh_resize":
            detail = (f"{ev.get('from_width', '?')} -> "
                      f"{ev.get('to_width', '?')} worker(s)")
            worker = "—"
            width = ev.get("to_width", "?")
        else:
            bits = []
            if ev.get("staleness") is not None:
                bits.append(f"staleness {ev['staleness']}")
            if ev.get("weight") is not None:
                bits.append(f"weight {ev['weight']:g}")
            if ev.get("reason"):
                bits.append(ev["reason"])
            detail = "; ".join(bits) or "—"
            worker = ev.get("worker", "?")
            width = ev.get("width", "?")
        lines.append(
            f"| {ev.get('round', '?')} | {kind} | {worker} "
            f"| {width} | {detail} |")
    return lines


def _serve_lines(serves: list[dict]) -> list[str]:
    """Engine lifecycle: loads, priced refusals, drains — the serving
    twin of the runner's preflight_oom lines."""
    lines = []
    for ev in serves:
        kind = ev.get("kind", "?")
        who = ev.get("model", "?")
        fam = ev.get("family")
        arm = ev.get("arm")
        label = who if fam is None else f"{who} ({fam}/{arm})"
        if kind == "load_refused":
            lines.append(
                f"- **REFUSED load** `{label}`: predicted "
                f"{ev.get('predicted_bytes', 0):,} B next to "
                f"{ev.get('resident_bytes', 0):,} B resident exceeds "
                f"the {ev.get('budget_bytes', 0):,} B usable-HBM budget "
                "— refused before any compile")
        elif kind == "model_loaded":
            lines.append(
                f"- loaded `{label}` buckets {ev.get('buckets', [])}, "
                f"priced {ev.get('predicted_bytes', 0):,} B "
                f"({ev.get('resident_bytes', 0):,} B now resident), "
                f"all buckets AOT-compiled in "
                f"{ev.get('wall_s', 0):.1f} s")
        elif kind == "shutdown":
            lines.append(
                f"- shutdown drain served {ev.get('requests', 0)} "
                "in-flight request(s) — zero lost")
        elif kind == "rollout":
            lines.append(
                f"- **ROLLOUT** `{label}` -> version "
                f"{ev.get('version', '?')}: hot swap in "
                f"{ev.get('wall_s', 0):.4f} s, incumbent drained "
                f"{ev.get('drained', 0)} ticket(s) with its own "
                "executables")
        elif kind == "rollback":
            lines.append(
                f"- **ROLLBACK** `{label}` -> version "
                f"{ev.get('version', '?')}: previous ServedModel "
                f"restored bitwise, {ev.get('drained', 0)} ticket(s) "
                "drained")
        elif kind == "candidate_built":
            lines.append(
                f"- candidate built `{label}` buckets "
                f"{ev.get('buckets', [])}, AOT-compiled on the builder "
                f"thread in {ev.get('wall_s', 0):.1f} s")
        else:
            note = ev.get("note")
            detail = f" — {note}" if note else ""
            lines.append(f"- {kind} `{label}`{detail}")
    return lines


def _replica_lines(replicas: list[dict]) -> list[str]:
    """Pod membership and lifecycle: joins, kills (with the re-routed
    ticket ledger — the zero-drop proof), per-replica rollouts, and the
    aggregate load-run summary (serve/router.py)."""
    lines = []
    for ev in replicas:
        kind = ev.get("kind", "?")
        rep = ev.get("replica")
        who = f"replica {rep}" if rep is not None else "pool"
        if kind == "replica_up":
            note = ev.get("note")
            how = f" ({note})" if note else ""
            lines.append(
                f"- **UP** {who}: joined the pool at width "
                f"{ev.get('width', '?')}{how}")
        elif kind == "replica_down":
            lines.append(
                f"- **DOWN** {who}: {ev.get('rerouted', 0)} in-flight "
                f"ticket(s) re-routed to survivors (outstanding "
                f"{ev.get('outstanding', 0)}, dropped "
                f"{ev.get('dropped', 0)}), pool width now "
                f"{ev.get('width', '?')}")
        elif kind == "resize":
            lines.append(
                f"- resize {ev.get('from_width', '?')} -> "
                f"{ev.get('to_width', '?')}: serving mesh re-cut, "
                "replicas re-placed")
        elif kind == "rollout":
            lines.append(
                f"- rollout {who} -> version {ev.get('version', '?')}: "
                f"hot swap under load, incumbent drained "
                f"{ev.get('drained', 0)} ticket(s)")
        elif kind == "summary":
            lines.append(
                f"- summary: width {ev.get('width', '?')}, "
                f"{ev.get('requests', 0)} request(s) at "
                f"{ev.get('rps', 0):g} req/s aggregate, "
                f"{ev.get('shed', 0)} shed, "
                f"{ev.get('dropped', 0)} dropped, "
                f"{ev.get('rerouted', 0)} re-routed")
        else:
            note = ev.get("note")
            detail = f" — {note}" if note else ""
            lines.append(f"- {kind} {who}{detail}")
    return lines


def _loop_lines(loops: list[dict]) -> list[str]:
    """Production-loop transitions: checkpoints, rollouts, rollbacks,
    refusals — the train-to-serve narrative over the serve lifecycle."""
    lines = []
    for ev in loops:
        kind = ev.get("kind", "?")
        who = ev.get("model", "?")
        if kind == "checkpoint":
            lines.append(
                f"- checkpoint @ round {ev.get('round', '?')} (iter "
                f"{ev.get('iteration', '?')}) -> `{ev.get('path', '?')}`"
                " — atomic npz commit")
        elif kind == "rollout":
            lines.append(
                f"- rollout `{who}` -> version {ev.get('version', '?')}"
                f" from round {ev.get('round', '?')} checkpoint "
                f"({ev.get('drained', 0)} in-flight ticket(s) drained)")
        elif kind == "rollback":
            lines.append(
                f"- rollback `{who}` -> version {ev.get('version', '?')}"
                " — previous generation restored bitwise")
        elif kind == "refused":
            lines.append(
                f"- **REFUSED rollout** `{who}` — "
                f"{ev.get('note', 'admission pricing')}")
        elif kind == "summary":
            lines.append(
                f"- summary: {ev.get('round', 0)} elastic round(s), "
                f"{ev.get('rollouts', 0)} rollout(s), "
                f"{ev.get('rollbacks', 0)} rollback(s), "
                f"{ev.get('checkpoints', 0)} checkpoint(s), "
                f"{ev.get('compiles', 0)} serving-path compile(s)")
        else:
            note = ev.get("note")
            detail = f" — {note}" if note else ""
            lines.append(f"- {kind} `{who}`{detail}")
    return lines


class _RequestAgg:
    """Bounded-memory ``request`` roll-up per model x bucket: three
    fixed-boundary log-bucket histograms (obs/metrics.py) plus two
    counters — O(groups x buckets) however many requests stream past.
    Estimates carry the Histogram contract: within one bucket width
    (~5.93% relative) of exact nearest-rank, never under a tail."""

    __slots__ = ("groups",)

    def __init__(self) -> None:
        self.groups: dict[tuple, dict] = {}

    def fold(self, ev: dict) -> None:
        key = (str(ev.get("model", "?")), int(ev.get("bucket", 0)))
        grp = self.groups.get(key)
        if grp is None:
            grp = self.groups[key] = {
                "n": 0, "total": obs_metrics.Histogram(),
                "queue": obs_metrics.Histogram(),
                "device": obs_metrics.Histogram(),
                "deadline": 0, "padded": 0}
        grp["n"] += 1
        grp["total"].observe(float(ev.get("total_ms", 0)))
        grp["queue"].observe(float(ev.get("queue_wait_ms", 0)))
        grp["device"].observe(float(ev.get("device_ms", 0)))
        if ev.get("deadline_flush"):
            grp["deadline"] += 1
        if ev.get("padded"):
            grp["padded"] += 1


def _request_rows(agg: _RequestAgg) -> list[str]:
    """The per-request latency roll-up per model x bucket: p50/p99
    totals plus the stage decomposition's tails, read off log-bucket
    histograms — never a buffered list of raw requests.  Host+device
    walls measured engine-side; the device stage is fence-stamped by its
    serve_device span."""
    lines = [
        "Log-bucket estimates (obs/metrics.py: within ~5.93% of exact "
        "nearest-rank, exact at the extremes, never under a tail).",
        "",
        "| model | bucket | requests | p50 total ms | p99 total ms "
        "| p99 queue ms | p50 device ms | deadline flushes | padded |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (model, bucket) in sorted(agg.groups):
        grp = agg.groups[(model, bucket)]
        p50t = obs_metrics.percentile(grp["total"].snapshot(), 50)
        p99t = obs_metrics.percentile(grp["total"].snapshot(), 99)
        p99q = obs_metrics.percentile(grp["queue"].snapshot(), 99)
        p50d = obs_metrics.percentile(grp["device"].snapshot(), 50)
        lines.append(
            f"| {model} | {bucket} | {grp['n']} "
            f"| {p50t:.3f} | {p99t:.3f} "
            f"| {p99q:.3f} | {p50d:.3f} "
            f"| {grp['deadline']} | {grp['padded']} |")
    return lines


def _metrics_lines(ev: dict) -> list[str]:
    """One cumulative streaming-metrics snapshot — the run's LAST (hub
    state is cumulative, so the last flush supersedes; merging is for
    ACROSS runs): counters, gauges, per-histogram percentile estimates."""
    lines = [f"Cumulative snapshot seq {ev.get('seq', '?')} "
             "(the last flush of the run supersedes earlier ones)."]
    counters = ev.get("counters") or {}
    gauges = ev.get("gauges") or {}
    hists = ev.get("hists") or {}
    if counters or gauges:
        lines += ["", "| metric | kind | value |", "|---|---|---|"]
        for name in sorted(counters):
            value = counters[name]
            cell = f"{value:g}" if isinstance(value, float) else str(value)
            lines.append(f"| {name} | counter | {cell} |")
        for name in sorted(gauges):
            lines.append(f"| {name} | gauge | {gauges[name]:g} |")
    if hists:
        lines += ["", "| histogram | count | p50 | p99 | min | max |",
                  "|---|---|---|---|---|---|"]
        for name in sorted(hists):
            snap = hists[name]
            cells = [obs_metrics.percentile(snap, 50),
                     obs_metrics.percentile(snap, 99),
                     snap.get("min"), snap.get("max")]
            shown = " | ".join(
                "—" if c is None else f"{c:.3f}" for c in cells)
            lines.append(f"| {name} | {snap.get('count', 0)} "
                         f"| {shown} |")
    return lines


def _slo_lines(ev: dict) -> list[str]:
    """One SLO verdict (obs/slo.py, journaled by the window runner):
    which gates were applicable, the burn list when any failed, and
    which greens passed VACUOUSLY (zero subject events) — a reader
    citing this verdict as evidence must see which gates never
    measured anything."""
    burned = ev.get("burned") or []
    vacuous = ev.get("vacuous") or []
    verdict = "PASS" if ev.get("ok") else "**BURNED**"
    detail = ("" if not burned
              else " — burned: " + ", ".join(f"`{b}`" for b in burned))
    if vacuous:
        detail += (" — vacuous (no subject events): "
                   + ", ".join(f"`{v}`" for v in vacuous))
    src = f" over `{ev.get('journal')}`" if ev.get("journal") else ""
    return [f"- SLO {verdict} `{ev.get('job', '?')}`: "
            f"{ev.get('applicable', 0)}/{ev.get('gates', 0)} gate(s) "
            f"applicable{src}{detail}"]


def _ctl_lines(ctls: list[dict]) -> list[str]:
    """The control-plane stream (obs/burn.py + loop/autoctl.py "ctl"
    events): one roll-up line for the observe cadence, then every
    decide / act / cooldown / summary verbatim enough to replay the
    controller's reasoning from the report alone."""
    lines = []
    observes = [ev for ev in ctls if ev.get("kind") == "observe"]
    if observes:
        burn_steps = sum(1 for ev in observes if ev.get("burning"))
        lines.append(
            f"- {len(observes)} burn evaluation(s) folded "
            f"({burn_steps} saw ≥1 gate burning — per-gate fast/slow "
            "rates live in the streaming-metrics ctl/burn gauges)")
    for ev in ctls:
        kind = ev.get("kind", "?")
        t = ev.get("t")
        at = f"t={t:g}s " if isinstance(t, (int, float)) else ""
        if kind == "decide":
            lines.append(
                f"- {at}decide `{ev.get('action', '?')}` on gate "
                f"`{ev.get('gate', '?')}` — {ev.get('reason', '?')}")
        elif kind == "act":
            bits = [f"{key}={ev[key]}" for key in
                    ("replica", "width", "from_width", "to_width",
                     "count", "round", "version") if key in ev]
            extra = f" ({', '.join(bits)})" if bits else ""
            lines.append(
                f"- {at}**ACT** `{ev.get('action', '?')}`{extra}")
        elif kind == "cooldown":
            lines.append(
                f"- {at}cooldown: decision on `{ev.get('gate', '?')}` "
                f"suppressed for {ev.get('cooldown_s', 0):g} s more")
        elif kind == "summary":
            lines.append(
                f"- summary: {ev.get('observes', 0)} observe(s), "
                f"{ev.get('decides', 0)} decide(s), "
                f"{ev.get('acts', 0)} act(s), "
                f"{ev.get('cooldowns', 0)} cooldown(s), "
                f"{ev.get('refused', 0)} refused join(s); burning at "
                f"close: {ev.get('burning') or 'none'}")
        elif kind != "observe":
            note = ev.get("note")
            lines.append(f"- {at}{kind}" + (f" — {note}" if note else ""))
    return lines


def _token_lines(toks: list[dict]) -> list[str]:
    """The token-serving stream (serve/paged.py "token" events): one
    roll-up line over the per-request latency decompositions (TTFT /
    inter-token cadence), then prefill / admission_refused / summary
    lines with the block-pool gauges — enough to read the zero-leak
    ledger and the flat-cadence claim straight off the report."""
    lines = []
    reqs = [ev for ev in toks if ev.get("kind") == "request"]
    if reqs:
        ttft = sorted(ev.get("ttft_ms", 0.0) for ev in reqs)
        p50s = sorted(ev.get("inter_token_p50_ms", 0.0) for ev in reqs)
        total = sum(ev.get("tokens", 0) for ev in reqs)
        lines.append(
            f"- {len(reqs)} generation(s), {total} token(s); TTFT p50 "
            f"{ttft[len(ttft) // 2]:.3f} ms / max {ttft[-1]:.3f} ms; "
            f"inter-token p50-of-p50s {p50s[len(p50s) // 2]:.3f} ms")
    for ev in toks:
        kind = ev.get("kind", "?")
        if kind == "prefill":
            lines.append(
                f"- prefill: {ev.get('rows', 0)} row(s) on bucket "
                f"{ev.get('bucket', '?')} ({ev.get('prompt_tokens', 0)} "
                f"prompt token(s), {ev.get('wall_ms', 0):g} ms); pool "
                f"{ev.get('blocks_free', '?')}/"
                f"{ev.get('blocks_total', '?')} blocks free")
        elif kind == "admission_refused":
            lines.append(
                f"- **ADMISSION REFUSED** (priced pre-compile): "
                f"predicted {ev.get('predicted_bytes', 0):,} B > budget "
                f"{ev.get('budget_bytes', 0):,} B")
        elif kind == "summary":
            leaked = ev.get("leaked", 0)
            dropped = ev.get("dropped", 0)
            compiles = ev.get("compiles", 0)
            flags = []
            if leaked:
                flags.append(f"**LEAKED {leaked}**")
            if dropped:
                flags.append(f"**DROPPED {dropped}**")
            if compiles:
                flags.append(f"**{compiles} POST-WARMUP COMPILE(S)**")
            verdict = ", ".join(flags) if flags else \
                "ledger exact, zero compiles"
            lines.append(
                f"- summary: {ev.get('requests', 0)} request(s), "
                f"{ev.get('steps', 0)} decode step(s), "
                f"{ev.get('prefills', 0)} prefill(s); blocks "
                f"allocated {ev.get('allocated', 0)} / freed "
                f"{ev.get('freed', 0)} — {verdict}")
        elif kind != "request":
            note = ev.get("note")
            lines.append(f"- {kind}" + (f" — {note}" if note else ""))
    return lines


def _runner_lines(events: list[dict]) -> list[str]:
    """The window-runner evidence ledger (tools/tpu_window_runner.py):
    dials, jobs, refusals, and per-job SLO verdicts — rendered here so
    one report covers a whole evidence journal, not only Recorder runs
    (tools/tunnel_log.py stays the round-narrative renderer)."""
    lines = []
    for ev in events:
        kind = ev.get("event", "?")
        if kind == "runner_start":
            jobs = ev.get("jobs") or []
            lines.append(
                f"- runner start: queue `{ev.get('queue', '?')}`, "
                f"{len(jobs)} job(s)")
        elif kind == "dial_start":
            lines.append(f"- dial (probe {ev.get('probe', '?')}) started")
        elif kind == "dial_end":
            if ev.get("ok"):
                lines.append(
                    f"- dial (probe {ev.get('probe', '?')}): backend "
                    f"`{ev.get('platform') or '?'}` up in "
                    f"{ev.get('dt_s', 0):.1f} s")
            else:
                lines.append(
                    f"- dial (probe {ev.get('probe', '?')}): DEAD after "
                    f"{ev.get('dt_s', 0):.1f} s — "
                    f"{ev.get('error') or 'no backend'}")
        elif kind == "dial_abandoned":
            lines.append(
                f"- dial (probe {ev.get('probe', '?')}) abandoned — "
                f"{ev.get('note', '?')}")
        elif kind == "job_start":
            setup = " [setup]" if ev.get("setup") else ""
            lines.append(
                f"- job `{ev.get('job', '?')}`{setup} started "
                f"(deadline {ev.get('deadline_s', 0):g} s)")
        elif kind == "job_end":
            status = ("TIMED OUT" if ev.get("timed_out")
                      else f"rc {ev.get('rc')}")
            death = " — window death" if ev.get("window_death") else ""
            lines.append(
                f"- job `{ev.get('job', '?')}`: {status} in "
                f"{ev.get('dt_s', 0):.1f} s{death}")
        elif kind == "queue_reload_failed":
            lines.append(
                f"- **queue reload FAILED**: {ev.get('error', '?')} "
                "(runner kept the previous queue)")
        elif kind == "preflight_oom":
            lines.append(
                f"- **preflight OOM refusal** `{ev.get('job', '?')}`: "
                f"{ev.get('model', '?')} batch {ev.get('batch', '?')} "
                f"{ev.get('dtype', '?')} predicts "
                f"{ev.get('predicted_bytes', 0):,} B against the "
                f"{ev.get('budget_bytes', 0):,} B budget — refused "
                "without burning a dial")
        elif kind == "setup_failed":
            lines.append(
                f"- **setup FAILED** `{ev.get('job', '?')}`: "
                f"{ev.get('note', '?')}")
        elif kind == "slo":
            lines += _slo_lines(ev)
        elif kind == "sched":
            lines += _sched_lines(ev)
        elif kind == "runner_done":
            lines.append(f"- runner done: {ev.get('reason', '?')}")
    return lines


def _sched_lines(ev: dict) -> list[str]:
    """One survival-policy scheduler decision (tools/window_policy.py;
    journaled only under ``--policy survival``), keyed on ``kind``."""
    k = ev.get("kind", "?")
    if k == "fit":
        return [f"- sched fit [{ev.get('policy', '?')}]: "
                f"{ev.get('windows', 0)} window(s) "
                f"({ev.get('window_deaths', 0)} death(s), median "
                f"{ev.get('median_window_s', 0):g} s), "
                f"{ev.get('heals', 0)} heal obs (median "
                f"{ev.get('heal_median_s', 0):g} s) from "
                f"{len(ev.get('sources') or [])} journal(s)"]
    if k == "pick":
        return [f"- sched pick `{ev.get('job', '?')}` at window age "
                f"{ev.get('window_age_s', 0):g} s: value "
                f"{ev.get('value', 0):g} x p_survive "
                f"{ev.get('p_survive', 0):g} = score "
                f"{ev.get('score', 0):g} over "
                f"{ev.get('candidates', 0)} candidate(s)"]
    if k == "window_summary":
        return [f"- sched window summary (probe {ev.get('probe', '?')}): "
                f"expected {ev.get('expected_value', 0):g}, banked "
                f"{ev.get('banked_value', 0):g} across "
                f"{ev.get('jobs_banked', 0)} job(s) in "
                f"{ev.get('window_age_s', 0):g} s"]
    if k == "redial_backoff":
        return [f"- sched redial backoff: deferring dial "
                f"{ev.get('delay_s', 0):g} s after "
                f"{ev.get('consecutive_dead', 0)} consecutive death(s) "
                f"(fitted heal median {ev.get('heal_median_s', 0):g} s)"]
    return [f"- sched {k}: {ev.get('note', '')}"]


def _waterfall_lines(defining: list[dict], lin: dict,
                     label: str) -> list[str]:
    """One causal chain (obs/lineage.py chain) as an indented list:
    child first, each hop naming the event that defined its span."""
    from sparknet_tpu_torch.obs import lineage as obs_lineage

    lines = ["", f"### waterfall — {label}", ""]
    for depth, hop in enumerate(obs_lineage.chain(defining, lin)):
        attrs = hop.get("attrs")
        bits = []
        if isinstance(attrs, dict):
            bits = [f"{key}={attrs[key]}" for key in sorted(attrs)
                    if key not in ("span", "parent")]
        extra = f" ({', '.join(bits)})" if bits else ""
        origin = f" [{hop['event']}]" if hop.get("event") else ""
        span = hop.get("span") or label
        dangling = (" — DANGLING (parent never defined)"
                    if attrs is None else "")
        lines.append(f"- {'  ' * depth}`{span}`{origin}{extra}{dangling}")
    return lines


def _lineage_section(defining: list[dict], last_round: dict | None,
                     last_request_lin: dict | None,
                     requests_linked: int,
                     request_parents: set[str]) -> list[str]:
    """The ``--lineage`` view: audit roll-up plus two waterfalls — the
    last round back to its shard range, the last request back through
    its serve generation / checkpoint / round to a root."""
    from sparknet_tpu_torch.obs import lineage as obs_lineage

    verdict = obs_lineage.audit(defining)
    defined = obs_lineage.spans(defining)
    dangling = list(verdict["dangling"])
    for parent in sorted(request_parents):
        if parent not in defined and not parent.startswith(
                obs_lineage.ROOT_PREFIXES):
            dangling.append(f"request -> {parent}")
    lines = [
        "", "## lineage (causal spans)", "",
        f"- {verdict['spans']} defined span(s), {verdict['edges']} "
        "parent edge(s) between producer events",
        f"- {requests_linked} request(s) linked across "
        f"{len(request_parents)} generation parent(s)",
    ]
    if dangling:
        lines.append(f"- **{len(dangling)} dangling ref(s)**: "
                     + ", ".join(f"`{d}`" for d in dangling))
    else:
        lines.append("- dangling refs: none — lineage-complete")
    if last_round is not None and isinstance(
            last_round.get("lineage"), dict):
        lines += _waterfall_lines(defining, last_round["lineage"],
                                  "last round")
    if last_request_lin is not None:
        lines += _waterfall_lines(defining, last_request_lin,
                                  "last request")
    return lines


def _bench_lines(benches: list[dict]) -> list[str]:
    lines = []
    for ev in benches:
        rec = ev.get("record") or {}
        metric = ev.get("metric", "?")
        value = rec.get("value")
        unit = rec.get("unit", "")
        bound = rec.get("roofline_img_s_upper_bound")
        conflict = rec.get("bound_inconsistency") or rec.get(
            "roofline_img_s_upper_bound_conflicting")
        tags = []
        tags.append("measured" if ev.get("measured") else "UNMEASURED")
        if not ev.get("fenced"):
            tags.append("unfenced")
        if rec.get("probe") is not None:
            tags.append(f"probe {rec['probe']}")
        tag = ", ".join(tags)
        if conflict is not None:
            why = rec.get("bound_inconsistency",
                          "value above its stated bound")
            lines.append(
                f"- `{metric}`: REFUSED — record carries a roofline "
                f"conflict ({why}); not printable as a headline number "
                f"({tag})")
            continue
        if (value is not None and bound is not None
                and isinstance(value, (int, float)) and value > bound):
            lines.append(
                f"- `{metric}`: REFUSED — value exceeds its stated "
                f"roofline bound {bound:g} {unit} and is withheld "
                f"({tag})")
            continue
        shown = "n/a" if value is None else f"{value:g} {unit}".rstrip()
        extra = f", bound {bound:g}" if bound is not None else ""
        lines.append(f"- `{metric}` = {shown} ({tag}{extra})")
    return lines


def _bank_lines(banks: list[dict]) -> list[str]:
    lines = []
    for ev in banks:
        label = "measured" if ev.get("measured") else \
            "rehearsal — not chip evidence"
        detail = ""
        if ev.get("metric") is not None:
            value = ev.get("value")
            detail = f" {ev['metric']}" + (
                f"={value:g}" if isinstance(value, (int, float)) else "")
        lines.append(f"- `{ev.get('path', '?')}` ({label}){detail}")
    return lines


def render(events: Iterable[dict], source: str = "journal",
           lineage: bool = False) -> str:
    """Deterministic markdown for one journal's events (pure function of
    its input — the golden test depends on that).  ``events`` may be a
    generator: the pass is single, and ``request`` lines fold into
    histograms instead of buffering."""
    lines = [
        f"# obsnet run report — {source}",
        "",
        "Rendered by `python -m sparknet_tpu.obs report` from the "
        "structured obs journal (`sparknet_tpu/obs/schema.py`).",
        "Walls are trusted only when fence-stamped via "
        "`common.value_fence` (unstamped walls are REFUSED), and no "
        "throughput is printed above its stated roofline bound.",
    ]
    runs: list[str] = []
    by_run: dict[str, dict[str, list]] = {}
    runner_events: list[dict] = []
    request_aggs: dict[str, _RequestAgg] = {}
    last_round: dict | None = None
    last_request_lin: dict | None = None
    requests_linked = 0
    request_parents: set[str] = set()
    for ev in events:
        kind = ev.get("event")
        run_id = ev.get("run_id")
        if run_id is None:
            if kind in _RUNNER_EVENTS:
                runner_events.append(ev)
            continue
        if run_id not in by_run:
            runs.append(run_id)
            by_run[run_id] = {"start": [], "round": [], "span": [],
                              "member": [], "feed": [], "recompile": [],
                              "bench": [], "bank": [], "end": [],
                              "serve": [], "loop": [], "metrics": [],
                              "replica": [], "ctl": [], "token": []}
        if kind == "request":
            agg = request_aggs.get(run_id)
            if agg is None:
                agg = request_aggs[run_id] = _RequestAgg()
            agg.fold(ev)
            lin = ev.get("lineage")
            if isinstance(lin, dict):
                last_request_lin = lin
                requests_linked += 1
                parent = lin.get("parent")
                if isinstance(parent, str):
                    request_parents.add(parent)
            continue
        key = {"run_start": "start", "run_end": "end",
               "worker_lost": "member", "worker_joined": "member",
               "mesh_resize": "member"}.get(kind, kind)
        if key == "metrics":
            # cumulative snapshots: the last supersedes — keep ONE
            by_run[run_id]["metrics"] = [ev]
            continue
        if key in by_run[run_id]:
            by_run[run_id][key].append(ev)
            if key == "round":
                last_round = ev

    if not runs and not runner_events:
        lines += ["", "_No obs events in this journal._", ""]
        return "\n".join(lines)

    if runner_events:
        lines += ["", "## window-runner ledger", ""]
        lines += _runner_lines(runner_events)

    for run_id in runs:
        group = by_run[run_id]
        started = group["start"][0].get("utc", "?") if group["start"] \
            else "?"
        lines += ["", f"## run `{run_id}` (started {started})"]
        if group["round"]:
            lines += ["", "### rounds", ""]
            lines += _round_rows(group["round"])
        if group["member"]:
            lines += ["", "### elastic membership", ""]
            lines += _member_rows(group["member"])
        if group["span"]:
            lines += ["", "### spans", ""]
            lines += _span_rows(group["span"])
        if group["feed"]:
            lines += ["", "### feed stages (host-side)", ""]
            lines += _feed_rows(group["feed"])
        if group["serve"]:
            lines += ["", "### serving engine", ""]
            lines += _serve_lines(group["serve"])
        if group["loop"]:
            lines += ["", "### production loop (train-to-serve)", ""]
            lines += _loop_lines(group["loop"])
        if group["replica"]:
            lines += ["", "### replica pool (pod-scale serving)", ""]
            lines += _replica_lines(group["replica"])
        if group["ctl"]:
            lines += ["", "### control plane (burn → action)", ""]
            lines += _ctl_lines(group["ctl"])
        if group["token"]:
            lines += ["", "### token serving (paged decode)", ""]
            lines += _token_lines(group["token"])
        if run_id in request_aggs:
            lines += ["", "### request latency (p50/p99 per model × "
                          "bucket)", ""]
            lines += _request_rows(request_aggs[run_id])
        if group["metrics"]:
            lines += ["", "### streaming metrics", ""]
            lines += _metrics_lines(group["metrics"][0])
        if group["recompile"]:
            lines += ["", "### recompiles", ""]
            for ev in group["recompile"]:
                lines.append(
                    f"- **{ev.get('count', '?')} unexpected XLA "
                    f"compilation(s)** after warmup in mode "
                    f"`{ev.get('where', '?')}` (process total "
                    f"{ev.get('total', '?')}) — a warm step should "
                    "never recompile")
        if group["bench"]:
            lines += ["", "### bench records", ""]
            lines += _bench_lines(group["bench"])
        if group["bank"]:
            lines += ["", "### banked evidence", ""]
            lines += _bank_lines(group["bank"])
        if group["end"]:
            ev = group["end"][0]
            lines += ["",
                      f"Run end: {ev.get('rounds', 0)} round(s), "
                      f"{ev.get('spans', 0)} span(s), "
                      f"{ev.get('compiles', 0)} backend compilation(s)."]

    if lineage:
        defining: list[dict] = []
        for run_id in runs:
            group = by_run[run_id]
            for key in ("feed", "round", "serve", "loop", "replica"):
                defining.extend(group[key])
        lines += _lineage_section(defining, last_round,
                                  last_request_lin, requests_linked,
                                  request_parents)
    lines.append("")
    return "\n".join(lines)


def render_path(path: str, source: str | None = None,
                lineage: bool = False) -> str:
    import os

    return render(schema.stream_journal(path),
                  source=source or os.path.basename(path),
                  lineage=lineage)
