"""obs CLI: ``python -m sparknet_tpu_torch.obs
{report|validate|slo|top|dryrun} ...``.

Counterpart of ``sparknet_tpu/obs/__main__.py``.

* ``report <journal> [--out f.md] [--lineage]``: render a journal to
  markdown (``obs/report.py``: refuses unstamped walls; never prints a
  throughput above its stated roofline bound).  ``--lineage`` appends the
  causal-span audit and the parent/child waterfalls for the last round and
  the last request (``obs/lineage.py``).
* ``validate [journals...]``: schema-check journal files; with no
  arguments, every ``docs/evidence_r*/*.jsonl`` of the repo.  Legacy
  deviations pass only through the allowlist in ``obs/schema.py``.  Exit 1
  on any violation.
* ``slo [journals...] [--manifest f.json]``: evaluate the declarative SLO
  manifest (``docs/slo_manifest.json``) against journals (the same default
  discovery).  Gates with no subject events pass vacuously and say so;
  exit 1 on any burn.
* ``top <journal> [--interval s] [--once] [--frames N]``: live-tail a
  GROWING journal: each poll folds only the newly appended complete lines
  into streaming metrics (``obs/metrics.py``) and repaints one summary
  frame, in bounded memory however long the run.
* ``dryrun [--out p] [--rounds N] [--tau T] [--devices W] [--elastic]``:
  dp (tau 1, synchronous SGD) and tau (SparkNet averaging) rounds of
  ``ParallelTrainer`` over a world of W ranks (one process a rank, joined
  as ``tpunet train --num-processes`` joins them; ``obs/train_legs.py``)
  with the Recorder armed on rank 0; ``--elastic`` adds a fault-injected
  ``ElasticTrainer`` leg (kill/join/straggle between rounds) whose
  membership events land on the same schema.  ``--serve`` swaps the
  training legs for the serving load run (``serve/loadgen.load_run``: the
  requests through every captured bucket, a journaled over-budget load
  refusal; exit 1 unless 0 CUDA graphs were captured after the warm-up).
  ``--loop`` drives the train-to-serve production loop (``loop/dryrun.py``:
  elastic rounds -> atomic checkpoint -> hot swap into the live engine ->
  over-budget refusal -> bitwise rollback, with traffic in flight).
  ``--replica`` drives the pod-serving fault plan
  (``serve/dryrun.replica_run``: a kill with a known backlog, a steady
  open-loop leg, a live join/kill/swap, continuous-batching exactness).
  ``--ctl`` replays the four control-plane scenarios
  (``loop/ctl_scenarios.py``) through the SLOController on virtual time,
  action traces diffed against the banked ``docs/ctl_contracts/``; no
  device.  Every leg but ``--ctl`` runs on the card unless ``--device
  cpu``; each exits 1 unless its gates hold, the journal is schema-clean
  and its lineage audit finds no dangling parent.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def _discover_journals() -> list[str]:
    """Every evidence journal of the repo (``docs/evidence_r*/*.jsonl``)."""
    return sorted(glob.glob(os.path.join(_REPO, "docs", "evidence_r*", "*.jsonl")))


def validate_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs validate",
        description="schema-check journal files (default: every "
        "docs/evidence_r*/*.jsonl)")
    ap.add_argument("journals", nargs="*")
    args = ap.parse_args(argv)
    from sparknet_tpu_torch.obs import schema

    paths = args.journals or _discover_journals()
    if not paths:
        print("no journals found", file=sys.stderr)
        return 2
    rc = 0
    for path in paths:
        try:
            n, allowed, errors = schema.validate_journal(path)
        except OSError as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            rc = 1
            continue
        status = "OK" if not errors else "FAIL"
        extra = f", {allowed} legacy line(s) allowlisted" if allowed else ""
        print(f"{status} {path}: {n} line(s){extra}")
        for err in errors:
            print(f"  {err}")
        if errors:
            rc = 1
    return rc


def slo_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs slo",
        description="evaluate the declarative SLO manifest (docs/slo_manifest.json) "
        "against journal(s); default: every docs/evidence_r*/*.jsonl.  Exit 1 on "
        "any burn.")
    ap.add_argument("journals", nargs="*")
    ap.add_argument("--manifest", help="alternate manifest path")
    ap.add_argument("--quiet", action="store_true",
                    help="verdict lines only, no per-gate detail")
    args = ap.parse_args(argv)
    from sparknet_tpu_torch.obs import slo

    manifest = slo.load_manifest(args.manifest or slo.default_manifest_path())
    paths = args.journals or _discover_journals()
    if not paths:
        print("no journals found", file=sys.stderr)
        return 2
    rc = 0
    for path in paths:
        try:
            results = slo.evaluate_journal(path, manifest)
        except OSError as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            rc = 1
            continue
        burned = [r["id"] for r in results if not r["ok"]]
        applicable = sum(1 for r in results if r["applicable"])
        print(f"{'OK' if not burned else 'BURN'} {path}: {applicable}/{len(results)} "
              "gate(s) applicable")
        if not args.quiet:
            for r in results:
                mark = "pass" if r["ok"] else "BURN"
                scope = "" if r["applicable"] else " (vacuous)"
                print(f"  [{mark}] {r['id']}{scope}: {r['detail']}")
        if burned:
            rc = 1
    return rc


def report_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs report",
        description="render an obs journal to markdown")
    ap.add_argument("journal")
    ap.add_argument("--out", help="write here instead of stdout")
    ap.add_argument("--lineage", action="store_true",
                    help="append the causal-span audit + waterfalls")
    args = ap.parse_args(argv)
    if not os.path.exists(args.journal):
        print(f"no such journal: {args.journal}", file=sys.stderr)
        return 2
    from sparknet_tpu_torch.obs.report import render_path

    text = render_path(args.journal, lineage=args.lineage)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return 0


def top_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs top",
        description="live-tail a growing journal into streaming metrics: each "
        "poll folds only newly appended complete lines (obs/metrics.py "
        "JournalTail), in bounded memory at any run length")
    ap.add_argument("journal")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="one poll, one frame, exit")
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after N frames (0 = until Ctrl-C)")
    args = ap.parse_args(argv)
    import time
    from collections import deque

    from sparknet_tpu_torch.obs import metrics as obs_metrics

    tail = obs_metrics.JournalTail(args.journal)
    # fold-only hub: the flush clock never fires (top reads state
    # directly; it must not mint metrics events for someone's journal)
    hub = obs_metrics.MetricsHub(flush_every=1 << 62)
    # the live ctl decision stream: the last few decide/act/cooldown lines
    # verbatim (the counters say how many; these say WHAT)
    ctl_recent: deque = deque(maxlen=5)
    folded = 0
    frames = 0
    try:
        while True:
            for ev in tail.poll():
                kind = ev.get("event")
                if isinstance(kind, str):
                    hub.observe_event(kind, ev)
                    folded += 1
                    if kind == "ctl" and ev.get("kind") in ("decide", "act", "cooldown"):
                        ctl_recent.append(ev)
            frames += 1
            print(_top_frame(args.journal, folded, hub, ctl_recent), flush=True)
            if args.once or (args.frames and frames >= args.frames):
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _top_frame(path: str, folded: int, hub, ctl_recent=()) -> str:
    from sparknet_tpu_torch.obs import metrics as obs_metrics

    lines = [f"== obs top {path} — {folded} event(s) folded =="]
    for name in sorted(hub.counters):
        value = hub.counters[name]
        lines.append(f"  {name} = {value:g}")
    for name in sorted(hub.gauges):
        lines.append(f"  {name} ~ {hub.gauges[name]:g} (gauge)")
    for name in sorted(hub.hists):
        snap = hub.hists[name].snapshot()
        p50 = obs_metrics.percentile(snap, 50)
        p99 = obs_metrics.percentile(snap, 99)
        lines.append(
            f"  {name}: n={snap['count']} p50={p50:.3f} "
            f"p99={p99:.3f} max={snap['max']:.3f}")
    if ctl_recent:
        lines.append("  -- ctl decisions (most recent last) --")
        for ev in ctl_recent:
            t = ev.get("t")
            bits = [f"t={t:g}" if isinstance(t, (int, float)) else None,
                    ev.get("action"), ev.get("gate"),
                    ev.get("reason") or ev.get("note")]
            lines.append(f"  ctl/{ev.get('kind', '?')}: "
                         + " ".join(b for b in bits if b))
    if len(lines) == 1:
        lines.append("  (no metric-bearing events yet)")
    return "\n".join(lines)


def journal_gates(path: str) -> int:
    """The post-dryrun gates: zero schema findings, a clean lineage audit
    (every parent ref resolves to a defined span or a root) and the chaos
    gate."""
    from sparknet_tpu_torch.obs import lineage, schema

    rc = 0
    n, _allowed, errors = schema.validate_journal(path)
    if errors:
        print(f"obs dryrun: SCHEMA FAIL: {len(errors)} finding(s) over {n} line(s):",
              file=sys.stderr)
        for err in errors[:20]:
            print(f"  {err}", file=sys.stderr)
        rc = 1
    else:
        print(f"obs dryrun: schema clean over {n} line(s)", file=sys.stderr)
    verdict = lineage.audit(schema.stream_journal(path))
    if verdict["dangling"]:
        print(f"obs dryrun: LINEAGE FAIL: {len(verdict['dangling'])} dangling ref(s):",
              file=sys.stderr)
        for ref in verdict["dangling"][:20]:
            print(f"  {ref}", file=sys.stderr)
        rc = 1
    else:
        print(f"obs dryrun: lineage complete: {verdict['spans']} span(s), "
              f"{verdict['edges']} edge(s), {verdict['requests_linked']} request(s) "
              "linked", file=sys.stderr)
    if _chaos_gate():
        rc = 1
    return rc


def _chaos_gate() -> int:
    """The JAX dryruns diff the lock edges a chaos schedule observed
    (``SPARKNET_CHAOS_SCHED``) against a banked static lock graph; the
    port has neither the instrumented locks nor the graph yet (ROADMAP
    Queue A14).  Armed, the gate fails rather than pass unchecked; a no-op
    (0) when the mode is off (unset, empty, or not an integer)."""
    raw = os.environ.get("SPARKNET_CHAOS_SCHED", "").strip()
    try:
        int(raw, 0)
    except ValueError:
        return 0
    print("obs dryrun: CHAOS FAIL: SPARKNET_CHAOS_SCHED is armed, but the port has no "
          "chaos-scheduled locks or static lock graph to check them against (ROADMAP "
          "Queue A14, conccheck)", file=sys.stderr)
    return 1


def _ctl_dryrun(out: str) -> int:
    """The four scenarios' replay and banked-trace diff, then the four
    CONTROLLED journals concatenated into ``out``.  The bare-arm journals
    burn their gates by design and stay in a temporary directory."""
    from sparknet_tpu_torch.loop import ctl_scenarios

    summary = ctl_scenarios.replay(
        journal_dir=tempfile.mkdtemp(prefix="ctl_dryrun_"),
        log=lambda m: print(f"obs dryrun [ctl]: {m}", file=sys.stderr))
    with open(out, "w", encoding="utf-8") as dst:
        for record in summary["scenarios"]:
            with open(record["controlled"]["journal"], encoding="utf-8") as src:
                dst.write(src.read())
    acted = sum(len(r["controlled"]["actions"]) for r in summary["scenarios"])
    print(f"obs dryrun [ctl]: {len(summary['scenarios'])} scenario(s), {acted} controller "
          f"action(s), traces {'MATCH' if summary['ok'] else 'DIVERGED'} vs "
          "docs/ctl_contracts/ (bare arms burned, controlled arms held, zero drops)")
    _say_journal(out)
    gates = journal_gates(out)
    return 0 if summary["ok"] and gates == 0 else 1


def _say_journal(out: str) -> None:
    print(f"obs dryrun: journal at {out}: render with "
          f"`python -m sparknet_tpu_torch.obs report {out}`")


def dryrun_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs dryrun",
        description="dp and tau rounds over a world of ranks with the Recorder armed, "
        "or one of the serving, loop, replica and control-plane legs")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "obs_dryrun.jsonl"),
                    help="the journal to write (default: obs_dryrun.jsonl in the "
                    "temporary directory, which follows TMPDIR)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tau", type=int, default=3)
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks of the training legs, one process each (default 2)")
    ap.add_argument("--family", default="cifar10_quick")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--elastic", action="store_true",
                    help="add an elastic fault-injection leg (parallel/elastic.py): "
                    "kill/join/straggle across rounds, so the journal carries "
                    "worker_lost/worker_joined/mesh_resize events")
    ap.add_argument("--serve", action="store_true",
                    help="run the serving load run INSTEAD of the training legs "
                    "(serve/loadgen.py): the requests through every captured bucket "
                    "on two resident models, one journaled over-budget load refusal, "
                    "and 0 CUDA graph captures after the warm-up")
    ap.add_argument("--requests", type=int, default=504,
                    help="request count for --serve (default 504)")
    ap.add_argument("--loop", action="store_true",
                    help="run the train-to-serve production loop INSTEAD of the "
                    "training legs: elastic rounds -> atomic checkpoint -> candidate "
                    "-> hot swap -> refusal -> bitwise rollback with requests in "
                    "flight; exit 1 unless all gates pass")
    ap.add_argument("--iterations", type=int, default=1,
                    help="train->rollout cycles for --loop (default 1)")
    ap.add_argument("--replica", action="store_true",
                    help="run the pod-serving fault plan INSTEAD of the training legs "
                    "(serve/dryrun.py): K replicas under open-loop load with a "
                    "kill/join/swap plan firing mid-stream, zero-drop re-route, "
                    "deadline shedding, and the continuous-batching exactness gate")
    ap.add_argument("--replicas", type=int, default=4,
                    help="pool width for --replica (default 4)")
    ap.add_argument("--ctl", action="store_true",
                    help="replay the four control-plane scenarios "
                    "(loop/ctl_scenarios.py) INSTEAD of the training legs: "
                    "virtual-time traffic through the SLOController, action traces "
                    "diffed against docs/ctl_contracts/, bare arms burn and "
                    "controlled arms hold with zero drops; no device")
    args = ap.parse_args(argv)

    # a fresh journal a dryrun: appending over a previous run would
    # interleave run ids in the rendered report
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(args.out):
        os.remove(args.out)
    if args.ctl:
        # a host-side simulation: no device; each scenario arm arms its
        # own Recorder
        return _ctl_dryrun(args.out)

    if not (args.replica or args.loop or args.serve):
        from sparknet_tpu_torch.obs.train_legs import train_legs

        rc = train_legs(devices=args.devices, rounds=args.rounds, tau=args.tau,
                        family=args.family, elastic=args.elastic, device=args.device,
                        journal=args.out)
        _say_journal(args.out)
        return 1 if rc or journal_gates(args.out) else 0

    from sparknet_tpu_torch.common import resolve_device
    from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder

    device = resolve_device(args.device)
    rec = set_recorder(Recorder(args.out))
    try:
        if args.replica:
            from sparknet_tpu_torch.serve.dryrun import replica_run

            summary = replica_run(
                replicas=args.replicas, devices=[str(device)] * (args.replicas + 1),
                log=lambda m: print(f"obs dryrun [replica]: {m}", file=sys.stderr))
        elif args.loop:
            from sparknet_tpu_torch.loop.dryrun import loop_run

            summary = loop_run(
                iterations=args.iterations, rounds_per_rollout=args.rounds,
                family=args.family, tau=args.tau, device=device,
                log=lambda m: print(f"obs dryrun [loop]: {m}", file=sys.stderr))
        else:
            from sparknet_tpu_torch.serve.loadgen import load_run

            summary = load_run(
                requests=args.requests, family=args.family, device=device,
                log=lambda m: print(f"obs dryrun [serve]: {m}", file=sys.stderr))
    finally:
        rec.close()
        set_recorder(None)
    if args.replica:
        print(f"obs dryrun [replica]: {summary['replicas_start']} -> "
              f"{summary['replicas_end']} replica(s) through faults "
              f"{summary['faults_fired']}, {summary['requests']} request(s) "
              f"({summary['dropped']} dropped, {summary['shed']} shed, "
              f"{summary['rerouted']} re-routed), queue p99 "
              f"{summary['queue_p99_ms']:.1f} ms (bound {summary['queue_bound_ms']:.0f} ms), "
              f"{summary['serve_path_compiles']} serving-path capture(s), continuous "
              f"exact: {summary['continuous_exact']}")
        ok = summary["ok"]
    elif args.loop:
        print(f"obs dryrun [loop]: {summary['rounds']} elastic round(s) -> "
              f"{summary['rollouts']} rollout(s) / {summary['rollbacks']} rollback(s), "
              f"{summary['requests']} request(s) ({summary['dropped']} dropped), "
              f"{summary['serve_path_compiles']} serving-path capture(s), scores changed: "
              f"{summary['scores_changed']}, restored bitwise: "
              f"{summary['scores_restored']}, refusal journaled: {summary['refused']}")
        ok = summary["ok"]
    else:
        print(f"obs dryrun [serve]: {summary['requests']} request(s), buckets "
              f"{summary['buckets_exercised']}, {summary['compiles_post_warmup']} "
              f"post-warmup capture(s), p50 {summary['p50_ms']:.2f} ms / p99 "
              f"{summary['p99_ms']:.2f} ms, refusal journaled: {summary['refused']}")
        ok = summary["compiles_post_warmup"] == 0
    _say_journal(args.out)
    return 0 if ok and journal_gates(args.out) == 0 else 1


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = {"report": report_main, "validate": validate_main, "slo": slo_main,
                "top": top_main, "dryrun": dryrun_main}
    if not argv or argv[0] not in commands:
        print(__doc__)
        return 2
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
