"""obs CLI: ``python -m sparknet_tpu_torch.obs {validate|slo|dryrun} ...``.

Counterpart of ``sparknet_tpu/obs/__main__.py``.

* ``validate [journals...]``: schema-check journal files; with no
  arguments, every ``docs/evidence_r*/*.jsonl`` of the repo.  Legacy
  deviations pass only through the allowlist in ``obs/schema.py``.  Exit 1
  on any violation.
* ``slo [journals...] [--manifest f.json]``: evaluate the declarative SLO
  manifest (``docs/slo_manifest.json``) against journals (the same default
  discovery).  Gates with no subject events pass vacuously and say so;
  exit 1 on any burn.
* ``dryrun --loop [--out p] [--device cuda|cpu]``: the train-to-serve
  production loop (``loop/dryrun.py``) with the Recorder armed: elastic
  rounds -> atomic checkpoint -> hot swap into the live engine ->
  over-budget refusal -> bitwise rollback, with traffic in flight; exit 1
  unless every gate holds, the journal is schema-clean and its lineage
  audit finds no dangling parent.  On the card unless ``--device cpu``.

``report`` (``obs/report.py``) and ``top``, and the other dryrun legs,
exit naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX CLI's commands and dryrun legs the port does not carry yet
_UNPORTED = {
    "report": "Queue A13 (obs/report.py)",
    "top": "Queue A13 (obs top over obs/metrics.py)",
}


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


def journal_gates(path: str) -> int:
    """The post-dryrun gates: zero schema findings AND a clean lineage
    audit (every parent ref resolves to a defined span or a root)."""
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
    return rc


def dryrun_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs dryrun",
        description="the production loop with the Recorder armed (--loop)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "obs_dryrun.jsonl"),
                    help="the journal to write (default: obs_dryrun.jsonl in the "
                    "temporary directory, which follows TMPDIR)")
    ap.add_argument("--loop", action="store_true",
                    help="run the train-to-serve production loop: elastic rounds -> "
                    "atomic checkpoint -> candidate -> hot swap -> refusal -> bitwise "
                    "rollback with requests in flight; exit 1 unless all gates pass")
    ap.add_argument("--rounds", type=int, default=2, help="elastic rounds per rollout")
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--family", default="cifar10_quick")
    ap.add_argument("--iterations", type=int, default=1,
                    help="train->rollout cycles (default 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for leg in ("elastic", "serve", "replica", "ctl"):
        ap.add_argument(f"--{leg}", action="store_true",
                        help="not ported (ROADMAP Queue A13)")
    args = ap.parse_args(argv)
    legs = [leg for leg in ("elastic", "serve", "replica", "ctl") if getattr(args, leg)]
    if legs or not args.loop:
        print(f"obs dryrun: only --loop is ported to sparknet_tpu_torch; "
              f"{'--' + legs[0] if legs else 'the dp/tau legs'} not yet (ROADMAP Queue "
              "A13)", file=sys.stderr)
        return 2

    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(args.out):
        os.remove(args.out)  # a fresh journal a dryrun
    from sparknet_tpu_torch.loop.dryrun import loop_run
    from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder

    rec = set_recorder(Recorder(args.out))
    try:
        summary = loop_run(iterations=args.iterations, rounds_per_rollout=args.rounds,
                           family=args.family, tau=args.tau, device=args.device,
                           log=lambda m: print(f"obs dryrun [loop]: {m}", file=sys.stderr))
    finally:
        rec.close()
        set_recorder(None)
    print(f"obs dryrun [loop]: {summary['rounds']} elastic round(s) -> "
          f"{summary['rollouts']} rollout(s) / {summary['rollbacks']} rollback(s), "
          f"{summary['requests']} request(s) ({summary['dropped']} dropped), "
          f"{summary['serve_path_compiles']} serving-path capture(s), scores changed: "
          f"{summary['scores_changed']}, restored bitwise: {summary['scores_restored']}, "
          f"refusal journaled: {summary['refused']}")
    print(f"obs dryrun: journal at {args.out}")
    return 0 if summary["ok"] and journal_gates(args.out) == 0 else 1


def _unported(name: str):
    def fn(argv: list[str]) -> int:
        print(f"obs {name} is not ported to sparknet_tpu_torch yet "
              f"(ROADMAP {_UNPORTED[name]})", file=sys.stderr)
        return 2
    return fn


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = {"validate": validate_main, "slo": slo_main, "dryrun": dryrun_main,
                **{name: _unported(name) for name in _UNPORTED}}
    if not argv or argv[0] not in commands:
        print(__doc__)
        return 2
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
