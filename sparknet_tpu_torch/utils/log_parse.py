"""Training-log parser — table extraction from driver/solver logs.

Copy of ``sparknet_tpu/utils/log_parse.py``.

Equivalent of the reference's log tooling (ref:
caffe/tools/extra/parse_log.py:17-74 ``parse_log`` +
extract_seconds.py): turn a training log into train/test row tables
keyed by iteration, and write them as ``<log>.train`` / ``<log>.test``
CSVs.

Our logs interleave two line shapes:

- solver display lines (``Solver.step``):
  ``Iteration 200, loss = 0.68188, lr = 0.001``
- event-log lines (``EventLogger``):
  ``12.345: loss: 2.34100, i = 10`` and
  ``12.345: scores: {'accuracy': 0.73, 'loss': 0.62}``

Event-log lines carry wall-clock seconds since driver start (the
reference's ``Seconds`` column, derived there from glog timestamps);
solver lines carry the learning rate.
"""

from __future__ import annotations

import ast
import csv
import re
from typing import Any

_RE_ITERATION = re.compile(r"Iteration (\d+), loss = ([-+.\deEnainf]+), lr = ([-+.\deE]+)")
# EventLogger always writes "{elapsed:.3f}: " — anchor to that shape so
# arbitrary dotted prefixes (IPs, versions) in a mixed capture don't parse
_RE_EVENT = re.compile(r"^(\d+\.\d{3}): (.*)$")
_RE_EVENT_LOSS = re.compile(r"^loss: ([-+.\deEnainf]+), i = (\d+)$")
_RE_EVENT_SCORES = re.compile(r"^scores: (\{.*\})(?:, i = (\d+))?$")


def parse_log(path: str) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """Parse a training log into ``(train_rows, test_rows)``.

    Each row is a dict with at least ``NumIters``; train rows add
    ``loss`` and (when a solver display line supplied one)
    ``LearningRate``; rows derived from event-log lines add ``Seconds``.
    Test rows carry one column per score name (ref: parse_log.py's
    "Test net output #k: name = val" table).
    """
    train_rows: list[dict[str, Any]] = []
    test_rows: list[dict[str, Any]] = []
    last_iter = 0

    def add_train(row: dict[str, Any]) -> None:
        # A capture of stdout carries BOTH the solver display line and the
        # event-log mirror for the same iteration — merge instead of
        # emitting duplicate NumIters rows (earlier fields win: the display
        # line's smoothed loss over the mirror's raw per-iter loss).
        if train_rows and train_rows[-1]["NumIters"] == row["NumIters"]:
            train_rows[-1] = {**row, **train_rows[-1]}
        else:
            train_rows.append(row)

    for raw in open(path):
        line = raw.rstrip("\n")
        seconds = None
        m = _RE_EVENT.match(line)
        if m:
            seconds, line = float(m.group(1)), m.group(2)

        it = _RE_ITERATION.search(line)
        if it:
            last_iter = int(it.group(1))
            add_train(
                {
                    "NumIters": last_iter,
                    "loss": float(it.group(2)),
                    "LearningRate": float(it.group(3)),
                    **({"Seconds": seconds} if seconds is not None else {}),
                }
            )
            continue

        el = _RE_EVENT_LOSS.match(line)
        if el:
            last_iter = int(el.group(2))
            row: dict[str, Any] = {"NumIters": last_iter, "loss": float(el.group(1))}
            if seconds is not None:
                row["Seconds"] = seconds
            add_train(row)
            continue

        es = _RE_EVENT_SCORES.match(line)
        if es:
            try:
                scores = ast.literal_eval(es.group(1))
            except (ValueError, SyntaxError):
                continue
            if not isinstance(scores, dict):
                continue
            row = {"NumIters": int(es.group(2)) if es.group(2) else last_iter}
            if seconds is not None:
                row["Seconds"] = seconds
            row.update({str(k): float(v) for k, v in scores.items()})
            test_rows.append(row)
    return train_rows, test_rows


def _columns(rows: list[dict[str, Any]]) -> list[str]:
    lead = ["NumIters", "Seconds", "LearningRate"]
    names = []
    for row in rows:
        for key in row:
            if key not in lead and key not in names:
                names.append(key)
    return [c for c in lead if any(c in r for r in rows)] + names


def save_csv(rows: list[dict[str, Any]], path: str, delimiter: str = ",") -> None:
    """Write rows as CSV (ref: parse_log.py:136-147 save_csv_files)."""
    cols = _columns(rows)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, delimiter=delimiter, restval="")
        writer.writeheader()
        writer.writerows(rows)


def parse_log_to_csv(path: str, out_dir: str | None = None, delimiter: str = ",") -> tuple[str, str]:
    """``<log>.train`` / ``<log>.test`` next to the log (or in out_dir)."""
    import os

    train_rows, test_rows = parse_log(path)
    base = os.path.basename(path)
    directory = out_dir if out_dir is not None else (os.path.dirname(path) or ".")
    os.makedirs(directory, exist_ok=True)
    train_path = os.path.join(directory, base + ".train")
    test_path = os.path.join(directory, base + ".test")
    save_csv(train_rows, train_path, delimiter)
    save_csv(test_rows, test_path, delimiter)
    return train_path, test_path
