"""Scenario replay for the SLO control plane, on virtual time.

Counterpart of the JAX package's ``tools/ctl_scenarios.py``, inside the
port so that its runtime imports nothing of ``tools/``.  The controller's
claim, "on a burning SLO it spends the right muscle, and with it off the
same traffic burns", is checked with no device at all: deterministic
open-loop traffic programs are replayed through a discrete-time queueing
model of the pod, and the controller's ``ctl`` action trace is diffed
against the banked manifests in ``docs/ctl_contracts/``.  Those manifests
are the JAX package's, read only: there is no ``--update`` here, so the
port's ``loop/autoctl.SLOController``, ``obs/burn.py``, ``obs/slo.py`` and
``Recorder`` must reproduce the reference's traces action for action.

Four scenarios:

* **diurnal_ramp**: offered load ramps over the serving capacity and back
  (the daily peak).  Expected: one priced ``join_replica`` on the way up,
  one patient ``kill_replica`` after the healthy period.
* **flash_crowd**: a step to ~2x capacity with the device pool fully owned
  by training and serving: no free device, so the controller must
  ``lend_width`` (an elastic shrink at a round boundary) before it can
  join, then return everything when the crowd passes.
* **straggler_storm**: two of three replicas degrade to 30% drain rate for
  30 s.  Expected: joins to cover the lost capacity, kills after the storm.
* **poison_canary**: a rollout lands a model that drains at 35%.
  Expected: the burn inside the canary window answers with a bitwise
  ``rollback`` (capacity is not the cure for a poisoned model) before any
  request exceeds its drop deadline.

Every run journals schema-valid events through the port's Recorder; the
controlled arm must hold every ``docs/slo_manifest.json`` gate (the batch
``obs slo`` over its own journal) with zero drops and a recovered burn
engine, while the bare arm must burn at least one gate per scenario.

Model notes: one replica drains ``_REPLICA_RATE`` req/s; queue wait is
``backlog / capacity`` (+ a base service latency); requests past
``_DROP_DEADLINE_MS`` shed from the queue into the drop ledger.  The
reference's own failure mode motivates the catalog: stragglers and lost
executors mid-round (ref: src/main/scala/apps/CifarApp.scala:95).

Usage::

    python -m sparknet_tpu_torch.loop.ctl_scenarios [--scenario NAME]
                                                    [--journal-dir DIR]

Exit 1 on any trace or gate mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from sparknet_tpu_torch.loop.autoctl import SLOController
from sparknet_tpu_torch.obs import slo as batch_slo
from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONTRACT_DIR = os.path.join(REPO, "docs", "ctl_contracts")

_TICK_S = 0.25          # sim step (exact in binary: t never drifts)
_STEP_EVERY = 2         # controller cadence: every 0.5 s of sim time
_REPLICA_RATE = 100.0   # req/s one healthy replica drains
_BASE_WAIT_MS = 2.0     # service latency floor under an empty queue
_DROP_DEADLINE_MS = 5000.0  # a request older than this is dropped
_SAMPLES_PER_TICK = 4   # journaled request lines per tick
# deterministic intra-tick spread so the p99 is not the mean
_SPREAD = (0.90, 0.95, 1.00, 1.08)
_MODEL, _BUCKET = "live", 8
# static admission pricing for the sim plane (the real planes price
# through serve/residency off the banked batch-fit table)
_PRED_BYTES = 640_000_000
_BUDGET_BYTES = 13_000_000_000


def _ramp(t: float, t0: float, t1: float, v0: float, v1: float) -> float:
    if t <= t0:
        return v0
    if t >= t1:
        return v1
    return v0 + (v1 - v0) * (t - t0) / (t1 - t0)


def _diurnal_rate(t: float) -> float:
    if t < 30.0:
        return 120.0
    if t < 40.0:
        return _ramp(t, 30.0, 40.0, 120.0, 240.0)
    if t < 55.0:
        return 240.0
    if t < 65.0:
        return _ramp(t, 55.0, 65.0, 240.0, 120.0)
    return 120.0


def _flash_rate(t: float) -> float:
    return 280.0 if 30.0 <= t < 70.0 else 140.0


SCENARIOS: dict[str, dict] = {
    "diurnal_ramp": {
        "duration_s": 120.0, "replicas": 2, "train_width": 0,
        "devices": 8, "rate": _diurnal_rate,
    },
    "flash_crowd": {
        "duration_s": 130.0, "replicas": 2, "train_width": 6,
        "devices": 8, "rate": _flash_rate, "round_s": 4.0,
        "min_train_width": 2,
    },
    "straggler_storm": {
        "duration_s": 120.0, "replicas": 3, "train_width": 0,
        "devices": 8, "rate": lambda t: 240.0,
        "straggle": {"from": 30.0, "until": 60.0, "workers": 2,
                     "factor": 0.3},
    },
    "poison_canary": {
        "duration_s": 120.0, "replicas": 2, "train_width": 0,
        "devices": 8, "rate": lambda t: 140.0,
        "canary_at": 30.0, "poison_factor": 0.5,
    },
}


class SimPod:
    """Discrete-time queueing model of the pod — and the control plane
    the SLOController steers (same duck-typed surface RouterPlane /
    LoopPlane implement, so the controller under test is the production
    class, byte-for-byte)."""

    def __init__(self, spec: dict, *, controller_armed: bool,
                 scenario: str):
        self.spec = spec
        self.scenario = scenario
        self.t = 0.0
        self.tick_i = 0
        self.replicas: list[int] = list(range(spec["replicas"]))
        self._next_rid = spec["replicas"]
        self.baseline = spec["replicas"]
        self.train_width = int(spec.get("train_width", 0))
        self.train_width0 = self.train_width
        self.min_train_width = int(spec.get("min_train_width", 2))
        self.devices = int(spec.get("devices", 8))
        self.round_s = float(spec.get("round_s", 4.0))
        self.backlog = 0.0
        self.dropped = 0.0
        self.served = 0.0
        self.submitted = 0.0
        self.max_wait_ms = 0.0
        self.poison = False
        self.rolled_out = False
        self.version = 1
        self._pending_joins: list[tuple[float, int]] = []  # (ready_t, rid)
        self._pending_lend = 0
        self._pending_restore = 0
        self.ctl: SLOController | None = None
        if controller_armed:
            # cooldown 6 s: one replica boot (1 s) plus the settle the
            # suspension window grants must fit inside a cooldown, or
            # the controller double-spends on the same backlog
            self.ctl = SLOController(self, scenario=scenario,
                                     clock=lambda: self.t,
                                     cooldown_s=6.0, healthy_s=30.0)

    # -- journaling (and the controller's event feed) ----------------------

    def _emit(self, event: str, **fields) -> None:
        from sparknet_tpu_torch.obs.recorder import get_recorder

        get_recorder().emit(event, **fields)
        if self.ctl is not None:
            self.ctl.observe(event, fields, t=self.t)

    # -- ControlPlane surface ----------------------------------------------

    def serve_width(self) -> int:
        return len(self.replicas) + len(self._pending_joins)

    def _free_devices(self) -> int:
        # a pending lend frees its device only at the round boundary
        # (train_width still holds it), so it is deliberately absent here
        return self.devices - self.serve_width() - self.train_width

    def can_grow(self):
        if self._free_devices() <= 0:
            return None
        return {"fits": True, "predicted_bytes": _PRED_BYTES,
                "budget_bytes": _BUDGET_BYTES}

    def grow(self) -> dict:
        rid = self._next_rid
        self._next_rid += 1
        self._pending_joins.append((self.t + 1.0, rid))  # 1 s boot
        self._emit("replica", kind="replica_up", replica=rid,
                   width=self.serve_width(),
                   note="controller join — booting")
        return {"replica": rid, "width": self.serve_width()}

    def shrink(self):
        if len(self.replicas) <= max(1, self.baseline):
            return None
        rid = max(self.replicas)
        self.replicas.remove(rid)
        self._emit("replica", kind="replica_down", replica=rid,
                   width=self.serve_width(),
                   note="controller scale-down — borrowed capacity "
                        "returned")
        return {"replica": rid, "width": self.serve_width()}

    def can_lend(self) -> bool:
        return (self.train_width - self._pending_lend - 1
                >= self.min_train_width)

    def lend(self):
        if not self.can_lend():
            return None
        self._pending_lend += 1
        at = int(self.t / self.round_s) + 1
        return {"count": 1, "from_width": self.train_width,
                "to_width": self.train_width - self._pending_lend,
                "round": at}

    def restore(self):
        lent = self.train_width0 - self.train_width - self._pending_lend
        if lent <= 0:
            return None
        self._pending_restore = lent
        at = int(self.t / self.round_s) + 1
        return {"count": lent, "from_width": self.train_width,
                "to_width": self.train_width + lent, "round": at}

    def rollback(self):
        if not self.rolled_out:
            return None
        self.poison = False
        self.rolled_out = False
        self._emit("serve", kind="rollback", version=self.version - 1,
                   note="controller rollback — previous generation "
                        "restored bitwise")
        return {"ok": True, "version": self.version - 1}

    # -- the tick ----------------------------------------------------------

    def _capacity_per_s(self) -> float:
        spec = self.spec
        storm = spec.get("straggle")
        total = 0.0
        for i, _rid in enumerate(self.replicas):
            factor = 1.0
            if storm and storm["from"] <= self.t < storm["until"] \
                    and i < storm["workers"]:
                factor = storm["factor"]
            total += _REPLICA_RATE * factor
        if self.poison:
            total *= float(spec.get("poison_factor", 0.35))
        return total

    def _apply_boundaries(self) -> None:
        # booted joins come online
        ready = [(rt, rid) for rt, rid in self._pending_joins
                 if rt <= self.t]
        if ready:
            self._pending_joins = [(rt, rid) for rt, rid
                                   in self._pending_joins if rt > self.t]
            for _rt, rid in ready:
                self.replicas.append(rid)
        # train-width loans land at round boundaries only
        if self.tick_i and (self.t % self.round_s) == 0.0:
            if self._pending_lend:
                self.train_width -= self._pending_lend
                self._pending_lend = 0
            if self._pending_restore:
                self.train_width += self._pending_restore
                self._pending_restore = 0

    def tick(self) -> None:
        spec = self.spec
        self._apply_boundaries()
        canary_at = spec.get("canary_at")
        if canary_at is not None and not self.rolled_out \
                and not self.poison and self.t >= canary_at \
                and self.version == 1:
            self.version = 2
            self.poison = True
            self.rolled_out = True
            self._emit("serve", kind="rollout", version=self.version,
                       note="canary generation landed")
        arrivals = spec["rate"](self.t) * _TICK_S
        capacity_s = self._capacity_per_s()
        capacity = capacity_s * _TICK_S
        self.submitted += arrivals
        self.backlog += arrivals
        done = min(self.backlog, capacity)
        self.backlog -= done
        self.served += done
        # bounded queue: anything already past the drop deadline sheds
        max_backlog = capacity_s * _DROP_DEADLINE_MS / 1000.0
        if self.backlog > max_backlog:
            shed = self.backlog - max_backlog
            self.backlog = max_backlog
            self.dropped += shed
        wait_ms = _BASE_WAIT_MS + (
            self.backlog / capacity_s * 1000.0 if capacity_s > 0
            else _DROP_DEADLINE_MS)
        self.max_wait_ms = max(self.max_wait_ms, wait_ms)
        for spread in _SPREAD[:_SAMPLES_PER_TICK]:
            w = round(wait_ms * spread, 3)
            self._emit("request", model=_MODEL, bucket=_BUCKET,
                       queue_wait_ms=w, batch_assembly_ms=0.05,
                       device_ms=1.2, total_ms=round(w + 1.25, 3))
        if self.ctl is not None and self.tick_i % _STEP_EVERY == 0:
            self.ctl.step(t=self.t)
        self.tick_i += 1
        self.t = self.tick_i * _TICK_S

    def finish(self) -> None:
        self._emit("replica", kind="summary",
                   requests=int(self.submitted),
                   dropped=int(round(self.dropped)),
                   width=self.serve_width(),
                   wall_s=self.t)
        self._emit("serve", kind="summary", compiles=0,
                   requests=int(self.served),
                   note="sim pod roll-up (AOT ladder modeled: zero "
                        "serve-path compiles by construction)")
        if self.ctl is not None:
            self.ctl.summary(t=self.t)


def run_scenario(name: str, *, controlled: bool,
                 journal: str) -> dict:
    """One arm of one scenario: fresh journal, fresh sim, batch-SLO
    verdict over the arm's own journal.  Returns the trace record."""
    spec = SCENARIOS[name]
    if os.path.exists(journal):
        os.remove(journal)
    rec = set_recorder(Recorder(journal))
    try:
        sim = SimPod(spec, controller_armed=controlled, scenario=name)
        while sim.t < spec["duration_s"]:
            sim.tick()
        sim.finish()
        rec.close()
    finally:
        set_recorder(None)
    results = batch_slo.evaluate_journal(journal,
                                         batch_slo.load_manifest())
    record = {
        "scenario": name,
        "arm": "controlled" if controlled else "bare",
        "journal": journal,
        "dropped": int(round(sim.dropped)),
        "max_wait_ms": round(sim.max_wait_ms, 3),
        "slo_burned": [r["id"] for r in results if not r["ok"]],
        "slo_vacuous": [r["id"] for r in results
                        if r["ok"] and not r["applicable"]],
    }
    if controlled:
        record["actions"] = list(sim.ctl.actions)
        record["counts"] = dict(sim.ctl.counts)
        record["end_burning"] = sim.ctl.burn.burning(sim.t)
        record["train_width"] = sim.train_width
        record["serve_width"] = sim.serve_width()
    return record


def manifest_path(name: str) -> str:
    return os.path.join(CONTRACT_DIR, f"{name}.json")


def replay(names=None, *, journal_dir: str | None = None, log=print) -> dict:
    """Run every requested scenario A/B and diff its action trace and
    bare-arm burn set against the banked manifest.  Returns a summary dict
    with ``ok``."""
    names = list(names or SCENARIOS)
    tmp = journal_dir or tempfile.mkdtemp(prefix="ctl_scenarios_")
    os.makedirs(tmp, exist_ok=True)
    problems: list[str] = []
    records = []
    for name in names:
        bare = run_scenario(
            name, controlled=False,
            journal=os.path.join(tmp, f"ctl_{name}_bare.jsonl"))
        ctl = run_scenario(
            name, controlled=True,
            journal=os.path.join(tmp, f"ctl_{name}_controlled.jsonl"))
        records.append({"bare": bare, "controlled": ctl})
        # the A/B gates: bare burns, controlled holds
        if not bare["slo_burned"]:
            problems.append(f"{name}: bare arm burned NO gate "
                            "(scenario lost its teeth)")
        if ctl["slo_burned"]:
            problems.append(f"{name}: controlled arm burned "
                            f"{ctl['slo_burned']}")
        if ctl["dropped"] != 0:
            problems.append(f"{name}: controlled arm dropped "
                            f"{ctl['dropped']} requests")
        if ctl["end_burning"]:
            problems.append(f"{name}: burn engine still burning at end "
                            f"{ctl['end_burning']}")
        banked_path = manifest_path(name)
        if not os.path.exists(banked_path):
            problems.append(f"{name}: no banked manifest ({banked_path})")
        else:
            with open(banked_path, encoding="utf-8") as f:
                banked = json.load(f)
            if banked.get("actions") != ctl["actions"]:
                problems.append(
                    f"{name}: action trace drifted from banked manifest"
                    f" — got {ctl['actions']!r}, banked "
                    f"{banked.get('actions')!r}")
            if banked.get("bare_burned") != bare["slo_burned"]:
                problems.append(
                    f"{name}: bare-arm burn set drifted — got "
                    f"{bare['slo_burned']}, banked "
                    f"{banked.get('bare_burned')}")
        log(json.dumps({"scenario": name,
                        "bare_burned": bare["slo_burned"],
                        "actions": [a["action"] for a in ctl["actions"]],
                        "dropped": ctl["dropped"],
                        "max_wait_ms": ctl["max_wait_ms"]},
                       sort_keys=True))
    for p in problems:
        log(f"ctl_scenarios: FAIL {p}")
    return {"ok": not problems, "problems": problems,
            "scenarios": records, "journal_dir": tmp}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", action="append",
                    choices=sorted(SCENARIOS),
                    help="replay only this scenario (repeatable)")
    ap.add_argument("--journal-dir",
                    help="where the arm journals land (default: a temporary directory)")
    args = ap.parse_args(argv)
    summary = replay(args.scenario, journal_dir=args.journal_dir)
    print(json.dumps({"ok": summary["ok"],
                      "scenarios": len(summary["scenarios"]),
                      "problems": summary["problems"]}, sort_keys=True))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
