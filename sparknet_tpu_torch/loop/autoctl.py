"""SLOController: the telemetry-to-action loop.

Counterpart of ``sparknet_tpu/loop/autoctl.py``: the same decisions on the
same burn stream.  The reference tolerated membership churn (SparkNet's
master re-broadcast and kept training whatever the executor pool looked
like, ref: src/main/scala/apps/CifarApp.scala:95-136), but who changed the
pool was always an operator or a fault.  Here a controller subscribed to
the streaming burn engine (``obs/burn.py``) spends the port's own muscles
on its own telemetry:

- **scale the replica pool** on projected-wait burn (the router's
  ``join_replica``/``kill_replica`` through the zero-drop ledger, the
  join priced before any boot);
- **lend training width to serving** under a flash crowd (the
  ``ElasticTrainer`` resized at the NEXT round boundary; a mid-round
  resize would tear the averaging);
- **roll back a canary** on SLO burn (the engine's bitwise ``rollback``).

Every step journals schema-valid ``ctl`` events (observe / decide / act /
cooldown / summary).  Actions are rate-limited by a cooldown and the burn
engine's own hysteresis.

Threading contract: the controller is STEPPED, never self-scheduling (no
thread of its own): call :meth:`SLOController.step` from the loop that
already owns the traffic (the loadgen submit loop, the loop drive).  In a
pool of ranks it runs on rank 0, which owns the journal and the engine;
``LoopPlane``'s plan changes reach the other ranks through
``ProductionLoop``'s broadcast of the plan at each iteration.

Off by default: nothing constructs an SLOController unless ``tpunet serve
--controller`` / ``tpunet loop --controller`` asks for one.
"""

from __future__ import annotations

import time

from sparknet_tpu_torch.obs.burn import BurnEngine
from sparknet_tpu_torch.obs.recorder import get_recorder

__all__ = ["SLOController", "RouterPlane", "LoopPlane"]

# the latency gate id the scale/lend/rollback actions answer to
_LATENCY_GATE = "warm-queue-p99"
# gates whose burn MORE CAPACITY can absorb: queue-wait and the
# shed/drop ledger.  A compile or roofline burn is a correctness
# signal — outside the canary window the controller journals it and
# stands down rather than booting replicas at a recompiling pod
_CAPACITY_GATES = ("warm-queue-p99", "zero-drop")

DEFAULT_COOLDOWN_S = 3.0
# healthy-for-this-long before any scale-down (the release side of the
# hysteresis: joining is urgent, leaving is patient)
DEFAULT_HEALTHY_S = 10.0
# a rollout is a "canary" (burn -> rollback, not burn -> scale) for
# this long after the swap lands
DEFAULT_CANARY_S = 60.0


class SLOController:
    """Burn stream in, priced actions out, everything journaled.

    ``plane`` is the control surface (duck-typed): the methods below
    are consulted, each optional action degrading to "not available"
    when the plane lacks the muscle —

    - ``serve_width() -> int``
    - ``can_grow() -> dict | None`` — admission preview; ``None`` means
      no free device, ``{"fits": False, ...}`` means priced and
      refused, ``{"fits": True, ...}`` carries the priced bytes
    - ``grow() -> dict`` / ``shrink() -> dict | None`` — join/kill a
      replica (shrink only below the baseline the controller grew)
    - ``can_lend() -> bool`` / ``lend() -> dict | None`` /
      ``restore() -> dict | None`` — train-width loan at the next
      round boundary
    - ``rollback() -> dict | None`` — bitwise canary rollback
    """

    def __init__(self, plane, *, manifest: dict | None = None,
                 fast_s: float = 1.0, slow_s: float = 30.0,
                 suspend_s: float = 5.0,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 healthy_s: float = DEFAULT_HEALTHY_S,
                 canary_s: float = DEFAULT_CANARY_S,
                 scenario: str | None = None, clock=None):
        self.plane = plane
        self._clock = clock or time.perf_counter
        self.burn = BurnEngine(manifest, fast_s=fast_s, slow_s=slow_s,
                                 suspend_s=suspend_s, clock=self._clock)
        self.cooldown_s = float(cooldown_s)
        self.healthy_s = float(healthy_s)
        self.canary_s = float(canary_s)
        self.scenario = scenario
        self._cooldown_until = float("-inf")
        self._cooldown_logged = False
        self._healthy_since: float | None = None
        self._last_rollout_t: float | None = None
        self._grown = 0  # replicas this controller added
        self._lent = 0   # train workers this controller lent away
        self.counts = {"observes": 0, "decides": 0, "acts": 0,
                       "cooldowns": 0, "refused": 0}
        self.actions: list[dict] = []  # the banked-trace material

    # -- event intake ------------------------------------------------------

    def observe(self, event: str, fields: dict,
                t: float | None = None) -> None:
        """Feed one journal event to the burn engine; also tracks the
        canary window (rollout seen -> burn answers with rollback)."""
        now = self._clock() if t is None else float(t)
        if event in ("serve", "replica", "loop"):
            kind = fields.get("kind")
            if kind == "rollout":
                self._last_rollout_t = now
            elif kind == "rollback":
                self._last_rollout_t = None
        self.burn.observe(event, fields, t=now)

    def feed_tail(self, tail, t: float | None = None) -> int:
        """Drain a live journal tail into the engine (the
        out-of-process wiring `tpunet serve --controller` uses)."""
        n = 0
        for ev in tail.poll():
            name = ev.get("event")
            if isinstance(name, str):
                self.observe(name, ev, t=t)
                n += 1
        return n

    # -- the decision step -------------------------------------------------

    def _emit(self, kind: str, **fields) -> None:
        if self.scenario is not None:
            fields.setdefault("scenario", self.scenario)
        get_recorder().emit("ctl", kind=kind, **fields)

    def _canary_live(self, now: float) -> bool:
        return (self._last_rollout_t is not None
                and now - self._last_rollout_t <= self.canary_s)

    def step(self, t: float | None = None) -> list[dict]:
        """One observe -> decide -> act pass.  Returns the actions
        executed this step (usually empty)."""
        now = self._clock() if t is None else float(t)
        results = self.burn.evaluate(now)
        self.counts["observes"] += 1
        self._emit("observe", t=round(now, 3), gates=results,
                   burning=[r["id"] for r in results if r["burning"]])
        burning = [r for r in results if r["burning"]]
        if burning:
            self._healthy_since = None
            return self._respond_to_burn(now, burning)
        if self._healthy_since is None:
            self._healthy_since = now
        return self._maybe_release(now)

    def _cooling(self, now: float, gate: dict) -> bool:
        if now < self._cooldown_until:
            if not self._cooldown_logged:
                self._cooldown_logged = True
                self.counts["cooldowns"] += 1
                self._emit("cooldown", t=round(now, 3),
                           gate=gate["id"],
                           cooldown_s=round(self._cooldown_until - now, 3),
                           note="decision suppressed by hysteresis")
            return True
        self._cooldown_logged = False
        return False

    def _decide(self, now: float, gate: dict, action: str,
                reason: str) -> None:
        self.counts["decides"] += 1
        fields = {"t": round(now, 3), "gate": gate["id"],
                  "action": action, "reason": reason}
        if gate.get("fast") is not None:
            fields["fast"] = gate["fast"]
        if gate.get("slow") is not None:
            fields["slow"] = gate["slow"]
        self._emit("decide", **fields)

    def _act(self, now: float, action: str, outcome: dict) -> dict:
        self.counts["acts"] += 1
        record = {"action": action, "t": round(now, 3)}
        record.update({k: v for k, v in outcome.items()
                       if isinstance(v, (int, float, str, bool))})
        self.actions.append(record)
        self._emit("act", **record)
        self._cooldown_until = now + self.cooldown_s
        self._cooldown_logged = False
        return record

    def _respond_to_burn(self, now: float,
                         burning: list[dict]) -> list[dict]:
        gate = next((r for r in burning if r["id"] == _LATENCY_GATE),
                    next((r for r in burning
                          if r["id"] in _CAPACITY_GATES), burning[0]))
        if self._cooling(now, gate):
            return []
        plane = self.plane
        # a burning canary rolls back FIRST: capacity cannot fix a
        # poisoned model, and rollback is the cheapest reversible move
        if self._canary_live(now):
            self._decide(now, gate, "rollback",
                         "burn inside the canary window")
            outcome = plane.rollback()
            if outcome is not None:
                self._last_rollout_t = None
                return [self._act(now, "rollback", outcome)]
            return []
        if gate["id"] not in _CAPACITY_GATES:
            # compile / roofline burn outside the canary window:
            # capacity cannot absorb it — journal and stand down
            self._decide(now, gate, "none",
                         "capacity cannot absorb this gate's burn")
            self._cooldown_until = now + self.cooldown_s
            return []
        verdict = plane.can_grow()
        if verdict is not None and verdict.get("fits"):
            self._decide(now, gate, "join_replica",
                         "projected-wait burn, free device, priced fit")
            outcome = dict(verdict)
            outcome.update(plane.grow())
            self._grown += 1
            return [self._act(now, "join_replica", outcome)]
        if verdict is not None and not verdict.get("fits"):
            # priced and refused: journal it, do not boot (the serving
            # twin of preflight_oom — refusal is an outcome, not an
            # error)
            self.counts["refused"] += 1
            self._decide(now, gate, "none",
                         "admission refused the join "
                         f"(predicted {verdict.get('predicted_bytes')} "
                         f"> budget {verdict.get('budget_bytes')})")
            self._cooldown_until = now + self.cooldown_s
            return []
        if plane.can_lend():
            self._decide(now, gate, "lend_width",
                         "pool exhausted — lending training width at "
                         "the next round boundary")
            outcome = plane.lend()
            if outcome is not None:
                self._lent += int(outcome.get("count", 1))
                return [self._act(now, "lend_width", outcome)]
            return []
        self._decide(now, gate, "none",
                     "no free device, nothing to lend")
        self._cooldown_until = now + self.cooldown_s
        return []

    def _maybe_release(self, now: float) -> list[dict]:
        """The patient side: healthy long enough -> give back what the
        burn borrowed (kill grown replicas first — that frees the
        device a restored training worker needs)."""
        if self._grown == 0 and self._lent == 0:
            return []
        if now - (self._healthy_since or now) < self.healthy_s:
            return []
        if now < self._cooldown_until:
            return []
        if self._grown > 0:
            outcome = self.plane.shrink()
            if outcome is not None:
                self._grown -= 1
                self._decide(now, {"id": _LATENCY_GATE},
                             "kill_replica",
                             f"healthy {self.healthy_s:.0f}s — "
                             "returning borrowed capacity")
                return [self._act(now, "kill_replica", outcome)]
            self._grown = 0  # plane already at baseline
            return []
        outcome = self.plane.restore()
        if outcome is not None:
            self._lent = 0
            self._decide(now, {"id": _LATENCY_GATE}, "restore_width",
                         "healthy — returning lent training width")
            return [self._act(now, "restore_width", outcome)]
        self._lent = 0
        return []

    def summary(self, t: float | None = None) -> dict:
        """Journal + return the run roll-up (the scenario harness's
        trace footer)."""
        now = self._clock() if t is None else float(t)
        fields = {"t": round(now, 3), "ok": True, **self.counts,
                  "burning": self.burn.burning(now)}
        self._emit("summary", **fields)
        return fields


class RouterPlane:
    """ControlPlane over the ``ReplicaRouter``: grow/shrink the pool, priced
    through the replica engines' own admission (the fit table they were
    given, against their device's memory) or through ``fit_table`` at the
    same budget.  No training side, so lend/restore/rollback are
    unavailable (``tpunet serve --controller`` scales; the loop lends)."""

    def __init__(self, router, *, baseline: int | None = None,
                 fit_table: dict | None = None):
        self.router = router
        self.baseline = int(baseline if baseline is not None
                            else router.width())
        self._fit_table = fit_table

    def serve_width(self) -> int:
        return self.router.width()

    def _policy(self):
        from sparknet_tpu_torch.serve.residency import AdmissionPolicy

        live = next(iter(self.router._replicas.values())).engine.policy
        if self._fit_table is None:
            return live
        policy = AdmissionPolicy(self._fit_table, hbm_bytes=0)
        policy.budget_bytes = live.budget_bytes
        return policy

    def can_grow(self) -> dict | None:
        if self.router.free_devices() <= 0:
            return None
        verdict = self._policy().admit(self.router.family,
                                       max(self.router.buckets),
                                       resident_bytes=0)
        return {"fits": bool(verdict.get("fits", True)),
                "predicted_bytes": verdict.get("predicted_bytes"),
                "budget_bytes": verdict.get("budget_bytes")}

    def grow(self) -> dict:
        rid = self.router.join_replica()
        return {"replica": rid, "width": self.router.width()}

    def shrink(self) -> dict | None:
        if self.router.width() <= max(1, self.baseline):
            return None
        rid = max(self.router.replica_ids())
        rerouted = self.router.kill_replica(rid)
        return {"replica": rid, "width": self.router.width(),
                "rerouted": rerouted}

    def can_lend(self) -> bool:
        return False

    def lend(self) -> dict | None:
        return None

    def restore(self) -> dict | None:
        return None

    def rollback(self) -> dict | None:
        return None


class LoopPlane:
    """ControlPlane over the ``ProductionLoop``: lend/restore training
    width through the elastic trainer's OWN boundary protocol (a
    FaultEvent at ``round + 1``, never a mid-round tear; the loop
    broadcasts the plan to every rank at its next iteration), and the
    bitwise canary rollback.  The loop serves through one engine, so
    replica grow/shrink is unavailable here."""

    def __init__(self, loop, *, min_train_width: int = 2):
        self.loop = loop
        self.min_train_width = int(min_train_width)
        self._lent_wids: list[int] = []

    def serve_width(self) -> int:
        return 1

    def can_grow(self) -> dict | None:
        return None

    def grow(self) -> dict:
        raise RuntimeError("LoopPlane cannot grow the serve pool")

    def shrink(self) -> dict | None:
        return None

    def can_lend(self) -> bool:
        trainer = self.loop.trainer
        return trainer.width - 1 >= self.min_train_width

    def lend(self) -> dict | None:
        from sparknet_tpu_torch.parallel import elastic

        trainer = self.loop.trainer
        if trainer.width - 1 < self.min_train_width:
            return None
        wid = trainer._wids[-1]  # newest worker leaves first
        at = trainer.round + 1
        trainer.plan = elastic.FaultPlan(
            trainer.plan.events + (elastic.kill(wid, at),))
        self._lent_wids.append(wid)
        return {"count": 1, "from_width": trainer.width,
                "to_width": trainer.width - 1, "round": at}

    def restore(self) -> dict | None:
        from sparknet_tpu_torch.parallel import elastic

        if not self._lent_wids:
            return None
        trainer = self.loop.trainer
        n = len(self._lent_wids)
        at = trainer.round + 1
        trainer.plan = elastic.FaultPlan(
            trainer.plan.events + (elastic.join(at, count=n),))
        self._lent_wids.clear()
        return {"count": n, "from_width": trainer.width,
                "to_width": trainer.width + n, "round": at}

    def rollback(self) -> dict | None:
        try:
            prev = self.loop.rollback()
        except (KeyError, RuntimeError):
            return None  # nothing retained to roll back to
        return {"ok": True, "version": getattr(prev, "version", -1)}
