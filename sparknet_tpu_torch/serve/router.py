"""Replica router: K served copies in a pool of device slots, elastic
between flushes.

Counterpart of ``sparknet_tpu/serve/router.py``.  A :class:`ReplicaRouter`
holds K replicas, each its own :class:`~sparknet_tpu_torch.serve.engine.
ServeEngine` on one device slot, with no collective between them.

* ``submit`` sends a ticket to the replica with the least PROJECTED wait
  (its queue depth over its own drain-rate EWMA), raw depth breaking the
  tie before any rate evidence exists: join-shortest-queue that routes
  around a replica whose drain slowed.  ``submit_many`` routes a whole
  arrival chunk the same way under one lock.
* Admission prices PER REPLICA: each engine carries its own policy
  against its own device's memory.
* ``shed=True`` routes through the engines' deadline-aware admission.
* A kill STEALS the dead replica's pending tickets (unstamped,
  unresolved) and ADOPTS them onto the least-loaded survivor merged by
  original submit time: the SAME Ticket objects resolve, zero drop.
* A join copies the live weights (``load_model(variables=...)``, a copy
  on the new replica's device) so the pool stays score-consistent.
* ``rollout`` hot-swaps every replica in turn (``build_candidate`` +
  ``swap_model``): while one replica captures and swaps, the others keep
  serving.

The device pool is a list of SLOTS: one card may fill several
(``devices=["cuda:0"] * K``), each slot a replica with its own weights
and graphs.  The JAX router re-cuts a data mesh over the live devices on
every resize; here a resize re-counts the live slots (``live_slots``).
K replicas on one card share its SMs and copy engines, so they show the
pool's routing, kill, join and rollout behaviour, not K cards' scaling:
as with the elastic trainer's ranks on one card, throughput across cards
is not measured.  With ``SPARKNET_OBS`` armed the router journals the JAX
router's ``replica`` events: ``replica_up`` (boot and join),
``replica_down`` (with ``rerouted``), ``resize`` (a kill or a join re-cut
the live slots), ``rollout`` (per replica) and the ``summary``
(:meth:`summary`: ``dropped`` = submitted - resolved, which must be 0).

ref: caffe/src/caffe/parallel.cpp P2PSync (the reference's replica
fan-out across train replicas; serve-side routing is new surface).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.serve.batcher import Ticket
from sparknet_tpu_torch.serve.engine import ServeEngine, percentile

__all__ = ["Replica", "ReplicaRouter"]


class Replica:
    """One pool member: a stable id, its device slot, and a single-model
    engine.  Ids never recycle."""

    __slots__ = ("rid", "slot", "device", "engine", "model")

    def __init__(self, rid: int, slot: int, device, engine: ServeEngine, model):
        self.rid = rid
        self.slot = slot
        self.device = device
        self.engine = engine
        self.model = model

    def outstanding(self) -> int:
        """Lock-free queue-depth snapshot."""
        return len(self.model.batcher._q)


class ReplicaRouter:
    """K-replica serving pool with least-projected-wait routing, elastic
    membership, and per-replica hot swap.  One model name serves across
    the whole pool.  ``devices`` is the slot list (default: one slot per
    visible card); ``hbm_bytes`` is each engine's budget (default: its
    card's memory; required on the CPU)."""

    def __init__(self, replicas: int = 4, family: str = "transformer",
                 arm: str = "f32", buckets: tuple = (1, 8, 64),
                 max_wait_ms: float = 25.0, *, model_name: str = "model",
                 seed: int = 0, fit_table: dict | None = None,
                 hbm_bytes: int | None = None, devices=None):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.family = family
        self.arm = arm
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_wait_ms = float(max_wait_ms)
        self.model_name = model_name
        self.seed = int(seed)
        self._fit_table = fit_table
        self._hbm_bytes = hbm_bytes
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "devices=['cpu', ...] to run on the CPU explicitly")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self._device_pool = list(devices)
        if replicas > len(self._device_pool):
            raise ValueError(f"cannot place {replicas} replicas on "
                             f"{len(self._device_pool)} device slot(s)")
        self._lock = threading.RLock()
        self._replicas: dict[int, Replica] = {}
        self._next_rid = 0
        self._closed = False
        self.submitted = 0
        self.rerouted_total = 0
        # the ledger of models that left the pool (killed replicas,
        # swapped-out generations): pod stats count EVERY resolved ticket,
        # or the zero-drop arithmetic would blame churn for drops
        self._retired_requests = 0
        self._retired_batches = 0
        self._retired_shed = 0
        self._retired_compiles = 0
        self._retired_lat: list[float] = []
        self._retired_queue: list[float] = []
        self.live_slots: list[int] = []
        rec = get_recorder()
        for _ in range(replicas):
            rep = self._boot_replica(variables=None)
            rec.emit("replica", kind="replica_up", replica=rep.rid, model=model_name,
                     family=family, arm=arm, width=len(self._replicas),
                     predicted_bytes=rep.model.predicted_bytes, note="initial pool boot")

    # -- membership internals ----------------------------------------------

    def _slots(self) -> list[int]:
        return sorted(rep.slot for rep in self._replicas.values())

    def _free_slot(self) -> int:
        used = set(self._slots())
        for slot in range(len(self._device_pool)):
            if slot not in used:
                return slot
        raise RuntimeError(f"device pool exhausted ({len(self._device_pool)} slots, "
                           f"{len(self._replicas)} live replicas)")

    def _boot_replica(self, variables=None) -> Replica:
        """One replica: its own engine on a free slot, the model loaded
        (priced + captured) before it joins the pool, so a booting replica
        never receives traffic half-built."""
        with self._lock:
            slot = self._free_slot()
        device = self._device_pool[slot]
        engine = ServeEngine(self.buckets, self.max_wait_ms, fit_table=self._fit_table,
                             hbm_bytes=self._hbm_bytes, device=device)
        model = engine.load_model(self.model_name, family=self.family, arm=self.arm,
                                  buckets=self.buckets, seed=self.seed,
                                  variables=variables)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            rep = Replica(rid, slot, device, engine, model)
            self._replicas[rid] = rep
            self.live_slots = self._slots()
        return rep

    def _retire_counters(self, model, engine=None) -> None:
        """Fold a departing model's ledger into the pod totals (router lock
        held)."""
        self._retired_requests += model.requests
        self._retired_batches += model.batches
        self._retired_lat.extend(model.lat_total_ms)
        self._retired_queue.extend(model.lat_queue_ms)
        if engine is not None:
            self._retired_shed += engine.shed_total
            self._retired_compiles += engine.serve_path_compiles

    # -- membership surface (between flushes) ------------------------------

    def replica_ids(self) -> list[int]:
        with self._lock:
            return list(self._replicas)

    def width(self) -> int:
        return len(self._replicas)

    def free_devices(self) -> int:
        """Pool slots not hosting a replica (the SLO controller's can-grow
        preview, ``loop/autoctl.py``)."""
        with self._lock:
            return len(self._device_pool) - len(self._replicas)

    def _resized(self, from_width: int, reason: str) -> None:
        get_recorder().emit("replica", kind="resize", from_width=from_width,
                            to_width=len(self._replicas), note=reason)

    def kill_replica(self, rid: int) -> int:
        """A replica dies: steal its pending tickets and adopt them onto the
        least-loaded survivor (the SAME Ticket objects resolve there).
        Returns the re-routed ticket count."""
        with self._lock:
            if len(self._replicas) <= 1:
                raise RuntimeError("cannot kill the last replica (the pool would "
                                   "drop its queue)")
            from_width = len(self._replicas)
            dead = self._replicas.pop(rid)
            stolen = dead.model.batcher.steal()
            dead.model.batcher.close(drain=False)
            dead.engine._closed = True
            target = min(self._replicas.values(), key=Replica.outstanding)
            target.model.batcher.adopt(stolen)
            self.rerouted_total += len(stolen)
            self.live_slots = self._slots()
        # a batch the pump took before the kill finishes under the dead
        # model's lock before its ledger is folded in
        with dead.model.lock, self._lock:
            self._retire_counters(dead.model, dead.engine)
        get_recorder().emit(
            "replica", kind="replica_down", replica=rid, model=self.model_name,
            family=self.family, arm=self.arm, width=len(self._replicas),
            rerouted=len(stolen), outstanding=target.outstanding(),
            note=f"pending tickets adopted by replica {target.rid} merged by original "
                 "submit time: zero dropped")
        self._resized(from_width, f"replica {rid} killed")
        return len(stolen)

    def join_replica(self) -> int:
        """A fresh replica joins on a free slot with the live weights COPIED
        from a serving replica.  Returns the new replica id."""
        with self._lock:
            from_width = len(self._replicas)
            donor = next(iter(self._replicas.values()))
            variables = donor.model.source_variables
        rep = self._boot_replica(variables=variables)
        get_recorder().emit(
            "replica", kind="replica_up", replica=rep.rid, model=self.model_name,
            family=self.family, arm=self.arm, width=len(self._replicas),
            predicted_bytes=rep.model.predicted_bytes,
            note=f"elastic join: weights copied from replica {donor.rid}")
        self._resized(from_width, f"replica {rep.rid} joined")
        return rep.rid

    def rollout(self, variables=None, seed: int | None = None) -> int:
        """Hot-swap every replica to a new generation, one after another:
        each candidate captures off the request path, then swaps under its
        replica's pump lock while the others keep serving.  Returns the
        tickets drained through retiring models."""
        rec = get_recorder()
        drained = 0
        for rid in self.replica_ids():
            with self._lock:
                rep = self._replicas.get(rid)
            if rep is None:  # killed while we walked the pool
                continue
            candidate = rep.engine.build_candidate(
                self.model_name, family=self.family, arm=self.arm,
                buckets=self.buckets, variables=variables,
                seed=self.seed if seed is None else seed)
            info = rep.engine.swap_model(self.model_name, candidate)
            # a batch the pump took before the flip finishes under the
            # retiring model's lock before its ledger is folded in
            with rep.model.lock, self._lock:
                # the engine's ledgers (shed, captures) stay with the
                # engine; only the retiring MODEL's counters leave
                self._retire_counters(rep.model)
                rep.model = candidate
            drained += info["drained"]
            rec.emit("replica", kind="rollout", replica=rid, model=self.model_name,
                     family=self.family, arm=self.arm, version=info["version"],
                     drained=info["drained"], wall_s=round(info["swap_wall_s"], 6),
                     note="per-replica hot swap: the pool kept serving through the "
                          "capture")
        return drained

    # -- request path ------------------------------------------------------

    def warmup(self, rs: np.random.RandomState | None = None) -> int:
        """Force one flush through every bucket on EVERY replica, counted in
        the pod ledger so the zero-drop arithmetic stays exact.  Returns
        requests."""
        from sparknet_tpu_torch.serve.loadgen import synthetic_items

        rs = rs if rs is not None else np.random.RandomState(0)
        n = 0
        for rep in list(self._replicas.values()):
            for b in self.buckets:
                for item in synthetic_items(rep.model, max(1, b // 2), rs):
                    rep.engine.submit(self.model_name, item)
                    with self._lock:
                        self.submitted += 1
                    n += 1
                rep.engine.pump(force=True)
        return n

    def submit(self, item, *, shed: bool = False) -> Ticket | None:
        """Route one request to the least-projected-wait replica.  Returns
        its Ticket, or None when ``shed=True`` and that replica's projected
        queue wait is over the deadline bound."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            # enqueue inside the router lock: a concurrent kill can never
            # close the chosen batcher between the pick and the submit
            engine = self._pick_replica().engine
            ticket, line = engine.submit_deferred(self.model_name, item, shed=shed)
            if ticket is not None:
                self.submitted += 1
        # the shed journal line is written with no lock held
        engine.emit_shed(line)
        return ticket

    def submit_many(self, items: list, *, shed: bool = False) -> tuple[list[Ticket], int]:
        """Route a whole arrival chunk to the least-projected-wait replica
        under one router-lock acquisition.  Returns ``(tickets, shed_n)``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            engine = self._pick_replica().engine
            tickets, n_shed, line = engine.submit_many_deferred(
                self.model_name, items, shed=shed)
            self.submitted += len(tickets)
        engine.emit_shed(line)
        return tickets, n_shed

    def _pick_replica(self) -> Replica:
        """Least projected wait (batcher ``projected_wait_snapshot``), raw
        depth the tie-break.  Caller holds the router lock."""
        return min(self._replicas.values(),
                   key=lambda rep: (rep.model.batcher.projected_wait_snapshot(),
                                    len(rep.model.batcher._q)))

    def pump(self, force: bool = False) -> int:
        """One fair sweep: at most ONE batch per replica per pass, so a deep
        queue cannot starve its neighbours.  ``force=True`` sweeps until
        every replica is empty."""
        executed = 0
        while True:
            swept = 0
            for rep in list(self._replicas.values()):
                swept += rep.engine.pump(force=force, max_batches=1)
            executed += swept
            if swept == 0 or not force:
                return executed

    def serve_forever(self, until=None, poll_s: float = 0.002) -> int:
        """Pod pump loop: sweep all replicas; nap only when a sweep drained
        nothing."""
        executed = 0
        while not self._closed and not (until and until()):
            n = self.pump()
            executed += n
            if n == 0:
                time.sleep(poll_s)
        return executed

    def shutdown(self) -> int:
        """Drain every replica (zero in-flight requests lost) and close the
        pool.  Returns requests served during the drain."""
        with self._lock:
            self._closed = True
            reps = list(self._replicas.values())
        drained = 0
        for rep in reps:
            for batch in rep.model.batcher.close(drain=True):
                rep.engine._execute(rep.model, batch)
                drained += len(batch)
        return drained

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        """Pod roll-up: latencies merged across replicas (host clock),
        shed/reroute ledgers, per-replica detail."""
        with self._lock:
            reps = list(self._replicas.values())
            lat = list(self._retired_lat)
            queue = list(self._retired_queue)
            requests = self._retired_requests
            batches = self._retired_batches
            shed = self._retired_shed
            compiles = self._retired_compiles
        per_replica = {}
        for rep in reps:
            m = rep.model
            lat.extend(m.lat_total_ms)
            queue.extend(m.lat_queue_ms)
            requests += m.requests
            batches += m.batches
            shed += rep.engine.shed_total
            compiles += rep.engine.serve_path_compiles
            per_replica[rep.rid] = {"slot": rep.slot, "requests": m.requests,
                                    "batches": m.batches,
                                    "outstanding": rep.outstanding()}
        return {
            "family": self.family, "arm": self.arm, "buckets": list(self.buckets),
            "replicas": len(reps), "requests": requests, "batches": batches,
            "submitted": self.submitted, "shed": shed,
            "rerouted": self.rerouted_total, "serve_path_compiles": compiles,
            "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
            "queue_p99_ms": percentile(queue, 99), "per_replica": per_replica,
        }

    def emit_summary(self, wall_s: float) -> dict:
        """Journal the pod roll-up as a ``replica`` summary event and return
        it: :meth:`stats` plus ``dropped`` (submitted minus resolved, which
        MUST be 0: the zero-drop ledger the dryrun gates on) and ``rps``
        over ``wall_s``."""
        s = self.stats()
        s["dropped"] = self.submitted - s["requests"]
        s["rps"] = s["requests"] / wall_s if wall_s > 0 else 0.0
        get_recorder().emit(
            "replica", kind="summary", model=self.model_name, family=self.family,
            arm=self.arm, width=s["replicas"], requests=s["requests"], shed=s["shed"],
            rerouted=s["rerouted"], dropped=s["dropped"], rps=round(s["rps"], 2),
            p50_ms=round(s["p50_ms"], 3), p99_ms=round(s["p99_ms"], 3),
            wall_s=round(wall_s, 3), note="pod aggregate (host-side walls)")
        return s
