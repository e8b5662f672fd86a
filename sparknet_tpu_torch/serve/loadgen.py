"""Synthetic load for the serving engine: arrival schedules, items, bursts,
the closed-loop load run and the steady pod run.

Counterpart of ``sparknet_tpu/serve/loadgen.py``.  ``load_run`` covers
every ladder bucket, a multi-model resident set, one over-budget refusal
and the capture ledger across >= 500 requests: the ledger is read AFTER
the model loads and a one-batch-per-bucket warm-up (every load captures
its buckets by design; what must be zero is captures caused by traffic).

The refusal is priced through an injected fit table: no table is banked
for the card (``serve/residency.py``), so ``load_run`` builds its engine
with :func:`over_budget_table`, one row that prices the refusal family
above any device's memory, and leaves the served families unpriced
(admitted).  ``pod_run(controller=True)`` arms the SLO controller
(``loop/autoctl.py``) over a ``RouterPlane``, stepped from the submit loop
and tailing the armed obs journal.  With ``SPARKNET_OBS`` armed
``load_run`` journals its ``serve`` summary.

ref: apps/ImageNetRunDBApp.scala:1 (the reference's synthetic-drive
scoring loop; open/closed-loop arrival processes are new surface).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.serve.engine import (
    SERVE_BUCKETS,
    AdmissionRefused,
    ServeEngine,
    percentile,
)
from sparknet_tpu_torch.serve.graphs import capture_count

__all__ = ["burst_plan", "hbm_budget", "load_run", "open_loop_schedule", "over_budget_table",
           "pod_run", "synthetic_items"]

# the memory a CPU engine prices admission against (the tests' figure): a
# CPU has no card whose memory the engine could read
CPU_HBM_BYTES = 16 << 30


def hbm_budget(device, hbm_bytes: int | None = None) -> int | None:
    """The memory an engine on ``device`` prices admission against:
    ``hbm_bytes`` when given; else on the card None (the engine reads the
    card's memory) and off it :data:`CPU_HBM_BYTES`."""
    if hbm_bytes is None and device is not None and torch.device(device).type != "cuda":
        return CPU_HBM_BYTES
    return hbm_bytes


def open_loop_schedule(rate: float, seconds: float, seed: int = 7) -> np.ndarray:
    """Deterministic open-loop (Poisson) arrival schedule: cumulative
    offsets (s) of every arrival in ``[0, seconds)`` at mean ``rate``
    req/s, exponential gaps from a seeded RNG (the same (rate, seconds,
    seed) always gives the same schedule, bit for bit the JAX package's)."""
    if rate <= 0 or seconds <= 0:
        raise ValueError(f"need positive rate/seconds, got {rate}/{seconds}")
    rs = np.random.RandomState(seed)
    n = max(16, int(rate * seconds * 1.5))
    gaps = rs.exponential(1.0 / rate, n)
    arrivals = np.cumsum(gaps)
    while arrivals[-1] < seconds:
        gaps = rs.exponential(1.0 / rate, n)
        arrivals = np.append(arrivals, arrivals[-1] + np.cumsum(gaps))
    return arrivals[arrivals < seconds]


def synthetic_items(model, n: int, rs: np.random.RandomState) -> list:
    """``n`` single-request payloads in the model's item shape and dtype
    (the JAX package's draws)."""
    if model.item_dtype == np.int32:
        vocab = getattr(model.family, "vocab", 2) or 2
        return [rs.randint(0, vocab, model.item_shape).astype(np.int32)
                for _ in range(n)]
    return [(rs.randn(*model.item_shape) * 10).astype(np.float32) for _ in range(n)]


def burst_plan(requests: int = 504, buckets: tuple = SERVE_BUCKETS) -> list[int]:
    """A deterministic burst-size sequence covering every bucket:
    largest-first fills (one burst per bucket, exact fit), then padded
    mid-bursts, then a trickle of singles up to ``requests`` total."""
    plan = [b for b in sorted(buckets, reverse=True)]
    mid = sorted(buckets)[min(1, len(buckets) - 1)]
    while sum(plan) + mid <= requests:
        plan.append(max(1, mid - 3) if len(plan) % 3 == 0 else mid)
    while sum(plan) < requests:
        plan.append(1)
    return plan


def over_budget_table(family: str) -> dict:
    """A one-row fit table pricing ``family`` at 1 EiB at any batch, more
    than any device holds: an injected refusal, not a measurement."""
    return {"families": {family: {"f32": {
        "c0": 1 << 60, "c1": 0, "params_bytes": 0, "slots_bytes": 0}}}}


def pod_run(replicas: int = 2, family: str = "transformer", arm: str = "f32",
            buckets: tuple = (1, 8, 64), max_wait_ms: float = 25.0,
            rate: float = 2000.0, seconds: float = 1.0, seed: int = 0,
            chunk_s: float = 0.005, controller: bool = False, log=None,
            devices=None, hbm_bytes: int | None = None) -> dict:
    """Steady open-loop load through a K-replica pod (no fault plan; that
    is ``dryrun.replica_run``'s job): boots a ``ReplicaRouter``, warms every
    bucket on every replica, reads the capture ledger, then sprays a seeded
    Poisson schedule in ``chunk_s`` horizons with deadline shedding on.

    ``controller=True`` arms an :class:`~sparknet_tpu_torch.loop.autoctl.
    SLOController` over a ``RouterPlane``, stepped from THIS loop (never a
    thread of its own), tailing the armed obs journal for the request
    stream when ``SPARKNET_OBS`` is set.  Off, nothing is constructed.

    Returns the pod summary; ``compiles_post_warmup`` and ``dropped`` are
    the gates (both must be 0)."""
    from sparknet_tpu_torch.serve.router import ReplicaRouter

    def say(msg: str) -> None:
        if log:
            log(msg)

    say(f"booting {replicas} replica(s) ({family}/{arm}), capturing "
        f"{len(buckets)} bucket(s) each ...")
    router = ReplicaRouter(replicas=replicas, family=family, arm=arm, buckets=buckets,
                           max_wait_ms=max_wait_ms, seed=seed, devices=devices,
                           hbm_bytes=hbm_budget(devices[0] if devices else None, hbm_bytes))
    rs = np.random.RandomState(seed)
    router.warmup(rs)
    captures0 = capture_count()

    ctl = tail = None
    if controller:
        from sparknet_tpu_torch.loop.autoctl import RouterPlane, SLOController
        from sparknet_tpu_torch.obs.metrics import JournalTail

        rec = get_recorder()
        if rec.enabled:
            tail = JournalTail(rec.path)
        ctl = SLOController(RouterPlane(router, baseline=replicas))
        say("controller armed (RouterPlane: priced join/kill"
            + (", tailing the obs journal)" if tail is not None
               else "; no journal armed: the burn gates see only summaries)"))

    def ctl_step() -> None:
        if ctl is None:
            return
        if tail is not None:
            ctl.feed_tail(tail)
        ctl.step()

    schedule = open_loop_schedule(rate, seconds, seed=seed)
    say(f"traffic: {len(schedule)} open-loop arrival(s) at {rate:g} req/s offered ...")
    items = synthetic_items(next(iter(router._replicas.values())).model, 256, rs)
    stop = threading.Event()
    pump = threading.Thread(target=router.serve_forever,
                            kwargs={"until": stop.is_set}, daemon=True)
    pump.start()
    tickets = []
    t0 = time.perf_counter()
    i = 0
    try:
        while i < len(schedule):
            now = time.perf_counter() - t0
            j = i
            while j < len(schedule) and schedule[j] <= now + chunk_s:
                j += 1
            if j > i:
                chunk = [items[k % len(items)] for k in range(i, j)]
                admitted, _ = router.submit_many(chunk, shed=True)
                tickets.extend(admitted)
                i = j
            else:
                time.sleep(min(chunk_s, schedule[i] - now))
            ctl_step()
        for t in tickets:
            t.wait(timeout=60.0)
        wall_s = time.perf_counter() - t0
    finally:
        stop.set()
        pump.join(timeout=30.0)
    router.pump(force=True)
    ctl_step()
    summary = router.emit_summary(wall_s)
    summary["offered"] = len(schedule)
    summary["admitted"] = len(tickets)
    summary["compiles_post_warmup"] = capture_count() - captures0
    summary["wall_s"] = round(wall_s, 3)
    if ctl is not None:
        summary["ctl"] = {**ctl.summary(), "actions": list(ctl.actions)}
    router.shutdown()
    return summary


def load_run(requests: int = 504, family: str = "cifar10_quick", arm: str = "f32",
             extra_models: tuple = (("aux", "lenet", "f32"),),
             buckets: tuple = SERVE_BUCKETS, max_wait_ms: float = 5.0,
             refusal_family: str | None = "resnet50", seed: int = 0, log=None,
             device=None, hbm_bytes: int | None = None) -> dict:
    """The closed-loop load run.  Returns a summary dict;
    ``compiles_post_warmup`` (the capture ledger's delta over the traffic
    phase) must be 0."""

    def say(msg: str) -> None:
        if log:
            log(msg)

    fit_table = over_budget_table(refusal_family) if refusal_family else None
    engine = ServeEngine(buckets=buckets, max_wait_ms=max_wait_ms, fit_table=fit_table,
                         hbm_bytes=hbm_budget(device, hbm_bytes), device=device)
    say(f"loading primary ({family}/{arm}), capturing {len(engine.buckets)} "
        "bucket(s) ...")
    primary = engine.load_model("primary", family=family, arm=arm, seed=seed)
    for name, fam, extra_arm in extra_models:
        say(f"loading {name} ({fam}/{extra_arm}) ...")
        engine.load_model(name, family=fam, arm=extra_arm, seed=seed)

    refused = False
    if refusal_family:
        try:
            # priced at the full ladder top: admission fires before any
            # construction, so the refused family need not be serveable
            engine.load_model("over_hbm", family=refusal_family,
                              buckets=(SERVE_BUCKETS[-1],))
        except AdmissionRefused as e:
            refused = True
            say(f"over-budget load refused as priced: "
                f"{e.verdict['predicted_bytes']:,} B predicted vs "
                f"{e.verdict['budget_bytes']:,} B budget")

    rs = np.random.RandomState(seed)
    # warm-up: one forced flush through every bucket, THEN read the ledger
    for b in engine.buckets:
        for item in synthetic_items(primary, max(1, b // 2), rs):
            engine.submit("primary", item)
        engine.pump(force=True)
    captures0 = capture_count()

    plan = burst_plan(requests, engine.buckets)
    say(f"traffic: {sum(plan)} request(s) over {len(plan)} burst(s) ...")
    tickets = []
    t0 = time.perf_counter()
    for i, burst in enumerate(plan):
        model_name = ("aux" if (extra_models and burst == 1 and i % 4 == 0)
                      else "primary")
        target = engine._models[model_name]
        for item in synthetic_items(target, burst, rs):
            tickets.append((model_name, engine.submit(model_name, item)))
        engine.pump(force=True)
    wall_s = time.perf_counter() - t0
    compiles_post = capture_count() - captures0

    for _, t in tickets:
        t.wait(timeout=60.0)
    totals = [ms for m in engine._models.values() for ms in m.lat_total_ms]
    summary = {
        "requests": len(tickets),
        "resolved": sum(t.done() for _, t in tickets),
        "batches": sum(m.batches for m in engine._models.values()),
        "padded_rows": sum(m.padded_rows for m in engine._models.values()),
        "buckets_exercised": sorted({t.bucket for _, t in tickets}),
        "compiles_post_warmup": compiles_post,
        "serve_path_compiles": engine.serve_path_compiles,
        "p50_ms": percentile(totals, 50),
        "p99_ms": percentile(totals, 99),
        "rps": len(tickets) / wall_s if wall_s > 0 else 0.0,
        "wall_s": wall_s,
        "refused": refused,
        "stats": engine.stats(),
    }
    get_recorder().emit(
        "serve", kind="summary", model="primary", family=family, arm=arm,
        buckets=summary["buckets_exercised"], requests=summary["requests"],
        batches=summary["batches"], padded=summary["padded_rows"],
        compiles=compiles_post, p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
        rps=round(summary["rps"], 1), wall_s=round(wall_s, 3),
        note="closed-loop load run (host-side walls)")
    engine.shutdown()
    return summary
