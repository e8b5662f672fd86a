"""The pod-serving drive: kill, join and swap under Poisson load.

Counterpart of ``sparknet_tpu/serve/dryrun.py`` (``replica_run``).  One
deterministic run against a live K-replica pool:

1. a kill with a KNOWN backlog: tickets submitted without a pump, one
   replica killed; its pending tickets are stolen and adopted by a
   survivor, ``rerouted`` > 0, and every one of them resolves;
2. a STEADY open-loop Poisson leg (``loadgen.open_loop_schedule``) with
   membership fixed: the queue p99 of admitted requests must sit inside
   ``max_wait_ms`` + one pump tick (the shed rule's whole point).  Faults
   stay out of this leg: a join or rollout captures whole bucket ladders,
   and a p99 across that window would measure the capture, not admission;
3. the same traffic while the fault plan runs LIVE: a replica joins
   (weights copied from a serving donor), another dies mid-stream, and a
   rollout walks the pool, with ``dropped == 0`` and
   ``serve_path_compiles == 0`` (captures happen on the boot and builder
   paths, never the request path);
4. continuous batching: a char-LM request decoded interleaved with
   churning neighbours gives the SAME greedy continuation as decoded
   alone (``ContinuousDecoder``, which runs eagerly and captures nothing).

Returns the summary; ``gates`` holds each gate's verdict and ``ok`` their
conjunction.  The router journals the pod's roll-up and the run its own
``replica`` summary event (the Recorder's, when one is armed).  Every gate but ``queue_p99`` is deterministic; that one is
read on the host clock, so it holds only where the pump thread is not
starved of a core.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["replica_run"]


def replica_run(replicas: int = 4, family: str = "transformer", arm: str = "f32",
                buckets: tuple = (1, 8, 64), max_wait_ms: float = 25.0,
                rate: float = 2000.0, seconds: float = 1.5, backlog: int = 40,
                seed: int = 0, log=None, devices=None,
                hbm_bytes: int | None = None) -> dict:
    """Run the kill/join/swap fault plan under open-loop load on the pool's
    device slots (``devices``, as ``ReplicaRouter`` takes them; they must
    hold one more slot than ``replicas`` for the join); returns the gate
    summary."""
    from sparknet_tpu_torch.obs.recorder import get_recorder
    from sparknet_tpu_torch.serve.continuous import ContinuousDecoder
    from sparknet_tpu_torch.serve.engine import SHED_TICK_MS
    from sparknet_tpu_torch.serve.loadgen import (
        hbm_budget, open_loop_schedule, synthetic_items)
    from sparknet_tpu_torch.serve.router import ReplicaRouter

    def say(msg: str) -> None:
        if log:
            log(msg)

    t_start = time.perf_counter()
    say(f"booting {replicas} replica(s) ({family}/{arm}), capturing "
        f"{len(buckets)} bucket(s) each ...")
    router = ReplicaRouter(replicas=replicas, family=family, arm=arm, buckets=buckets,
                           max_wait_ms=max_wait_ms, seed=seed, devices=devices,
                           hbm_bytes=hbm_budget(devices[0] if devices else None, hbm_bytes))
    some_model = next(iter(router._replicas.values())).model
    rs = np.random.RandomState(seed)
    router.warmup(rs)

    # -- leg 1: a kill with a known backlog ----------------------------------
    pre = [router.submit(item) for item in synthetic_items(some_model, backlog, rs)]
    victim = router.replica_ids()[0]
    rerouted = router.kill_replica(victim)
    router.pump(force=True)
    kill_resolved = all(t.done() for t in pre)
    say(f"kill: replica {victim} died with {rerouted} in-flight ticket(s) "
        f"re-routed; all resolved={kill_resolved}")

    def fire(kind: str) -> None:
        if kind == "join":
            router.join_replica()
        elif kind == "kill":
            router.kill_replica(router.replica_ids()[0])
        else:
            router.rollout(seed=seed + 1)
        say(f"fault fired mid-stream: {kind} (width now {router.width()})")

    items = synthetic_items(some_model, 256, rs)
    stop = threading.Event()
    worker = threading.Thread(target=router.serve_forever,
                              kwargs={"until": stop.is_set}, daemon=True)
    worker.start()
    steady, tickets, fired = [], [], []
    shed = 0
    try:
        # -- leg 2: steady open loop, membership fixed --------------------
        sched_a = open_loop_schedule(rate, seconds, seed=seed + 3)
        t0 = time.perf_counter()
        for i, due in enumerate(sched_a):
            now = time.perf_counter() - t0
            if due > now:
                time.sleep(due - now)
            t = router.submit(items[i % len(items)], shed=True)
            if t is None:
                shed += 1
            else:
                steady.append(t)
        for t in steady:
            t.wait(timeout=60.0)
        from sparknet_tpu_torch.serve.engine import percentile

        queue_p99 = percentile([(t.t_batch - t.t_submit) * 1e3 for t in steady
                                if t.t_batch is not None], 99)
        bound_ms = max_wait_ms + SHED_TICK_MS
        say(f"steady open loop: {len(steady)} admitted, {shed} shed, queue p99 "
            f"{queue_p99:.1f} ms (bound {bound_ms:.0f} ms)")

        # -- leg 3: open loop with a live join, kill and rollout -----------
        schedule = open_loop_schedule(rate, seconds, seed=seed + 7)
        faults = [(0.35 * seconds, "join"), (0.55 * seconds, "kill"),
                  (0.75 * seconds, "swap")]
        t0 = time.perf_counter()
        for i, due in enumerate(schedule):
            while faults and (time.perf_counter() - t0) >= faults[0][0]:
                fired.append(faults.pop(0)[1])
                fire(fired[-1])
            now = time.perf_counter() - t0
            if due > now:
                time.sleep(due - now)
            t = router.submit(items[i % len(items)], shed=True)
            if t is None:
                shed += 1
            else:
                tickets.append(t)
        for _, kind in faults:  # short schedules: fire the tail anyway
            fired.append(kind)
            fire(kind)
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        worker.join(timeout=30.0)
    if worker.is_alive():  # the drain below would wait on its model's lock
        raise RuntimeError("the pod's pump thread did not stop within 30 s of its stop")
    router.shutdown()
    for t in tickets:
        t.wait(timeout=60.0)
    stats = router.emit_summary(wall)
    dropped = sum(1 for t in pre + steady + tickets if not t.done())
    say(f"faulted open loop: {len(tickets)} admitted, captures on the request "
        f"path {stats['serve_path_compiles']}, dropped {dropped}")

    # -- leg 4: continuous batching, interleaved == alone --------------------
    dev = some_model.device
    alone = ContinuousDecoder(slots=4, seq_len=16, vocab=32, seed=seed, device=dev)
    t_alone = alone.submit([1, 2, 3], 8)
    alone.run()
    churn = ContinuousDecoder(slots=4, seq_len=16, vocab=32, seed=seed, device=dev)
    for i in range(6):  # staggered lengths force slot churn
        churn.submit([5 + i], 4 + i)
    t_mix = churn.submit([1, 2, 3], 8)
    churn.run()
    continuous_exact = t_alone.wait(5.0) == t_mix.wait(5.0)

    summary = {
        "replicas_start": replicas,
        "replicas_end": router.width(),
        "faults_fired": fired,
        "requests": len(pre) + len(steady) + len(tickets),
        "batches": stats["batches"],
        "shed": shed,
        "rerouted": stats["rerouted"],
        "rerouted_deterministic": rerouted,
        "kill_resolved": kill_resolved,
        "dropped": dropped,
        "pod_dropped": stats["dropped"],
        "queue_p99_ms": queue_p99,
        "queue_bound_ms": bound_ms,
        "p99_ms": stats["p99_ms"],
        "serve_path_compiles": stats["serve_path_compiles"],
        "continuous_exact": continuous_exact,
        "continuous_steps": alone.steps + churn.steps,
        "slot_churn": churn.stats()["admitted"] > churn.slots,
        "wall_s": time.perf_counter() - t_start,
    }
    summary["gates"] = {
        "kill_reroute": rerouted > 0 and kill_resolved,
        "no_drop": dropped == 0,
        "faults_fired": len(fired) == 3,
        "no_request_path_capture": summary["serve_path_compiles"] == 0,
        "queue_p99": queue_p99 <= bound_ms,  # a host-clock bound
        "continuous_exact": continuous_exact and summary["slot_churn"],
    }
    summary["ok"] = all(summary["gates"].values())
    get_recorder().emit(
        "replica", kind="summary", model="dryrun", family=family, arm=arm,
        width=router.width(), requests=summary["requests"], shed=shed,
        rerouted=stats["rerouted"], dropped=dropped, p99_ms=round(stats["p99_ms"], 3),
        wall_s=round(summary["wall_s"], 3),
        note=f"mode-20 fault plan {fired}: gates ok={summary['ok']} "
             f"compiles={summary['serve_path_compiles']} dropped={dropped}")
    return summary
