"""The production-loop drive: train, swap, refuse, roll back, prove it.

Counterpart of ``sparknet_tpu/loop/dryrun.py``.  One deterministic run
shared by ``python -m sparknet_tpu_torch.obs dryrun --loop``, ``tpunet
loop``, ``chip_smoke.py`` and the tests, exercising the FULL cycle against
a live engine with traffic in flight:

1. the seed-initialized incumbent serves a probe (scores ``s0``),
2. ``ProductionLoop`` trains elastic rounds, checkpoints atomically,
   captures the candidate from the SAVED file on a builder thread and
   hot-swaps it in (tickets submitted before the swap drain through the
   incumbent's own graphs: zero dropped),
3. the probe's scores CHANGE (``s1 != s0``: trained weights are live),
4. an over-budget candidate (``resnet50`` at the top bucket) is refused by
   admission pricing before any device work (journaled, incumbent
   untouched: the probe still reads ``s1``),
5. ``rollback`` restores the generation the last swap retired and the
   probe reads its scores again BITWISE (same ServedModel, same graphs):
   ``s0`` with one iteration, as in the JAX drive; with more, the scores
   the probe read just before the last rollout (the JAX drive holds them
   to ``s0``, which a rollback one generation back cannot give),
6. throughout, ``engine.serve_path_compiles`` stays ZERO: every capture
   landed on the builder thread, none on the serving path (the per-thread
   capture ledger, ``obs/sentinel.py``).

The refusal is priced through an injected one-row fit table
(``serve.loadgen.over_budget_table``): no table is banked for the card.

The run is on CUDA unless ``device="cpu"`` is given, and raises without a
card.  In a pool of ranks every rank calls :func:`loop_run` with the same
arguments: rank 0 holds the engine, the traffic and the gates, the other
ranks train and checkpoint with it (their summary carries the training
side and ``ok`` True).
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

__all__ = ["loop_run"]


def loop_run(iterations: int = 1, rounds_per_rollout: int = 2,
             family: str = "cifar10_quick", arm: str = "f32",
             buckets: tuple = (1, 8), per_worker_batch: int = 2,
             width: int | None = None, tau: int = 2, requests: int = 48,
             max_wait_ms: float = 5.0, refusal_family: str | None = "resnet50",
             seed: int = 0, workdir: str | None = None, controller: bool = False,
             log=None, device=None, plan=None) -> dict:
    """Run the full train -> serve -> swap -> rollback cycle; returns the
    gate summary (``ok`` and each gate).  ``width`` defaults to the process
    group's size (a world of one when no group exists); ``plan`` is a
    ``FaultPlan`` every rank replays.

    ``controller=True`` arms an :class:`~sparknet_tpu_torch.loop.autoctl.
    SLOController` over a ``LoopPlane`` on rank 0, stepped after each
    traffic burst and after the training cycle."""
    import torch.distributed as dist

    from sparknet_tpu_torch.common import resolve_device
    from sparknet_tpu_torch.loop.controller import ProductionLoop
    from sparknet_tpu_torch.loop.feed import synthetic_shard_feed
    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
    from sparknet_tpu_torch.serve.engine import ServeEngine
    from sparknet_tpu_torch.serve.loadgen import hbm_budget, over_budget_table
    from sparknet_tpu_torch.solvers.solver import Solver

    def say(msg: str) -> None:
        if log:
            log(msg)

    device = resolve_device(device)
    fam = GRAPH_SWEEP_FAMILIES[family]
    rank = dist.get_rank() if dist.is_initialized() else 0
    own_workdir = workdir is None
    if own_workdir:
        box = [tempfile.mkdtemp(prefix="tpunet_loop_") if rank == 0 else None]
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast_object_list(box, src=0)
        workdir = box[0]
    t_start = time.perf_counter()
    engine = None
    if rank == 0:
        engine = ServeEngine(
            buckets=buckets, max_wait_ms=max_wait_ms, device=device,
            hbm_bytes=hbm_budget(device),
            fit_table=over_budget_table(refusal_family) if refusal_family else None)
    loop = ProductionLoop(
        Solver(fam.solver(), fam.net(per_worker_batch), device=device), engine,
        synthetic_shard_feed(fam, per_worker_batch, seed=seed), workdir=workdir,
        family=family, arm=arm, buckets=buckets, width=width, tau=tau, plan=plan)
    try:
        if engine is None:
            summary = loop.run(iterations=iterations,
                               rounds_per_rollout=rounds_per_rollout, seed=seed)
            summary.update(rank=rank, ok=True)
            return summary
        return _serve_and_gate(loop, engine, iterations=iterations,
                               rounds_per_rollout=rounds_per_rollout, requests=requests,
                               refusal_family=refusal_family, seed=seed,
                               controller=controller, say=say, t_start=t_start)
    finally:
        loop.close()
        if own_workdir and rank == 0:
            shutil.rmtree(workdir, ignore_errors=True)


def _serve_and_gate(loop, engine, *, iterations: int, rounds_per_rollout: int,
                    requests: int, refusal_family: str | None, seed: int,
                    controller: bool, say, t_start: float) -> dict:
    """Rank 0's part of :func:`loop_run`: the traffic, the cycle and the
    gates."""
    from sparknet_tpu_torch.obs.recorder import get_recorder
    from sparknet_tpu_torch.obs.sentinel import get_sentinel
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS, AdmissionRefused
    from sparknet_tpu_torch.serve.loadgen import synthetic_items

    family, arm = loop.family, loop.arm
    sentinel = get_sentinel()
    captures0 = sentinel.count
    say(f"loading incumbent ({family}/{arm}), capturing {len(engine.buckets)} "
        "bucket(s) ...")
    incumbent = loop.ensure_serving(seed=seed)
    models = [incumbent]  # every generation that served, for the replay count

    rs = np.random.RandomState(seed)
    probe = synthetic_items(incumbent, 1, rs)[0]
    # warm every bucket, then zero the serving-path ledger: load captures
    # are by design, traffic or rollout captures on the request path the bug
    for b in engine.buckets:
        for item in synthetic_items(incumbent, max(1, b // 2), rs):
            engine.submit(loop.serve_name, item)
        engine.pump(force=True)
    compiles0 = engine.serve_path_compiles
    serving0 = sentinel.thread_count()
    s0 = np.asarray(engine.infer(loop.serve_name, probe))

    ctl = tail = None
    if controller:
        from sparknet_tpu_torch.loop.autoctl import LoopPlane, SLOController
        from sparknet_tpu_torch.obs.metrics import JournalTail

        rec = get_recorder()
        if rec.enabled:
            tail = JournalTail(rec.path)
        ctl = SLOController(LoopPlane(loop))
        say("controller armed (LoopPlane: lend/restore width, canary rollback)")

    def ctl_step() -> None:
        if ctl is None:
            return
        if tail is not None:
            ctl.feed_tail(tail)
        ctl.step()

    tickets = []

    def traffic(n: int) -> None:
        model = engine._models[loop.serve_name]
        for item in synthetic_items(model, n, rs):
            tickets.append(engine.submit(loop.serve_name, item))
        engine.pump(force=True)
        ctl_step()

    traffic(max(1, requests // 3))

    pending_swap: list = []
    retired = [s0]  # the probe on the generation the last swap retires

    def before_rollout(i: int) -> None:
        """Before the LAST rollout: probe the live generation (the one a
        rollback restores; the incumbent when ``iterations`` is 1), then
        leave tickets PENDING across the swap: they must resolve through
        its own graphs (the drain contract)."""
        live = engine._models[loop.serve_name]
        models.append(live)
        if i < iterations - 1:
            return
        retired[0] = np.asarray(engine.infer(loop.serve_name, probe))
        pending_swap.extend(engine.submit(loop.serve_name, item)
                            for item in synthetic_items(live, 3, rs))
        tickets.extend(pending_swap)

    say(f"training {iterations} x {rounds_per_rollout} elastic round(s) "
        f"(W={loop.trainer.width}, tau={loop.trainer.tau}) + rollout ...")
    trained = loop.run(iterations=iterations, rounds_per_rollout=rounds_per_rollout,
                       seed=seed, before_rollout=before_rollout)
    models.append(engine._models[loop.serve_name])
    ctl_step()
    swap_drained_ok = all(t.done() for t in pending_swap)
    s1 = np.asarray(engine.infer(loop.serve_name, probe))
    # an armed controller may have rolled the canary back already
    ctl_rolled_back = loop.rollbacks > 0
    scores_changed = not np.array_equal(s0, s1)
    say(f"post-rollout: scores_changed={scores_changed} "
        f"ctl_rolled_back={ctl_rolled_back} pending drained={swap_drained_ok}")

    traffic(max(1, requests // 3))

    refused = False
    if refusal_family:
        try:
            engine.build_candidate(loop.serve_name, family=refusal_family,
                                   buckets=(SERVE_BUCKETS[-1],))
        except AdmissionRefused as e:
            refused = True
            loop._emit("refused", round=loop.trainer.round,
                       note=f"over-budget candidate refused: "
                            f"{e.verdict['predicted_bytes']:,} B predicted vs "
                            f"{e.verdict['budget_bytes']:,} B budget")
            say("over-budget rollout candidate refused as priced")
    incumbent_intact = np.array_equal(s1, np.asarray(engine.infer(loop.serve_name, probe)))
    if loop.rollbacks > 0 and not ctl_rolled_back:
        # the controller rolled back between the two probes
        ctl_rolled_back = True
        incumbent_intact = True

    pending_rb = [engine.submit(loop.serve_name, item)
                  for item in synthetic_items(engine._models[loop.serve_name], 3, rs)]
    tickets.extend(pending_rb)
    ctl_rolled_back = ctl_rolled_back or loop.rollbacks > 0
    if ctl_rolled_back:
        say("canary already rolled back by the controller: no scripted rollback")
        engine.pump(force=True)
    else:
        loop.rollback()
    rollback_drained_ok = all(t.done() for t in pending_rb)
    s2 = np.asarray(engine.infer(loop.serve_name, probe))
    scores_restored = np.array_equal(retired[0], s2)
    say(f"post-rollback: scores_restored={scores_restored} "
        f"pending drained={rollback_drained_ok}")

    traffic(max(1, requests // 3))

    for t in tickets:
        t.wait(timeout=60.0)
    dropped = sum(1 for t in tickets if not t.done())
    serve_compiles = engine.serve_path_compiles - compiles0
    engine.shutdown()

    summary = {
        "iterations": iterations,
        "rounds": loop.trainer.round,
        "rollouts": loop.rollouts,
        "rollbacks": loop.rollbacks,
        "checkpoints": loop.checkpoints,
        "requests": len(tickets),
        "dropped": dropped,
        "swap_drained": swap_drained_ok,
        "rollback_drained": rollback_drained_ok,
        "scores_changed": scores_changed,
        "scores_restored": scores_restored,
        "incumbent_intact_after_refusal": incumbent_intact,
        "refused": refused,
        "serve_path_compiles": serve_compiles,
        # the serving thread's own captures after the warm-up: 0 while the
        # builder thread captured the candidate
        "serving_thread_captures": sentinel.thread_count() - serving0,
        "captures": sentinel.count - captures0,
        "replays": sum(m.batches for m in {id(m): m for m in models}.values()),
        "loss": trained["loss"],
        "rollout": loop.last_rollout,
        "wall_s": round(time.perf_counter() - t_start, 3),
    }
    summary["ctl_rolled_back"] = ctl_rolled_back
    summary["ok"] = bool(
        serve_compiles == 0 and dropped == 0 and swap_drained_ok
        and rollback_drained_ok and (scores_changed or ctl_rolled_back)
        and scores_restored and incumbent_intact and (refused or not refusal_family))
    if ctl is not None:
        summary["ctl"] = {**ctl.summary(), "actions": list(ctl.actions)}
    get_recorder().emit(
        "loop", kind="summary", model=loop.serve_name, family=family, arm=arm,
        iteration=iterations, round=loop.trainer.round, rollouts=loop.rollouts,
        rollbacks=loop.rollbacks, checkpoints=loop.checkpoints,
        requests=len(tickets), drained=len(pending_swap) + len(pending_rb),
        compiles=serve_compiles, loss=0.0, wall_s=summary["wall_s"],
        note=f"loop drive: gates ok={summary['ok']} compiles={serve_compiles} "
             f"dropped={dropped}")
    return summary
