"""The port's replica router, pod load and fault-plan drive on the CPU
(``sparknet_tpu_torch/serve/router.py``, ``loadgen.pod_run``,
``dryrun.replica_run``), every replica on ``device="cpu"`` slots.

The cases of the JAX package's ``tests/test_serve_replica.py`` router
section, on the port: a kill re-routes the victim's queue exactly with
zero drops (the SAME Ticket objects resolve on a survivor); the
projected-wait pick over raw depth; the one-batch-per-model pump cap; the
chunked submit path; a join copies the live weights bit for bit; plus a
rollout under load, the pod run, and ``replica_run``'s gates with a short
schedule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu_torch.serve import graphs  # noqa: E402
from sparknet_tpu_torch.serve.dryrun import replica_run  # noqa: E402
from sparknet_tpu_torch.serve.engine import SHED_TICK_MS, ServeEngine  # noqa: E402
from sparknet_tpu_torch.serve.loadgen import pod_run, synthetic_items  # noqa: E402
from sparknet_tpu_torch.serve.router import ReplicaRouter  # noqa: E402

HBM = 16 << 30


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_captures_on_cpu():
    before = graphs.capture_count()
    yield
    assert graphs.capture_count() == before


def _router(replicas=2, slots=None, **kw):
    kw.setdefault("family", "lenet")
    kw.setdefault("buckets", (1, 8))
    kw.setdefault("max_wait_ms", 5.0)
    return ReplicaRouter(replicas=replicas, devices=["cpu"] * (slots or replicas),
                         hbm_bytes=HBM, **kw)


def _items(router, n, seed=3):
    model = next(iter(router._replicas.values())).model
    return synthetic_items(model, n, np.random.RandomState(seed))


def test_kill_reroutes_pending_exactly_zero_drop():
    router = _router(replicas=2)
    tickets = [router.submit(it) for it in _items(router, 12)]
    victim = router.replica_ids()[0]
    pending = router._replicas[victim].outstanding()
    assert pending > 0  # the pick spread work over both replicas
    rerouted = router.kill_replica(victim)
    assert rerouted == pending
    assert router.width() == 1 and router.live_slots == [1]
    router.pump(force=True)
    assert all(t.done() for t in tickets)
    stats = router.emit_summary(wall_s=1.0)
    assert stats["dropped"] == 0 and stats["rerouted"] == rerouted
    with pytest.raises(RuntimeError, match="last replica"):
        router.kill_replica(router.replica_ids()[0])
    router.shutdown()


def test_pick_replica_prefers_low_projected_wait():
    router = _router(replicas=2)
    slow, fast = list(router._replicas.values())
    slow.model.batcher._ewma_rate = 10.0  # 1 pending -> 100 ms wait
    slow.model.batcher.submit("stuck")
    fast.model.batcher._ewma_rate = 10_000.0
    for i in range(4):  # a deeper queue, but ~0.4 ms projected
        fast.model.batcher.submit(f"q{i}")
    assert router._pick_replica() is fast
    slow.model.batcher._ewma_rate = None  # no evidence: depth breaks the tie
    assert router._pick_replica() is slow
    for rep in (slow, fast):  # junk payloads must not reach _execute
        rep.model.batcher.steal()
    router.shutdown()


def test_pump_caps_one_batch_per_model_per_sweep():
    router = _router(replicas=1)
    rep = next(iter(router._replicas.values()))
    for it in _items(router, 20):
        router.submit(it)
    assert rep.engine.pump(force=True, max_batches=1) == 1
    assert rep.outstanding() == 12
    assert router.pump(force=True) == 2
    assert rep.outstanding() == 0
    router.shutdown()


def test_submit_many_routes_chunk_and_counts():
    router = _router(replicas=2)
    tickets, n_shed = router.submit_many(_items(router, 10), shed=True)
    assert len(tickets) == 10 and n_shed == 0
    assert router.submitted == 10
    assert sorted(r.outstanding() for r in router._replicas.values()) == [0, 10]
    router.pump(force=True)
    assert all(t.done() for t in tickets)
    router.shutdown()


def test_join_copies_live_weights_bitwise():
    router = _router(replicas=1, slots=2)
    item = _items(router, 1)[0]
    donor = next(iter(router._replicas.values()))
    before = donor.engine.infer("model", item)
    rid = router.join_replica()
    assert router.width() == 2 and router.live_slots == [0, 1]
    joined = router._replicas[rid]
    assert np.array_equal(joined.engine.infer("model", item), before)
    # a copy, not the donor's tensors
    w_donor = donor.model.variables.params["conv1"][0]
    w_joined = joined.model.variables.params["conv1"][0]
    assert torch.equal(w_donor, w_joined) and w_donor.data_ptr() != w_joined.data_ptr()
    with pytest.raises(RuntimeError, match="exhausted"):
        router.join_replica()
    router.shutdown()


def test_rollout_walks_the_pool_with_zero_drops():
    router = _router(replicas=2)
    router.warmup()
    queued = [router.submit(it) for it in _items(router, 6)]
    drained = router.rollout(seed=1)
    assert drained == 6 and all(t.done() for t in queued)
    stats = router.emit_summary(wall_s=1.0)
    assert stats["dropped"] == 0 and stats["serve_path_compiles"] == 0
    # the queued tickets were served by the seed-0 generation; the pool
    # now serves seed 1's weights
    ref = {s: ServeEngine(buckets=(1, 8), device="cpu", hbm_bytes=HBM) for s in (0, 1)}
    for s, engine in ref.items():
        engine.load_model("m", family="lenet", seed=s)
    for t in queued:
        assert np.array_equal(t.result, ref[0].infer("m", t.payload))
    item = queued[0].payload
    for rep in router._replicas.values():
        assert rep.model.version == 1
        assert np.array_equal(rep.engine.infer("model", item), ref[1].infer("m", item))
    router.shutdown()
    for engine in ref.values():
        engine.shutdown()


def test_pod_run_steady_load():
    s = pod_run(replicas=2, family="lenet", buckets=(1, 8), rate=300.0, seconds=0.3,
                devices=["cpu"] * 2, hbm_bytes=HBM)
    assert s["dropped"] == 0 and s["compiles_post_warmup"] == 0
    assert s["admitted"] + s["shed"] == s["offered"] > 0
    assert s["replicas"] == 2
    # the SLO controller (loop/autoctl.py) steps from the submit loop
    c = pod_run(replicas=2, family="lenet", buckets=(1, 8), rate=300.0, seconds=0.3,
                devices=["cpu"] * 3, hbm_bytes=HBM, controller=True)
    assert c["dropped"] == 0 and c["compiles_post_warmup"] == 0
    assert c["ctl"]["observes"] >= 1 and c["ctl"]["ok"]


def test_replica_run_gates_short_schedule():
    """Kill with a known backlog, a steady open-loop leg, a live
    join/kill/rollout with zero drops and zero request-path captures, and
    the continuous decoder's interleaved-equals-alone gate.  The steady
    leg's queue p99 bound (max_wait_ms + one pump tick) is a host-clock
    gate: it is held on the card by chip_smoke.py's replica phase, not
    here, where parallel test workers may starve the pump thread."""
    s = replica_run(replicas=2, buckets=(1, 8), rate=300.0, seconds=0.4, backlog=12,
                    devices=["cpu"] * 3, hbm_bytes=HBM)
    assert s["faults_fired"] == ["join", "kill", "swap"]
    assert s["rerouted_deterministic"] > 0 and s["kill_resolved"]
    assert s["dropped"] == s["pod_dropped"] == 0
    assert s["serve_path_compiles"] == 0
    assert np.isfinite(s["queue_p99_ms"]) and s["queue_bound_ms"] == 25.0 + SHED_TICK_MS
    assert s["continuous_exact"] and s["slot_churn"]
    assert all(ok for gate, ok in s["gates"].items() if gate != "queue_p99")
    assert s["replicas_end"] == 1
