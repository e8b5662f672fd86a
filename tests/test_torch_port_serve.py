"""The port's CNN serving engine on the CPU (``sparknet_tpu_torch/serve``).

1. **The batcher against the JAX batcher**: one script of submits, clock
   advances, takes, sheds, chunked submits, steals and adopts runs through
   both ``DynamicBatcher``s under one fake clock; the flush sequences
   (bucket, batch_n, deadline_flush, payloads, t_batch), the shed counts
   and the projected waits are equal.  The JAX package's own batcher and
   loadgen cases (``tests/test_serve.py``, ``tests/test_serve_replica.py``)
   run unchanged against the port's classes.
2. **The engine against the JAX engine**: the same JAX-initialised
   weights (through ``interop.netvars_from_numpy``) and the same numpy
   items through the JAX ``ServeEngine`` and the port's, for
   ``cifar10_quick``, ``lenet`` and ``transformer`` at buckets (1, 8): the
   scores agree at rtol 1e-5 / atol 1e-5 (the classifier tests' tolerance:
   float32 sums in another order).
3. **Port-only checks**: exactness within a bucket, bit for bit; pricing,
   refusal and release of residency; the arms and families that raise;
   hot swap and rollback (also under live ``serve_forever`` traffic);
   ``shutdown``'s drain; the 504-request ``load_run``; CUDA by default;
   a ``serve/shed`` journal write that stalls holds no serving lock, so
   ``submit`` and ``pump`` on another thread go on.

On the CPU a bucket runs eagerly (no CUDA graph), so the capture ledger
stays at 0.  The tests pin one intra-op thread (ROADMAP Queue C item 7).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_serve  # noqa: E402  (the JAX package's serve tests)
import test_serve_replica  # noqa: E402

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.serve import batcher as port_batcher  # noqa: E402
from sparknet_tpu_torch.serve import engine as port_engine  # noqa: E402
from sparknet_tpu_torch.serve import graphs, loadgen  # noqa: E402
from sparknet_tpu_torch.serve.engine import (  # noqa: E402
    SERVE_BUCKETS, AdmissionRefused, ServeEngine, build_serve_program)
from sparknet_tpu_torch.serve.residency import AdmissionPolicy  # noqa: E402

CPU = dict(device="cpu", hbm_bytes=16 << 30)
FAMILIES = ("cifar10_quick", "lenet", "transformer")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a CPU GEMM's order of sums follows its thread
    team, which other work in the process can shrink."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_captures_on_cpu():
    before = graphs.capture_count()
    yield
    assert graphs.capture_count() == before


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# -- the batcher against the JAX batcher --------------------------------------


def _flush(batch):
    if batch is None:
        return None
    t = batch[0]
    return ("flush", t.bucket, t.batch_n, t.deadline_flush,
            [x.payload for x in batch], t.t_batch)


def _batcher_script(cls, buckets):
    """Drive one batcher through every rule; returns its trace."""
    clock = FakeClock()
    b = cls(buckets=buckets, max_wait_ms=5.0, clock=clock)
    trace = []
    # a trickle: deadline flushes
    for tick in range(30):
        clock.t = tick * 1e-3
        if tick % 2 == 0 and tick < 14:
            b.submit(f"t{tick}")
        trace.append(_flush(b.take()))
    # a burst, drained by forced takes 12.5 ms apart: rate windows
    for i in range(8 * buckets[-1] + 5):
        b.submit(f"b{i}")
    for _ in range(7):
        clock.t += 0.0125
        trace.append(_flush(b.take(force=True)))
        trace.append(("proj", b.projected_wait_ms(), b.projected_wait_snapshot(),
                      b._ewma_rate, b._ewma_take_ms))
    # shedding, one at a time and chunked
    for i in range(2 * buckets[-1] + 3):
        t = b.shed(f"s{i}", tick_ms=15.0)
        trace.append(None if t is None else ("admit", t.payload, t.t_submit))
    tickets, n_shed = b.submit_many([f"m{i}" for i in range(40)], shed=True, tick_ms=15.0)
    trace.append(("many", [t.payload for t in tickets], n_shed, b.shed_count,
                  b.last_projected_ms))
    # a re-route: steal into a second batcher, merged by submit time
    other = cls(buckets=buckets, max_wait_ms=5.0, clock=clock)
    clock.t += 0.001
    other.submit("late")
    other.adopt(b.steal())
    trace.append(("adopted", other.pending(), b.pending()))
    while (batch := other.take(force=True)) is not None:
        trace.append(_flush(batch))
    # the drain on close, and a close without drain
    for i in range(buckets[-1] + 2):
        b.submit(f"c{i}")
    trace.append([_flush(x) for x in b.close(drain=True)])
    c = cls(buckets=buckets, max_wait_ms=5.0, clock=clock)
    t = c.submit("x")
    c.close(drain=False)
    trace.append(("closed", type(t.error).__name__, str(t.error)))
    return trace


@pytest.mark.parametrize("buckets", [(1, 8, 64, 256), (1, 8), (4,)],
                         ids=["ladder", "two", "one"])
def test_batcher_flush_sequence_matches_jax(buckets):
    from sparknet_tpu.serve.batcher import DynamicBatcher as JaxBatcher

    want = _batcher_script(JaxBatcher, buckets)
    got = _batcher_script(port_batcher.DynamicBatcher, buckets)
    assert got == want
    # the script reached the rate windows and shed some arrivals
    assert any(x and x[0] == "proj" and x[3] for x in got)
    assert None in got[-20:] or any(x and x[0] == "many" and x[2] for x in got)


# the JAX package's own batcher, ticket, percentile and schedule cases, run
# against the port's classes (their module globals swapped for the port's)
JAX_CASES = [getattr(test_serve, n) for n in (
    "test_bucket_for_picks_smallest_fitting", "test_deadline_flush_under_trickle_load",
    "test_full_bucket_flushes_without_deadline", "test_partial_flush_stamps_smallest_bucket",
    "test_close_drains_every_inflight_request", "test_close_without_drain_fails_tickets",
    "test_overflow_drains_as_multiple_batches", "test_percentile_nearest_rank",
    "test_exec_batch_floor")] + [getattr(test_serve_replica, n) for n in (
    "test_window_opens_only_when_backlog_persists",
    "test_windowed_rate_and_projection_arithmetic",
    "test_asymmetric_ewma_adopts_slowdowns_fast",
    "test_shed_rejects_over_projection_and_counts",
    "test_shed_largest_bucket_floor_never_chokes", "test_cold_start_cap_bounds_blind_backlog",
    "test_submit_many_cold_cap_and_fifo_tail",
    "test_submit_many_rate_cap_floors_at_one_quantum",
    "test_ticket_event_is_lazy_and_resolve_lock_free",
    "test_open_loop_schedule_deterministic")]


@pytest.mark.parametrize("case", JAX_CASES, ids=[c.__name__[5:] for c in JAX_CASES])
def test_jax_batcher_cases_on_the_port(case, monkeypatch):
    import sparknet_tpu.serve.loadgen as jax_loadgen

    port = {"DynamicBatcher": port_batcher.DynamicBatcher, "Ticket": port_batcher.Ticket,
            "percentile": port_engine.percentile, "exec_batch": port_engine.exec_batch,
            "EXEC_FLOOR": port_engine.EXEC_FLOOR}
    mod = test_serve if case.__module__ == test_serve.__name__ else test_serve_replica
    for name, value in port.items():
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jax_loadgen, "open_loop_schedule", loadgen.open_loop_schedule)
    case()


@pytest.mark.parametrize("buckets", [SERVE_BUCKETS, (1, 8), (1, 8, 64), (4,)])
def test_loadgen_plans_and_draws_match_jax(buckets):
    from sparknet_tpu.parallel.modes import _feeds_for
    from sparknet_tpu.models.zoo import GRAPH_SWEEP_FAMILIES as JAX_FAMILIES
    from sparknet_tpu.serve import loadgen as jax_loadgen

    assert loadgen.burst_plan(504, buckets) == jax_loadgen.burst_plan(504, buckets)
    assert np.array_equal(loadgen.open_loop_schedule(500.0, 0.7, seed=len(buckets)),
                          jax_loadgen.open_loop_schedule(500.0, 0.7, seed=len(buckets)))
    for name in FAMILIES:
        fam = port_engine._family(name)
        want = _feeds_for(JAX_FAMILIES[name], buckets[-1], np.random.RandomState(5))
        got = port_engine._synthetic_feeds(fam, buckets[-1], seed=5)
        for k in want:
            assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype


# -- the engine against the JAX engine -----------------------------------------


def _jax_weights(model):
    v = model.variables
    return interop.netvars_from_numpy(
        {k: [np.asarray(p) for p in pl] for k, pl in v.params.items()},
        {k: {n: np.asarray(x) for n, x in s.items()} for k, s in v.state.items()},
        device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_scores_match_jax_engine(family):
    """Bucket 1 (``infer``), a full bucket 8 and a padded one: the port's
    scores within rtol 1e-5 / atol 1e-5 of the JAX engine's on the JAX
    engine's own weights."""
    from sparknet_tpu.serve import ServeEngine as JaxEngine

    jax_engine = JaxEngine(buckets=(1, 8))
    jax_model = jax_engine.load_model("m", family=family)
    engine = ServeEngine(buckets=(1, 8), **CPU)
    model = engine.load_model("m", family=family, variables=_jax_weights(jax_model))
    assert model.item_shape == tuple(jax_model.item_shape)
    assert model.item_dtype == jax_model.item_dtype
    assert model.score_blob == jax_model.score_blob
    items = loadgen.synthetic_items(model, 8, np.random.RandomState(3))
    for it in items[:2]:
        np.testing.assert_allclose(engine.infer("m", it),
                                   np.asarray(jax_engine.infer("m", it)),
                                   rtol=1e-5, atol=1e-5)
    for n in (8, 3):
        mine = [engine.submit("m", it) for it in items[:n]]
        theirs = [jax_engine.submit("m", it) for it in items[:n]]
        assert engine.pump(force=True) == jax_engine.pump(force=True) == 1
        for a, b in zip(mine, theirs):
            assert (a.bucket, a.batch_n) == (b.bucket, b.batch_n) == (8, n)
            np.testing.assert_allclose(a.result, np.asarray(b.result), rtol=1e-5, atol=1e-5)
    engine.shutdown()
    jax_engine.shutdown()


# -- port-only checks -------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_exact_within_bucket_and_across_buckets_on_cpu(family):
    """Within a bucket, bit for bit: a padded 3-batch and a full 8-batch
    give each real row the same bits.  Across buckets the engine promises
    no bits (``serve/engine.py``); on the CPU with one thread the same
    request in buckets 1, 8 and 64 agrees within 1e-5 of the largest
    |score| (the GEMMs' sums in another order; measured here at up to
    1.1e-6 of it between buckets 8 and 64, transformer, and bucket 1
    against 8 bit for bit for lenet and transformer)."""
    engine = ServeEngine(buckets=(1, 8, 64), **CPU)
    model = engine.load_model("m", family=family)
    items = loadgen.synthetic_items(model, 8, np.random.RandomState(3))
    full = [engine.submit("m", it) for it in items]
    engine.pump(force=True)
    padded = [engine.submit("m", it) for it in items[:3]]
    engine.pump(force=True)
    assert [t.bucket for t in full + padded] == [8] * 11
    for a, b in zip(padded, full):
        assert np.array_equal(a.result, b.result)
    serial = [engine.infer("m", it) for it in items]
    wide = [engine.submit("m", it) for it in items * 2]
    engine.pump(force=True)
    assert {t.bucket for t in wide} == {64}
    for one, t8, t64 in zip(serial, full, wide):
        tol = 1e-5 * np.abs(t8.result).max()
        assert np.abs(one - t8.result).max() <= tol
        assert np.abs(t64.result - t8.result).max() <= tol
    engine.shutdown()


def test_priced_loads_refused_admitted_and_released():
    """Priced families add their predicted bytes; a load past the budget
    is refused before any construction; an unload releases its bytes; a
    family the table does not price is admitted at 0 bytes."""
    row = {"c0": 100, "c1": 1, "params_bytes": 50, "slots_bytes": 20}
    table = {"families": {"lenet": {"f32": row}, "cifar10_quick": {"f32": row}}}
    engine = ServeEngine(buckets=(1, 8), fit_table=table, device="cpu", hbm_bytes=150)
    assert engine.policy.budget_bytes == 135
    engine.load_model("a", family="lenet")
    assert engine.resident_bytes() == 100 + 8 - 20
    with pytest.raises(AdmissionRefused) as ei:
        engine.load_model("b", family="cifar10_quick")
    v = ei.value.verdict
    assert v["priced"] and not v["fits"] and v["resident_bytes"] == 88
    assert engine.models() == ["a"]
    engine.load_model("t", family="transformer")  # unpriced: admitted
    assert engine.resident_bytes() == 88
    engine.unload_model("a")
    assert engine.resident_bytes() == 0 and engine.models() == ["t"]
    engine.load_model("b", family="cifar10_quick", buckets=(1,))
    assert engine.resident_bytes() == 100 + 1 - 20
    with pytest.raises(KeyError):
        engine.submit("a", np.zeros((1, 28, 28), np.float32))
    policy = AdmissionPolicy(fit_table={"families": {}}, hbm_bytes=1)
    verdict = policy.admit("lenet", max_bucket=256, resident_bytes=0)
    assert verdict["fits"] and not verdict["priced"]
    engine.shutdown()


def test_over_budget_refusal_through_an_injected_table():
    table = loadgen.over_budget_table("resnet50")
    engine = ServeEngine(fit_table=table, **CPU)
    with pytest.raises(AdmissionRefused, match="over the") as ei:
        engine.load_model("big", family="resnet50", buckets=(1, 8, 64, 256))
    assert ei.value.verdict["predicted_bytes"] > ei.value.verdict["budget_bytes"]
    assert engine.models() == [] and engine.resident_bytes() == 0


def test_arms_families_and_shapes_refused():
    engine = ServeEngine(buckets=(1,), **CPU)
    # the int8 arm loads since quant.py landed (tests/test_torch_port_quant.py)
    assert engine.load_model("q", family="lenet", arm="int8").qstate
    engine.unload_model("q")
    with pytest.raises(ValueError, match="unknown arm"):
        engine.load_model("m", family="lenet", arm="fp8")
    # the fold_bn arm and the mobilenet family load since BatchNorm landed
    engine.load_model("folded", family="lenet", arm="fold_bn")
    engine.load_model("mobile", family="mobilenet")
    engine.unload_model("folded")
    engine.unload_model("mobile")
    with pytest.raises(KeyError, match="serveable families"):
        engine.load_model("m", family="resnet50")
    engine.load_model("m", family="lenet")
    with pytest.raises(ValueError, match="item shape"):
        engine.submit("m", np.zeros((3, 32, 32), np.float32))
    with pytest.raises(ValueError, match="already resident"):
        engine.load_model("m", family="lenet")
    with pytest.raises(ValueError, match="hbm_bytes"):
        ServeEngine(device="cpu")
    engine.shutdown()


def test_swap_drains_with_the_incumbent_and_rollback_is_bitwise():
    engine = ServeEngine(buckets=(1, 8), **CPU)
    engine.load_model("m", family="lenet", seed=0)
    items = loadgen.synthetic_items(engine._models["m"], 4, np.random.RandomState(1))
    before = [engine.infer("m", it) for it in items]
    stale = [engine.submit("m", it) for it in items[:3]]  # queued, not pumped
    candidate = engine.build_candidate("m", family="lenet", seed=1)
    info = engine.swap_model("m", candidate)
    assert info == {"version": 1, "drained": 3, "swap_wall_s": info["swap_wall_s"]}
    for t, want in zip(stale, before):  # served by the incumbent's programs
        assert np.array_equal(t.result, want)
    after = [engine.infer("m", it) for it in items]
    assert not np.array_equal(after[0], before[0])
    assert engine._models["m"].previous is not None
    prev = engine.rollback("m")
    assert prev.version == 0 and engine._models["m"] is prev
    for it, want in zip(items, before):
        assert np.array_equal(engine.infer("m", it), want)
    with pytest.raises(RuntimeError, match="no previous generation"):
        engine.rollback("m")
    assert engine.serve_path_compiles == 0
    engine.shutdown()


def test_swap_and_rollback_under_live_serve_forever():
    """A pump thread serves while this thread builds, swaps and rolls back:
    every ticket resolves, none through a half-swapped model."""
    engine = ServeEngine(buckets=(1, 8), max_wait_ms=2.0, **CPU)
    engine.load_model("m", family="transformer", seed=0)
    items = loadgen.synthetic_items(engine._models["m"], 16, np.random.RandomState(2))
    pump = threading.Thread(target=engine.serve_forever, kwargs={"poll_s": 0.01})
    pump.start()
    tickets = []
    try:
        for step in range(3):
            tickets += [engine.submit("m", it) for it in items]
            candidate = engine.build_candidate("m", family="transformer", seed=step + 1)
            tickets += [engine.submit("m", it) for it in items]
            engine.swap_model("m", candidate)
            tickets += [engine.submit("m", it) for it in items]
            if step == 1:
                engine.rollback("m")
        for t in tickets:
            t.wait(timeout=60.0)
    finally:
        drained = engine.shutdown()
        pump.join(timeout=30.0)
    assert not pump.is_alive()
    assert drained == 0 and all(t.done() and t.error is None for t in tickets)
    assert engine.serve_path_compiles == 0


def test_infer_returns_while_another_thread_submits():
    """``infer`` pumps until its own ticket resolves, not until every queue
    is empty, so a client that keeps submitting cannot hold it forever."""
    engine = ServeEngine(buckets=(1, 64), **CPU)
    engine.load_model("m", family="lenet")
    items = loadgen.synthetic_items(engine._models["m"], 4, np.random.RandomState(4))
    want = engine.infer("m", items[0])
    stop = threading.Event()

    def client():  # slower than a 64-batch drains, faster than one infer
        while not stop.is_set():
            engine.submit("m", items[1])
            time.sleep(2e-4)

    feeder = threading.Thread(target=client)
    feeder.start()
    try:
        got = [engine.infer("m", items[0]) for _ in range(5)]
    finally:
        stop.set()
        feeder.join(timeout=30.0)
    assert not feeder.is_alive()
    for g in got:  # bucket 1 or 64: the across-bucket tolerance
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max()
    engine.shutdown()


def test_shutdown_drains_every_ticket():
    engine = ServeEngine(buckets=(1, 64), max_wait_ms=1e6, **CPU)  # nothing due
    engine.load_model("m", family="lenet")
    engine.load_model("n", family="cifar10_quick")
    tickets = [engine.submit(name, it) for name in ("m", "n")
               for it in loadgen.synthetic_items(engine._models[name], 11,
                                                 np.random.RandomState(0))]
    pump = threading.Thread(target=engine.serve_forever, kwargs={"poll_s": 0.01})
    pump.start()
    assert engine.shutdown() == 22
    pump.join(timeout=30.0)
    assert not pump.is_alive()
    assert all(t.done() and t.result.shape == (10,) for t in tickets)
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit("m", tickets[0].payload)


def test_load_run_resolves_504_requests():
    summary = loadgen.load_run(**CPU)
    assert summary["requests"] == summary["resolved"] == 504
    assert summary["buckets_exercised"] == list(SERVE_BUCKETS)
    assert summary["compiles_post_warmup"] == summary["serve_path_compiles"] == 0
    assert summary["refused"]
    assert summary["p99_ms"] >= summary["p50_ms"] > 0
    assert summary["padded_rows"] > 0
    assert set(summary["stats"]) == {"primary", "aux"}
    assert sum(s["requests"] for s in summary["stats"].values()) == 504 + 1 + 4 + 32 + 128


def test_build_serve_program_is_the_bucket_forward():
    fn, variables, feeds, alt = build_serve_program("lenet", bucket=1, device="cpu")
    out, alt_out = fn(variables, feeds), fn(variables, alt)
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    assert not torch.equal(out, alt_out)
    engine = ServeEngine(buckets=(1,), **CPU)
    engine.load_model("m", family="lenet", variables=variables)
    got = engine.infer("m", feeds["data"][0].numpy())
    np.testing.assert_array_equal(got, out[0].numpy())
    engine.shutdown()


def test_launches_recorded_by_a_capture_count_at_each_replay():
    """A kernel call inside a capture records a graph node: it is kept for
    the capture, not counted as a launch, and each replay adds it; another
    thread's launches meanwhile count as launches."""
    from sparknet_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    try:
        with kernels.recording_launches() as recorded:
            kernels._count("FLASH_LAUNCHES")
            other = threading.Thread(target=kernels._count, args=("FLASH_LAUNCHES",))
            other.start()
            other.join()
            kernels._count("FLASH_LAUNCHES")
        assert recorded == {"FLASH_LAUNCHES": 2} and kernels.FLASH_LAUNCHES == 1
        for _ in range(3):
            kernels.add_launches(recorded)
        kernels._count("FLASH_LAUNCHES")
        assert kernels.FLASH_LAUNCHES == 1 + 3 * 2 + 1
        assert kernels.PAGED_LAUNCHES == 0
    finally:
        kernels.reset_launch_counts()


def test_serving_entry_points_default_to_cuda(monkeypatch):
    from sparknet_tpu_torch.serve.router import ReplicaRouter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: ServeEngine(), lambda: ReplicaRouter(replicas=1),
                  lambda: loadgen.load_run(), lambda: build_serve_program()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_wait_due_wakes_when_a_hot_swap_drains_the_batcher():
    """A worker blocked in ``wait_due`` on the generation a hot swap
    retires returns at once (False: nothing due), so it goes on to wait on
    the next generation's batcher instead of sleeping out its timeout."""
    b = port_batcher.DynamicBatcher(buckets=(1, 8), max_wait_ms=5.0)
    out = []

    def worker():
        t0 = time.monotonic()
        out.append((b.wait_due(timeout=60.0), time.monotonic() - t0))

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    t0 = time.monotonic()
    while th.is_alive() and time.monotonic() - t0 < 20.0:
        assert b.drain() == []  # a drain before the worker waits wakes nothing
        th.join(timeout=0.05)
    assert out and out[0][0] is False and out[0][1] < 20.0, out


def test_stalled_shed_journal_write_holds_no_serving_lock(tmp_path):
    """The throttled ``serve/shed`` line is decided under the pump lock but
    written after it is released: while one thread's shed write is stalled
    (a journal on a slow filesystem), another thread submits, pumps and
    gets its scores.  The recorder's sink blocks on an ``Event`` for the
    shed line alone, before its own lock, so only the engine's locks are
    in question."""
    from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder

    class StalledShedSink(Recorder):
        def __init__(self, path):
            super().__init__(path)
            self.entered, self.release = threading.Event(), threading.Event()

        def emit(self, event, **fields):
            if fields.get("kind") == "shed":
                self.entered.set()
                self.release.wait(60.0)
            super().emit(event, **fields)

    rec = StalledShedSink(str(tmp_path / "journal.jsonl"))
    prev = set_recorder(rec)
    shed_out, other_out = [], []
    shedder = other = None
    try:
        engine = ServeEngine(buckets=(1, 2), max_wait_ms=1e6, **CPU)  # nothing due
        engine.load_model("m", family="lenet")
        item = loadgen.synthetic_items(engine._models["m"], 1, np.random.RandomState(6))[0]
        # no rate evidence yet: the queue holds two of the top bucket, then sheds
        assert all(engine.submit("m", item, shed=True) is not None for _ in range(4))
        shedder = threading.Thread(
            target=lambda: shed_out.append(engine.submit("m", item, shed=True)), daemon=True)
        shedder.start()
        assert rec.entered.wait(30.0)  # the shed line's write is stalled now

        def client():
            t = engine.submit("m", item)
            engine.pump(force=True)
            other_out.append(t.wait(30.0))

        other = threading.Thread(target=client, daemon=True)
        other.start()
        other.join(timeout=30.0)
        assert not other.is_alive(), "submit/pump waited on the stalled shed write"
        assert other_out and other_out[0].shape == (10,)
    finally:
        rec.release.set()
        for th in (shedder, other):
            if th is not None:
                th.join(timeout=30.0)
        set_recorder(prev)
    assert shed_out == [None] and engine.shed_total == 1
    engine.shutdown()
    rec.close()
    lines = (tmp_path / "journal.jsonl").read_text().splitlines()
    assert sum('"kind": "shed"' in line for line in lines) == 1
