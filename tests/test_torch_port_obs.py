"""The port's obs journal (``sparknet_tpu_torch/obs``) against the JAX
package's ``sparknet_tpu/obs``, on the CPU.

1. **Schema**: the port's ``validate_line`` gives the JAX verdict on a
   corpus of one valid and one broken line for every event; a journal the
   port writes (the loop drive, obs on) passes the JAX ``validate_journal``.
2. **Recorder**: with obs off ``emit`` writes nothing and ``Span.fence``
   never reads its tensor; on a rank other than 0 the env-built recorder is
   off.  With obs off the hot paths (``Solver.step``, a ``ParallelTrainer``
   and an ``ElasticTrainer`` round, an engine replay) dispatch the same
   ATen ops as with obs on, less the one fence read (``.item()``) of
   ``Solver.step``; nothing is captured; the params are bit for bit equal.
   A port round record has the JAX record's keys and values (all but the
   walls and the optional ``comm``, which waits for A14) for the same
   trainer settings.
3. **Sentinel**: captures attributed per thread.
4. **Lineage**: the span ids equal the JAX ids for the same inputs, and
   ``audit``/``chain`` agree on one journal.
5. **metrics, slo, burn, autoctl**: on the same event streams the
   histogram buckets and percentiles, the hub's snapshots, the SLO
   verdicts, the burn gates' states and the ``SLOController``'s decisions
   and journaled ``ctl`` events are equal (exactly: the stdlib modules are
   the same code).
"""

import copy
import json
import os
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.loop import autoctl as jautoctl  # noqa: E402
from sparknet_tpu.obs import burn as jburn  # noqa: E402
from sparknet_tpu.obs import lineage as jlineage  # noqa: E402
from sparknet_tpu.obs import metrics as jmetrics  # noqa: E402
from sparknet_tpu.obs import recorder as jrecorder  # noqa: E402
from sparknet_tpu.obs import schema as jschema  # noqa: E402
from sparknet_tpu.obs import slo as jslo  # noqa: E402

from sparknet_tpu_torch.loop import autoctl  # noqa: E402
from sparknet_tpu_torch.obs import burn, lineage, metrics, schema, slo  # noqa: E402
from sparknet_tpu_torch.obs import recorder as precorder  # noqa: E402
from sparknet_tpu_torch.obs.sentinel import get_sentinel  # noqa: E402
from sparknet_tpu_torch.serve import graphs  # noqa: E402

import test_ctl  # noqa: E402  (the JAX package's controller tests: FakePlane)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- 1. schema ---------------------------------------------------------------


def _value(spec):
    """A value of the first type a schema spec allows."""
    t = spec[0] if isinstance(spec, tuple) else spec
    return {int: 1, float: 1.5, str: "x", list: [], dict: {}, bool: True,
            type(None): None}[t]


def _corpus(event: str) -> tuple[dict, dict]:
    required, optional = jschema.EVENTS[event]
    valid = {"event": event, "utc": "2026-10-18 12:00:00Z"}
    valid.update({k: _value(v) for k, v in required.items()})
    if optional:
        k = sorted(optional)[0]
        valid[k] = _value(optional[k])
    broken = dict(valid)
    if required:
        broken.pop(sorted(required)[0])
    else:
        broken["no_such_field"] = 1
    return valid, broken


def test_events_are_the_jax_events():
    assert schema.EVENTS == jschema.EVENTS
    assert schema.LEGACY_ALLOWLIST == jschema.LEGACY_ALLOWLIST


@pytest.mark.parametrize("event", sorted(jschema.EVENTS))
def test_validate_line_gives_the_jax_verdict(event):
    valid, broken = _corpus(event)
    assert schema.validate_line(valid) == jschema.validate_line(valid) == []
    got = schema.validate_line(broken)
    assert got and got == jschema.validate_line(broken)
    for bad in ({**valid, "utc": "yesterday"}, {**valid, "event": "nope"}, [valid]):
        assert schema.validate_line(bad) == jschema.validate_line(bad)


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    """A journal of the port's loop drive (obs on, CPU, one thread)."""
    from sparknet_tpu_torch.loop.dryrun import loop_run

    path = str(tmp_path_factory.mktemp("obs") / "loop.jsonl")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rec = precorder.set_recorder(precorder.Recorder(path, metrics_flush_every=16))
    try:
        summary = loop_run(requests=6, device="cpu")
    finally:
        rec.close()
        precorder.set_recorder(None)
        torch.set_num_threads(n)
    assert summary["ok"], summary
    return path


def test_port_journal_passes_both_validators(journal):
    for validate in (schema.validate_journal, jschema.validate_journal):
        n, allowed, errors = validate(journal)
        assert n > 20 and allowed == 0 and not errors, errors[:5]
    events = schema.load_journal(journal)
    names = {e["event"] for e in events}
    assert {"run_start", "round", "loop", "serve", "span", "request", "metrics",
            "run_end"} <= names
    serve = [e["kind"] for e in events if e["event"] == "serve"]
    assert serve[:1] == ["model_loaded"] and "candidate_built" in serve
    assert {"rollout", "rollback", "load_refused", "shutdown"} <= set(serve)
    assert all(e["fenced"] for e in events if e["event"] in ("round", "span"))


# -- 2. recorder -------------------------------------------------------------


class _Unreadable:
    def item(self):
        raise AssertionError("the fence read its tensor with obs off")


def test_off_recorder_writes_nothing_and_never_fences(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for raw in ("", "0"):
        monkeypatch.setenv("SPARKNET_OBS", raw)
        rec = precorder.Recorder.from_env()
        assert not rec and rec.run_id == "off"
        rec.emit("serve", kind="shutdown")
        rec.round(mode="solo", tau=1, devices=1, iters=1, batch=1, wall_s=1.0, loss=0.0,
                  fenced=True)
        with rec.span("x") as sp:
            assert sp.fence(_Unreadable()) is None
        rec.close()
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("SPARKNET_OBS", "1")
    assert precorder.Recorder.from_env().path == "obs_journal.jsonl"


def test_rank_other_than_0_journals_nothing(monkeypatch, tmp_path):
    import torch.distributed as dist

    monkeypatch.setenv("SPARKNET_OBS", str(tmp_path / "j.jsonl"))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert not precorder.Recorder.from_env()
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    assert precorder.Recorder.from_env()


def test_fence_reads_the_value(tmp_path):
    rec = precorder.Recorder(str(tmp_path / "j.jsonl"))
    with rec.span("step") as sp:
        assert sp.fence(torch.tensor(2.5)) == 2.5
    line = schema.load_journal(str(tmp_path / "j.jsonl"))[-1]
    assert line["fenced"] and line["fence_value"] == 2.5


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The ATen ops dispatched under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _lenet_solver():
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.solvers.solver import Solver

    return Solver(zoo.lenet_solver(), zoo.lenet(2), device="cpu")


def _feed(it):
    rs = np.random.RandomState(it)
    return {"data": rs.rand(2, 1, 28, 28).astype(np.float32),
            "label": rs.randint(0, 10, 2).astype(np.int32)}


def _traced(tmp_path, armed: bool, run):
    """``run()``'s ops and result with obs armed or off."""
    rec = precorder.set_recorder(precorder.Recorder(str(tmp_path / "on.jsonl")
                                                    if armed else None))
    captures = get_sentinel().count
    try:
        with _Ops() as mode:
            out = run()
    finally:
        rec.close()
        precorder.set_recorder(None)
    assert get_sentinel().count == captures
    return mode.ops, out


def _arena(solver):
    return torch.cat([p.detach().reshape(-1) for pl in solver.variables.params.values()
                      for p in pl])


def test_solver_step_off_path_dispatches_nothing_more(tmp_path, one_thread):
    runs = {}
    for armed in (False, True):
        s = _lenet_solver()
        runs[armed] = _traced(tmp_path, armed, lambda: s.step(3, _feed)) + (_arena(s),)
    (off, loss_off, w_off), (on, loss_on, w_on) = runs[False], runs[True]
    fence = "aten._local_scalar_dense.default"
    assert [op for op in on if op != fence] == [op for op in off if op != fence]
    assert on.count(fence) - off.count(fence) == 1  # the one fence read
    assert loss_on == loss_off and torch.equal(w_on, w_off)


@pytest.mark.parametrize("trainer", ["tau", "elastic"])
def test_trainer_round_off_path_is_the_on_path(tmp_path, trainer, one_thread):
    from sparknet_tpu_torch.parallel import ElasticTrainer, ParallelTrainer

    runs = {}
    for armed in (False, True):
        s = _lenet_solver()
        if trainer == "tau":
            tr = ParallelTrainer(s, tau=2)
            fn = lambda: tr.train_round(lambda it: {  # noqa: E731
                k: np.stack([_feed(it)[k], _feed(it + 1)[k]]) for k in ("data", "label")})
        else:
            tr = ElasticTrainer(s, tau=2)
            fn = lambda: tr.train_round(_feed)  # noqa: E731
        try:
            runs[armed] = _traced(tmp_path, armed, fn) + (_arena(s),)
        finally:
            tr.close()
    (off, loss_off, w_off), (on, loss_on, w_on) = runs[False], runs[True]
    assert on == off and loss_on == loss_off and torch.equal(w_on, w_off)


def test_engine_replay_off_path_is_the_on_path(tmp_path, one_thread):
    from sparknet_tpu_torch.serve.engine import ServeEngine
    from sparknet_tpu_torch.serve.loadgen import synthetic_items

    runs = {}
    for armed in (False, True):
        e = ServeEngine(buckets=(1, 8), device="cpu", hbm_bytes=16 << 30)
        m = e.load_model("m", family="lenet")
        items = synthetic_items(m, 5, np.random.RandomState(0))

        def run():
            ts = [e.submit("m", x) for x in items]
            e.pump(force=True)
            return np.stack([t.wait(5.0) for t in ts])

        runs[armed] = _traced(tmp_path, armed, run)
        e.shutdown()
    (off, s_off), (on, s_on) = runs[False], runs[True]
    assert on == off and np.array_equal(s_on, s_off)


def _record(path):
    return next(e for e in schema.load_journal(path) if e["event"] == "round")


# walls and losses are the run's own; ``compiles`` counts XLA compiles in
# the JAX record and CUDA graph captures in the port's (an eager step
# captures none)
_TIMED = {"utc", "run_id", "wall_s", "images_per_sec", "loss", "loss_ema", "comm",
          "compiles"}


def _compare_round(port_path, jax_path):
    got, want = _record(port_path), _record(jax_path)
    assert "comm" not in got  # the optional field waits for A14
    assert set(got) == set(want) - {"comm"}
    assert {k: v for k, v in got.items() if k not in _TIMED} == \
        {k: v for k, v in want.items() if k not in _TIMED}
    assert got["fenced"] and got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["compiles"] == 0


@pytest.mark.parametrize("mode", ["solo", "tau", "elastic"])
def test_round_record_matches_the_jax_record(tmp_path, mode, one_thread):
    """The same lenet weights, feeds and settings through both packages."""
    from sparknet_tpu.models import zoo as jzoo
    from sparknet_tpu.parallel.elastic import ElasticTrainer as JElastic
    from sparknet_tpu.parallel.trainer import ParallelTrainer as JParallel
    from sparknet_tpu.solvers.solver import Solver as JSolver
    from jax.sharding import Mesh

    from sparknet_tpu_torch.parallel import ElasticTrainer, ParallelTrainer

    js = JSolver(jzoo.lenet_solver(), jzoo.lenet(2))
    snap = js.save(str(tmp_path / "start"))
    ps = _lenet_solver()
    ps.restore(snap)
    stacked = lambda it: {k: np.stack([_feed(it)[k], _feed(it + 1)[k]])  # noqa: E731
                          for k in ("data", "label")}
    jpath, ppath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jrec = jrecorder.set_recorder(jrecorder.Recorder(jpath))
    try:
        if mode == "solo":
            js.step(2, _feed)
        elif mode == "tau":
            mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
            JParallel(js, mesh=mesh, tau=2).train_round(stacked)
        else:
            JElastic(js, width=1, tau=2, devices=jax.devices()[:1]).train_round(_feed)
    finally:
        jrec.close()
        jrecorder.set_recorder(None)
    prec = precorder.set_recorder(precorder.Recorder(ppath))
    try:
        if mode == "solo":
            ps.step(2, _feed)
        elif mode == "tau":
            tr = ParallelTrainer(ps, tau=2)
            tr.train_round(stacked)
            tr.close()
        else:
            tr = ElasticTrainer(ps, tau=2)
            tr.train_round(_feed)
            tr.close()
    finally:
        prec.close()
        precorder.set_recorder(None)
    _compare_round(ppath, jpath)


# -- 3. sentinel -------------------------------------------------------------


def test_sentinel_attributes_captures_per_thread():
    """A capture counts on the capturing thread alone: a builder thread's
    captures move its own count, never the caller's (the mechanism behind
    ``serve_path_compiles``)."""
    sentinel = get_sentinel()
    main0, total0 = sentinel.thread_count(), graphs.capture_count()
    builder = []

    def build():
        b0 = sentinel.thread_count()
        for _ in range(3):
            sentinel.note_capture()  # what BucketProgram._capture calls
        builder.append(sentinel.thread_count() - b0)

    t = threading.Thread(target=build)
    t.start()
    t.join(timeout=30.0)
    assert builder == [3]
    assert sentinel.thread_count() == main0
    assert graphs.capture_count() == total0 + 3 == sentinel.count


# -- 4. lineage --------------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("feed_span", ("lmdb",)), ("round_span", ("elastic", 7)),
    ("checkpoint_span", ("/w/round00004.solverstate.npz",)),
    ("candidate_span", ("a/b/round00002.solverstate.npz",)),
    ("generation_span", ("live", 3)), ("seed_root", (5,)),
    ("feed_lineage", ("ring", 4, 9)), ("round_lineage", ("tau", 2, 4, 5)),
    ("checkpoint_lineage", ("/x/r.npz", "round:elastic:1")),
    ("checkpoint_lineage", ("/x/r.npz", None)),
])
def test_span_ids_are_the_jax_ids(fn, args):
    assert getattr(lineage, fn)(*args) == getattr(jlineage, fn)(*args)


def test_ambient_parent_is_thread_local():
    with lineage.ambient("ckpt:a"):
        seen = []
        t = threading.Thread(target=lambda: seen.append(lineage.current_parent()))
        t.start()
        t.join()
        with lineage.ambient("ckpt:b"):
            assert lineage.current_parent() == "ckpt:b"
        assert lineage.current_parent() == "ckpt:a"
    assert seen == [None] and lineage.current_parent() is None


def test_audit_and_chain_agree_with_jax(journal):
    events = schema.load_journal(journal)
    assert lineage.audit(events) == jlineage.audit(events)
    assert not lineage.audit(events)["dangling"] and lineage.audit(events)["spans"] >= 5
    broken = events + [{"event": "request", "lineage": {"parent": "gen:live:v9"}}]
    assert lineage.audit(broken) == jlineage.audit(broken)
    assert lineage.audit(broken)["dangling"] == ["request -> gen:live:v9"]
    for ev in events:
        lin = ev.get("lineage")
        if isinstance(lin, dict) and lin.get("parent"):
            assert lineage.chain(events, lin) == jlineage.chain(events, lin)


# -- 5. metrics, slo, burn, autoctl -------------------------------------------


def _stream(seed: int, n: int = 400) -> list[dict]:
    """A seeded mix of journal events with a virtual clock ``t``."""
    rs = np.random.RandomState(seed)
    out, t = [], 0.0
    for i in range(n):
        t += float(rs.exponential(0.05))
        r = rs.rand()
        if r < 0.7:
            wait = float(rs.lognormal(2.5 if i < n // 2 else 4.0, 0.6))
            ev = {"event": "request", "model": f"m{rs.randint(2)}",
                  "bucket": int(rs.choice([1, 8])), "queue_wait_ms": round(wait, 4),
                  "batch_assembly_ms": 0.1, "device_ms": 1.0, "total_ms": round(wait + 1.1, 4)}
        elif r < 0.8:
            ev = {"event": "feed", "name": "ring", "batches": 4, "images": 32,
                  "wall_s": 1.0, "stages": {"slot_wait": float(rs.rand() * 0.2),
                                            "source": 0.5, "transform": 0.3}}
        elif r < 0.86:
            ev = {"event": "round", "mode": "elastic", "tau": 2, "devices": 2, "iters": 2,
                  "batch": 4, "wall_s": float(rs.rand()), "loss_ema": 1.0}
        elif r < 0.9:
            ev = {"event": "recompile", "count": 1, "total": i, "expected": bool(rs.rand() < .5)}
        elif r < 0.94:
            ev = {"event": "serve", "kind": str(rs.choice(["rollout", "shed", "summary"])),
                  "dropped": int(rs.rand() < 0.2), "shed": 2, "compiles": 0}
        elif r < 0.97:
            ev = {"event": "loop", "kind": "checkpoint"}
        else:
            ev = {"event": "token", "kind": "request", "ttft_ms": float(rs.rand() * 400)}
        ev["t"] = round(t, 4)
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_histograms_and_hub_equal_jax(seed):
    events = _stream(seed)
    values = [e["queue_wait_ms"] for e in events if e["event"] == "request"] + [0.0, -1.0]
    h, jh = metrics.Histogram(), jmetrics.Histogram()
    for v in values:
        h.observe(v)
        jh.observe(v)
    assert h.snapshot() == jh.snapshot()
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert metrics.percentile(h.snapshot(), q) == jmetrics.percentile(jh.snapshot(), q)
    assert [metrics.bucket_index(v) for v in values if v > 0] == \
        [jmetrics.bucket_index(v) for v in values if v > 0]
    half = len(values) // 2
    a, b = metrics.Histogram(), metrics.Histogram()
    for v in values[:half]:
        a.observe(v)
    for v in values[half:]:
        b.observe(v)
    assert metrics.merge_snapshots(a.snapshot(), b.snapshot()) == \
        jmetrics.merge_snapshots(a.snapshot(), b.snapshot())
    hub, jhub = metrics.MetricsHub(64), jmetrics.MetricsHub(64)
    for e in events:
        fields = {k: v for k, v in e.items() if k not in ("event", "t")}
        assert hub.observe_event(e["event"], fields) == jhub.observe_event(e["event"], fields)
    assert hub.flush_fields() == jhub.flush_fields()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_verdicts_equal_jax(seed):
    manifest = jslo.load_manifest()
    assert slo.load_manifest() == manifest
    events = _stream(seed)
    steady = [e for e in events if not (e["event"] in ("serve", "loop"))]
    for stream in (events, steady, []):
        got, want = slo.evaluate(stream, manifest), jslo.evaluate(stream, manifest)
        assert got == want
        assert slo.verdict_fields("j", got) == jslo.verdict_fields("j", want)


@pytest.mark.parametrize("seed", [0, 1])
def test_burn_gate_states_equal_jax(seed):
    manifest = jslo.load_manifest()
    kw = dict(fast_s=1.0, slow_s=5.0, suspend_s=2.0, clock=lambda: 0.0)
    eng, jeng = burn.BurnEngine(manifest, **kw), jburn.BurnEngine(manifest, **kw)
    for i, e in enumerate(_stream(seed)):
        fields = {k: v for k, v in e.items() if k not in ("event", "t")}
        eng.observe(e["event"], fields, t=e["t"])
        jeng.observe(e["event"], fields, t=e["t"])
        if i % 10 == 0:
            assert eng.evaluate(e["t"]) == jeng.evaluate(e["t"])
    assert eng.burning(e["t"]) == jeng.burning(e["t"])
    assert any(eng.burning(t) for t in (e["t"],)) or eng.evaluate(e["t"])


def _ctl_run(pkg_ctl, pkg_rec, path, plane, script):
    rec = pkg_rec.set_recorder(pkg_rec.Recorder(path, run_id="r"))
    try:
        ctl = pkg_ctl.SLOController(plane, manifest=test_ctl._MANIFEST, cooldown_s=3.0,
                                    healthy_s=10.0, clock=lambda: 0.0)
        script(ctl)
        ctl.summary(t=100.0)
    finally:
        rec.close()
        pkg_rec.set_recorder(None)
    lines = [{k: v for k, v in e.items() if k != "utc"}
             for e in schema.load_journal(path) if e["event"] == "ctl"]
    return ctl.actions, ctl.counts, plane.calls, lines


def _burn_then_recover(ctl):
    test_ctl._burn(ctl, t0=0.0)
    ctl.step(t=4.0)
    ctl.step(t=4.5)  # cooling down
    test_ctl._burn(ctl, t0=8.0)
    ctl.step(t=12.0)
    test_ctl._recover(ctl, t0=13.0)
    for t in (14.0, 20.0, 30.0, 45.0):
        ctl.step(t=t)


def _canary(ctl):
    ctl.observe("serve", {"kind": "rollout"}, t=0.0)
    test_ctl._burn(ctl, t0=6.0)
    ctl.step(t=10.0)


@pytest.mark.parametrize("case", ["join", "refused", "lend", "exhausted", "canary"])
def test_controller_decisions_equal_jax(tmp_path, case):
    planes = {"join": dict(free=1), "refused": dict(free=1, fits=False),
              "lend": dict(free=0, lendable=1), "exhausted": dict(free=0),
              "canary": dict(free=1, rollback_ok=True)}
    script = _canary if case == "canary" else _burn_then_recover
    got = _ctl_run(autoctl, precorder, str(tmp_path / "p.jsonl"),
                   test_ctl.FakePlane(**planes[case]), script)
    want = _ctl_run(jautoctl, jrecorder, str(tmp_path / "j.jsonl"),
                    test_ctl.FakePlane(**planes[case]), script)
    assert got == want
    assert got[3] and got[1]["observes"] >= 1


def test_journal_tail_reads_complete_lines_like_jax(tmp_path):
    path = tmp_path / "j.jsonl"
    path.write_text('{"event": "a"}\n{"event": "b"}\n{"event": "c"')
    tail, jtail = metrics.JournalTail(str(path)), jmetrics.JournalTail(str(path))
    assert list(tail.poll()) == list(jtail.poll()) == [{"event": "a"}, {"event": "b"}]
    with open(path, "a") as f:
        f.write('}\n')
    assert list(tail.poll()) == list(jtail.poll()) == [{"event": "c"}]
    path.write_text('{"event": "d"}\n')  # truncated: the cursor resets
    assert list(tail.poll()) == list(jtail.poll()) == [{"event": "d"}]


def test_obs_cli_validate_and_refusals(journal, capsys, monkeypatch):
    from sparknet_tpu_torch.obs.__main__ import main

    assert main(["validate", journal]) == 0
    assert main(["slo", "--quiet", journal]) == 0
    assert capsys.readouterr().out.startswith("OK ")
    assert main(["report", journal]) == 0
    assert "# obsnet run report" in capsys.readouterr().out
    assert main(["report", journal + ".missing"]) == 2
    # the chaos gate has nothing to check the port against yet (ROADMAP
    # A14): armed, a dryrun fails instead of passing unchecked
    monkeypatch.setenv("SPARKNET_CHAOS_SCHED", "7")
    assert main(["dryrun", "--ctl", "--out", journal + ".ctl"]) == 1
    bad = os.path.join(os.path.dirname(journal), "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"event": "round", "utc": "2026-10-18 12:00:00Z"}) + "\n")
    assert main(["validate", bad]) == 1
    assert copy.deepcopy(schema.EVENTS) == jschema.EVENTS


def test_obs_cli_dryrun_loop_journals_under_the_temp_dir(tmp_path, monkeypatch):
    """``dryrun --loop`` with no ``--out`` writes its journal in the
    temporary directory (which follows TMPDIR), and it validates."""
    import tempfile

    from sparknet_tpu_torch.obs.__main__ import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert main(["dryrun", "--loop", "--device", "cpu", "--rounds", "1", "--tau", "1"]) == 0
    path = tmp_path / "obs_dryrun.jsonl"
    n, _, errors = schema.validate_journal(str(path))
    assert n > 0 and not errors
