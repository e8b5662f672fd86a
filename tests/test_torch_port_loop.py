"""The port's production loop (``sparknet_tpu_torch/loop``) on the CPU,
against the JAX package's ``ProductionLoop``.

1. **Loop parity.**  The JAX ``ProductionLoop`` runs at width 1 and at
   width 2 on the virtual CPU mesh; the port's at a world of one (in this
   process) and in a pool of two spawned gloo ranks (rank 0 serves).  Both
   start from one JAX-initialized ``cifar10_quick`` snapshot at a
   per-worker batch of 2, τ 2, two rounds, the same shard feed
   (``synthetic_shard_feed``: bit for bit the JAX feed) and three tickets
   left pending across the swap.  The checkpoint's arrays agree key for
   key, and so do the probe's scores after the rollout (rtol 1e-4, atol
   1e-5 of each array's largest |value|: the elastic tests' tolerance, as
   the two packages sum in other orders and momentum carries each last
   digit on).  The ``loop`` events agree in sequence (kind, round,
   version, drained), and the rollback restores the incumbent's scores bit
   for bit within each package.
2. **The loop drive** (``loop_run``): every gate, after
   ``tests/test_loop.py``'s, and a journal that validates and audits.
3. **The pieces**: the atomic save never shows a torn archive, the
   watcher, the deploy round trip, the shard feeds against the JAX feeds.
4. **The CLI**: ``loop`` and ``serve`` with ``--device cpu`` and ``--obs``
   exit 0 with their one-line summaries; ``bench`` and ``pods`` still
   refuse; ``pod_run(controller=True)`` runs.

The tests pin one intra-op thread where they compare bit for bit
(ROADMAP Queue C item 7) and restore it after.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.loop.controller import ProductionLoop as JProductionLoop  # noqa: E402
from sparknet_tpu.loop.feed import synthetic_shard_feed as j_feed  # noqa: E402
from sparknet_tpu.models.zoo import GRAPH_SWEEP_FAMILIES as J_FAMILIES  # noqa: E402
from sparknet_tpu.obs import recorder as jrecorder  # noqa: E402
from sparknet_tpu.obs import schema as jschema  # noqa: E402
from sparknet_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from sparknet_tpu.serve.loadgen import synthetic_items as j_items  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

from sparknet_tpu_torch import cli  # noqa: E402
from sparknet_tpu_torch.loop import (  # noqa: E402
    CheckpointWatcher,
    ProductionLoop,
    synthetic_shard_feed,
    variables_from_checkpoint,
)
from sparknet_tpu_torch.loop.dryrun import loop_run  # noqa: E402
from sparknet_tpu_torch.models import zoo  # noqa: E402
from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES  # noqa: E402
from sparknet_tpu_torch.obs import lineage, schema  # noqa: E402
from sparknet_tpu_torch.obs import recorder as precorder  # noqa: E402
from sparknet_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from sparknet_tpu_torch.serve.loadgen import synthetic_items  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = "cifar10_quick"
B = 2  # per-worker batch
TAU = 2
ROUNDS = 2
BUCKETS = (1,)
PENDING = 3  # tickets left pending across the swap
CPU = dict(device="cpu", hbm_bytes=16 << 30)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what, rtol=1e-4, arel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max()) + 1e-30, err_msg=what)


def _loop_events(path):
    return [(e["kind"], e.get("round"), e.get("version"), e.get("drained"))
            for e in schema.load_journal(path) if e.get("event") == "loop"]


# -- the port's run in a pool of two: rank 0 serves --------------------------

CHILD = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from sparknet_tpu_torch.loop import ProductionLoop, synthetic_shard_feed
from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder
from sparknet_tpu_torch.parallel import initialize_distributed
from sparknet_tpu_torch.serve.engine import ServeEngine
from sparknet_tpu_torch.serve.loadgen import synthetic_items
from sparknet_tpu_torch.solvers.solver import Solver

rank, work = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(f"{work}/spec.json"))
initialize_distributed(store_path=f"{work}/store", rank=rank, world_size=2, device="cpu")
fam = GRAPH_SWEEP_FAMILIES[spec["family"]]
s = Solver(fam.solver(), fam.net(spec["b"]), device="cpu")
s.restore(f"{work}/start.solverstate.npz")
engine = None
if rank == 0:
    set_recorder(Recorder(f"{work}/port2.jsonl"))
    engine = ServeEngine(buckets=tuple(spec["buckets"]), device="cpu", hbm_bytes=16 << 30)
loop = ProductionLoop(s, engine, synthetic_shard_feed(fam, spec["b"], seed=0),
                      workdir=f"{work}/ckpt2", family=spec["family"],
                      buckets=tuple(spec["buckets"]), tau=spec["tau"], width=2)
out = {}
if rank == 0:
    m = loop.ensure_serving(seed=0)
    rs = np.random.RandomState(5)
    probe = synthetic_items(m, 1, rs)[0]
    out["s0"] = engine.infer("live", probe)
    pending = [engine.submit("live", x) for x in synthetic_items(m, spec["pending"], rs)]
loop.run(iterations=1, rounds_per_rollout=spec["rounds"])
if rank == 0:
    out["pending_done"] = np.array(all(t.done() for t in pending))
    out["s1"] = engine.infer("live", probe)
    loop.rollback()
    out["s2"] = engine.infer("live", probe)
    engine.shutdown()
    np.savez(f"{work}/port2.npz", **out)
    set_recorder(Recorder(f"{work}/member.jsonl"))
loop.close()
# the membership journal: worker 1 killed at round 1
from sparknet_tpu_torch.parallel import ElasticTrainer, FaultPlan, kill
tr = ElasticTrainer(s, tau=1, plan=FaultPlan([kill(1, at_round=1)]))
tr.train(2, synthetic_shard_feed(fam, spec["b"], seed=0))
tr.close()
if rank == 0:
    set_recorder(None)
import torch.distributed as dist
dist.destroy_process_group()
print("rank", rank, "done")
'''


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The JAX loop at widths 1 and 2 and the port's at a world of one and
    a pool of two, from one snapshot; the pool runs while JAX computes."""
    work = tmp_path_factory.mktemp("loop_parity")
    fam = J_FAMILIES[FAMILY]
    snap = JSolver(fam.solver(), fam.net(B)).save(str(work / "start"))
    (work / "spec.json").write_text(json.dumps(dict(
        family=FAMILY, b=B, tau=TAU, rounds=ROUNDS, buckets=BUCKETS, pending=PENDING)))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env = {k: v for k, v in env.items() if not k.startswith(("JAX", "SPARKNET_OBS"))}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        res = {}
        for width in (1, 2):
            res[("jax", width)] = _jax_run(work, snap, width)
        res[("port", 1)] = _port_run(work, snap)
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"pool rank failed:\n{o}\n{e}"
    got = dict(np.load(work / "port2.npz"))
    ckpt = sorted((work / "ckpt2").glob("*.solverstate.npz"))
    res[("port", 2)] = dict(got, ckpt=str(ckpt[-1]), journal=str(work / "port2.jsonl"),
                            member=str(work / "member.jsonl"))
    return res


def _jax_run(work, snap, width):
    fam = J_FAMILIES[FAMILY]
    path = str(work / f"jax{width}.jsonl")
    rec = jrecorder.set_recorder(jrecorder.Recorder(path))
    try:
        s = JSolver(fam.solver(), fam.net(B))
        s.restore(snap)
        engine = JServeEngine(buckets=BUCKETS)
        loop = JProductionLoop(s, engine, j_feed(fam, B, seed=0), workdir=str(work / f"jck{width}"),
                               family=FAMILY, buckets=BUCKETS, tau=TAU, width=width,
                               devices=jax.devices()[:width])
        m = loop.ensure_serving(seed=0)
        rs = np.random.RandomState(5)
        probe = j_items(m, 1, rs)[0]
        s0 = np.asarray(engine.infer("live", probe))
        pending = [engine.submit("live", x) for x in j_items(m, PENDING, rs)]
        loop.run(iterations=1, rounds_per_rollout=ROUNDS)
        done = all(t.done() for t in pending)
        s1 = np.asarray(engine.infer("live", probe))
        loop.rollback()
        s2 = np.asarray(engine.infer("live", probe))
        engine.shutdown()
    finally:
        rec.close()
        jrecorder.set_recorder(None)
    ckpt = sorted((work / f"jck{width}").glob("*.solverstate.npz"))[-1]
    return dict(s0=s0, s1=s1, s2=s2, pending_done=done, ckpt=str(ckpt), journal=path)


def _port_run(work, snap):
    fam = GRAPH_SWEEP_FAMILIES[FAMILY]
    path = str(work / "port1.jsonl")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rec = precorder.set_recorder(precorder.Recorder(path))
    try:
        s = Solver(fam.solver(), fam.net(B), device="cpu")
        s.restore(snap)
        engine = ServeEngine(buckets=BUCKETS, **CPU)
        loop = ProductionLoop(s, engine, synthetic_shard_feed(fam, B, seed=0),
                              workdir=str(work / "ck1"), family=FAMILY, buckets=BUCKETS,
                              tau=TAU, width=1)
        try:
            m = loop.ensure_serving(seed=0)
            rs = np.random.RandomState(5)
            probe = synthetic_items(m, 1, rs)[0]
            s0 = engine.infer("live", probe)
            pending = [engine.submit("live", x) for x in synthetic_items(m, PENDING, rs)]
            loop.run(iterations=1, rounds_per_rollout=ROUNDS)
            done = all(t.done() for t in pending)
            s1 = engine.infer("live", probe)
            loop.rollback()
            s2 = engine.infer("live", probe)
            engine.shutdown()
        finally:
            loop.close()
    finally:
        rec.close()
        precorder.set_recorder(None)
        torch.set_num_threads(n)
    ckpt = sorted((work / "ck1").glob("*.solverstate.npz"))[-1]
    return dict(s0=s0, s1=s1, s2=s2, pending_done=done, ckpt=str(ckpt), journal=path)


@pytest.mark.parametrize("width", [1, 2])
def test_checkpoint_agrees_with_jax_key_for_key(parity, width):
    port, ref = parity[("port", width)], parity[("jax", width)]
    with np.load(port["ckpt"]) as got, np.load(ref["ckpt"]) as want:
        keys = sorted(k for k in want.files if k.startswith(("param/", "state/", "hist/")))
        assert keys and keys == sorted(k for k in got.files
                                       if k.startswith(("param/", "state/", "hist/")))
        assert int(got["__iter__"]) == int(want["__iter__"]) == ROUNDS * TAU
        for k in keys:
            _close(got[k], want[k], f"width {width}: {k}")


@pytest.mark.parametrize("width", [1, 2])
def test_probe_scores_after_rollout_agree_with_jax(parity, width):
    port, ref = parity[("port", width)], parity[("jax", width)]
    _close(port["s1"], ref["s1"], f"width {width}: probe scores after the rollout")
    assert not np.array_equal(port["s0"], port["s1"])  # the trained weights serve
    assert bool(port["pending_done"]) and ref["pending_done"]


@pytest.mark.parametrize("width", [1, 2])
def test_loop_events_agree_with_jax(parity, width):
    port, ref = parity[("port", width)], parity[("jax", width)]
    got, want = _loop_events(port["journal"]), _loop_events(ref["journal"])
    assert got == want
    assert [k for k, *_ in got] == ["checkpoint", "candidate", "rollout", "summary",
                                    "rollback"]
    assert got[2][3] == PENDING  # the pending tickets drained through the incumbent
    n, _, errors = jschema.validate_journal(port["journal"])
    assert n > 0 and not errors, errors[:5]


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("width", [1, 2])
def test_rollback_restores_scores_bitwise(parity, package, width):
    run = parity[(package, width)]
    assert np.array_equal(np.asarray(run["s0"]), np.asarray(run["s2"]))


def test_pool_of_two_journals_from_rank_0_only(parity):
    events = schema.load_journal(parity[("port", 2)]["journal"])
    rounds = [e for e in events if e.get("event") == "round"]
    assert [(r["mode"], r["devices"], r["workers"], r["batch"]) for r in rounds] == \
        [("elastic", 2, 2, 2 * B)] * ROUNDS
    assert sum(e.get("event") == "run_start" for e in events) == 1
    assert not lineage.audit(events)["dangling"]


def test_pool_journals_its_membership(parity):
    """Rank 0 journals the lost worker and the resize with the fields the
    JAX trainer's boundary writes for the same plan, and the rounds at
    widths 2 and 1."""
    path = parity[("port", 2)]["member"]
    n, _, errors = jschema.validate_journal(path)
    assert n > 0 and not errors, errors[:5]
    events = schema.load_journal(path)
    member = [{k: v for k, v in e.items() if k not in ("utc", "run_id")} for e in events
              if e["event"] in ("worker_lost", "worker_joined", "mesh_resize")]
    assert member == [
        {"event": "worker_lost", "worker": 1, "round": 1, "width": 1,
         "reason": "killed (fault plan)"},
        {"event": "mesh_resize", "round": 1, "from_width": 2, "to_width": 1, "devices": 1}]
    assert [(e["devices"], e["workers"], e["batch"], e["lineage"]["shards"])
            for e in events if e["event"] == "round"] == [(2, 2, 2 * B, [0, 1]),
                                                          (1, 1, B, [2, 2])]


# -- the loop drive ----------------------------------------------------------


def test_loop_run_gates(tmp_path, one_thread):
    """Every gate of the drive at a minimal scale, and its journal."""
    path = str(tmp_path / "j.jsonl")
    rec = precorder.set_recorder(precorder.Recorder(path))
    try:
        summary = loop_run(iterations=1, rounds_per_rollout=1, tau=1, requests=6,
                           per_worker_batch=2, workdir=str(tmp_path / "loop"), device="cpu")
    finally:
        rec.close()
        precorder.set_recorder(None)
    assert summary["ok"], summary
    assert summary["serve_path_compiles"] == 0 and summary["dropped"] == 0
    assert summary["scores_changed"] and summary["scores_restored"]
    assert summary["refused"] and summary["incumbent_intact_after_refusal"]
    assert summary["checkpoints"] == 1 and summary["rollouts"] == 1
    assert summary["rollout"]["drained"] == 3
    n, _, errors = schema.validate_journal(path)
    assert n > 0 and not errors, errors[:5]
    assert not lineage.audit(schema.load_journal(path))["dangling"]
    kinds = [e["kind"] for e in schema.load_journal(path) if e.get("event") == "loop"]
    assert kinds == ["checkpoint", "candidate", "rollout", "summary", "refused",
                     "rollback", "summary"]


def test_loop_run_token_family(one_thread):
    summary = loop_run(family="transformer", rounds_per_rollout=1, tau=1, requests=6,
                       device="cpu")
    assert summary["ok"], summary


def test_loop_needs_the_engine_on_rank_0_alone(tmp_path):
    fam = GRAPH_SWEEP_FAMILIES["lenet"]
    with pytest.raises(ValueError, match="rank 0 alone holds the engine"):
        ProductionLoop(Solver(fam.solver(), fam.net(2), device="cpu"), None,
                       synthetic_shard_feed(fam, 2), workdir=str(tmp_path))


def test_loop_run_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        loop_run()


# -- the pieces --------------------------------------------------------------


def _small_solver():
    return Solver(zoo.lenet_solver(), zoo.lenet(2), device="cpu")


def test_atomic_save_never_shows_a_torn_archive(tmp_path, monkeypatch):
    """A reader polling the final npz name during a SLOW save sees nothing
    or a complete archive (temp + ``os.replace``)."""
    import sparknet_tpu_torch.solvers.solver as solver_mod

    solver = _small_solver()
    prefix = str(tmp_path / "snap")
    final = f"{prefix}.solverstate.npz"
    real_savez = np.savez

    def slow_savez(f, **arrays):
        buf = io.BytesIO()
        real_savez(buf, **arrays)
        payload = buf.getvalue()
        step = max(1, len(payload) // 20)
        for i in range(0, len(payload), step):
            f.write(payload[i:i + step])
            time.sleep(0.002)

    monkeypatch.setattr(solver_mod.np, "savez", slow_savez)
    torn: list[str] = []
    stop = threading.Event()

    def poller():
        while not stop.is_set():
            if os.path.exists(final):
                try:
                    with np.load(final) as data:
                        assert "__iter__" in data.files
                except Exception as e:  # a torn archive is the bug
                    torn.append(repr(e))
            time.sleep(0.001)

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    try:
        out = solver.save(prefix)
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert out == final and os.path.exists(final)
    assert not torn, torn[:3]
    assert not [n for n in os.listdir(tmp_path) if n != os.path.basename(final)]


def test_checkpoint_watcher_sees_only_complete_new_files(tmp_path):
    w = CheckpointWatcher(str(tmp_path))
    assert w.poll() == []
    solver = _small_solver()
    path = solver.save(str(tmp_path / "round00001"))
    assert w.poll() == [path]
    assert w.poll() == []  # never the same path twice
    path2 = solver.save(str(tmp_path / "round00002"))
    assert w.poll() == [path2]


def test_checkpoint_deploy_roundtrip_bitwise(tmp_path):
    solver = _small_solver()
    path = solver.save(str(tmp_path / "snap"))
    variables = variables_from_checkpoint(path)
    for lname, plist in solver.variables.params.items():
        got = variables.params[lname]
        assert len(got) == len(plist)
        for a, b in zip(got, plist):
            assert torch.equal(a, b.detach().cpu()), lname
    for lname, state in solver.variables.state.items():
        for k, v in state.items():
            assert torch.equal(variables.state[lname][k], v.detach().cpu()), (lname, k)


def test_deploy_reads_the_jax_checkpoint_and_rejects_paramless(tmp_path):
    from sparknet_tpu.loop.deploy import variables_from_checkpoint as j_deploy

    fam = J_FAMILIES["lenet"]
    path = JSolver(fam.solver(), fam.net(2)).save(str(tmp_path / "j"))
    want, got = j_deploy(path), variables_from_checkpoint(path)
    assert sorted(want.params) == sorted(got.params)
    for ln, pl in want.params.items():
        for a, b in zip(pl, got.params[ln]):
            assert np.array_equal(np.asarray(a), b.numpy())
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, **{"__iter__": np.asarray(0)})
    with pytest.raises(ValueError, match="no param/"):
        variables_from_checkpoint(empty)


@pytest.mark.parametrize("family", ["cifar10_quick", "transformer"])
def test_shard_feed_is_the_jax_feed(family):
    """Shard ``g`` is the same batch in both packages, bit for bit."""
    got = synthetic_shard_feed(GRAPH_SWEEP_FAMILIES[family], 2, seed=3)
    want = j_feed(J_FAMILIES[family], 2, seed=3)
    for g in (0, 7, 8):
        a, b = got(g), want(g)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], np.asarray(b[k])), (g, k)
    assert np.array_equal(got(7)["data"], got(7)["data"])
    assert not np.array_equal(got(7)["data"], got(8)["data"])


def test_shard_batches_matches_jax():
    from sparknet_tpu.data.pipeline import SyntheticImageSource as JSource
    from sparknet_tpu.data.pipeline import shard_batches as j_shard

    from sparknet_tpu_torch.data.pipeline import SyntheticImageSource, shard_batches

    fn = shard_batches(SyntheticImageSource(4, shape=(3, 8, 8), seed=1))
    ref = j_shard(JSource(4, shape=(3, 8, 8), seed=1))
    for g in (0, 1, 5):
        assert np.array_equal(fn(g)["data"], ref(g)["data"])
        assert np.array_equal(fn(g)["label"], ref(g)["label"])


# -- the CLI -----------------------------------------------------------------


def _cli(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def test_cli_loop_on_cpu_with_obs(tmp_path, capsys, monkeypatch, one_thread):
    monkeypatch.delenv("SPARKNET_OBS", raising=False)
    path = str(tmp_path / "cli.jsonl")
    try:
        rc, summary = _cli(["--obs", path, "loop", "--device", "cpu", "--requests", "6",
                            "--rounds", "1"], capsys)
    finally:
        precorder.set_recorder(None)
    assert rc == 0 and summary["ok"], summary
    n, _, errors = jschema.validate_journal(path)
    assert n > 0 and not errors, errors[:5]


def test_cli_serve_on_cpu(capsys, one_thread):
    rc, summary = _cli(["serve", "--device", "cpu", "--requests", "40", "--buckets", "1,8"],
                       capsys)
    assert rc == 0 and summary["compiles_post_warmup"] == 0 and summary["refused"]
    assert summary["requests"] == 40


def test_cli_serve_pod_with_controller(capsys):
    rc, summary = _cli(["serve", "--device", "cpu", "--replicas", "2", "--family", "lenet",
                        "--buckets", "1,8", "--rate", "200", "--seconds", "0.3",
                        "--controller"], capsys)
    assert rc == 0 and summary["dropped"] == 0, summary
    assert summary["ctl"]["observes"] >= 1


@pytest.mark.parametrize("cmd", ["bench", "pods"])
def test_cli_still_refuses(cmd):
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main([cmd])
