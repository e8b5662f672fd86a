"""The port's distributed trainer (``sparknet_tpu_torch/parallel``) against
the JAX package's ``ParallelTrainer``, on the CPU at a small size.

Two gloo processes (spawned once for the module, joined through a
``FileStore`` in a temp dir) each own one replica of a narrow AlexNet
(dropout 0, both LRNs, 4 images a worker) restored from one JAX-initialized
snapshot.  Each feeds its own half of seeded global batches
(``local_shard``); the JAX trainer runs in this process on a 2-device
virtual CPU mesh and is fed the global batches, which are the same data.
Four cases, 3 rounds each: tau 1 on the fused path, tau 3 per blob and
fused, EASGD alpha 0.45 at tau 2.

Tolerances, after 3 rounds: the round losses at rtol 1e-5; params, state,
each worker's history and the EASGD center at rtol 1e-4 with an absolute
1e-5 of each blob's largest |value| (``test_torch_port_solver``'s, for the
same reasons: the two packages sum in other orders); distributed eval at
rtol 1e-5.  A world of one in this process is held bit for bit to the
Solver's own steps.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from sparknet_tpu import layers_dsl as jdsl  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.parallel import ParallelTrainer as JTrainer  # noqa: E402
from sparknet_tpu.parallel import data_parallel_mesh  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch import layers_dsl  # noqa: E402
from sparknet_tpu_torch.common import get_config, set_config  # noqa: E402
from sparknet_tpu_torch.net import WeightCollection  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.parallel import (  # noqa: E402
    ParallelTrainer,
    data_parallel_group,
    initialize_distributed,
    local_shard,
)
from sparknet_tpu_torch.proto.text_format import serialize  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig, dropout_seed  # noqa: E402

from test_torch_port_solver import narrow_alexnet  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B_LOCAL = 4
ROUNDS = 3
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="step",
              gamma=0.5, stepsize=4)
CASES = {  # name -> (tau, fused, elastic_alpha)
    "tau1_fused": (1, True, 0.0),
    "tau3_blob": (3, False, 0.0),
    "tau3_fused": (3, True, 0.0),
    "easgd_tau2": (2, False, 0.45),
}
TEST_CASE = "tau3_fused"  # the case whose trainer also runs test()
TEST_BATCHES = 2

# One worker: restores the snapshot, trains every case for ROUNDS rounds on
# its half of the global batches, and writes what it holds after each case.
CHILD = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from sparknet_tpu_torch.common import set_config
from sparknet_tpu_torch.ops import kernels
from sparknet_tpu_torch.parallel import ParallelTrainer, initialize_distributed, local_shard
from sparknet_tpu_torch.proto.text_format import parse
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(f"{work}/spec.json"))
initialize_distributed(store_path=f"{work}/store", rank=rank, world_size=world,
                       device="cpu")
net = parse(open(f"{work}/net.prototxt").read())
feeds = np.load(f"{work}/feeds.npz")
for name, (tau, fused, alpha) in spec["cases"].items():
    set_config(fused_update=fused)
    solver = Solver(SolverConfig(**spec["solver"]), net, device="cpu")
    solver.restore(f"{work}/start.solverstate.npz")
    tr = ParallelTrainer(solver, tau=tau, elastic_alpha=alpha)
    stacked = tau > 1 or alpha > 0

    def data_fn(it, name=name, tau=tau, stacked=stacked):
        g = {k: feeds[f"{name}/{k}"][it:it + tau] if stacked
             else feeds[f"{name}/{k}"][it] for k in ("data", "label")}
        return local_shard(g, rank, world, stacked)

    kernels.reset_launch_counts()
    out = {"loss": np.array([tr.train_round(data_fn) for _ in range(spec["rounds"])]),
           "iter": np.array(tr.iter),
           "launches": np.array([kernels.LRN_LAUNCHES, kernels.FUSED_UPDATE_LAUNCHES])}
    v = solver.variables  # the trainer steps and averages the Solver itself
    for ln, pl in v.params.items():
        for i, p in enumerate(pl):
            out[f"param/{ln}/{i}"] = p.detach().numpy()
    for ln, s in v.state.items():
        for k, t in s.items():
            out[f"state/{ln}/{k}"] = t.detach().numpy()
    for ln, sl in solver.slots.items():
        for i, hl in enumerate(sl):
            for j, h in enumerate(hl):
                out[f"hist/{ln}/{i}/{j}"] = h.detach().numpy()
    for ln, pl in (tr.center or {}).items():
        for i, p in enumerate(pl):
            out[f"center/{ln}/{i}"] = p.detach().numpy()
    if name == spec["test_case"]:
        scores = tr.test(spec["test_batches"], lambda b: local_shard(
            {k: feeds[f"test/{k}"][b] for k in ("data", "label")}, rank, world, False))
        for k, val in scores.items():
            out[f"test/{k}"] = np.array(val)
    np.savez(f"{work}/{name}.rank{rank}.npz", **out)
dist.destroy_process_group()
print("worker", rank, "done")
"""


def _global_feeds(seed: int, n: int) -> dict:
    """n seeded global batches of WORLD * B_LOCAL images at raw-pixel scale."""
    rs = np.random.RandomState(seed)
    b = WORLD * B_LOCAL
    return {"data": (rs.randn(n, b, 3, 67, 67) * 50).astype(np.float32),
            "label": rs.randint(0, 10, (n, b)).astype(np.int32)}


def _steps(tau, alpha):
    return ROUNDS * tau


@pytest.fixture(scope="module")
def fused_both():
    """Put both packages' ``fused_update`` back after the module."""
    saved = (jget_config().fused_update, get_config().fused_update)
    yield
    jset_config(fused_update=saved[0])
    set_config(fused_update=saved[1])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, fused_both):
    """The snapshot, the feeds, and the two workers' results by case."""
    work = tmp_path_factory.mktemp("parallel")
    js = JSolver(JSolverConfig(**SOLVER), narrow_alexnet(jdsl, batch=WORLD * B_LOCAL))
    snap = js.save(str(work / "start"))
    (work / "net.prototxt").write_text(
        serialize(narrow_alexnet(layers_dsl, batch=B_LOCAL)))
    feeds = {}
    for c, (name, (tau, _, alpha)) in enumerate(CASES.items()):
        for k, v in _global_feeds(100 + c, _steps(tau, alpha)).items():
            feeds[f"{name}/{k}"] = v
    for k, v in _global_feeds(99, TEST_BATCHES).items():
        feeds[f"test/{k}"] = v
    np.savez(work / "feeds.npz", **feeds)
    (work / "spec.json").write_text(json.dumps(dict(
        cases=CASES, solver=SOLVER, rounds=ROUNDS, test_case=TEST_CASE,
        test_batches=TEST_BATCHES)))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env = {k: v for k, v in env.items() if not k.startswith("JAX")}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(WORLD), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e}"
    results = {name: [dict(np.load(work / f"{name}.rank{r}.npz")) for r in range(WORLD)]
               for name in CASES}
    return snap, feeds, results


def _jax_run(name, snap, feeds):
    """The JAX trainer on a 2-device mesh, fed the global batches."""
    tau, fused, alpha = CASES[name]
    jset_config(fused_update=fused)
    js = JSolver(JSolverConfig(**SOLVER), narrow_alexnet(jdsl, batch=WORLD * B_LOCAL))
    js.restore(snap)
    jt = JTrainer(js, mesh=data_parallel_mesh(WORLD), tau=tau, elastic_alpha=alpha)
    stacked = tau > 1 or alpha > 0

    def data_fn(it):
        return {k: feeds[f"{name}/{k}"][it:it + tau] if stacked
                else feeds[f"{name}/{k}"][it] for k in ("data", "label")}

    losses = [jt.train_round(data_fn) for _ in range(ROUNDS)]
    return jt, np.array(losses)


def _close(got, ref, what, rtol=1e-4, arel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max()) + 1e-30,
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_two_gloo_workers_match_the_jax_trainer(name, spawned):
    snap, feeds, results = spawned
    tau, fused, alpha = CASES[name]
    jt, jloss = _jax_run(name, snap, feeds)
    stacked = tau > 1 or alpha > 0
    for r, res in enumerate(results[name]):
        assert int(res["iter"]) == jt.iter == ROUNDS * tau
        np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
        # the CPU runs the plain versions: no kernel launch is counted
        assert res["launches"].tolist() == [0, 0]
        for ln, blobs in jt.variables.params.items():
            for i, b in enumerate(blobs):
                b = np.asarray(b)
                _close(res[f"param/{ln}/{i}"], b[r] if stacked else b,
                       f"rank {r} param {ln}[{i}]")
                for j, h in enumerate(jt.slots[ln][i]):
                    h = np.asarray(h)
                    _close(res[f"hist/{ln}/{i}/{j}"], h[r] if stacked else h,
                           f"rank {r} history {ln}[{i}][{j}]")
        for ln, s in jt.variables.state.items():
            for k, v in s.items():
                v = np.asarray(v)
                _close(res[f"state/{ln}/{k}"], v[r] if stacked else v,
                       f"rank {r} state {ln}/{k}")
        if alpha:
            for ln, blobs in jt.center.items():
                for i, c in enumerate(blobs):
                    _close(res[f"center/{ln}/{i}"], c, f"rank {r} center {ln}[{i}]")
    a, b = results[name]
    if alpha:  # EASGD: the workers differ, the center is replicated
        assert not all(np.array_equal(a[k], b[k]) for k in a if k.startswith("param/"))
        assert all(np.array_equal(a[k], b[k]) for k in a if k.startswith("center/"))
    else:  # averaged or synchronous: the replicas are equal bit for bit
        assert all(np.array_equal(a[k], b[k]) for k in a if k.startswith("param/"))
    if name == TEST_CASE:
        jscores = jt.test(TEST_BATCHES, lambda b_: {
            k: feeds[f"test/{k}"][b_] for k in ("data", "label")})
        for res in results[name]:
            assert set(jscores) == {k[5:] for k in res if k.startswith("test/")}
            for k, v in jscores.items():
                np.testing.assert_allclose(float(res[f"test/{k}"]), v, rtol=1e-5)


# -- a world of one, in this process ----------------------------------------


def _cpu_feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": (rs.randn(B_LOCAL, 3, 67, 67) * 50).astype(np.float32),
             "label": rs.randint(0, 10, B_LOCAL).astype(np.int32)} for _ in range(n)]


def _solver(fused):
    set_config(fused_update=fused)
    return Solver(SolverConfig(**SOLVER), narrow_alexnet(layers_dsl, batch=B_LOCAL),
                  device="cpu")


def _equal_state(tr, s):
    for ln, pl in s.variables.params.items():
        for a, b in zip(tr.solver.variables.params[ln], pl):
            assert torch.equal(a, b), ln
    for ln, sl in s.slots.items():
        for ha, hb in zip(tr.solver.slots[ln], sl):
            assert all(torch.equal(a, b) for a, b in zip(ha, hb)), ln


@pytest.fixture
def one_thread():
    """One intra-op thread while the trainer and the lone Solver step: with
    several, the CPU convolutions' sums follow the thread team, which the
    gloo all-reduce inside a tau-1 step can shrink for a later call, so the
    two runs differed in last bits now and then."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
@pytest.mark.parametrize("tau", [1, 3])
def test_world_of_one_round_is_the_solvers_steps(tau, fused, fused_both, one_thread):
    """With no process group the trainer forms a world of one (gloo on the
    CPU): a round of tau steps is tau ``Solver.step``s bit for bit, and the
    group is gone after ``close``, which hands the solver back."""
    feeds = _cpu_feeds(2 * tau)
    solver = _solver(fused)
    tr = ParallelTrainer(solver, tau=tau)
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (tr.num_workers, tr.rank) == (1, 0)
        ref = _solver(fused)
        stack = lambda it: {k: np.stack([feeds[it + i][k] for i in range(tau)])  # noqa: E731
                            for k in feeds[0]}
        for _ in range(2):
            loss = tr.train_round(stack if tau > 1 else lambda it: feeds[it])
            losses = []
            ref.step(tau, lambda it: feeds[it], callback=lambda it, l: losses.append(l))
            np.testing.assert_allclose(loss, np.mean(losses), rtol=1e-6)
        assert tr.iter == ref.iter == 2 * tau
        _equal_state(tr, ref)
    finally:
        tr.close()
    assert not dist.is_initialized()
    assert solver.worker == 0
    ref.step(1, lambda it: feeds[it - 2 * tau])  # both step alone again
    solver.step(1, lambda it: feeds[it - 2 * tau])
    _equal_state(tr, ref)


def test_dropout_seed_of_rank_zero_is_the_solvers():
    """Worker 0 draws a lone Solver's masks; each worker's generator is
    seeded apart, and the trainer gives rank r's Solver ``worker = r``."""
    assert dropout_seed(7, 12) == dropout_seed(7, 12, 0) == 7 * 1_000_003 + 12
    assert len({dropout_seed(7, 12, r) for r in range(4)}) == 4


def test_refusals_match_jax(fused_both):
    """iter_size > 1 and the EASGD stability bound raise with the JAX
    trainer's messages; orbax checkpoints raise NotImplementedError."""
    for kw in (dict(iter_size=2), {}):
        cfg = dict(SOLVER, **kw)
        jset_config(fused_update=False)
        js = JSolver(JSolverConfig(**cfg), narrow_alexnet(jdsl, batch=B_LOCAL))
        ps = Solver(SolverConfig(**cfg), narrow_alexnet(layers_dsl, batch=B_LOCAL),
                    device="cpu")
        args = dict(tau=1, elastic_alpha=1.5) if not kw else dict(tau=2)
        with pytest.raises(ValueError) as jerr:
            JTrainer(js, mesh=data_parallel_mesh(1), **args)
        with pytest.raises(ValueError) as perr:
            ParallelTrainer(ps, **args)
        assert str(perr.value) == str(jerr.value)
    assert not dist.is_initialized()  # refused before any group was formed
    tr = ParallelTrainer(ps, tau=2)
    try:
        for call in (tr.save, tr.restore):
            with pytest.raises(NotImplementedError, match="A5"):
                call("x")
    finally:
        tr.close()


def test_tau_weight_exchange_roundtrip(fused_both):
    """get_weights -> set_weights -> get_weights is the identity, for the
    averaged replica and for the EASGD center (the counterpart of the JAX
    package's ``test_tau_weight_exchange_roundtrip``)."""
    for alpha in (0.0, 0.5):
        tr = ParallelTrainer(_solver(True), tau=3, elastic_alpha=alpha)
        try:
            wc = tr.get_weights()
            assert isinstance(wc, WeightCollection)
            bumped = WeightCollection({k: [a + 1.0 for a in v]
                                       for k, v in wc.weights.items()})
            tr.set_weights(bumped)
            wc2 = tr.get_weights()
            for ln in wc.layers():
                for a, b in zip(wc2[ln], bumped[ln]):
                    np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(
                tr.solver.variables.params["fc8"][0].numpy(), bumped["fc8"][0])
        finally:
            tr.close()


def test_sync_to_solver_snapshot_restores_in_jax(tmp_path, fused_both):
    """After two tau rounds, ``sync_to_solver`` and the port's
    ``Solver.save`` write a snapshot the JAX ``Solver.restore`` loads: the
    trainer's params, history and iteration."""
    feeds = _cpu_feeds(4, seed=3)
    solver = _solver(True)
    tr = ParallelTrainer(solver, tau=2)
    try:
        tr.train(2, lambda it: {k: np.stack([feeds[it][k], feeds[it + 1][k]])
                                for k in feeds[0]})
        tr.sync_to_solver()
    finally:
        tr.close()
    assert solver.iter == 4
    path = solver.save(str(tmp_path / "synced"))
    jset_config(fused_update=False)
    js = JSolver(JSolverConfig(**SOLVER), narrow_alexnet(jdsl, batch=B_LOCAL))
    js.restore(path)
    assert js.iter == 4
    for ln, pl in solver.variables.params.items():
        for i, p in enumerate(pl):
            np.testing.assert_array_equal(np.asarray(js.variables.params[ln][i]), p.numpy())
            np.testing.assert_array_equal(np.asarray(js.slots[ln][i][0]),
                                          solver.slots[ln][i][0].numpy())


def test_local_shard_cuts_the_batch_axis():
    g = {"data": np.arange(2 * 6 * 3).reshape(2, 6, 3), "label": np.arange(12).reshape(2, 6)}
    one = local_shard({k: v[0] for k, v in g.items()}, 1, 3, with_tau_axis=False)
    np.testing.assert_array_equal(one["data"], g["data"][0, 2:4])
    tau = local_shard(g, 2, 3, with_tau_axis=True)
    np.testing.assert_array_equal(tau["label"], g["label"][:, 4:6])
    t = local_shard({"x": torch.arange(8)}, 0, 2, with_tau_axis=False)
    assert t["x"].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not divide"):
        local_shard({"x": np.zeros(5)}, 0, 2, with_tau_axis=False)


def test_data_parallel_group_and_refusals(tmp_path):
    """A FileStore world of one: the default group is the worker set; a
    worker count outside the world raises, and so does a FileStore without
    rank and world size."""
    initialize_distributed(store_path=str(tmp_path / "store"), rank=0,
                           world_size=1, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert data_parallel_group() is dist.group.WORLD
        assert data_parallel_group(1) is dist.group.WORLD
        with pytest.raises(ValueError, match="cannot form 2 workers"):
            data_parallel_group(2)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="rank and world_size"):
        initialize_distributed(store_path=str(tmp_path / "s2"))
    assert kernels.FUSED_UPDATE_LAUNCHES == 0


def test_the_default_backend_follows_the_device(monkeypatch):
    """NCCL for CUDA (``device=None`` means CUDA), gloo for the CPU; with no
    card, the default raises instead of falling back to the CPU."""
    from sparknet_tpu_torch.parallel.mesh import default_backend

    assert default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_backend(None) == default_backend("cuda") == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_backend(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed(rank=0, world_size=1)
    assert not dist.is_initialized()
