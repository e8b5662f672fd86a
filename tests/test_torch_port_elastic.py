"""The port's elastic trainer (``sparknet_tpu_torch/parallel/elastic.py``)
against the JAX package's ``ElasticTrainer``, on the CPU at a small size.

The pure pieces (``round_shards``, ``FaultPlan``) are held to the
reference's on the same inputs.  Then three gloo processes (one pool,
spawned once for the module, joined through a ``FileStore``) each hold a
worker slot and replay every case: a narrow AlexNet (dropout 0, both
LRNs, 2 images a worker) restored from one JAX-initialized snapshot,
``data_fn(g)`` a seeded batch of shard ``g``.  The JAX trainer runs the
same plan in this process on the first 3 of the 8 virtual CPU devices
(``devices=``).  Cases: no plan (also bit for bit against the port's
``ParallelTrainer`` τ rounds of the same shards), a kill then a join, a
kill and a join at one boundary (the joiner adopts the entry consensus,
the departing worker's slots included), a straggler that rejoins at
``decay ** s`` (with ``state_dict`` taken while it is parked, a round
trip that continues the trajectory bit for bit, and ``sync_to_solver``),
a straggler past ``staleness_bound`` that is dropped, and the plans the
reference refuses.  A world of one in this process is held bit for bit to
the Solver's own steps.

Tolerances are ``test_torch_port_parallel``'s: the round losses at rtol
1e-5; params and slots at rtol 1e-4 with an absolute 1e-5 of each blob's
largest |value|.  They are not tighter because the two packages take
their sums in other orders (XLA's convolutions and psum against ATen's and
gloo's), and SGD with momentum carries each last-digit difference into the
next rounds; a join's consensus is a mean of equal replicas, which may
move a last digit.  Within the port, equalities are exact: the weighted
round at weight 1 is ``ParallelTrainer``'s bit for bit, the active ranks'
params are equal after every round, and a restored pool continues the
original's trajectory bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import layers_dsl as jdsl  # noqa: E402
from sparknet_tpu.parallel import elastic as jel  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch import layers_dsl  # noqa: E402
from sparknet_tpu_torch.parallel import elastic  # noqa: E402
from sparknet_tpu_torch.proto.text_format import serialize  # noqa: E402

from test_torch_port_solver import narrow_alexnet  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = 3
B = 2  # images a worker
SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="step",
              gamma=0.5, stepsize=4)
# name -> (tau, rounds, staleness_bound, plan as (kind, round, worker, steps))
CASES = {
    "plain": (2, 2, 3, []),
    "kill_then_join": (1, 3, 3, [("kill", 1, 2, 0), ("join", 2, -1, 0)]),
    "kill_and_join": (1, 2, 3, [("kill", 1, 2, 0), ("join", 1, -1, 0)]),
    "straggler": (2, 3, 3, [("delay", 1, 1, 2)]),
    "dropped": (1, 5, 1, [("delay", 1, 2, 3)]),
}
# plans both packages refuse, as (plan, width)
REFUSED = {
    "kill unknown": ([("kill", 0, 9, 0)], 3),
    "kill last": ([("kill", 0, 0, 0)], 1),
    "kill while parked": ([("delay", 0, 1, 2), ("kill", 1, 1, 0)], 3),
    "delay last": ([("delay", 0, 0, 2)], 1),
    "too wide": ([("join", 0, -1, 0)], 3),
}


# what this process and the pool's processes share (the pool's processes
# import neither jax nor this module)
SHARED = r'''
import numpy as np


def _events(mod, plan):
    out = []
    for kind, rnd, worker, steps in plan:
        if kind == "kill":
            out.append(mod.kill(worker, at_round=rnd))
        elif kind == "join":
            out.append(mod.join(at_round=rnd))
        else:
            out.append(mod.delay(worker, at_round=rnd, steps=steps))
    return mod.FaultPlan(out)


def shard_feed(g):
    """Shard g's per-worker batch of 2 images: a pure function of g."""
    rs = np.random.RandomState(1000 + g)
    return {"data": (rs.randn(2, 3, 67, 67) * 50).astype(np.float32),
            "label": rs.randint(0, 10, 2).astype(np.int32)}
'''
exec(SHARED)

# One worker slot of the pool: replays every case and writes what it holds.
CHILD = SHARED + r'''
import json, sys
import torch
import torch.distributed as dist
from sparknet_tpu_torch.parallel import ParallelTrainer, initialize_distributed
from sparknet_tpu_torch.parallel import elastic
from sparknet_tpu_torch.parallel.trainer import slot_tensors
from sparknet_tpu_torch.proto.text_format import parse
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig

rank, pool, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(f"{work}/spec.json"))
CASES, REFUSED, SOLVER = spec["cases"], spec["refused"], spec["solver"]
initialize_distributed(store_path=f"{work}/store", rank=rank, world_size=pool, device="cpu")
net = parse(open(f"{work}/net.prototxt").read())


def solver():
    s = Solver(SolverConfig(**SOLVER), net, device="cpu")
    s.restore(f"{work}/start.solverstate.npz")
    return s


def held(s, out, prefix):
    for ln, pl in s.variables.params.items():
        for i, p in enumerate(pl):
            out[f"{prefix}param/{ln}/{i}"] = p.detach().numpy().copy()
    for ln, sl in s.slots.items():
        for i, hl in enumerate(sl):
            for j, h in enumerate(hl):
                out[f"{prefix}hist/{ln}/{i}/{j}"] = h.detach().numpy().copy()


def flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def arena(s):
    return flat([p for pl in s.variables.params.values() for p in pl])


for name, (tau, rounds, bound, plan) in CASES.items():
    tr = elastic.ElasticTrainer(solver(), width=pool, tau=tau, staleness_bound=bound,
                                plan=_events(elastic, plan))
    used = []

    def data_fn(g):
        used.append(g)
        return shard_feed(g)

    out, losses, equal, twin, rt = {}, [], [], None, ([], [])
    for r in range(rounds):
        loss = tr.train_round(data_fn)
        losses.append(np.nan if loss is None else loss)
        if twin is not None:  # the restored pool, round for round
            b = twin.train_round(shard_feed)
            rt[0].append(losses[-1])
            rt[1].append(np.nan if b is None else b)
        # the active ranks' params, bit for bit equal after every round
        mine = arena(tr.solver) if tr.active else None
        rows = [None] * pool
        dist.all_gather_object(rows, mine)
        live = [x for x in rows if x is not None]
        equal.append(all(torch.equal(x, live[0]) for x in live))
        if name == "straggler" and r == 1:
            state = tr.state_dict()
            out["sd/wids"] = np.array(state["wids"])
            out["sd/parked"] = np.array([[p.wid, p.parked_round, p.rejoin_round]
                                         for p in state["parked"]])
            out["sd/conv1"] = state["variables"].params["conv1"][0]
            out["sd/parked_conv1"] = state["parked"][0].variables.params["conv1"][0]
            out["sd/parked_hist"] = state["parked"][0].slots["conv1"][0][0]
            twin = elastic.ElasticTrainer(solver(), width=pool, tau=tau,
                                          staleness_bound=bound, plan=_events(elastic, plan))
            twin.load_state_dict(state)
    out.update(loss=np.array(losses), equal=np.array(equal), used=np.array(used),
               active=np.array(tr.active), iter=np.array(tr.iter),
               cursor=np.array(tr.cursor), wids=np.array(tr.worker_ids),
               weights=np.array(tr.round_weights),
               rank_of=np.array([tr._rank_of[w] for w in tr.worker_ids]))
    held(tr.solver, out, "")
    if name == "plain":  # ParallelTrainer's tau rounds over the same shards
        pt = ParallelTrainer(solver(), tau=tau)

        def stacked(it):
            cols = elastic.round_shards(it * pool, tau, pool)[:, rank]
            fs = [shard_feed(int(g)) for g in cols]
            return {k: np.stack([f[k] for f in fs]) for k in fs[0]}

        pl = [pt.train_round(stacked) for _ in range(rounds)]
        out["pt_equal"] = np.array(
            torch.equal(arena(pt.solver), arena(tr.solver))
            and torch.equal(flat(slot_tensors(pt.solver)), flat(slot_tensors(tr.solver))))
        out["pt_loss"] = np.array(pl)
    if name == "straggler":  # the restored twin continued bit for bit
        out["rt_equal"] = np.array(
            torch.equal(arena(tr.solver), arena(twin.solver))
            and torch.equal(flat(slot_tensors(tr.solver)),
                            flat(slot_tensors(twin.solver))))
        out["rt_loss"], out["rt_twin"] = np.array(rt[0]), np.array(rt[1])
        tr.sync_to_solver()
        out["sync_iter"] = np.array(tr.solver.iter)
        held(tr.solver, out, "sync/")
    np.savez(f"{work}/{name}.rank{rank}.npz", **out)

refused = {}
for label, (plan, width) in REFUSED.items():
    tr = elastic.ElasticTrainer(solver(), width=width, tau=1, plan=_events(elastic, plan))
    try:
        for _ in range(2):
            tr.train_round(shard_feed)
        refused[label] = None
    except ValueError as err:
        refused[label] = str(err)
json.dump(refused, open(f"{work}/refused.rank{rank}.json", "w"))
dist.destroy_process_group()
print("worker", rank, "done")
'''


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The snapshot, and the pool's results by case and rank."""
    work = tmp_path_factory.mktemp("elastic")
    (work / "spec.json").write_text(json.dumps(dict(cases=CASES, refused=REFUSED,
                                                    solver=SOLVER)))
    js = JSolver(JSolverConfig(**SOLVER), narrow_alexnet(jdsl, batch=B))
    snap = js.save(str(work / "start"))
    (work / "net.prototxt").write_text(serialize(narrow_alexnet(layers_dsl, batch=B)))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env = {k: v for k, v in env.items() if not k.startswith("JAX")}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(POOL), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(POOL)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e}"
    results = {name: [dict(np.load(work / f"{name}.rank{r}.npz")) for r in range(POOL)]
               for name in CASES}
    refused = [json.loads((work / f"refused.rank{r}.json").read_text()) for r in range(POOL)]
    return snap, results, refused


def _jax_trainer(snap, width, tau, plan, bound=3):
    js = JSolver(JSolverConfig(**SOLVER), narrow_alexnet(jdsl, batch=B))
    js.restore(snap)
    return jel.ElasticTrainer(js, width=width, tau=tau, staleness_bound=bound,
                              plan=_events(jel, plan), devices=jax.devices()[:POOL])


def _close(got, ref, what, rtol=1e-4, arel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max()) + 1e-30, err_msg=what)


def _hold_rank_to_row(res, variables, slots, row, what):
    for ln, blobs in variables.params.items():
        for i, b in enumerate(blobs):
            _close(res[f"param/{ln}/{i}"], np.asarray(b)[row], f"{what} param {ln}[{i}]")
            for j, h in enumerate(slots[ln][i]):
                _close(res[f"hist/{ln}/{i}/{j}"], np.asarray(h)[row],
                       f"{what} history {ln}[{i}][{j}]")


# -- the pure pieces ---------------------------------------------------------


@pytest.mark.parametrize("cursor,tau,width", [(0, 1, 1), (5, 3, 4), (7, 2, 3), (12, 1, 8),
                                              (3, 4, 2)])
def test_round_shards_matches_jax(cursor, tau, width):
    got = elastic.round_shards(cursor, tau, width)
    np.testing.assert_array_equal(got, jel.round_shards(cursor, tau, width))
    assert got.shape == (tau, width)
    assert sorted(got.ravel().tolist()) == list(range(cursor, cursor + tau * width))


@pytest.mark.parametrize("events", [
    [("explode", 0, 0, 0)], [("delay", 0, 0, 0)], [("join_zero", 0, 0, 0)],
    [("kill", 2, 1, 0), ("join", 1, -1, 0), ("delay", 1, 0, 3)], [],
], ids=["unknown kind", "delay steps 0", "join count 0", "sorted", "empty"])
def test_fault_plan_validation_matches_jax(events):
    """Both packages refuse the same plans with the same messages, and
    order and select the rest alike."""
    def build(mod):
        evs = []
        for kind, rnd, worker, steps in events:
            if kind == "join_zero":
                evs.append(mod.FaultEvent(round=rnd, kind="join", count=0))
            elif kind in ("explode", "delay"):
                evs.append(mod.FaultEvent(round=rnd, kind=kind, worker=worker, steps=steps))
            else:
                evs.append(_events(mod, [(kind, rnd, worker, steps)]).events[0])
        return mod.FaultPlan(evs)

    try:
        want = build(jel)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            build(elastic)
        assert str(got.value) == str(err)
        return
    plan = build(elastic)
    assert [dataclass_tuple(e) for e in plan.events] == [dataclass_tuple(e) for e in want.events]
    for rnd in range(4):
        assert [dataclass_tuple(e) for e in plan.at(rnd)] == \
            [dataclass_tuple(e) for e in want.at(rnd)]


def dataclass_tuple(e):
    return (e.round, e.kind, e.worker, e.count, e.steps)


def test_trainer_refusals_match_jax():
    """iter_size > 1, a decay outside (0, 1] and a width beyond the pool
    raise with the JAX trainer's messages (a world of one here, formed by
    nobody: the checks come first)."""
    from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig

    for kw, args in ((dict(iter_size=2), {}), ({}, dict(staleness_decay=0.0)),
                     ({}, dict(width=2))):
        cfg = dict(SOLVER, **kw)
        js = JSolver(JSolverConfig(**cfg), narrow_alexnet(jdsl, batch=B))
        ps = Solver(SolverConfig(**cfg), narrow_alexnet(layers_dsl, batch=B), device="cpu")
        with pytest.raises(ValueError) as jerr:
            jel.ElasticTrainer(js, devices=jax.devices()[:1], **args)
        with pytest.raises(ValueError) as perr:
            elastic.ElasticTrainer(ps, **args)
        assert str(perr.value) == str(jerr.value)
    assert not torch.distributed.is_initialized()


# -- the spawned pool against the JAX trainer ---------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_pool_matches_the_jax_elastic_trainer(name, spawned):
    snap, results, _ = spawned
    tau, rounds, bound, plan = CASES[name]
    jt = _jax_trainer(snap, POOL, tau, plan, bound)
    jloss = []
    for _ in range(rounds):
        jloss.append(jt.train_round(shard_feed))
    ranks = results[name]
    r0 = next(res for res in ranks if bool(res["active"]))
    assert r0["wids"].tolist() == list(jt._wids)
    np.testing.assert_allclose(r0["weights"], jt._round_weights, rtol=0, atol=0)
    assert int(r0["iter"]) == jt.iter and int(r0["cursor"]) == jt.cursor
    for res in ranks:
        assert res["equal"].all(), "active ranks differ after a round"
        active_rounds = ~np.isnan(res["loss"])
        np.testing.assert_allclose(res["loss"][active_rounds],
                                   np.array(jloss)[active_rounds], rtol=1e-5)
    # every shard id up to the cursor consumed once, over the pool
    used = np.concatenate([res["used"] for res in ranks])
    assert sorted(used.tolist()) == list(range(jt.cursor))
    for pos, rank in enumerate(r0["rank_of"]):
        res = ranks[int(rank)]
        assert bool(res["active"])
        _hold_rank_to_row(res, jt.variables, jt.slots, pos, f"{name} worker {jt._wids[pos]}")
    if name == "plain":
        for res in ranks:
            assert bool(res["pt_equal"]), "weight-1 rounds differ from ParallelTrainer's"
            np.testing.assert_array_equal(res["pt_loss"], res["loss"])
    if name == "kill_and_join":
        assert jt._wids == [0, 1, 3]
    if name == "dropped":
        assert jt.width == 2 and not jt._parked
        assert sum(bool(res["active"]) for res in ranks) == 2


def test_straggler_state_dict_round_trip_and_sync(spawned):
    """The straggler case: ``state_dict`` while worker 1 is parked holds
    the JAX trainer's rows and parked replica; a pool restored from it
    continues the trajectory bit for bit; ``sync_to_solver`` gives every
    solver the JAX trainer's consensus."""
    snap, results, _ = spawned
    tau, _, bound, plan = CASES["straggler"]
    jt = _jax_trainer(snap, POOL, tau, plan, bound)
    for _ in range(2):
        jt.train_round(shard_feed)
    state = jt.state_dict()
    ranks = results["straggler"]
    for res in ranks:  # every rank gathered the same dict
        assert res["sd/wids"].tolist() == state["wids"]
        assert res["sd/parked"].tolist() == [[p.wid, p.parked_round, p.rejoin_round]
                                             for p in state["parked"]]
        _close(res["sd/conv1"], np.asarray(state["variables"].params["conv1"][0]),
               "state_dict conv1")
        _close(res["sd/parked_conv1"], np.asarray(state["parked"][0].variables.params["conv1"][0]),
               "parked conv1")
        _close(res["sd/parked_hist"], np.asarray(state["parked"][0].slots["conv1"][0][0]),
               "parked history")
        assert bool(res["rt_equal"])
        np.testing.assert_array_equal(res["rt_loss"], res["rt_twin"])
    jt.train_round(shard_feed)
    jt.sync_to_solver()
    for res in ranks:
        assert int(res["sync_iter"]) == jt.solver.iter
        for ln, blobs in jt.solver.variables.params.items():
            for i, b in enumerate(blobs):
                _close(res[f"sync/param/{ln}/{i}"], np.asarray(b), f"synced {ln}[{i}]")
                _close(res[f"sync/hist/{ln}/{i}/0"], np.asarray(jt.solver.slots[ln][i][0]),
                       f"synced history {ln}[{i}]")


def test_refused_plans_match_jax(spawned):
    """Killing an unknown worker, the last worker or a parked one, parking
    the last worker and a set wider than the pool raise on every rank with
    the JAX trainer's messages."""
    snap, _, refused = spawned
    for label, (plan, width) in REFUSED.items():
        jt = _jax_trainer(snap, width, 1, plan)
        with pytest.raises(ValueError) as err:
            for _ in range(2):
                jt.train_round(shard_feed)
        for r in range(POOL):
            assert refused[r][label] == str(err.value), (label, r)


def test_world_of_one_rounds_are_the_solvers_steps():
    """With no process group the trainer forms a world of one (gloo on the
    CPU): a round of tau steps on shards 0.. is tau ``Solver.step``s on
    the same shards bit for bit, ``get_weights`` is the replica, and
    ``close`` ends the group."""
    import torch.distributed as dist

    from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig

    def solver():
        return Solver(SolverConfig(**SOLVER), narrow_alexnet(layers_dsl, batch=B),
                      device="cpu")

    tr, ref = elastic.ElasticTrainer(solver(), tau=2), solver()
    try:
        assert dist.is_initialized() and (tr.pool, tr.width, tr.active) == (1, 1, True)
        losses = [tr.train_round(shard_feed) for _ in range(2)]
        ref.step(4, shard_feed)
        assert (tr.iter, tr.cursor, ref.iter) == (4, 4, 4)
        assert all(np.isfinite(losses))
        wc = tr.get_weights()
        for ln, pl in ref.variables.params.items():
            for i, p in enumerate(pl):
                assert torch.equal(tr.solver.variables.params[ln][i], p), ln
                np.testing.assert_array_equal(wc[ln][i], p.numpy())
    finally:
        tr.close()
    assert not dist.is_initialized() and tr.solver.worker == 0
