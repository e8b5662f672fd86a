"""The port's sequence parallelism (``parallel/ring_attention.py``,
``parallel/ulysses.py``, the MultiHeadAttention layer's dispatch,
``Network.apply``'s sequence blocks and ``ParallelTrainer`` over an
``auto_mesh`` with a seq axis) against the JAX package, on the CPU at a
small size.

Four gloo processes (one pool, spawned once for the module, joined
through a ``FileStore``) run every case; the JAX side runs in this process
on the virtual CPU mesh, where the JAX package's own tests run.  Cases:

* ring and Ulysses attention at [2, 4, 32, 8], causal and not, over a seq
  axis of 4: the whole output against JAX's ``ring_self_attention`` /
  ``ulysses_self_attention`` (atol 2e-5, JAX's test's), and the gradient of
  sum(o^2) through the blocks (each rank's loss its own block's) against
  ``jax.grad`` of the same sum through the JAX function (atol 5e-5);
* the ``transformer`` family at JAX's ``test_seq_parallel.py`` shape (B 16,
  S 32) trained 3 SGD steps on grids (data 1, seq 4) and (data 2, seq 2),
  ring and Ulysses, against the JAX single-device ``Solver`` from the same
  snapshot (atol 2e-4, JAX's own), and its distributed eval;
* a 1-block char LM at S 32 under Adam on a seq axis of 4, ring and
  Ulysses, each step from the JAX Solver's params and history of the step
  before (loss rtol 1e-4; params rtol 1e-4, atol 1e-5 x max + 1e-2 x
  base_lr: the one-step Adam gate of the char LM on the card);
* ``seq_feeds``, the tau refusal and the Ulysses head-count error with the
  JAX package's messages, and an indivisible sequence training whole.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jmodels  # noqa: E402
from sparknet_tpu.parallel.mesh import auto_mesh as jauto_mesh  # noqa: E402
from sparknet_tpu.parallel.ring_attention import ring_self_attention as jring  # noqa: E402
from sparknet_tpu.parallel.sharding import ShardingRules as JRules  # noqa: E402
from sparknet_tpu.parallel.trainer import ParallelTrainer as JTrainer  # noqa: E402
from sparknet_tpu.parallel.ulysses import ulysses_self_attention as julysses  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = 4
ATTN_SHAPE = (2, 4, 32, 8)
B, S = 16, 32  # the transformer family's case (JAX's test_seq_parallel.py)
GRIDS = ((1, 4), (2, 2))  # (data, seq)
STEPS = 3
LM = dict(batch=4, seq_len=32, vocab=32, embed_dim=32, heads=4, ffn_dim=64, blocks=1)


def attn_qkv(seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*ATTN_SHAPE) * 0.5).astype(np.float32) for _ in range(3)]


def transformer_feeds(n, seed=0, seq=S):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randint(0, 64, (B, seq)).astype(np.int32),
             "label": rs.randint(0, 10, B).astype(np.int32)} for _ in range(n)]


def lm_feeds(n):
    rs = np.random.RandomState(3)
    shape = (LM["batch"], LM["seq_len"])
    return [{"data": rs.randint(0, LM["vocab"], shape).astype(np.int32),
             "label": rs.randint(0, LM["vocab"], shape).astype(np.int32)} for _ in range(n)]


# One rank of the pool: runs every case and writes what it holds.
CHILD = r'''
import json, sys, warnings
import numpy as np
import torch
import torch.distributed as dist
from sparknet_tpu_torch import models
from sparknet_tpu_torch.common import set_config
from sparknet_tpu_torch.parallel import ParallelTrainer, ShardingRules, auto_mesh
from sparknet_tpu_torch.parallel import initialize_distributed, local_shard
from sparknet_tpu_torch.parallel.collectives import all_gather
from sparknet_tpu_torch.parallel.ring_attention import ring_attention, ring_self_attention
from sparknet_tpu_torch.parallel.ring_attention import seq_block
from sparknet_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_self_attention
from sparknet_tpu_torch.solvers.solver import Solver

rank, pool, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(f"{work}/spec.json"))
initialize_distributed(store_path=f"{work}/store", rank=rank, world_size=pool, device="cpu")
torch.set_num_threads(1)
out = {}

# -- the attention cores ---------------------------------------------------
mesh = auto_mesh(seq_parallel=pool, device="cpu")
seq = mesh.comm("seq")
qkv = [torch.from_numpy(a) for a in np.load(f"{work}/attn.npz").values()]
for impl, whole, block in (("ring", ring_self_attention, ring_attention),
                           ("ulysses", ulysses_self_attention, ulysses_attention)):
    for causal in (False, True):
        key = f"{impl}_{int(causal)}"
        out[f"{key}/o"] = whole(mesh, *qkv, causal=causal).numpy()
        parts = [seq_block(t, seq).clone().requires_grad_(True) for t in qkv]
        (block(*parts, seq, causal) ** 2).sum().backward()
        for name, p in zip("qkv", parts):
            out[f"{key}/d{name}"] = all_gather(p.grad, 2, seq).numpy()


def held(s, prefix):
    for ln, pl in s.variables.params.items():
        for i, p in enumerate(pl):
            out[f"{prefix}/param/{ln}/{i}"] = p.detach().numpy().copy()


# -- the transformer family over (data, seq) grids -------------------------
tf_feeds = [dict(np.load(f"{work}/tf{i}.npz")) for i in range(spec["steps"])]
tf_test = [dict(np.load(f"{work}/tf_test{i}.npz")) for i in range(2)]
for data, sq in spec["grids"]:
    mesh = auto_mesh(seq_parallel=sq, device="cpu")
    d = mesh.coords["data"]
    for impl in ("ring", "ulysses"):
        set_config(fused_update=(impl == "ring"))
        s = Solver(models.transformer_solver(),
                   models.transformer(spec["B"] // data, seq_len=spec["S"]), device="cpu")
        s.restore(f"{work}/tf_start.solverstate.npz")
        tr = ParallelTrainer(s, mesh=mesh, rules=ShardingRules(attention_impl=impl))
        key = f"tf_{data}x{sq}_{impl}"
        out[f"{key}/loss"] = np.array([
            tr.train_round(lambda it: local_shard(tf_feeds[it], d, data, False))
            for _ in range(spec["steps"])])
        held(s, key)
        if impl == "ring" and data == 1:
            acc = tr.test(2, lambda b: local_shard(tf_test[b], d, data, False))
            out[f"{key}/accuracy"] = np.array(acc["accuracy"])
        tr.close()
    set_config(fused_update=False)

# -- the char LM, each step from the JAX Solver's state -------------------
mesh = auto_mesh(seq_parallel=pool, device="cpu")
lm_feeds = [dict(np.load(f"{work}/lm{i}.npz")) for i in range(spec["steps"])]
for impl in ("ring", "ulysses"):
    set_config(fused_update=True)
    s = Solver(models.charlm_solver(), models.charlm(**spec["lm"]), device="cpu")
    tr = ParallelTrainer(s, mesh=mesh, rules=ShardingRules(attention_impl=impl))
    losses = []
    for k in range(spec["steps"]):
        s.restore(f"{work}/lm_{k}.solverstate.npz")
        losses.append(tr.train_round(lambda it: lm_feeds[it]))
        held(s, f"lm_{impl}_{k}")
    out[f"lm_{impl}/loss"] = np.array(losses)
    tr.close()
    set_config(fused_update=False)

# -- refusals and the indivisible sequence --------------------------------
errors = {}
feed30 = dict(np.load(f"{work}/tf30.npz"))
s = Solver(models.transformer_solver(), models.transformer(spec["B"], seq_len=30), device="cpu")
tr = ParallelTrainer(s, mesh=mesh, rules=ShardingRules(seq_feeds=("data",)))
try:
    tr.train_round(lambda it: feed30)
except ValueError as err:
    errors["seq_feeds"] = str(err)
s = Solver(models.transformer_solver(), models.transformer(spec["B"], seq_len=30), device="cpu")
s.restore(f"{work}/tf30_start.solverstate.npz")
tr = ParallelTrainer(s, mesh=mesh)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    out["tf30/loss"] = np.array(tr.train_round(lambda it: feed30))
errors["tf30_warned"] = any("not divisible" in str(w.message) for w in caught)
held(s, "tf30")
try:
    ParallelTrainer(Solver(models.transformer_solver(), models.transformer(spec["B"]),
                           device="cpu"), mesh=mesh, tau=3)
except ValueError as err:
    errors["tau"] = str(err)
s = Solver(models.transformer_solver(), models.transformer(8, seq_len=spec["S"], heads=2),
           device="cpu")
tr = ParallelTrainer(s, mesh=mesh, rules=ShardingRules(attention_impl="ulysses"))
try:
    tr.train_round(lambda it: {k: v[:8] for k, v in tf_feeds[0].items()})
except ValueError as err:
    errors["ulysses_heads"] = str(err)
try:
    auto_mesh(model_parallel=3, device="cpu")
except ValueError as err:
    errors["auto_mesh"] = str(err)
mesh = auto_mesh(model_parallel=2, seq_parallel=2, device="cpu")
errors["mesh"] = [mesh.shape, mesh.coords, mesh.comm("data", "seq").ranks,
                  mesh.comm("model").ranks]
if rank == 0:
    np.savez(f"{work}/out.npz", **out)
    json.dump(errors, open(f"{work}/errors.json", "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Writes the inputs and snapshots, runs the pool; returns its results
    and the JAX side's references."""
    work = tmp_path_factory.mktemp("seqpar")
    ref = {}
    np.savez(work / "attn.npz", *attn_qkv(0))
    tf = transformer_feeds(STEPS)
    for i, f in enumerate(tf):
        np.savez(work / f"tf{i}.npz", **f)
    tf_test = transformer_feeds(2, seed=7)
    for i, f in enumerate(tf_test):
        np.savez(work / f"tf_test{i}.npz", **f)
    js = JSolver(jmodels.transformer_solver(), jmodels.transformer(B, seq_len=S))
    js.save(str(work / "tf_start"))
    for f in tf:
        js.step(1, lambda it, f=f: f)
    ref["tf"] = js
    ref["tf_acc"] = js.test(2, lambda b: tf_test[b])["accuracy"]
    # the char LM: the JAX Solver's state before each step
    lm = lm_feeds(STEPS)
    for i, f in enumerate(lm):
        np.savez(work / f"lm{i}.npz", **f)
    jl = JSolver(jmodels.charlm_solver(), jmodels.charlm(**LM))
    ref["lm"] = []
    for k, f in enumerate(lm):
        jl.save(str(work / f"lm_{k}"))
        loss = jl.step(1, lambda it, f=f: f)  # average_loss 1: the step's loss
        ref["lm"].append(({ln: [np.asarray(p) for p in pl]
                           for ln, pl in jl.variables.params.items()}, float(loss)))
    # the indivisible sequence: S 30 on a seq axis of 4
    feed30 = transformer_feeds(1, seed=5, seq=30)[0]
    np.savez(work / "tf30.npz", **feed30)
    j30 = JSolver(jmodels.transformer_solver(), jmodels.transformer(B, seq_len=30))
    j30.save(str(work / "tf30_start"))
    j30.step(1, lambda it: feed30)
    ref["tf30"] = j30
    (work / "spec.json").write_text(json.dumps(dict(
        steps=STEPS, grids=GRIDS, B=B, S=S, lm=LM)))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env = {k: v for k, v in env.items() if not k.startswith("JAX")}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(POOL), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(POOL)]
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}\n{e}"
    got = dict(np.load(work / "out.npz"))
    errors = json.loads((work / "errors.json").read_text())
    return got, errors, ref


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_core_matches_jax(pool, impl, causal):
    got, _, _ = pool
    q, k, v = (jnp.asarray(a) for a in attn_qkv(0))
    mesh = Mesh(np.array(jax.devices()[:POOL]), ("seq",))
    whole = jring if impl == "ring" else julysses
    fn = jax.jit(lambda *a: whole(mesh, *a, causal=causal))
    key = f"{impl}_{int(causal)}"
    np.testing.assert_allclose(got[f"{key}/o"], np.asarray(fn(q, k, v)), atol=2e-5)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"{key}/d{name}"], np.asarray(g), atol=5e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"data{g[0]}xseq{g[1]}")
def test_transformer_seq_parallel_matches_single_device(pool, grid, impl):
    """3 SGD steps on a (data, seq) grid == the JAX single-device Solver."""
    got, _, ref = pool
    key = f"tf_{grid[0]}x{grid[1]}_{impl}"
    assert np.all(np.isfinite(got[f"{key}/loss"]))
    for ln, plist in ref["tf"].variables.params.items():
        for i, a in enumerate(plist):
            np.testing.assert_allclose(got[f"{key}/param/{ln}/{i}"], np.asarray(a),
                                       atol=2e-4, err_msg=f"{ln}[{i}]")


def test_seq_parallel_eval_matches_single_device(pool):
    got, _, ref = pool
    assert float(got["tf_1x4_ring/accuracy"]) == pytest.approx(ref["tf_acc"], abs=1e-5)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_charlm_steps_match_jax_step_by_step(pool, impl):
    """Each Adam step on a seq axis of 4, from the JAX Solver's state of the
    step before, lands within the one-step Adam gate of the JAX step; its
    loss (the mean over the seq ranks of each block's mean) within rtol
    1e-4 of the JAX step's."""
    got, _, ref = pool
    base_lr = jmodels.charlm_solver().base_lr
    for k, (params, loss) in enumerate(ref["lm"]):
        np.testing.assert_allclose(got[f"lm_{impl}/loss"][k], loss, rtol=1e-4,
                                   err_msg=f"step {k} loss")
        for ln, plist in params.items():
            for i, a in enumerate(plist):
                atol = 1e-5 * float(np.abs(a).max()) + 1e-2 * base_lr
                np.testing.assert_allclose(got[f"lm_{impl}_{k}/param/{ln}/{i}"], a,
                                           rtol=1e-4, atol=atol, err_msg=f"step {k} {ln}[{i}]")


def test_seq_feed_divisibility_and_refusals_match_jax(pool):
    """seq_feeds raises JAX's 'not divisible' message; the tau refusal and
    the Ulysses head-count error are JAX's, word for word."""
    _, errors, _ = pool
    rs = np.random.RandomState(0)
    feed = {"data": rs.randint(0, 64, (B, 30)).astype(np.int32),
            "label": rs.randint(0, 10, B).astype(np.int32)}
    mesh = jauto_mesh(num_devices=POOL, seq_parallel=POOL)
    tr = JTrainer(JSolver(jmodels.transformer_solver(), jmodels.transformer(B, seq_len=30)),
                  mesh=mesh, tau=1, rules=JRules(seq_feeds=("data",)))
    with pytest.raises(ValueError, match="not divisible") as jerr:
        tr.train_round(lambda it: feed)
    assert errors["seq_feeds"] == str(jerr.value)
    with pytest.raises(ValueError, match="tau=1") as jerr:
        JTrainer(JSolver(jmodels.transformer_solver(), jmodels.transformer(B)),
                 mesh=mesh, tau=3)
    assert errors["tau"] == str(jerr.value)
    tr = JTrainer(JSolver(jmodels.transformer_solver(), jmodels.transformer(8, heads=2)),
                  mesh=mesh, tau=1, rules=JRules(attention_impl="ulysses"))
    feeds = transformer_feeds(1)[0]
    with pytest.raises(ValueError, match="divisible") as jerr:
        tr.train_round(lambda it: {k: v[:8] for k, v in feeds.items()})
    assert errors["ulysses_heads"] == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jauto_mesh(num_devices=POOL, model_parallel=3)
    assert errors["auto_mesh"] == str(jerr.value)


def test_mesh_layout_matches_jax(pool):
    """auto_mesh(model 2, seq 2) over 4 ranks: JAX's axis order and shape,
    seq minor-most."""
    _, errors, _ = pool
    shape, coords, data_seq, model = errors["mesh"]
    jmesh = jauto_mesh(num_devices=POOL, model_parallel=2, seq_parallel=2)
    assert shape == dict(jmesh.shape)
    assert list(shape) == list(jmesh.axis_names)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert coords == {"data": 0, "model": 0, "seq": 0}  # rank 0's
    assert data_seq == sorted(int(i) for i in ids[:, 0, :].ravel())
    assert model == [int(i) for i in ids[0, :, 0]]


def test_indivisible_sequence_trains_whole(pool):
    """S 30 on a seq axis of 4: the feeds stay whole, the layers warn and
    run without sequence parallelism, and the step equals the JAX Solver's
    single-device step (atol 2e-4)."""
    got, errors, ref = pool
    assert errors["tf30_warned"]
    assert np.isfinite(got["tf30/loss"])
    for ln, plist in ref["tf30"].variables.params.items():
        for i, a in enumerate(plist):
            np.testing.assert_allclose(got[f"tf30/param/{ln}/{i}"], np.asarray(a),
                                       atol=2e-4, err_msg=f"{ln}[{i}]")
