"""The port's MoE layer, expert parallelism and GPipe schedule
(``ops/moe.py``, ``parallel/expert.py``, ``parallel/pipeline.py``,
``parallel/sharding.py`` and ``ParallelTrainer`` over a model axis) against
the JAX package, on the CPU at a small size.

Four gloo processes (one pool, spawned once for the module, joined
through a ``FileStore``) run every case; the JAX side runs in this process
on the virtual CPU mesh.  Cases:

* ``MoELayer`` at the shapes of JAX's ``test_models.py`` DSL case (x [2, 6,
  8], 4 experts of hidden 32): the dense layer in this process, and the
  layer holding one expert a rank over a model axis of 4, forward and the
  gradients of sum(y^2) against ``jax.grad`` (atol 1e-5);
* the ``test_parallel.py`` MoE net (MoE 4 x 32 on [8, 16] tokens, a
  3-way InnerProduct, SoftmaxWithLoss) trained 3 SGD steps by a
  ``ParallelTrainer`` over ``auto_mesh(model_parallel=4)`` against the JAX
  ``Solver`` from the same snapshot (atol 2e-5, JAX's test's), the expert
  blobs split over 'model'; ``get_weights``, ``sync_to_solver`` and the
  ``interop`` export give whole blobs, and the JAX Solver restores the
  export;
* ``expert_parallel_moe`` at E 4 (64 tokens, D 16, H 32): capacity 4.0
  against ``moe_dense`` and JAX's (atol 2e-5), capacity 1.0 with the same
  dropped rows as JAX's, bit for bit, and its refusal;
* ``pipeline_blocks`` at S 4, M 1, 2 and 6 against JAX's and against
  ``sequential_blocks`` (atol 1e-5);
* a Megatron-sharded blob raising ``NotImplementedError``, and replicating
  under ``tensor_parallel=False``.
"""

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from sparknet_tpu import layers_dsl as jdsl  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.ops.moe import moe_dense as jmoe_dense  # noqa: E402
from sparknet_tpu.parallel.expert import expert_parallel_moe as jexpert  # noqa: E402
from sparknet_tpu.parallel.pipeline import pipeline_blocks as jpipeline  # noqa: E402
from sparknet_tpu.parallel.pipeline import stack_stage_params as jstack  # noqa: E402
from sparknet_tpu.parallel.sharding import blob_shard_degree as jdegree  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch import layers_dsl  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.interop import netvars_from_numpy  # noqa: E402
from sparknet_tpu_torch.parallel import ShardingRules  # noqa: E402
from sparknet_tpu_torch.parallel.sharding import blob_shard_degree  # noqa: E402
from sparknet_tpu_torch.proto.text_format import Message, serialize  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = 4
STEPS = 3
E, T, D, H = 4, 64, 16, 32  # expert_parallel_moe's case
PIPE_S, PIPE_D = 4, 16


def moe_net(mod, x_shape, with_loss: bool):
    """JAX's DSL MoE nets: MoE (4 experts, hidden 32) on ``x``, then (the
    test_parallel.py net) a 3-way InnerProduct and SoftmaxWithLoss."""
    layers = [mod.MoELayer("moe", ["x"], num_experts=4, hidden_dim=32, top="h")]
    if with_loss:
        layers += [
            Message().set("name", "cls").set("type", "InnerProduct").add("bottom", "h")
            .add("top", "cls").set("inner_product_param", Message().set("num_output", 3)
                                   .set("weight_filler", Message().set("type", "xavier"))),
            mod.SoftmaxWithLoss("loss", ["cls", "label"]),
        ]
    net = mod.NetParam("moe_tp", *layers)
    net.add("input", "x")
    shape = Message()
    for d in x_shape:
        shape.add("dim", d)
    net.add("input_shape", shape)
    if with_loss:
        net.add("input", "label")
        net.add("input_shape", Message().add("dim", x_shape[0]))
    return net


def moe_feed(it):
    rs = np.random.RandomState(100 + it)
    return {"x": rs.randn(8, 16).astype(np.float32),
            "label": rs.randint(0, 3, 8).astype(np.int32)}


def expert_case():
    rs = np.random.RandomState(0)
    params = [(rs.randn(E, D) * 0.5), (rs.randn(E, H, D) * 0.3), (rs.randn(E, H) * 0.1),
              (rs.randn(E, D, H) * 0.3), (rs.randn(E, D) * 0.1)]
    return [p.astype(np.float32) for p in params], rs.randn(T, D).astype(np.float32)


def pipe_case():
    rs = np.random.RandomState(0)
    stages = [{"w": (rs.randn(PIPE_D, PIPE_D) * 0.3).astype(np.float32),
               "b": (rs.randn(PIPE_D) * 0.1).astype(np.float32)} for _ in range(PIPE_S)]
    xs = {m: rs.randn(m, 3, PIPE_D).astype(np.float32) for m in (1, 2, 6)}
    return stages, xs


CHILD = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from sparknet_tpu_torch.common import Phase, set_config
from sparknet_tpu_torch.compiler.graph import Network, NetVars
from sparknet_tpu_torch.interop import netvars_from_numpy, solverstate_from_port
from sparknet_tpu_torch.ops.moe import model_parallel, moe_dense
from sparknet_tpu_torch.parallel import (ParallelTrainer, ShardingRules, auto_mesh,
                                         expert_parallel_moe, initialize_distributed,
                                         param_shardings, pipeline_blocks, process_mesh,
                                         sequential_blocks, stack_stage_params)
from sparknet_tpu_torch.parallel.collectives import all_gather
from sparknet_tpu_torch.proto.text_format import parse
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig

rank, pool, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_distributed(store_path=f"{work}/store", rank=rank, world_size=pool, device="cpu")
torch.set_num_threads(1)
out, info = {}, {}

# -- the layer over a model axis of 4 --------------------------------------
mesh = auto_mesh(model_parallel=pool, device="cpu")
model = mesh.comm("model")
net = Network(parse(open(f"{work}/layer.prototxt").read()), Phase.TEST, device="cpu")
z = np.load(f"{work}/layer.npz")
whole = netvars_from_numpy({"moe": [z[f"p{i}"] for i in range(5)]}, device="cpu")
shard = param_shardings(net, whole, mesh).params["moe"]
info["layer_axes"] = [sh.axis for sh in shard]
mine = [sh.local(p).clone().requires_grad_(True) for p, sh in zip(whole.params["moe"], shard)]
x = torch.from_numpy(z["x"]).requires_grad_(True)
with model_parallel(mesh):
    blobs, _, _ = net.apply(NetVars({"moe": mine}, {}), {"x": x}, train=False)
y = blobs["h"]
(y ** 2).sum().backward()
out["layer/y"] = y.detach().numpy()
out["layer/dx"] = x.grad.numpy()
for i, p in enumerate(mine):
    out[f"layer/dp{i}"] = all_gather(p.grad, 0, model).numpy()

# -- the MoE net trained over the model axis --------------------------------
netp = parse(open(f"{work}/net.prototxt").read())
for fused in (False, True):
    set_config(fused_update=fused)
    s = Solver(SolverConfig(base_lr=0.05), netp, device="cpu")
    s.restore(f"{work}/net_start.solverstate.npz")
    tr = ParallelTrainer(s, mesh=mesh)
    info[f"net{int(fused)}/held"] = [list(p.shape) for p in s.variables.params["moe"]]
    feeds = [dict(np.load(f"{work}/feed{i}.npz")) for i in range(3)]
    out[f"net{int(fused)}/loss"] = np.array([tr.train_round(lambda it: feeds[it])
                                             for _ in range(3)])
    w = tr.get_weights()
    for ln in ("moe", "cls"):
        for i, a in enumerate(w[ln]):
            out[f"net{int(fused)}/w/{ln}/{i}"] = a
    solverstate_from_port(tr, f"{work}/export{int(fused)}.rank{rank}.solverstate.npz")
    info[f"net{int(fused)}/synced"] = [list(p.shape) for p in s.variables.params["moe"]]
    # the next round splits the blobs again
    tr.train_round(lambda it: feeds[0])
    info[f"net{int(fused)}/again"] = [list(p.shape) for p in s.variables.params["moe"]]
    tr.close()
set_config(fused_update=False)

# -- a Megatron blob ----------------------------------------------------------
big = parse(open(f"{work}/big.prototxt").read())
s = Solver(SolverConfig(base_lr=0.05), big, device="cpu")
try:
    ParallelTrainer(s, mesh=mesh)
except NotImplementedError as err:
    info["megatron"] = str(err)
tr = ParallelTrainer(s, mesh=mesh, rules=ShardingRules(tensor_parallel=False))
info["megatron_off"] = [list(p.shape) for p in s.variables.params["ip"]]

# -- expert_parallel_moe ------------------------------------------------------
emesh = process_mesh({"expert": pool}, device="cpu")
z = np.load(f"{work}/expert.npz")
params = [torch.from_numpy(z[f"p{i}"]) for i in range(5)]
xe = torch.from_numpy(z["x"])
out["expert/dense"] = moe_dense(params, xe).numpy()
out["expert/full"] = expert_parallel_moe(emesh, params, xe, capacity_factor=float(pool)).numpy()
out["expert/tight"] = expert_parallel_moe(emesh, params, xe, capacity_factor=1.0).numpy()
try:
    expert_parallel_moe(emesh, [params[0][:2]] + params[1:], xe)
except ValueError as err:
    info["expert_refusal"] = str(err)

# -- pipeline_blocks ----------------------------------------------------------
smesh = process_mesh({"stage": pool}, device="cpu")
z = np.load(f"{work}/pipe.npz")
stacked = stack_stage_params([{"w": torch.from_numpy(z[f"w{s}"]),
                               "b": torch.from_numpy(z[f"b{s}"])} for s in range(pool)])
block = lambda p, a: torch.tanh(a @ p["w"] + p["b"])
for m in (1, 2, 6):
    xm = torch.from_numpy(z[f"x{m}"])
    out[f"pipe/{m}"] = pipeline_blocks(smesh, block, stacked, xm).numpy()
    out[f"pipe/{m}/seq"] = sequential_blocks(block, stacked, xm).numpy()
info["pipe_rank"] = rank

np.savez(f"{work}/out.rank{rank}.npz", **out)
json.dump(info, open(f"{work}/info.rank{rank}.json", "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    work = tmp_path_factory.mktemp("moepipe")
    ref = {}
    # the layer alone: JAX-initialized params
    jnet = JNetwork(moe_net(jdsl, (2, 6, 8), False), JPhase.TEST)
    jv = jnet.init(jax.random.PRNGKey(0))
    lp = [np.asarray(p) for p in jv.params["moe"]]
    x = np.random.RandomState(1).randn(2, 6, 8).astype(np.float32)
    np.savez(work / "layer.npz", x=x, **{f"p{i}": p for i, p in enumerate(lp)})
    (work / "layer.prototxt").write_text(serialize(moe_net(layers_dsl, (2, 6, 8), False)))
    ref["layer"] = (lp, x)
    # the net trained 3 steps
    js = JSolver(JSolverConfig(base_lr=0.05), moe_net(jdsl, (8, 16), True))
    js.save(str(work / "net_start"))
    for i in range(STEPS):
        f = moe_feed(i)
        np.savez(work / f"feed{i}.npz", **f)
        js.step(1, lambda it, f=f: f)
    ref["net"] = js
    (work / "net.prototxt").write_text(serialize(moe_net(layers_dsl, (8, 16), True)))
    big = layers_dsl.NetParam("big", layers_dsl.InnerProductLayer("ip", ["x"], num_output=256))
    big.add("input", "x")
    big.add("input_shape", Message().add("dim", 2).add("dim", 8))
    (work / "big.prototxt").write_text(serialize(big))
    params, xe = expert_case()
    np.savez(work / "expert.npz", x=xe, **{f"p{i}": p for i, p in enumerate(params)})
    stages, xs = pipe_case()
    np.savez(work / "pipe.npz", **{f"w{s}": st["w"] for s, st in enumerate(stages)},
             **{f"b{s}": st["b"] for s, st in enumerate(stages)},
             **{f"x{m}": v for m, v in xs.items()})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env = {k: v for k, v in env.items() if not k.startswith("JAX")}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(POOL), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(POOL)]
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}\n{e}"
    got = [dict(np.load(work / f"out.rank{r}.npz")) for r in range(POOL)]
    info = [json.loads((work / f"info.rank{r}.json").read_text()) for r in range(POOL)]
    return got, info, ref, work


def _jax_layer_grads(lp, x):
    def loss(params, x):
        return jnp.sum(jmoe_dense(params, x.reshape(-1, x.shape[-1])) ** 2)

    y = jmoe_dense([jnp.asarray(p) for p in lp], jnp.asarray(x).reshape(-1, 8)).reshape(x.shape)
    dp, dx = jax.grad(loss, argnums=(0, 1))([jnp.asarray(p) for p in lp], jnp.asarray(x))
    return np.asarray(y), [np.asarray(g) for g in dp], np.asarray(dx)


def test_moe_layer_dense_matches_jax(pool):
    """The port's layer holding every expert, forward and gradients, against
    the JAX layer's dense compute."""
    _, _, ref, _ = pool
    lp, x = ref["layer"]
    want_y, want_dp, want_dx = _jax_layer_grads(lp, x)
    net = Network(moe_net(layers_dsl, (2, 6, 8), False), Phase.TEST, device="cpu")
    v = netvars_from_numpy({"moe": lp}, device="cpu")
    params = [p.clone().requires_grad_(True) for p in v.params["moe"]]
    xt = torch.from_numpy(x).requires_grad_(True)
    blobs, _, _ = net.apply(type(v)({"moe": params}, {}), {"x": xt}, train=False)
    (blobs["h"] ** 2).sum().backward()
    np.testing.assert_allclose(blobs["h"].detach().numpy(), want_y, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=1e-5)
    for p, g in zip(params, want_dp):
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-5)


@pytest.mark.parametrize("rank", range(POOL))
def test_moe_layer_model_sharded_matches_jax(pool, rank):
    """One expert a rank over a model axis of 4: every rank's output and
    input gradient, and the gathered param gradients, equal the dense
    layer's (atol 1e-5); every blob splits over 'model'."""
    got, info, ref, _ = pool
    lp, x = ref["layer"]
    want_y, want_dp, want_dx = _jax_layer_grads(lp, x)
    assert info[rank]["layer_axes"] == ["model"] * 5
    np.testing.assert_allclose(got[rank]["layer/y"], want_y, atol=1e-5)
    np.testing.assert_allclose(got[rank]["layer/dx"], want_dx, atol=1e-5)
    for i, g in enumerate(want_dp):
        np.testing.assert_allclose(got[rank][f"layer/dp{i}"], g, atol=1e-5, err_msg=f"p{i}")


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
def test_moe_net_trains_expert_sharded_like_jax(pool, fused):
    """3 SGD steps under auto_mesh(model_parallel=4) == the JAX Solver's 3
    steps (atol 2e-5); each rank holds one expert, the exports are whole
    and restore into the JAX Solver, and the next round splits again."""
    got, info, ref, work = pool
    js = ref["net"]
    k = f"net{int(fused)}"
    for r in range(POOL):
        assert info[r][f"{k}/held"][1] == [1, 32, 16]
        assert info[r][f"{k}/synced"][1] == [4, 32, 16]
        assert info[r][f"{k}/again"][1] == [1, 32, 16]
        for ln in ("moe", "cls"):
            for i, a in enumerate(js.variables.params[ln]):
                np.testing.assert_allclose(got[r][f"{k}/w/{ln}/{i}"], np.asarray(a),
                                           atol=2e-5, err_msg=f"rank {r} {ln}[{i}]")
    restored = JSolver(JSolverConfig(base_lr=0.05), moe_net(jdsl, (8, 16), True))
    restored.restore(str(work / f"export{int(fused)}.rank0.solverstate.npz"))
    assert restored.iter == STEPS
    for a, b in zip(jax.tree_util.tree_leaves(restored.variables.params),
                    jax.tree_util.tree_leaves(js.variables.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_megatron_blob_raises_and_replicates_when_asked(pool):
    _, info, _, _ = pool
    assert "Queue A12" in info[0]["megatron"] and "InnerProduct" in info[0]["megatron"]
    assert info[0]["megatron_off"] == [[256, 8], [256]]


def test_sharding_rules_defaults_match_jax():
    import dataclasses

    from sparknet_tpu.parallel.sharding import ShardingRules as JRules

    assert dataclasses.asdict(ShardingRules()) == dataclasses.asdict(JRules())


@pytest.mark.parametrize("layer_type,shape", [
    ("MoE", (4, 32, 16)), ("MoE", (6, 8)), ("MoE", (8,)), ("ReLU", (256,)),
    ("InnerProduct", (3, 16)), ("Embed", (64, 8)), ("Convolution", (100, 3, 5, 5))])
def test_blob_shard_degree_matches_jax(layer_type, shape):
    assert blob_shard_degree(layer_type, shape, 4) == jdegree(layer_type, shape, 4)
    assert blob_shard_degree(layer_type, shape, 4, ShardingRules(tensor_parallel=False)) == 1


@pytest.fixture(scope="module")
def jax_expert():
    """JAX's dispatch at capacity E and 1.0, and its refusal's message."""
    params, x = expert_case()
    mesh = Mesh(np.array(jax.devices()[:E]), ("expert",))
    jp = [jnp.asarray(p) for p in params]
    run = {c: np.asarray(jax.jit(partial(jexpert, mesh, capacity_factor=c))(jp, jnp.asarray(x)))
           for c in (float(E), 1.0)}
    with pytest.raises(ValueError) as jerr:
        jexpert(mesh, [jp[0][:2]] + jp[1:], jnp.asarray(x))
    return run[float(E)], run[1.0], str(jerr.value)


@pytest.mark.parametrize("rank", range(POOL))
def test_expert_parallel_matches_dense_and_jax(pool, jax_expert, rank):
    """Capacity E: equal to moe_dense and JAX's; capacity 1.0: JAX's dropped
    rows bit for bit, the kept ones equal; the refusal is JAX's."""
    got, info, _, _ = pool
    jfull, jtight, refusal = jax_expert
    g = got[rank]
    np.testing.assert_allclose(g["expert/full"], g["expert/dense"], atol=2e-5)
    np.testing.assert_allclose(g["expert/full"], jfull, atol=2e-5)
    dropped = np.all(g["expert/tight"] == 0, axis=1)
    want = np.all(jtight == 0, axis=1)
    assert want.any()
    np.testing.assert_array_equal(dropped, want)
    np.testing.assert_allclose(g["expert/tight"][~dropped], jtight[~want], atol=2e-5)
    assert info[rank]["expert_refusal"] == refusal


@pytest.mark.parametrize("m", [1, 2, 6])
def test_pipeline_blocks_match_jax(pool, m):
    """The GPipe schedule over 4 stages == JAX's and the sequential stack
    on every rank (atol 1e-5), the bubble-dominated M < S included."""
    got, _, _, _ = pool
    stages, xs = pipe_case()
    mesh = Mesh(np.array(jax.devices()[:PIPE_S]), ("stage",))
    stacked = jstack([{k: jnp.asarray(v) for k, v in st.items()} for st in stages])

    def block(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    want = np.asarray(jax.jit(partial(jpipeline, mesh, block))(stacked, jnp.asarray(xs[m])))
    for r in range(POOL):
        np.testing.assert_allclose(got[r][f"pipe/{m}"], want, atol=1e-5)
        np.testing.assert_allclose(got[r][f"pipe/{m}"], got[r][f"pipe/{m}/seq"], atol=1e-5)
