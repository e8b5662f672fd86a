"""Weight sharing by name (``param { name: ... }``) in the port against the
JAX package, on the zoo's ``mnist_siamese`` (two LeNet towers sharing all
ten blobs) at batch 4 on the CPU.

The JAX layout holds: the owner keeps the tensor, each sharer's position a
0-size placeholder, and a step sums both towers' gradients into the
owner's blob.  One SGD step (``mnist_siamese_solver``: inv policy,
momentum 0.9) from JAX-initialized weights, per blob and through the fused
arena, is held at the zoo tests' tolerances (loss rtol 1e-5; params and
history rtol 1e-4 with 1e-5 of a blob's largest |value|).  Snapshots keep
JAX's keys, ``.caffemodel`` files are byte-equal to the JAX export, and
the three alias errors read as JAX's.  The trainers (a world of one, gloo
on the CPU) average each shared blob once: a round is bit for bit the
Solver's steps.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.net import export_caffemodel as jexport_caffemodel  # noqa: E402
from sparknet_tpu.proto import parse as jparse  # noqa: E402
from sparknet_tpu.solvers import arena as jarena  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase, get_config, set_config  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network, is_placeholder  # noqa: E402
from sparknet_tpu_torch.net import copy_caffemodel_params, export_caffemodel  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

B = 4
TOWER = ("conv1", "conv2", "ip1", "ip2", "feat")


def siamese_feeds(seed: int, batch: int = B) -> dict:
    rs = np.random.RandomState(seed)
    return {"pair_data": rs.rand(batch, 2, 28, 28).astype(np.float32),
            "sim": rs.randint(0, 2, batch).astype(np.float32)}


def close(got, ref, what, rtol=1e-4, arel=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max(initial=0.0)) + 1e-30,
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step: weights before, loss, weights and history after, and
    the solver itself (per blob, f32)."""
    saved = jget_config()
    jset_config(fused_update=False, storage_dtype="f32")
    try:
        js = JSolver(jm.mnist_siamese_solver(), jm.mnist_siamese(batch=B))
        params0 = {ln: [np.array(p) for p in pl] for ln, pl in js.variables.params.items()}
        feeds = siamese_feeds(1)
        loss = float(js.step(1, lambda it: feeds))
        params = {ln: [np.array(p) for p in pl] for ln, pl in js.variables.params.items()}
        slots = {ln: [[np.array(h) for h in hl] for hl in sl] for ln, sl in js.slots.items()}
    finally:
        jset_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)
    return dict(js=js, params0=params0, feeds=feeds, loss=loss, params=params, slots=slots)


def port_solver(fused: bool) -> Solver:
    saved = get_config()
    set_config(fused_update=fused, storage_dtype="f32")
    try:
        return Solver(models.mnist_siamese_solver(), models.mnist_siamese(batch=B),
                      device="cpu")
    finally:
        set_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)


def test_init_aliases_and_placeholders_match_jax():
    jnet = JNetwork(jm.mnist_siamese(batch=B), JPhase.TRAIN)
    jv = jnet.init(jax.random.PRNGKey(0))
    net = Network(models.mnist_siamese(batch=B), Phase.TRAIN, device="cpu")
    v = net.init()
    assert net.param_aliases == jnet.param_aliases
    assert net.param_aliases == {(f"{t}_p", i): (t, i) for t in TOWER for i in (0, 1)}
    assert list(v.params) == list(jv.params)
    for ln, pl in jv.params.items():
        assert [tuple(p.shape) for p in v.params[ln]] == [tuple(p.shape) for p in pl], ln
    assert all(tuple(p.shape) == (0,) for t in TOWER for p in v.params[f"{t}_p"])
    # the TEST view shares the same owners
    assert Network(models.mnist_siamese(batch=B), Phase.TEST,
                   device="cpu").param_aliases == net.param_aliases


def test_layer_params_resolve_each_sharer_to_its_owner():
    net = Network(models.mnist_siamese(batch=B), Phase.TRAIN, device="cpu")
    v = net.init()
    flagged = {(ln, i) for ln, pl in v.params.items() for i, p in enumerate(pl)
               if is_placeholder(p)}
    assert flagged == set(net.param_aliases)
    for layer in net.layers:
        got = net.layer_params(layer.name, v.params)
        want = [v.params[o[0]][o[1]] if (o := net.param_aliases.get((layer.name, i))) else p
                for i, p in enumerate(v.params.get(layer.name, []))]
        assert len(got) == len(want) and all(a is b for a, b in zip(got, want)), layer.name
        assert not any(is_placeholder(p) for p in got), layer.name
    with pytest.raises(ValueError, match="Cannot share param"):
        net.layer_params("conv1_p", {"conv1_p": v.params["conv1_p"]})


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
def test_step_from_jax_weights_matches_jax(jax_run, fused):
    ps = port_solver(fused)
    ps.variables = interop.netvars_from_numpy(jax_run["params0"], device="cpu")
    if fused:
        jnet = JNetwork(jm.mnist_siamese(batch=B), JPhase.TRAIN)
        jv = jnet.init(jax.random.PRNGKey(0))  # the params in creation order
        jl = jarena.build_layout(jv.params, jnet.param_specs_for(jv), jax_run["js"].config,
                                 storage_dtype="f32")
        assert (ps.layout.total, ps.layout.n_tiles) == (jl.total, jl.n_tiles)
        assert [e.span for e in ps.layout.entries] == [e.span for e in jl.entries]
        assert all(e.span == 0 for e in ps.layout.entries if e.lname.endswith("_p"))
        np.testing.assert_array_equal(ps.layout.tile_lr, jl.tile_lr)
    loss = ps.step(1, lambda it: jax_run["feeds"])
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=1e-5)
    v, slots = ps.variables, ps.slots
    for ln, blobs in jax_run["params"].items():
        for i, ref in enumerate(blobs):
            close(v.params[ln][i].detach().numpy(), ref, f"param {ln}[{i}]")
            for j, h in enumerate(jax_run["slots"][ln][i]):
                close(slots[ln][i][j].detach().numpy(), h, f"history {ln}[{i}][{j}]")
    # the shared blobs stay one tensor each: the sharers hold placeholders
    assert all(p.numel() == 0 for t in TOWER for p in v.params[f"{t}_p"])


def test_snapshot_keys_and_caffemodel_bytes_match_jax(jax_run, tmp_path):
    js = jax_run["js"]
    jpath = js.save(str(tmp_path / "jax"))
    ps = port_solver(True)
    ps.variables = interop.netvars_from_numpy(jax_run["params"], device="cpu")
    ps.slots = {ln: [[torch.from_numpy(h) for h in hl] for hl in sl]
                for ln, sl in jax_run["slots"].items()}
    ps.iter = 1
    ppath = ps.save(str(tmp_path / "port"))
    with np.load(jpath) as jz, np.load(ppath) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        for k in jz.files:
            if k != "__meta__":
                np.testing.assert_array_equal(pz[k], jz[k], err_msg=k)
    jfile = str(tmp_path / "jax.caffemodel")
    # the same weights in the nets' layer order (a jitted JAX step hands its
    # params dict back with the keys sorted)
    jparams = {ln: js.variables.params[ln] for ln in jax_run["params0"]}
    jexport_caffemodel(JNetwork(jm.mnist_siamese(batch=B), JPhase.TRAIN), jparams, jfile)
    pfile = str(tmp_path / "port.caffemodel")
    export_caffemodel(ps.train_net, ps.variables.params, pfile)
    assert open(pfile, "rb").read() == open(jfile, "rb").read()
    # a load back: the owners take the file's blobs, the placeholders stay
    fresh = Network(models.mnist_siamese(batch=B), Phase.TRAIN, device="cpu").init().params
    loaded, names = copy_caffemodel_params(fresh, pfile)
    assert set(names) == set(jax_run["params"])
    for ln, blobs in jax_run["params"].items():
        for i, ref in enumerate(blobs):
            np.testing.assert_array_equal(loaded[ln][i].numpy(), ref)
    # the weights bridge carries the placeholders both ways
    bridged = interop.netvars_from_solverstate(jpath, device="cpu")
    assert {ln: [tuple(p.shape) for p in pl] for ln, pl in bridged.params.items()} == \
        {ln: [np.shape(p) for p in pl] for ln, pl in jax_run["params"].items()}
    written = interop.solverstate_from_port(ps, str(tmp_path / "bridge.solverstate.npz"))
    with np.load(jpath) as jz, np.load(written) as wz:
        assert sorted(jz.files) == sorted(wz.files)
    # and the port's snapshot restores in either package
    back = port_solver(False)
    back.restore(ppath)
    for ln, blobs in jax_run["params"].items():
        for i, ref in enumerate(blobs):
            np.testing.assert_array_equal(back.variables.params[ln][i].numpy(), ref)
    js.restore(ppath)


ALIAS_ERRORS = {
    "position": ('''input: "data" input_shape { dim: 2 dim: 4 }
        layer { name: "a" type: "InnerProduct" bottom: "data" top: "a"
                param { name: "w" } inner_product_param { num_output: 4 bias_term: false } }
        layer { name: "b" type: "InnerProduct" bottom: "a" top: "b"
                param { } param { name: "w" }
                inner_product_param { num_output: 4 bias_term: false } }''',
                 "at position 1 of layer 'b', which has only 1 learnable blob"),
    "shape": ('''input: "data" input_shape { dim: 2 dim: 4 }
        layer { name: "a" type: "InnerProduct" bottom: "data" top: "a"
                param { name: "w" } inner_product_param { num_output: 4 } }
        layer { name: "b" type: "InnerProduct" bottom: "a" top: "b"
                param { name: "w" } inner_product_param { num_output: 3 } }''',
              r"owner a\[0\] has shape \(4, 4\) but b\[0\] expects \(3, 4\)"),
    "owner_name": ('''input: "data" input_shape { dim: 2 dim: 4 }
        layer { name: "a" type: "ReLU" bottom: "data" top: "r" }
        layer { name: "a" type: "InnerProduct" bottom: "r" top: "a"
                param { name: "w" } inner_product_param { num_output: 4 } }
        layer { name: "b" type: "InnerProduct" bottom: "a" top: "b"
                param { name: "w" } inner_product_param { num_output: 4 } }''',
                   "param-owning layer 'a' shares its name with another layer"),
    "paramless_owner": ('''input: "data" input_shape { dim: 2 dim: 4 }
        layer { name: "r" type: "ReLU" bottom: "data" top: "r" param { name: "w" } }
        layer { name: "b" type: "InnerProduct" bottom: "r" top: "b"
                param { name: "w" } inner_product_param { num_output: 4 } }''',
                        "owner layer 'r' .position 0. declares no such blob"),
}


@pytest.mark.parametrize("case", sorted(ALIAS_ERRORS))
def test_alias_errors_read_as_jax(case):
    text, match = ALIAS_ERRORS[case]
    with pytest.raises(ValueError, match=match):
        JNetwork(jparse(text), JPhase.TRAIN).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=match):
        Network(parse(text), Phase.TRAIN, device="cpu").init()


@pytest.fixture
def one_thread():
    """One intra-op thread while trainer and Solver step (their CPU sums
    then split the same way, see test_torch_port_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
@pytest.mark.parametrize("trainer", ["parallel", "elastic"])
def test_trainers_average_each_shared_blob_once(jax_run, trainer, fused, one_thread):
    """A world of one round at tau 2 is 2 Solver steps bit for bit, and the
    consensus weights carry JAX's collection keys and shapes."""
    import torch.distributed as dist

    from sparknet_tpu_torch.net import variables_to_collection
    from sparknet_tpu_torch.parallel import ParallelTrainer
    from sparknet_tpu_torch.parallel.elastic import ElasticTrainer

    feeds = [siamese_feeds(10 + i) for i in range(2)]
    start = interop.netvars_from_numpy(jax_run["params0"], device="cpu")
    solver, ref = port_solver(fused), port_solver(fused)
    solver.variables = ref.variables = start
    if trainer == "parallel":
        tr = ParallelTrainer(solver, tau=2)
        stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
        run = lambda: tr.train_round(lambda it: stacked)  # noqa: E731
    else:
        tr = ElasticTrainer(solver, width=1, tau=2)
        run = lambda: tr.train_round(lambda g: feeds[g])  # noqa: E731
    try:
        run()
        weights = tr.get_weights()
    finally:
        tr.close()
    assert not dist.is_initialized()
    ref.step(2, lambda it: feeds[it])
    for ln, pl in ref.variables.params.items():
        for a, b in zip(pl, solver.variables.params[ln]):
            assert torch.equal(a, b), ln
    jwc = {ln: [np.shape(p) for p in pl] for ln, pl in jax_run["js"].variables.params.items()}
    assert {ln: [np.shape(a) for a in weights[ln]] for ln in weights.layers()} == jwc
    assert variables_to_collection(solver.variables).layers() == list(jax_run["params0"])


def test_per_layer_timing_runs_the_sharers_on_the_owners_blobs():
    """``utils.timing.time_layers`` (the CLI's ``time``) runs a sharer's
    layer on its owner's tensors, forward and backward."""
    from sparknet_tpu_torch.utils.timing import time_layers

    net = Network(models.mnist_siamese(batch=2), Phase.TRAIN, device="cpu")
    rows = time_layers(net, net.init(), siamese_feeds(3, batch=2), iterations=1)
    by_name = {r["layer"]: r for r in rows}
    assert all(by_name[f"{t}_p"]["backward_ms"] is not None for t in TOWER)
