"""The port's whole TEST-phase path at a small size, against the JAX package.

Each zoo net is built by both packages' builders; the JAX
``Network(..., Phase.TEST).init(key)`` weights cross into the port through
``sparknet_tpu_torch.interop``, so filler RNG never enters a comparison.
Inputs are raw-pixel scale (x50), as the zoo fillers expect.  AlexNet and
CaffeNet run at crop 67, which keeps every layer valid (conv1 gives 15,
pool5 gives 1).  Tolerance: atol/rtol 1e-4 on the loss and the last
InnerProduct's output (float32 accumulation order differs between XLA and
ATen through up to eight layers).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jax_models  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JaxNetwork  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)

# name -> (builder kwargs, input shape, classifier blob)
NETS = {
    "alexnet": (dict(batch=2, num_classes=10, crop=67), (2, 3, 67, 67), "fc8"),
    "caffenet": (dict(batch=2, num_classes=10, crop=67), (2, 3, 67, 67), "fc8"),
    "lenet": (dict(batch=3), (3, 1, 28, 28), "ip2"),
    "cifar10_quick": (dict(batch=3), (3, 3, 32, 32), "ip2"),
    "cifar10_full": (dict(batch=3), (3, 3, 32, 32), "ip1"),
}

_CACHE = {}


def jax_side(name):
    """(JAX net, its TEST-phase variables, numpy feeds, JAX outputs)."""
    if name not in _CACHE:
        kwargs, shape, _ = NETS[name]
        jnet = JaxNetwork(getattr(jax_models, name)(**kwargs), JPhase.TEST)
        jvars = jnet.init(jax.random.key(7))
        rs = np.random.RandomState(3)
        feeds = {"data": (rs.randn(*shape) * 50).astype(np.float32),
                 "label": rs.randint(0, 10, shape[0]).astype(np.int32)}
        fwd = jax.jit(lambda v, f: jnet.apply(v, f, rng=None, train=False))
        blobs, _, loss = fwd(jvars, feeds)
        _CACHE[name] = (jnet, jvars, feeds,
                        {k: np.asarray(v) for k, v in blobs.items()}, float(loss))
    return _CACHE[name]


def port_side(name):
    kwargs, _, _ = NETS[name]
    return Network(getattr(models, name)(**kwargs), Phase.TEST, device="cpu")


@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_jax(name):
    jnet, jvars, feeds, jblobs, jloss = jax_side(name)
    net = port_side(name)
    variables = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    before = kernels.LRN_LAUNCHES
    blobs, state, loss = net.apply(variables, feeds)
    assert kernels.LRN_LAUNCHES == before  # CPU tensors take the plain path
    out = NETS[name][2]
    np.testing.assert_allclose(blobs[out].numpy(), jblobs[out], **TOL)
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    np.testing.assert_allclose(float(blobs["accuracy"]), jblobs["accuracy"])
    assert np.isfinite(float(loss))
    assert state == {}


@pytest.mark.parametrize("name", list(NETS))
def test_structure_matches_jax(name):
    """Output blobs, feed shapes, every blob's shape and every param's
    shape agree with the JAX package's view of the same net."""
    jnet, jvars, _, _, _ = jax_side(name)
    net = port_side(name)
    variables = net.init(torch.Generator().manual_seed(0))
    assert net.output_blobs() == jnet.output_blobs()
    assert net.feed_shapes() == jnet.feed_shapes()
    assert net.feed_blobs == jnet.feed_blobs
    assert {k: v.shape for k, v in net.blob_info().items()} == {
        k: tuple(v.shape) for k, v in jnet.blob_info().items()}
    assert {k: [tuple(p.shape) for p in v] for k, v in variables.params.items()} == {
        k: [tuple(np.shape(p)) for p in v] for k, v in jvars.params.items()}
    assert all(p.device.type == "cpu" for v in variables.params.values() for p in v)


def test_partial_execution_matches_full_forward():
    _, jvars, feeds, _, jloss = jax_side("caffenet")
    net = port_side("caffenet")
    variables = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    full, _, loss = net.apply(variables, feeds)
    head, _, head_loss = net.apply(variables, feeds, end="norm2")
    assert "fc8" not in head and float(head_loss) == 0.0
    tail, _, tail_loss = net.apply(
        variables, {"norm2": head["norm2"], "label": feeds["label"]}, start="conv3")
    assert torch.equal(tail["fc8"], full["fc8"])
    assert float(tail_loss) == float(loss)
    with pytest.raises(ValueError, match="needs blob"):
        net.apply(variables, {"label": feeds["label"]}, start="conv3")
    with pytest.raises(ValueError, match="comes after"):
        net.apply(variables, feeds, start="conv3", end="conv1")


def test_interop_reads_solverstate_snapshot(tmp_path):
    """A snapshot written by the JAX Solver crosses through its npz key
    scheme and gives the same forward as the in-memory variables."""
    from sparknet_tpu.solvers.solver import Solver

    solver = Solver(jax_models.lenet_solver(), jax_models.lenet(batch=3))
    path = solver.save(str(tmp_path / "lenet"))
    variables = interop.netvars_from_solverstate(path, device="cpu")
    assert set(variables.params) == set(solver.variables.params)
    for name, blobs in solver.variables.params.items():
        for a, b in zip(variables.params[name], blobs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, _, feeds, _, _ = jax_side("lenet")
    jnet = JaxNetwork(jax_models.lenet(batch=3), JPhase.TEST)
    jblobs, _, _ = jnet.apply(solver.variables, feeds, rng=None, train=False)
    blobs, _, _ = port_side("lenet").apply(variables, feeds)
    np.testing.assert_allclose(blobs["ip2"].numpy(), np.asarray(jblobs["ip2"]), **TOL)


def test_interop_splits_layer_names_with_slashes():
    arrays = {
        "param/inception_3a/1x1/0": np.ones((2, 3), np.float32),
        "param/inception_3a/1x1/1": np.zeros((2,), np.float32),
        "state/bn/a/mean": np.full((3,), 2.0, np.float32),
        "hist/inception_3a/1x1/0/0": np.ones((2, 3), np.float32),
        "__iter__": np.asarray(5),
    }
    v = interop.netvars_from_solverstate(arrays, device="cpu")
    assert [tuple(t.shape) for t in v.params["inception_3a/1x1"]] == [(2, 3), (2,)]
    assert float(v.state["bn/a"]["mean"][0]) == 2.0
    assert set(v.params) == {"inception_3a/1x1"} and set(v.state) == {"bn/a"}
    with pytest.raises(ValueError, match="param blobs"):
        interop.netvars_from_solverstate({"param/x/1": np.ones(2, np.float32)},
                                         device="cpu")


def test_net_level_inputs_and_phase_filter():
    text = """name: "n" input: "data" input_dim: 2 input_dim: 3 input_dim: 5 input_dim: 5
      layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
      layer { name: "train_only" type: "ReLU" bottom: "ip" top: "ip"
        include { phase: TRAIN } }"""
    net = Network(parse(text), Phase.TEST, device="cpu")
    assert net.feed_shapes() == {"data": (2, 3, 5, 5)}
    assert [l.name for l in net.layers] == ["ip"]
    assert net.output_blobs() == ["ip"]
    v = net.init()
    blobs, _, loss = net.apply(v, {"data": np.ones((2, 3, 5, 5), np.float32)})
    assert tuple(blobs["ip"].shape) == (2, 4) and float(loss) == 0.0
    with pytest.raises(ValueError, match="missing feed"):
        net.apply(v, {})


def test_shared_param_names_are_not_ported():
    """A param name that no other layer names makes its layer the owner:
    no alias and a full blob (sharing itself is held against JAX in
    ``test_torch_port_shared_params.py``)."""
    text = """name: "n" input: "data" input_dim: 1 input_dim: 4
      layer { name: "a" type: "InnerProduct" bottom: "data" top: "a"
        param { name: "w" } inner_product_param { num_output: 4 } }"""
    net = Network(parse(text), Phase.TEST, device="cpu")
    assert net.param_aliases == {}
    assert [tuple(p.shape) for p in net.init().params["a"]] == [(4, 4), (4,)]
