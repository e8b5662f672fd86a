"""The ``Python`` layer type in the port against the JAX package's.

One Caffe-compat class (a Euclidean loss in the style of Caffe's
examples/pycaffe/layers/pyloss.py, importing only numpy) runs unchanged in
both packages: the loss and its gradient through the class's own
``backward`` agree within 1e-5 of their largest |value|.  A torch-native
class (``apply`` on tensors) equals the JAX-native class of the same
formula; a class whose ``apply`` returns something other than tensors
(JAX-native, say) is refused with a ``TypeError``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.compiler.graph import NetVars as JNetVars  # noqa: E402
from sparknet_tpu.proto import parse as jparse  # noqa: E402

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network, NetVars  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

TOL = 1e-5

# a module the prototxt names (the PYTHONPATH contract)
_MODULE_SRC = '''
import numpy as np


class EuclideanLossLayer:
    """Caffe's pyloss.py: the same class in either package."""

    def setup(self, bottom, top):
        if len(bottom) != 2:
            raise Exception("Need two inputs to compute distance.")

    def reshape(self, bottom, top):
        if bottom[0].count != bottom[1].count:
            raise Exception("Inputs must have the same dimension.")
        self.diff = np.zeros_like(bottom[0].data, dtype=np.float32)
        top[0].reshape(1)

    def forward(self, bottom, top):
        self.diff[...] = bottom[0].data - bottom[1].data
        top[0].data[...] = np.sum(self.diff ** 2) / bottom[0].num / 2.0

    def backward(self, top, propagate_down, bottom):
        for i in range(2):
            if not propagate_down[i]:
                continue
            sign = 1 if i == 0 else -1
            bottom[i].diff[...] = sign * self.diff / bottom[i].num


class ScaledTanhTorch:
    """Torch-native: apply on tensors."""

    def apply(self, x):
        import torch

        return torch.tanh(x) * float(self.param_str or 1.0)


class ScaledTanhJax:
    def apply(self, x):
        import jax.numpy as jnp

        return jnp.tanh(x) * float(self.param_str or 1.0)


class ReturnsNumpy:
    def apply(self, x):
        return np.tanh(np.asarray(x))


class PhaseProbe:
    def setup(self, bottom, top):
        pass

    def reshape(self, bottom, top):
        top[0].reshape(*bottom[0].data.shape)

    def forward(self, bottom, top):
        top[0].data[...] = bottom[0].data * (10.0 if self.phase == 0 else 1.0)


class Neither:
    pass
'''


@pytest.fixture(scope="module", autouse=True)
def pylayer_module(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_pylayers")
    (d / "port_py_layers.py").write_text(_MODULE_SRC)
    sys.path.insert(0, str(d))
    yield
    sys.path.remove(str(d))
    sys.modules.pop("port_py_layers", None)


LINREG = """
name: "linreg"
input: "x" input_shape { dim: 6 dim: 3 dim: 2 }
input: "y" input_shape { dim: 6 dim: 3 dim: 2 }
layer { type: "InnerProduct" name: "ipx" top: "ipx" bottom: "x"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { type: "InnerProduct" name: "ipy" top: "ipy" bottom: "y"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { type: "Python" name: "loss" top: "loss" bottom: "ipx" bottom: "ipy"
  python_param { module: "port_py_layers" layer: "EuclideanLossLayer" }
  loss_weight: 1 }
"""


def _feeds():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(6, 3, 2).astype(np.float32), "y": rs.randn(6, 3, 2).astype(np.float32)}


def _within(got, ref, what):
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), (what, err)


def test_caffe_compat_class_runs_unchanged_in_both_packages():
    jnet = JNetwork(jparse(LINREG), JPhase.TRAIN)
    jv = jnet.init(jax.random.PRNGKey(0))
    feeds = _feeds()

    def jloss(params):
        return jnet.apply(JNetVars(params=params, state=jv.state), feeds, rng=None)[2]

    jl, jg = jax.value_and_grad(jloss)(jv.params)
    net = Network(parse(LINREG), Phase.TRAIN, device="cpu")
    net.init()
    v = interop.netvars_from_numpy({k: [np.asarray(p) for p in pl]
                                    for k, pl in jv.params.items()}, device="cpu")
    leaves = [p.requires_grad_(True) for pl in v.params.values() for p in pl]
    blobs, _, loss = net.apply(v, feeds)
    a, b = blobs["ipx"].detach().numpy(), blobs["ipy"].detach().numpy()
    np.testing.assert_allclose(float(loss.detach()), np.sum((a - b) ** 2) / 6 / 2.0, rtol=1e-6)
    _within(loss.detach().numpy(), jl, "loss")
    grads = torch.autograd.grad(loss, leaves)
    ref = [g for pl in (jg["ipx"], jg["ipy"]) for g in pl]
    for k, (g, r) in enumerate(zip(grads, ref)):
        _within(g.numpy(), r, f"grad {k}")


def test_torch_native_class_equals_the_jax_native_one():
    text = ('input: "x" input_shape {{ dim: 2 dim: 3 }} layer {{ type: "Python" name: "t" '
            'bottom: "x" top: "y" python_param {{ module: "port_py_layers" layer: "{}" '
            'param_str: "2.5" }} }}')
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32) * 2
    g = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    jnet = JNetwork(jparse(text.format("ScaledTanhJax")), JPhase.TRAIN)
    jy, vjp = jax.vjp(lambda a: jnet.apply(jnet.init(jax.random.PRNGKey(0)), {"x": a},
                                           rng=None)[0]["y"], jnp.asarray(x))
    net = Network(parse(text.format("ScaledTanhTorch")), Phase.TRAIN, device="cpu")
    tx = torch.tensor(x, requires_grad=True)
    y = net.apply(net.init(), {"x": tx})[0]["y"]
    (tg,) = torch.autograd.grad(y, tx, torch.tensor(g))
    _within(y.detach().numpy(), jy, "y")
    _within(tg.numpy(), vjp(jnp.asarray(g))[0], "grad")


def test_non_tensor_apply_is_refused():
    text = ('input: "x" input_shape { dim: 2 dim: 3 } layer { type: "Python" name: "t" '
            'bottom: "x" top: "y" python_param { module: "port_py_layers" '
            'layer: "ReturnsNumpy" } }')
    net = Network(parse(text), Phase.TEST, device="cpu")
    with pytest.raises(TypeError, match="torch-native.*Caffe-compat"):
        net.init()


@pytest.mark.parametrize("phase,scale", [(Phase.TRAIN, 10.0), (Phase.TEST, 1.0)])
def test_compat_layer_sees_the_phase_as_an_int(phase, scale):
    text = ('input: "x" input_shape { dim: 2 dim: 3 } layer { type: "Python" name: "t" '
            'bottom: "x" top: "y" python_param { module: "port_py_layers" '
            'layer: "PhaseProbe" } }')
    net = Network(parse(text), phase, device="cpu")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = net.apply(net.init(), {"x": x})[0]["y"]
    np.testing.assert_array_equal(y.numpy(), x * scale)


@pytest.mark.parametrize("python_param,err", [
    ('python_param { module: "port_py_layers" layer: "Neither" }', "must define either"),
    ('python_param { layer: "Neither" }', "needs python_param"),
])
def test_malformed_python_layers_are_refused(python_param, err):
    text = (f'input: "x" input_shape {{ dim: 2 }} layer {{ type: "Python" name: "t" '
            f'bottom: "x" top: "y" {python_param} }}')
    with pytest.raises(ValueError, match=err):
        Network(parse(text), Phase.TEST, device="cpu")
