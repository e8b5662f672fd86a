"""Channels-last (``Config.layout = "nhwc"``) in the port against the JAX
package's nhwc, on the CPU at small sizes: whole steps, the device
augment and the int8 deploy path (the layers and the layout helpers are in
``test_torch_port_layout.py``).

A narrow AlexNet step under nhwc (grouped convs, both LRNs, dropout at 0,
the fc boundary) from JAX weights against the JAX nhwc step and against
the port's own nchw step; a JAX nchw snapshot continued under the port's
nhwc; the device augment's nhwc arm with the JAX draws injected; the int8
deploy path in both layouts.

Tolerances: whole steps at rtol 1e-5 / atol 1e-6 (the loss and every
post-step param, the JAX package's own gate for its layout equivalence);
the device augment bit for bit (the same per-element float32 operations on
the same draws); the int8 logits at rtol 1e-4 / atol 1e-5 (JAX's gate).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparknet_tpu import layers_dsl as jdsl  # noqa: E402
from sparknet_tpu import models as jax_models  # noqa: E402
from sparknet_tpu import quant as jquant  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.compiler.graph import NetVars as JNetVars  # noqa: E402
from sparknet_tpu.data import transform as jtr  # noqa: E402
from sparknet_tpu.data.device_transform import DeviceAugment as JDeviceAugment  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch import interop, layers_dsl, models, quant  # noqa: E402
from sparknet_tpu_torch.common import Phase, set_config  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.data import transform  # noqa: E402
from sparknet_tpu_torch.data.device_transform import DeviceAugment  # noqa: E402
from sparknet_tpu_torch.ops import layout  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig  # noqa: E402

from test_torch_port_feed import _images, _jax_draws  # noqa: E402
from test_torch_port_layout import both, nhwc  # noqa: E402,F401  (a fixture)
from test_torch_port_solver import narrow_alexnet  # noqa: E402

B, CROP = 3, 67  # narrow_alexnet's batch
SGD = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4)


# -- whole steps -----------------------------------------------------------


def _alexnet_feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": (rs.randn(B, 3, CROP, CROP) * 50).astype(np.float32),
             "label": rs.randint(0, 10, B).astype(np.int32)} for _ in range(n)]


def _params(solver) -> dict:
    return {ln: [np.asarray(p.detach() if hasattr(p, "detach") else p) for p in pl]
            for ln, pl in solver.variables.params.items()}


def _same_params(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for ln, blobs in want.items():
        for i, w in enumerate(blobs):
            np.testing.assert_allclose(got[ln][i], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"param {ln}[{i}]")


def test_narrow_alexnet_step_nhwc_matches_jax_and_nchw(both):
    """One SGD step of the narrow AlexNet (grouped convs, both LRNs,
    dropout at 0, the fc boundary) from the JAX solver's weights, carried
    over by ``interop``: the port under nhwc against the JAX package under
    nhwc, and against the port's own nchw step; the loss and every
    post-step param at rtol 1e-5 / atol 1e-6."""
    both("nhwc")
    (feeds,) = _alexnet_feeds(1)
    internal = layout.feeds_to_internal(feeds)
    js = JSolver(JSolverConfig(**SGD), narrow_alexnet(jdsl))
    start = interop.netvars_from_numpy(js.variables.params, js.variables.state,
                                       device="cpu")
    jloss = js.step(1, lambda it: internal)
    port = {}
    for lay in ("nhwc", "nchw"):
        set_config(layout=lay)
        ps = Solver(SolverConfig(**SGD), narrow_alexnet(layers_dsl), device="cpu")
        ps.variables = start
        assert ps.train_net.feed_shapes()["data"] == layout.internal_shape((B, 3, CROP, CROP))
        loss = ps.step(1, lambda it: layout.feeds_to_internal(feeds))
        port[lay] = (loss, _params(ps))
    np.testing.assert_allclose(port["nhwc"][0], jloss, rtol=1e-5, atol=1e-6)
    _same_params(port["nhwc"][1], _params(js))
    np.testing.assert_allclose(port["nhwc"][0], port["nchw"][0], rtol=1e-5, atol=1e-6)
    _same_params(port["nhwc"][1], port["nchw"][1])


def test_jax_nchw_snapshot_continues_under_port_nhwc(both, tmp_path):
    """A ``.solverstate.npz`` the JAX package wrote under nchw (after a
    momentum step) restores with no conversion into a port solver under
    nhwc, whose next step matches the JAX solver's next nchw step; the
    port's own snapshot then carries ``layout: nhwc`` as provenance."""
    both("nchw")
    f0, f1 = _alexnet_feeds(2, seed=3)
    js = JSolver(JSolverConfig(**SGD), narrow_alexnet(jdsl))
    js.step(1, lambda it: f0)
    path = js.save(str(tmp_path / "jax_nchw"))
    jloss = js.step(1, lambda it: f1)
    set_config(layout="nhwc")
    ps = Solver(SolverConfig(**SGD), narrow_alexnet(layers_dsl), device="cpu")
    ps.restore(path)
    assert ps.iter == 1
    loss = ps.step(1, lambda it: layout.feeds_to_internal(f1))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    _same_params(_params(ps), _params(js))
    saved = ps.save(str(tmp_path / "port_nhwc"))
    with np.load(saved) as z:
        assert json.loads(bytes(z["__meta__"]).decode())["layout"] == "nhwc"


# -- the device augment's nhwc arm ---------------------------------------------


@pytest.mark.parametrize("case", ["mean_image_scale", "mean_value"])
def test_device_augment_nhwc_matches_jax(case, both):
    """TEST and TRAIN (the JAX draws injected) in the nhwc arm: bit for bit
    the JAX nhwc arm on HWC bytes, and the port's nchw arm permuted on the
    same draws."""
    both("nhwc")
    rs = np.random.RandomState(6)
    mean = (rs.rand(3, 13, 12) * 255).astype(np.float32)
    cfg = (dict(crop_size=9, mirror=True, mean_image=mean, scale=0.0039)
           if case == "mean_image_scale" else
           dict(crop_size=11, mirror=True, mean_value=(104.0, 117.0, 123.0)))
    x = _images(8, (3, 13, 12), seed=7)
    xh = nhwc(x)
    port = DeviceAugment(transform.TransformConfig(**cfg), device="cpu")
    assert port.layout == "nhwc"
    port_nchw = DeviceAugment(transform.TransformConfig(**cfg), layout="nchw", device="cpu")
    ref = JDeviceAugment(jtr.TransformConfig(**cfg))
    for train, key in ((False, 0), (True, 1), (True, 2)):
        k = jax.random.key(key)
        want = np.asarray(ref(xh, k, train=train))
        draws = _jax_draws(k, 8, 13, 12, cfg["crop_size"]) if train else (None, None)
        got = port(torch.from_numpy(xh), train, offsets=draws[0], flips=draws[1])
        assert got.shape == (8, cfg["crop_size"], cfg["crop_size"], 3)
        np.testing.assert_array_equal(got.numpy(), want)
        canon = port_nchw(torch.from_numpy(x), train, offsets=draws[0], flips=draws[1])
        assert torch.equal(got, canon.permute(0, 2, 3, 1))


# -- the int8 deploy path ------------------------------------------------------


def test_int8_deploy_path_in_both_layouts(both):
    """Records calibrated under nchw drive the int8 forward under nhwc
    (the dequant on the trailing channel axis, the fc boundary
    canonicalized): the logits match the port's nchw int8 forward and the
    JAX package's nhwc int8 forward on the same canonical bytes, from the
    same weights and records (the records are bit for bit the JAX
    package's, ``test_torch_port_quant.py``)."""
    both("nchw")
    batch = 8
    net = Network(models.lenet(batch), Phase.TEST, device="cpu")
    v = net.init(torch.Generator().manual_seed(4))
    rs = np.random.RandomState(9)
    calib = [{"data": rs.rand(batch, 1, 28, 28).astype(np.float32),
              "label": rs.randint(0, 10, batch).astype(np.int32)} for _ in range(2)]
    feeds = calib[0]
    tq = quant.calibrate(net, v, calib, num_batches=2)
    with torch.no_grad(), quant.quantized_inference(tq):
        want = net.apply(v, feeds, train=False)[0]["ip2"].numpy()
    both("nhwc")
    net_h = Network(models.lenet(batch), Phase.TEST, device="cpu")
    internal = layout.feeds_to_internal(feeds)
    for records in (tq, quant.prepare(tq, net_h)):
        with torch.no_grad(), quant.quantized_inference(records):
            got = net_h.apply(v, internal, train=False)[0]["ip2"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jnet_h = JNetwork(jax_models.lenet(batch), JPhase.TEST)
    jvars = JNetVars(params={ln: [jnp.asarray(p.numpy()) for p in pl]
                             for ln, pl in v.params.items()}, state={})
    jq = {name: {"w_q": jnp.asarray(r["w_q"].numpy()),
                 "w_scale": jnp.asarray(r["w_scale"].numpy()),
                 "x_scale": r["x_scale"]} for name, r in tq.items()}
    with jquant.quantized_inference(jq):
        jout = jnet_h.apply(jvars, internal, rng=None, train=False)[0]["ip2"]
    np.testing.assert_allclose(got, np.asarray(jout), rtol=1e-4, atol=1e-5)
