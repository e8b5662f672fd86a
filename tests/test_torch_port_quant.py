"""The int8 deploy path of the port against the JAX package's
``sparknet_tpu/quant.py``.

* The quantizers: ``w_q``, ``w_scale`` and ``x_scale`` bit for bit JAX's.
* The int32 sums of ``int8_conv``/``int8_matmul`` bit for bit JAX's
  (``lax.conv_general_dilated``/``dot_general`` with int32 results), plain,
  strided, padded, dilated, grouped and depthwise; the dequantized outputs
  within one float32 ulp (the same float32 products, in fact equal).
* The zero padding the card's ``torch._int_mm`` needs is exact.
* ``calibrate``: every record bit for bit JAX's on lenet, and through the
  owner on the siamese net's shared weights; uncalibrated layers stay float.
* The quantized lenet forward within rtol/atol 1e-5 of JAX's (the pattern of
  ``tests/test_quant.py``), its top-1 agreeing with the float forward's.
* ``DeployNet.quantize_int8`` after ``fold_batchnorm``, and the refusal the
  other way round; ``Classifier.calibrate_int8`` against JAX's.
* The engine's ``int8`` arm: a padded batch bit for bit a full one within a
  bucket, the scores against the JAX engine's int8 arm at rtol/atol 1e-5.
* ``cli.py --dtype bf16``: ``train``/``test``/``time`` run and the Config
  is restored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparknet_tpu.common as jcommon  # noqa: E402
from sparknet_tpu import models as jax_models  # noqa: E402
from sparknet_tpu import quant as jquant  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402

import sparknet_tpu_torch.common as tcommon  # noqa: E402
from sparknet_tpu_torch import interop, models, quant  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_config():
    prev = tcommon.get_config()
    yield
    tcommon._config = prev


def _j(x):
    return np.array(x)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 8), (20, 1, 5, 5), (16, 8, 3, 3), (3, 75)])
def test_quantize_weight_bit_for_bit(shape):
    rs = np.random.RandomState(len(shape) + shape[0])
    w = (rs.randn(*shape) * rs.choice([1e-3, 0.1, 30.0], size=(shape[0],) + (1,) * (
        len(shape) - 1))).astype(np.float32)
    w[-1] = 0.0  # a dead channel: the 1e-12 floor
    jq, js = jquant.quantize_weight(w, channel_axis=0)
    tq, ts = quant.quantize_weight(torch.from_numpy(w), channel_axis=0)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), _j(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), _j(js).view(np.uint32))


def test_quantize_activation_bit_for_bit_with_ties():
    rs = np.random.RandomState(2)
    x = (rs.randn(5000) * 3).astype(np.float32)
    scale = np.float32(float(np.abs(x).max()) / 127.0)
    # exact half-way points round to even in both packages
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 200.0], np.float32) * scale
    np.testing.assert_array_equal(quant.quantize_activation(torch.from_numpy(x), scale).numpy(),
                                  _j(jquant.quantize_activation(x, scale)))


# ---------------------------------------------------------------------------
# the int32 products
# ---------------------------------------------------------------------------

CONV_CASES = {
    # name: (x shape, w shape, stride, pad, dilation, groups)
    "plain": ((2, 3, 9, 9), (8, 3, 3, 3), (1, 1), (0, 0), 1, 1),
    "stride_pad": ((2, 3, 15, 13), (20, 3, 5, 5), (2, 2), (2, 1), 1, 1),
    "cifar_conv1": ((2, 3, 12, 12), (32, 3, 5, 5), (1, 1), (2, 2), 1, 1),
    "dilated": ((1, 4, 12, 12), (6, 4, 3, 3), (1, 1), (2, 2), 2, 1),
    "group2": ((2, 8, 7, 7), (12, 4, 3, 3), (1, 1), (1, 1), 1, 2),
    "depthwise": ((2, 6, 8, 8), (6, 1, 3, 3), (2, 2), (1, 1), 1, 6),
}


def _conv_case(name):
    xs, ws, stride, pad, dil, groups = CONV_CASES[name]
    rs = np.random.RandomState(sum(xs))
    x = (rs.randn(*xs) * 20).astype(np.float32)
    w = (rs.randn(*ws) * 0.1).astype(np.float32)
    w_q, w_scale = jquant.quantize_weight(w)
    q = {"w_q": w_q, "w_scale": w_scale, "x_scale": np.float32(float(np.abs(x).max()) / 127.0)}
    tq = {"w_q": torch.from_numpy(_j(w_q)), "w_scale": torch.from_numpy(_j(w_scale)),
          "x_scale": q["x_scale"]}
    return x, q, tq, stride, pad, dil, groups


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_int8_conv_sums_bit_for_bit(name):
    x, q, tq, stride, pad, dil, groups = _conv_case(name)
    x_q = jquant.quantize_activation(x, q["x_scale"])
    want = jax.lax.conv_general_dilated(
        x_q, q["w_q"], window_strides=stride, padding=[(pad[0], pad[0]), (pad[1], pad[1])],
        rhs_dilation=(dil, dil), dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    got = quant.conv_int32(quant.quantize_activation(torch.from_numpy(x), q["x_scale"]),
                           tq["w_q"], stride=stride, padding=pad, dilation=(dil, dil),
                           groups=groups)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), _j(want))
    # dequantized: the same float32 products, within one float32 ulp
    jy = _j(jquant.int8_conv(x, q, stride=stride, padding=[(pad[0], pad[0]), (pad[1], pad[1])],
                             rhs_dilation=(dil, dil),
                             dimension_numbers=("NCHW", "OIHW", "NCHW"),
                             feature_group_count=groups))
    ty = quant.int8_conv(torch.from_numpy(x), tq, stride=stride, padding=pad,
                         dilation=(dil, dil), groups=groups).numpy()
    np.testing.assert_allclose(ty, jy, rtol=np.finfo(np.float32).eps, atol=0)


@pytest.mark.parametrize("m,k,n", [(1, 75, 20), (2, 800, 500), (17, 9, 3), (64, 33, 10)])
def test_int8_matmul_sums_bit_for_bit(m, k, n):
    rs = np.random.RandomState(m + k + n)
    x = (rs.randn(m, k) * 5).astype(np.float32)
    w = (rs.randn(n, k) * 0.2).astype(np.float32)
    w_q, w_scale = jquant.quantize_weight(w)
    q = {"w_q": w_q, "w_scale": w_scale, "x_scale": np.float32(float(np.abs(x).max()) / 127.0)}
    x_q = jquant.quantize_activation(x, q["x_scale"])
    want = jax.lax.dot_general(x_q, w_q, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tq = {"w_q": torch.from_numpy(_j(w_q)), "w_scale": torch.from_numpy(_j(w_scale)),
          "x_scale": q["x_scale"]}
    got = quant.int_matmul(quant.quantize_activation(torch.from_numpy(x), q["x_scale"]),
                           tq["w_q"].t())
    np.testing.assert_array_equal(got.numpy(), _j(want))
    np.testing.assert_allclose(quant.int8_matmul(torch.from_numpy(x), tq).numpy(),
                               _j(jquant.int8_matmul(x, q)),
                               rtol=np.finfo(np.float32).eps, atol=0)


@pytest.mark.parametrize("m,k,n", [(1, 75, 20), (2, 363, 96), (40, 8, 8), (17, 2400, 256)])
def test_int_mm_padding_is_exact(m, k, n):
    """The card's operands: more than 16 rows, K and N multiples of 8,
    zero-padded; the product of the padded operands, cut, is the
    product."""
    rs = np.random.RandomState(m * k)
    a = torch.from_numpy(rs.randint(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (k, n)).astype(np.int8))
    a_p = quant._pad_to(quant._pad_to(a, 1, 8), 0, 1, least=17)
    b_p = quant._pad_to(quant._pad_to(b, 0, 8), 1, 8)
    assert a_p.shape[0] > 16 and a_p.shape[1] % 8 == 0 and b_p.shape[1] % 8 == 0
    assert a_p.shape[1] == b_p.shape[0]
    np.testing.assert_array_equal(quant.int_matmul_torch(a_p, b_p)[:m, :n].numpy(),
                                  quant.int_matmul_torch(a, b).numpy())


def test_block_diagonal_weight_of_groups():
    """Three groups of 2 in and 2 out channels: each group's block on the
    diagonal, zeros elsewhere, K and N zero-padded from 6 to 8."""
    w = torch.arange(6 * 2 * 1 * 1, dtype=torch.int8).reshape(6, 2, 1, 1)
    m = quant._block_diagonal(w, 3)
    assert m.shape == (8, 8)
    for g in range(3):
        blk = slice(2 * g, 2 * g + 2)
        assert torch.equal(m[blk, blk], w[blk].reshape(2, 2).t())
    assert int(m.abs().sum()) == int(w.to(torch.int32).abs().sum())


# ---------------------------------------------------------------------------
# calibrate and the quantized forward
# ---------------------------------------------------------------------------

def _lenet(batch=8):
    jnet = JNetwork(jax_models.lenet(batch), JPhase.TEST)
    jvars = jnet.init(jax.random.key(4))
    net = Network(models.lenet(batch), Phase.TEST, device="cpu")
    v = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    rs = np.random.RandomState(9)
    calib = [{"data": rs.rand(batch, 1, 28, 28).astype(np.float32),
              "label": rs.randint(0, 10, batch).astype(np.int32)} for _ in range(3)]
    return jnet, jvars, net, v, calib


def _same_records(trec, jrec, exact_x: bool = True):
    """``w_q`` and ``w_scale`` bit for bit; ``x_scale`` bit for bit where
    the layer's input is a feed (the same absmax, the same arithmetic),
    else within rtol 1e-6: the absmax of a blob the float forward made,
    whose float32 sums run in another order in each package."""
    np.testing.assert_array_equal(trec["w_q"].numpy(), _j(jrec["w_q"]))
    np.testing.assert_array_equal(trec["w_scale"].numpy().view(np.uint32),
                                  _j(jrec["w_scale"]).view(np.uint32))
    assert type(trec["x_scale"]) is np.float32
    if exact_x:
        assert trec["x_scale"].view(np.uint32) == np.float32(jrec["x_scale"]).view(np.uint32)
    else:
        np.testing.assert_allclose(trec["x_scale"], jrec["x_scale"], rtol=1e-6)


def _records_match(tq, jq, net, exact_inputs):
    """Every record of ``tq`` against ``jq``; ``x_scale`` bit for bit where
    the layer's input is one of ``exact_inputs`` (feeds, or their exact
    slices)."""
    assert set(tq) == set(jq)
    fed = {l.name for l in net.layers if l.name in jq and l.bottoms[0] in exact_inputs}
    assert fed or not exact_inputs
    for name in jq:
        _same_records(tq[name], jq[name], exact_x=name in fed)


def test_calibrate_records_bit_for_bit():
    jnet, jvars, net, v, calib = _lenet()
    jq = jquant.calibrate(jnet, jvars, calib, num_batches=3)
    tq = quant.calibrate(net, v, calib, num_batches=3)
    assert set(tq) == {"conv1", "conv2", "ip1", "ip2"}
    _records_match(tq, jq, net, {"data"})
    with pytest.raises(ValueError, match="at least one feed"):
        quant.calibrate(net, v, [])


def test_quantized_lenet_forward_matches_jax():
    jnet, jvars, net, v, calib = _lenet()
    jq = jquant.calibrate(jnet, jvars, calib)
    tq = quant.calibrate(net, v, calib)
    rs = np.random.RandomState(10)
    feeds = {"data": rs.rand(8, 1, 28, 28).astype(np.float32),
             "label": rs.randint(0, 10, 8).astype(np.int32)}
    with jquant.quantized_inference(jq):
        jblobs, _, _ = jnet.apply(jvars, feeds, rng=None, train=False)
    float_blobs, _, _ = net.apply(v, feeds, train=False)
    for records in (tq, quant.prepare(tq, net)):
        with torch.no_grad(), quant.quantized_inference(records):
            blobs, _, _ = net.apply(v, feeds, train=False)
        np.testing.assert_allclose(blobs["ip2"].numpy(), _j(jblobs["ip2"]), rtol=1e-5,
                                   atol=1e-5)
    agree = (blobs["ip2"].argmax(-1) == float_blobs["ip2"].argmax(-1)).float().mean()
    assert float(agree) >= 0.75
    # outside the block the forward is float again, and the context is
    # per-thread: no record is active here
    assert quant.layer_qparams("conv1") is None
    again, _, _ = net.apply(v, feeds, train=False)
    assert torch.equal(again["ip2"], float_blobs["ip2"])


def test_uncalibrated_layers_stay_float():
    """Records for the InnerProducts only: the convolutions run in float,
    bit for bit the float forward's up to ip1."""
    _, _, net, v, calib = _lenet()
    tq = quant.calibrate(net, v, calib, layer_types=("InnerProduct",))
    assert set(tq) == {"ip1", "ip2"}
    feeds = calib[0]
    float_blobs, _, _ = net.apply(v, feeds, train=False)
    with torch.no_grad(), quant.quantized_inference(tq):
        blobs, _, _ = net.apply(v, feeds, train=False)
    assert torch.equal(blobs["pool2"], float_blobs["pool2"])
    assert not torch.equal(blobs["ip2"], float_blobs["ip2"])
    # TRAIN-mode forwards never consult the records
    with torch.no_grad(), quant.quantized_inference(tq):
        train_blobs, _, _ = net.apply(v, feeds, train=True)
    assert torch.equal(train_blobs["ip2"], float_blobs["ip2"])


def test_shared_weights_calibrate_through_their_owner():
    jnet = JNetwork(jax_models.mnist_siamese(batch=4), JPhase.TEST)
    jvars = jnet.init(jax.random.key(2))
    net = Network(models.mnist_siamese(batch=4), Phase.TEST, device="cpu")
    v = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    assert net.param_aliases
    rs = np.random.RandomState(1)
    calib = [{"pair_data": rs.rand(4, 2, 28, 28).astype(np.float32),
              "sim": np.array([0, 1, 1, 0], np.float32)}]
    jq = jquant.calibrate(jnet, jvars, calib)
    tq = quant.calibrate(net, v, calib)
    sharers = {ln for ln, _ in net.param_aliases}
    assert sharers & set(tq)
    # the Slice of pair_data into data/data_p copies exactly
    _records_match(tq, jq, net, {"data", "data_p"})
    for ln, _ in net.param_aliases:
        if ln in tq:
            owner = net.param_aliases[(ln, 0)][0]
            assert torch.equal(tq[ln]["w_q"], tq[owner]["w_q"])


# ---------------------------------------------------------------------------
# DeployNet / Classifier
# ---------------------------------------------------------------------------

BN_DEPLOY = """
name: "BNDeploy"
input: "data"
input_shape { dim: 4 dim: 3 dim: 10 dim: 10 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 weight_filler { type: "msra" } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "fc" type: "InnerProduct" bottom: "conv1" top: "fc"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


def _bn_deploy():
    from sparknet_tpu.models.deploy import DeployNet as JDeployNet
    from sparknet_tpu.proto import parse as jparse
    from sparknet_tpu_torch.models import DeployNet
    from sparknet_tpu_torch.proto import parse

    jd = JDeployNet(jparse(BN_DEPLOY))
    rs = np.random.RandomState(0)
    state = {"bn1": {"mean": (rs.randn(8) * 2).astype(np.float32),
                     "variance": (rs.rand(8) * 3 + 0.5).astype(np.float32),
                     "scale_factor": np.array([1.0], np.float32)}}
    from sparknet_tpu.compiler.graph import NetVars as JNetVars

    jd.variables = JNetVars(jd.variables.params, {"bn1": {k: jnp.asarray(x) for k, x in
                                                          state["bn1"].items()}})
    d = DeployNet(parse(BN_DEPLOY), device="cpu")
    d.variables = interop.netvars_from_numpy(jd.variables.params, jd.variables.state,
                                             device="cpu")
    return jd, d


def test_quantize_int8_after_fold_and_not_before():
    jd, d = _bn_deploy()
    rs = np.random.RandomState(3)
    calib = [{"data": (rs.randn(4, 3, 10, 10) * 5).astype(np.float32)} for _ in range(2)]
    assert d.fold_batchnorm() == jd.fold_batchnorm()
    jq = jd.quantize_int8(calib, num_batches=2)
    tq = d.quantize_int8(calib, num_batches=2)
    assert set(tq) == {"conv1", "fc"}
    _records_match(tq, jq, d.network, {"data"})
    x = (rs.randn(6, 3, 10, 10) * 5).astype(np.float32)
    np.testing.assert_allclose(d.forward_all("data", x)["prob"],
                               np.asarray(jd.forward_all("data", x)["prob"]),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError) as terr:
        d.fold_batchnorm()
    with pytest.raises(RuntimeError) as jerr:
        jd.fold_batchnorm()
    assert str(terr.value) == str(jerr.value)


def test_classifier_calibrate_int8_matches_jax():
    from sparknet_tpu.models.classifier import Classifier as JClassifier
    from sparknet_tpu.proto import parse as jparse
    from sparknet_tpu_torch.models import Classifier
    from sparknet_tpu_torch.proto import parse

    deploy = BN_DEPLOY.replace("dim: 10 dim: 10", "dim: 8 dim: 8").replace(
        "dim: 4 dim: 3", "dim: 10 dim: 3")
    jc = JClassifier(jparse(deploy), image_dims=(10, 10))
    c = Classifier(parse(deploy), image_dims=(10, 10), device="cpu")
    c.variables = interop.netvars_from_numpy(jc.variables.params, jc.variables.state,
                                             device="cpu")
    rs = np.random.RandomState(4)
    images = [rs.rand(12, 11, 3).astype(np.float32) * 4 for _ in range(3)]
    jq = jc.calibrate_int8(images)
    tq = c.calibrate_int8(images)
    _records_match(tq, jq, c.network, {"data"})
    np.testing.assert_allclose(c.predict(images), np.asarray(jc.predict(images)),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the engine's int8 arm
# ---------------------------------------------------------------------------

CPU = dict(device="cpu", hbm_bytes=16 << 30)


@pytest.fixture
def one_thread():
    """One intra-op thread for the bit-for-bit checks (ROADMAP Queue C item
    7), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family", ["lenet", "cifar10_quick"])
def test_engine_int8_arm_exact_within_a_bucket(family, one_thread):
    from sparknet_tpu_torch.serve import ServeEngine
    from sparknet_tpu_torch.serve.engine import _synthetic_feeds, _family

    e = ServeEngine(buckets=(8,), **CPU)
    m = e.load_model("q", family=family, arm="int8")
    assert m.qstate and m.arm == "int8"
    rows = _synthetic_feeds(_family(family), 8, seed=7)["data"]
    prog = m.programs[8]
    prog.host_input[:] = rows
    full = prog.run()
    prog.host_input[:] = 0
    prog.host_input[:3] = rows[:3]
    padded = prog.run()
    np.testing.assert_array_equal(padded[:3], full[:3])
    e.shutdown()


@pytest.mark.parametrize("family", ["lenet", "cifar10_quick", "transformer"])
def test_engine_int8_arm_matches_jax(family):
    """Fold, then calibrate once on the synthetic stream (2 batches of 8),
    then serve: the quant records bit for bit the JAX engine's and the
    scores within rtol/atol 1e-5."""
    from sparknet_tpu.serve.engine import ServeEngine as JServeEngine
    from sparknet_tpu_torch.serve import ServeEngine
    from sparknet_tpu_torch.serve.engine import _family, _synthetic_feeds

    je = JServeEngine(buckets=(8,))
    jm = je.load_model("q", family=family, arm="int8")
    e = ServeEngine(buckets=(8,), **CPU)
    v = interop.netvars_from_numpy(jm.variables.params, jm.variables.state, device="cpu")
    m = e.load_model("q", family=family, arm="int8", variables=v)
    net = Network(m.family.net(8), Phase.TEST, device="cpu")
    _records_match(m.qstate, jm.qstate, net, {"data"} if family != "transformer" else set())
    rows = _synthetic_feeds(_family(family), 5, seed=3)["data"]
    got = np.stack([e.infer("q", r) for r in rows])
    want = np.stack([np.asarray(je.infer("q", r)) for r in rows])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    e.shutdown()
    je.shutdown()


DEPTHWISE_NET = """
name: "Depthwise"
layer { name: "data" type: "Input" top: "data" input_param { shape { dim: 4 dim: 3 dim: 12 dim: 12 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 12 kernel_size: 3 pad: 1 weight_filler { type: "msra" } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "dw" type: "Convolution" bottom: "conv1" top: "dw"
  convolution_param { num_output: 12 group: 12 kernel_size: 3 pad: 1 bias_term: false
    weight_filler { type: "msra" } } }
layer { name: "relu2" type: "ReLU" bottom: "dw" top: "dw" }
layer { name: "pw" type: "Convolution" bottom: "dw" top: "pw"
  convolution_param { num_output: 10 group: 2 kernel_size: 1 weight_filler { type: "msra" } } }
layer { name: "fc" type: "InnerProduct" bottom: "pw" top: "fc"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
"""


def _record_bytes(qrun: dict) -> int:
    return sum(r["w_q"].numel() + 4 * r["w_scale"].numel() + r["w_mat"].numel()
               for r in qrun.values())


@pytest.mark.parametrize("name", ["lenet", "cifar10_quick", "depthwise"])
def test_resident_bytes_count_the_prepared_records(name):
    """``quant.resident_bytes`` from the weights' shapes equals the bytes
    of the records ``calibrate`` and ``prepare`` make when every layer is
    calibrated: int8 weights, float32 scales, and the product matrices,
    block-diagonal for the grouped and depthwise convolutions."""
    from sparknet_tpu_torch.proto import parse

    param = {"lenet": lambda: models.lenet(4), "cifar10_quick": lambda: models.cifar10_quick(4),
             "depthwise": lambda: parse(DEPTHWISE_NET)}[name]()
    net = Network(param, Phase.TEST, device="cpu")
    v = net.init(torch.Generator().manual_seed(0))
    shape = net.feed_shapes()["data"]
    rs = np.random.RandomState(2)
    feeds = [{"data": rs.rand(*shape).astype(np.float32)} for _ in range(2)]
    if "label" in net.feed_blobs:
        for f in feeds:
            f["label"] = np.zeros(shape[0], np.int32)
    qrun = quant.prepare(quant.calibrate(net, v, feeds, num_batches=2), net)
    assert set(qrun) == {l.name for l in net.layers if l.TYPE in ("Convolution", "InnerProduct")}
    assert quant.resident_bytes(net, v.params) == _record_bytes(qrun)
    if name == "depthwise":
        assert qrun["dw"]["w_mat"].shape == (112, 16)  # 12 groups x 9, padded to 8


def test_engine_prices_the_int8_matrices_on_top_of_the_f32_row():
    """A priced ``int8`` load adds its prepared records' bytes to the f32
    row's price; an ``f32`` load and an unpriced family do not."""
    from sparknet_tpu_torch.serve import ServeEngine

    row = {"c0": 1000, "c1": 1, "params_bytes": 50, "slots_bytes": 20}
    e = ServeEngine(buckets=(1, 8), fit_table={"families": {"lenet": {"f32": row}}}, **CPU)
    f = e.load_model("f", family="lenet")
    q = e.load_model("q", family="lenet", arm="int8")
    net = Network(q.family.net(1), Phase.TEST, device="cpu")
    assert f.predicted_bytes == 1000 + 8 - 20
    assert q.predicted_bytes == f.predicted_bytes + _record_bytes(quant.prepare(q.qstate, net))
    assert e.resident_bytes() == f.predicted_bytes + q.predicted_bytes
    assert e.load_model("c", family="cifar10_quick", arm="int8").predicted_bytes == 0
    e.shutdown()


# ---------------------------------------------------------------------------
# the CLI's --dtype bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["train", "test", "time"])
def test_cli_dtype_bf16_runs_and_restores_the_config(cmd, tmp_path, monkeypatch, capsys):
    from sparknet_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    argv = [cmd, "--device", "cpu", "--solver", "zoo:lenet", "--batch", "2",
            "--iterations", "2", "--dtype", "bf16"]
    if cmd == "test":
        s = tmp_path / "w"
        assert cli.main(["train", "--device", "cpu", "--solver", "zoo:lenet", "--batch", "2",
                         "--iterations", "1", "--output", str(s)]) == 0
        argv += ["--snapshot", f"{s}.solverstate.npz"]
    seen = []
    real = getattr(cli, f"cmd_{cmd}")

    def spy(args):
        seen.append(tcommon.get_config().compute_dtype)
        return real(args)

    # main() binds each subcommand to the module's function when it runs
    monkeypatch.setattr(cli, f"cmd_{cmd}", spy)
    assert cli.main(argv) == 0
    assert seen == [torch.bfloat16]
    assert tcommon.get_config().compute_dtype == torch.float32
    assert capsys.readouterr().out


def test_cli_restores_the_config_on_failure(tmp_path, monkeypatch):
    from sparknet_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        cli.main(["test", "--device", "cpu", "--solver", "zoo:lenet", "--batch", "2",
                  "--dtype", "bf16"])  # no weights: the command exits
    assert tcommon.get_config().compute_dtype == torch.float32
    assert jcommon.get_config().compute_dtype == jnp.float32
