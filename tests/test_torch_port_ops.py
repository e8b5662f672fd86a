"""Every layer the port carries, against the JAX package's layer.

The same prototxt goes through the JAX layer's ``apply`` and the port's, on
the same numpy inputs and weights.  Tolerance: atol and rtol 2e-4, the
cross-framework precedent of ``tests/test_torch_parity.py`` (float32
accumulation order differs between XLA and ATen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.ops import create_layer as jax_create_layer  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402

from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.ops import create_layer  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

ATOL = RTOL = 2e-4


def run_both(text, params, inputs):
    """(jax outputs, port outputs) of the first layer of ``text`` at TEST."""
    jl = jax_create_layer(jax_parse(text).get_all("layer")[0], JPhase.TEST)
    jout = jl.apply([jnp.asarray(p) for p in params], {},
                    [jnp.asarray(x) for x in inputs], train=False,
                    rng=jax.random.key(0)).outputs
    tl = create_layer(parse(text).get_all("layer")[0], Phase.TEST)
    tout = tl.apply([torch.from_numpy(p) for p in params], {},
                    [torch.from_numpy(x) for x in inputs], train=False).outputs
    return [np.asarray(o) for o in jout], [o.numpy() for o in tout]


def assert_same(text, params, inputs, atol=ATOL, rtol=RTOL):
    jout, tout = run_both(text, params, inputs)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "stride,pad,group,dilation",
    [(1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 1, 2), (1, 1, 2, 1), (3, 2, 4, 2)],
)
def test_convolution(rng, stride, pad, group, dilation):
    n, cin, cout, k = 2, 8, 12, 3
    x = rng.randn(n, cin, 13, 10).astype(np.float32) * 50
    w = rng.randn(cout, cin // group, k, k).astype(np.float32) * 0.01
    b = rng.randn(cout).astype(np.float32)
    assert_same(
        f"""layer {{ name: "c" type: "Convolution" bottom: "x" top: "y"
          convolution_param {{ num_output: {cout} kernel_size: {k}
            stride: {stride} pad: {pad} group: {group} dilation: {dilation} }} }}""",
        [w, b], [x])


def test_convolution_rectangular_no_bias(rng):
    x = rng.randn(2, 3, 11, 9).astype(np.float32)
    w = rng.randn(4, 3, 3, 5).astype(np.float32)
    assert_same(
        """layer { name: "c" type: "Convolution" bottom: "x" top: "y"
          convolution_param { num_output: 4 kernel_h: 3 kernel_w: 5
            stride_h: 2 stride_w: 1 pad_h: 1 pad_w: 2 bias_term: false } }""",
        [w], [x])


POOL_CASES = [
    # (pool, kernel, stride, pad, H, W): ceil-mode edges, pad, the
    # "last window starts in the padding" shrink, AVE's padded divisor
    ("MAX", 3, 2, 0, 9, 11),
    ("MAX", 3, 2, 1, 9, 11),
    ("MAX", 3, 2, 0, 55, 55),
    ("MAX", 2, 2, 1, 6, 7),
    ("AVE", 3, 2, 0, 8, 8),
    ("AVE", 3, 2, 1, 9, 11),
    ("AVE", 2, 2, 1, 6, 7),
    ("AVE", 3, 1, 1, 5, 5),
]


@pytest.mark.parametrize("pool,kernel,stride,pad,h,w", POOL_CASES)
def test_pooling(rng, pool, kernel, stride, pad, h, w):
    x = rng.randn(2, 3, h, w).astype(np.float32) * 10
    assert_same(
        f"""layer {{ name: "p" type: "Pooling" bottom: "x" top: "y"
          pooling_param {{ pool: {pool} kernel_size: {kernel} stride: {stride}
            pad: {pad} }} }}""",
        [], [x])


@pytest.mark.parametrize("pool", ["MAX", "AVE"])
def test_global_pooling(rng, pool):
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    assert_same(
        f"""layer {{ name: "p" type: "Pooling" bottom: "x" top: "y"
          pooling_param {{ pool: {pool} global_pooling: true }} }}""",
        [], [x])


def test_ave_pool_divisor_cached_across_inference_and_autograd(rng):
    """The AVE divisor is cached per geometry; a first forward under
    inference mode (serving) must leave a divisor that a later autograd
    forward (training) can save for its backward, with the same bits."""
    from sparknet_tpu_torch.ops import vision

    x = torch.from_numpy(rng.randn(2, 3, 13, 10).astype(np.float32))
    args = ((3, 2), (2, 2), (1, 1))
    key = (13, 10, 3, 2, 2, 2, 1, 1, x.device, x.dtype)
    vision._AVE_DIVISORS.pop(key, None)
    fresh = x.clone().requires_grad_()
    vision.caffe_avg_pool(fresh, *args).sum().backward()
    vision._AVE_DIVISORS.pop(key, None)
    with torch.inference_mode():
        served = vision.caffe_avg_pool(x, *args)
    assert key in vision._AVE_DIVISORS
    xg = x.clone().requires_grad_()
    trained = vision.caffe_avg_pool(xg, *args)
    trained.sum().backward()
    assert torch.equal(trained.detach(), served)
    assert torch.equal(xg.grad, fresh.grad)


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_relu(rng, slope):
    x = rng.randn(3, 4, 5, 5).astype(np.float32)
    assert_same(
        f"""layer {{ name: "r" type: "ReLU" bottom: "x" top: "x"
          relu_param {{ negative_slope: {slope} }} }}""",
        [], [x])


def test_dropout_is_identity_at_test(rng):
    x = rng.randn(4, 10).astype(np.float32)
    text = """layer { name: "d" type: "Dropout" bottom: "x" top: "x"
      dropout_param { dropout_ratio: 0.5 } }"""
    jout, tout = run_both(text, [], [x])
    np.testing.assert_array_equal(tout[0], x)
    np.testing.assert_array_equal(tout[0], jout[0])


def test_dropout_train_is_not_ported():
    """TRAIN-phase Dropout is ported now (the name predates it): without a
    generator it still refuses to run, and with one it draws a mask
    (``tests/test_torch_port_solver.py`` holds its statistics)."""
    layer = create_layer(parse(
        """layer { name: "d" type: "Dropout" bottom: "x" top: "x" }"""
    ).get_all("layer")[0], Phase.TRAIN)
    with pytest.raises(ValueError, match="needs a generator"):
        layer.apply([], {}, [torch.zeros(2, 3)], train=True)
    y = layer.apply([], {}, [torch.ones(2, 3)], train=True,
                    gen=torch.Generator().manual_seed(0)).outputs[0]
    assert set(y.unique().tolist()) <= {0.0, 2.0}


@pytest.mark.parametrize("shape,axis", [((4, 3, 4, 4), 1), ((2, 5, 6), 2),
                                        ((2, 3, 4, 5), 2), ((3, 7), -1)])
def test_inner_product_axis(rng, shape, axis):
    canon = axis + len(shape) if axis < 0 else axis
    dim = int(np.prod(shape[canon:]))
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(10, dim).astype(np.float32)
    b = rng.randn(10).astype(np.float32)
    assert_same(
        f"""layer {{ name: "ip" type: "InnerProduct" bottom: "x" top: "y"
          inner_product_param {{ num_output: 10 axis: {axis} }} }}""",
        [w, b], [x])


@pytest.mark.parametrize("shape,axis", [((8, 10), 1), ((2, 5, 3, 3), 1), ((2, 3, 6), -1)])
def test_softmax(rng, shape, axis):
    x = rng.randn(*shape).astype(np.float32) * 5
    assert_same(
        f"""layer {{ name: "s" type: "Softmax" bottom: "x" top: "y"
          softmax_param {{ axis: {axis} }} }}""",
        [], [x])


@pytest.mark.parametrize("extra", [
    "",
    "loss_param { normalize: false }",
    "loss_param { ignore_label: 3 }",
    "loss_weight: 0.5",
])
def test_softmax_with_loss(rng, extra):
    logits = rng.randn(8, 10).astype(np.float32) * 3
    labels = rng.randint(0, 10, 8).astype(np.int32)
    labels[:2] = 3
    assert_same(
        f"""layer {{ name: "loss" type: "SoftmaxWithLoss"
          bottom: "ip" bottom: "label" top: "loss" top: "prob" {extra} }}""",
        [], [logits, labels], atol=1e-5, rtol=1e-5)


def test_softmax_with_loss_spatial(rng):
    logits = rng.randn(2, 4, 3, 3).astype(np.float32)
    labels = rng.randint(0, 4, (2, 3, 3)).astype(np.float32)
    assert_same(
        """layer { name: "loss" type: "SoftmaxWithLoss"
          bottom: "x" bottom: "label" top: "loss" }""",
        [], [logits, labels], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("param", ["", "accuracy_param { top_k: 3 }",
                                   "accuracy_param { ignore_label: 1 }"])
def test_accuracy(rng, param):
    scores = rng.randn(16, 6).astype(np.float32)
    labels = rng.randint(0, 6, 16).astype(np.int32)
    assert_same(
        f"""layer {{ name: "acc" type: "Accuracy" bottom: "x" bottom: "label"
          top: "acc" {param} }}""",
        [], [scores, labels])


def test_concat_split_flatten(rng):
    a = rng.randn(2, 3, 4, 4).astype(np.float32)
    b = rng.randn(2, 5, 4, 4).astype(np.float32)
    assert_same("""layer { name: "c" type: "Concat" bottom: "a" bottom: "b"
      top: "c" }""", [], [a, b])
    assert_same("""layer { name: "c" type: "Concat" bottom: "a" bottom: "a"
      top: "c" concat_param { axis: 3 } }""", [], [a, a])
    assert_same("""layer { name: "s" type: "Split" bottom: "a" top: "s1"
      top: "s2" }""", [], [a])
    assert_same("""layer { name: "f" type: "Flatten" bottom: "a" top: "f" }""",
                [], [a])
    assert_same("""layer { name: "f" type: "Flatten" bottom: "a" top: "f"
      flatten_param { axis: 2 } }""", [], [a])


@pytest.mark.parametrize("text,in_shape", [
    ("""layer { name: "c" type: "Convolution" bottom: "x" top: "y"
       convolution_param { num_output: 6 kernel_size: 3 group: 2
         weight_filler { type: "xavier" } bias_filler { type: "constant" value: 0.1 } } }""",
     (2, 4, 8, 8)),
    ("""layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y"
       inner_product_param { num_output: 7 weight_filler { type: "gaussian" std: 0.01 } } }""",
     (2, 3, 4, 4)),
])
def test_init_shapes_match_jax(text, in_shape):
    """Params have the JAX package's blob shapes, so weights cross one to one."""
    jl = jax_create_layer(jax_parse(text).get_all("layer")[0], JPhase.TEST)
    jp, _ = jl.init(jax.random.key(0), [in_shape])
    tl = create_layer(parse(text).get_all("layer")[0], Phase.TEST)
    tp, _ = tl.init(torch.Generator().manual_seed(0), [in_shape])
    assert [tuple(p.shape) for p in tp] == [tuple(np.shape(p)) for p in jp]
    assert all(p.dtype == torch.float32 for p in tp)


@pytest.mark.parametrize("ftype,check", [
    ("constant value: 0.5", lambda t: bool((t == 0.5).all())),
    ("uniform min: -2 max: 3", lambda t: -2 <= float(t.min()) and float(t.max()) <= 3),
    ("gaussian std: 0.01", lambda t: abs(float(t.std()) - 0.01) < 0.002),
    ("xavier", lambda t: float(t.abs().max()) <= np.sqrt(3.0 / 48) + 1e-6),
    ("msra", lambda t: abs(float(t.std()) - np.sqrt(2.0 / 48)) < 0.03),
    ("positive_unitball", lambda t: np.allclose(t.reshape(32, -1).sum(1).numpy(), 1.0)),
])
def test_fillers(ftype, check):
    from sparknet_tpu_torch.ops import fillers

    f = parse(f"type: {ftype.split()[0]} " + " ".join(ftype.split()[1:]))
    t = fillers.fill(f, torch.Generator().manual_seed(0), (32, 3, 4, 4))
    assert tuple(t.shape) == (32, 3, 4, 4) and check(t)


@pytest.mark.parametrize("type_,queue", [("HDF5_DATA", "A9"), ("HDF5_OUTPUT", "A9"),
                                         ("HDF5Data", "A9"), ("HDF5Output", "A9")])
def test_unported_type_names_its_queue(type_, queue):
    lp = parse(f'layer {{ name: "l" type: "{type_}" bottom: "x" top: "y" }}').get_all("layer")[0]
    with pytest.raises(NotImplementedError, match=f"Queue {queue}"):
        create_layer(lp, Phase.TEST)
