"""The port's Caffe layer library against the JAX package's, layer by layer.

Every layer type the port took over from the JAX package's remaining
library (ten neuron layers, six losses, nine blocks, Deconvolution,
Im2col, SPP, STOCHASTIC pooling and DummyData) runs on the same seeded
inputs and JAX-initialized params in both packages: the outputs, and the
VJP of a seeded cotangent through params and float inputs.  Filter is held
against ``jax.jit`` of the JAX layer, the function of its jitted train step
(the port masks on every path).  STOCHASTIC pooling in TRAIN takes JAX's
own uniform draws (the same key and shape), injected.

Tolerances, of each array's largest |value|: elementwise layers 1e-6;
reductions, losses, Deconvolution, SPP and pooling 1e-5.
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
from sparknet_tpu_torch.ops import create_layer, vision  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

ELEM = 1e-6
RED = 1e-5


def layers(text: str, phase: str = "TRAIN"):
    """(JAX layer, port layer) of one ``layer { ... }`` text."""
    body = f"layer {{ name: \"l\" {text} }}"
    return (jax_create_layer(jax_parse(body).get_all("layer")[0], JPhase[phase]),
            create_layer(parse(body).get_all("layer")[0], Phase[phase]))


def within(got, ref, tol: float, what: str) -> None:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * float(np.abs(ref).max(initial=0.0)) + 1e-30, (what, err)


def check_layer(text: str, inputs: list, diff: list, tol: float, *, train: bool = True,
                jit: bool = False, seed: int = 3) -> list:
    """The layer's outputs and VJP in both packages; ``diff`` flags the
    float inputs to differentiate.  Returns the port's outputs."""
    jl, pl = layers(text)
    params = [np.asarray(p) for p in jl.init(jax.random.PRNGKey(7),
                                             [np.shape(x) for x in inputs])[0]]
    dix = [i for i, d in enumerate(diff) if d]

    def jf(p, dxs, rest):
        full = list(rest)
        for i, x in zip(dix, dxs):
            full[i] = x
        return jl.apply(p, {}, full, train=train, rng=None).outputs

    jfun = jax.jit(jf) if jit else jf
    rest = [jnp.asarray(x) for x in inputs]
    outs, vjp = jax.vjp(lambda p, d: jfun(p, d, rest), [jnp.asarray(p) for p in params],
                        [jnp.asarray(inputs[i]) for i in dix])
    rs = np.random.RandomState(seed)
    cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    tx = [torch.tensor(np.asarray(x)) for x in inputs]
    for i in dix:
        tx[i].requires_grad_(True)
    got = pl.apply(tp, {}, tx, train=train).outputs
    assert len(got) == len(outs), text
    for k, (o, jo) in enumerate(zip(got, outs)):
        within(o.detach().numpy(), jo, tol, f"{text}: output {k}")
    if not outs:
        return got
    jgp, jgx = vjp([jnp.asarray(c) for c in cots])
    wrt = tp + [tx[i] for i in dix]
    live = [(o, torch.tensor(c)) for o, c in zip(got, cots) if o.requires_grad]
    grads = (torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                 allow_unused=True) if live else [None] * len(wrt))
    for k, (g, jg) in enumerate(zip(grads, list(jgp) + list(jgx))):
        g = np.zeros(np.shape(jg), np.float32) if g is None else g.numpy()
        within(g, jg, tol, f"{text}: grad {k}")
    return got


def _x(shape, seed=0, scale=1.0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return np.abs(x) + 0.1 if positive else x


NEURON_CASES = [
    ('type: "PReLU" prelu_param { filler { type: "uniform" min: -0.5 max: 0.5 } }', {}),
    ('type: "PReLU" prelu_param { channel_shared: true filler { type: "uniform" min: 0.1 '
     'max: 0.9 } }', {}),
    ('type: "PReLU"', {}),
    ('type: "Sigmoid"', dict(scale=4.0)),
    ('type: "TanH"', dict(scale=3.0)),
    ('type: "AbsVal"', {}),
    ('type: "BNLL"', dict(scale=20.0)),
    ('type: "Exp"', {}),
    ('type: "Exp" exp_param { base: 2.0 scale: 0.5 shift: 0.1 }', {}),
    ('type: "Log"', dict(positive=True)),
    ('type: "Log" log_param { base: 10.0 scale: 2.0 shift: 1.0 }', dict(positive=True)),
    ('type: "Power" power_param { power: 2.0 scale: 0.5 shift: 1.0 }', {}),
    ('type: "Power" power_param { power: 0.5 }', dict(positive=True)),
    ('type: "Power" power_param { scale: 3.0 shift: -1.0 }', {}),
    ('type: "Threshold" threshold_param { threshold: 0.2 }', {}),
    ('type: "ELU" elu_param { alpha: 0.7 }', dict(scale=2.0)),
    ('type: "ELU"', {}),
]


@pytest.mark.parametrize("text,kw", NEURON_CASES, ids=[c[0].split('"')[1] + f"-{i}"
                                                      for i, c in enumerate(NEURON_CASES)])
def test_neuron_layer(text, kw):
    check_layer(f'{text} bottom: "x" top: "y"', [_x((2, 3, 4, 5), **kw)], [True], ELEM)


def _probs(n, k, seed):
    z = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    e = np.exp(z - z.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _labels(n, k, seed):
    return np.random.RandomState(seed).randint(0, k, n).astype(np.float32)


LOSS_CASES = {
    "euclidean": ('type: "EuclideanLoss"', lambda: [_x((4, 3, 2, 2)), _x((4, 3, 2, 2), 1)],
                  [True, True]),
    "hinge_l1": ('type: "HingeLoss"', lambda: [_x((6, 5)), _labels(6, 5, 1)], [True, False]),
    "hinge_l2": ('type: "HingeLoss" hinge_loss_param { norm: L2 }',
                 lambda: [_x((6, 5)), _labels(6, 5, 1)], [True, False]),
    "multinomial": ('type: "MultinomialLogisticLoss"',
                    lambda: [_probs(6, 5, 0), _labels(6, 5, 1)], [True, False]),
    "infogain_bottom": ('type: "InfogainLoss"',
                        lambda: [_probs(6, 5, 0), _labels(6, 5, 1),
                                 np.abs(_x((5, 5), 2))], [True, False, True]),
    "infogain_identity": ('type: "InfogainLoss"', lambda: [_probs(6, 5, 0), _labels(6, 5, 1)],
                          [True, False]),
    "sigmoid_xent": ('type: "SigmoidCrossEntropyLoss"',
                     lambda: [_x((4, 7), scale=3.0),
                              np.random.RandomState(5).rand(4, 7).astype(np.float32)],
                     [True, False]),
    "contrastive": ('type: "ContrastiveLoss" contrastive_loss_param { margin: 2.0 }',
                    lambda: [_x((8, 3)), _x((8, 3), 1), _labels(8, 2, 2)], [True, True, False]),
    "contrastive_legacy": ('type: "ContrastiveLoss" contrastive_loss_param { margin: 2.0 '
                           'legacy_version: true }',
                           lambda: [_x((8, 3)), _x((8, 3), 1), _labels(8, 2, 2)],
                           [True, True, False]),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_layer(case):
    text, make, diff = LOSS_CASES[case]
    ins = make()
    bottoms = " ".join(f'bottom: "b{i}"' for i in range(len(ins)))
    check_layer(f'{text} {bottoms} top: "loss"', ins, diff, RED)


@pytest.mark.parametrize("legacy", ["false", "true"])
def test_contrastive_loss_at_distance_zero(legacy):
    """A dissimilar pair with equal embeddings: finite loss and gradient
    (the safe square root), as in JAX."""
    a = _x((4, 3))
    b = a.copy()
    b[1] += 0.5
    sim = np.array([0, 0, 1, 0], np.float32)
    text = (f'type: "ContrastiveLoss" contrastive_loss_param {{ legacy_version: {legacy} }} '
            'bottom: "a" bottom: "b" bottom: "s" top: "loss"')
    loss = check_layer(text, [a, b, sim], [True, True, False], RED)[0]
    assert torch.isfinite(loss)


def test_infogain_matrix_from_its_source_file(tmp_path):
    """H from ``infogain_loss_param.source`` (a .binaryproto) equals H as the
    third bottom of the JAX layer."""
    from sparknet_tpu_torch.data.io_utils import array_to_blobproto

    h = np.abs(_x((1, 1, 5, 5), 2))
    path = tmp_path / "h.binaryproto"
    path.write_bytes(array_to_blobproto(h))
    p, lab = _probs(6, 5, 0), _labels(6, 5, 1)
    jl, _ = layers('type: "InfogainLoss" bottom: "p" bottom: "l" bottom: "h" top: "loss"')
    jloss, jgrad = jax.value_and_grad(
        lambda q: jl.apply([], {}, [q, jnp.asarray(lab), jnp.asarray(h.reshape(5, 5))],
                           train=True).outputs[0])(jnp.asarray(p))
    _, pl = layers(f'type: "InfogainLoss" bottom: "p" bottom: "l" top: "loss" '
                   f'infogain_loss_param {{ source: "{path}" }}')
    tp = torch.tensor(p, requires_grad=True)
    loss = pl.apply([], {}, [tp, torch.tensor(lab)], train=True).outputs[0]
    (g,) = torch.autograd.grad(loss, tp)
    within(loss.detach().numpy(), jloss, RED, "loss")
    within(g.numpy(), jgrad, RED, "grad")


BLOCK_CASES = {
    "slice_points": ('type: "Slice" slice_param { axis: 1 slice_point: 1 slice_point: 3 }',
                     ["a", "b", "c"], (2, 5, 3, 2), ELEM),
    "slice_equal": ('type: "Slice"', ["a", "b", "c"], (2, 6, 3, 2), ELEM),
    "slice_dim0": ('type: "Slice" slice_param { slice_dim: 0 slice_point: 1 }', ["a", "b"],
                   (3, 4), ELEM),
    "reshape_0_-1": ('type: "Reshape" reshape_param { shape { dim: 0 dim: -1 dim: 2 } }',
                     ["y"], (2, 3, 4, 2), ELEM),
    "reshape_axis": ('type: "Reshape" reshape_param { shape { dim: 2 dim: -1 } axis: 1 '
                     'num_axes: 2 }', ["y"], (2, 4, 3, 5), ELEM),
    "reshape_flat": ('type: "Reshape" reshape_param { shape { dim: -1 } }', ["y"],
                     (2, 3, 4), ELEM),
    "tile": ('type: "Tile" tile_param { tiles: 3 }', ["y"], (2, 3, 2), ELEM),
    "tile_axis2": ('type: "Tile" tile_param { axis: -1 tiles: 2 }', ["y"], (2, 3, 2), ELEM),
    "argmax": ('type: "ArgMax" argmax_param { top_k: 3 }', ["y"], (4, 2, 3, 3), ELEM),
    "argmax_val": ('type: "ArgMax" argmax_param { top_k: 2 out_max_val: true }', ["y"],
                   (4, 7), ELEM),
    "mvn": ('type: "MVN"', ["y"], (2, 3, 4, 5), RED),
    "mvn_across": ('type: "MVN" mvn_param { across_channels: true eps: 1e-3 }', ["y"],
                   (2, 3, 4, 5), RED),
    "mvn_mean_only": ('type: "MVN" mvn_param { normalize_variance: false }', ["y"],
                      (2, 3, 4, 5), RED),
}
for _op in ("SUM", "ASUM", "SUMSQ", "MEAN"):
    BLOCK_CASES[f"reduction_{_op}"] = (
        f'type: "Reduction" reduction_param {{ operation: {_op} axis: 1 coeff: -0.5 }}',
        ["y"], (3, 4, 2), RED)
    BLOCK_CASES[f"reduction_{_op}_all"] = (
        f'type: "Reduction" reduction_param {{ operation: {_op} }}', ["y"], (3, 4), RED)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_layer(case):
    text, tops, shape, tol = BLOCK_CASES[case]
    tops = " ".join(f'top: "{t}"' for t in tops)
    check_layer(f'{text} bottom: "x" {tops}', [_x(shape, scale=2.0)], [True], tol)


def test_argmax_ties_go_to_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0], [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    y = check_layer('type: "ArgMax" argmax_param { top_k: 4 out_max_val: true } '
                    'bottom: "x" top: "y"', [x], [True], ELEM)[0]
    assert y[0, 0].tolist() == [1.0, 2.0, 4.0, 5.0]
    assert y[1, 0].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_batch_reindex_sums_repeated_indices():
    x = _x((4, 3, 2))
    idx = np.array([2, 0, 2, 2, 3, 0], np.float32)
    check_layer('type: "BatchReindex" bottom: "x" bottom: "i" top: "y"', [x, idx],
                [True, False], RED)


@pytest.mark.parametrize("n_data", [1, 2])
def test_filter_masks_as_the_jitted_jax_layer(n_data):
    ins = [_x((5, 3, 2), k) for k in range(n_data)] + [np.array([1, 0, 2, 0, 1], np.float32)]
    bottoms = " ".join(f'bottom: "b{i}"' for i in range(len(ins)))
    tops = " ".join(f'top: "t{i}"' for i in range(n_data))
    got = check_layer(f'type: "Filter" {bottoms} {tops}', ins, [True] * n_data + [False], ELEM,
                      jit=True)
    assert tuple(got[0].shape) == (5, 3, 2) and float(got[0][1].detach().abs().sum()) == 0.0


def test_silence_produces_nothing():
    assert check_layer('type: "Silence" bottom: "x"', [_x((2, 3))], [True], ELEM) == []


VISION_CASES = {
    "deconv": ('type: "Deconvolution" convolution_param { num_output: 4 kernel_size: 4 '
               'stride: 2 pad: 1 weight_filler { type: "gaussian" std: 0.5 } '
               'bias_filler { type: "uniform" min: -1 max: 1 } }', (2, 3, 5, 5)),
    "deconv_group": ('type: "Deconvolution" convolution_param { num_output: 6 kernel_size: 3 '
                     'stride: 2 group: 3 weight_filler { type: "gaussian" std: 0.5 } }',
                     (2, 3, 4, 5)),
    "deconv_dilation": ('type: "Deconvolution" convolution_param { num_output: 2 kernel_size: 3 '
                        'stride: 3 pad: 2 dilation: 2 bias_term: false '
                        'weight_filler { type: "gaussian" std: 0.5 } }', (1, 4, 6, 4)),
    "deconv_rect": ('type: "Deconvolution" convolution_param { num_output: 4 kernel_h: 2 '
                    'kernel_w: 3 stride_h: 2 stride_w: 1 group: 2 '
                    'weight_filler { type: "xavier" } }', (2, 4, 3, 3)),
    "im2col": ('type: "Im2col" convolution_param { kernel_size: 3 stride: 2 pad: 1 }',
               (2, 3, 7, 6)),
    "im2col_rect": ('type: "Im2col" convolution_param { kernel_h: 2 kernel_w: 3 }',
                    (1, 2, 4, 5)),
    "spp_max": ('type: "SPP" spp_param { pyramid_height: 3 }', (2, 3, 9, 7)),
    "spp_ave": ('type: "SPP" spp_param { pyramid_height: 2 pool: AVE }', (2, 3, 5, 8)),
}


@pytest.mark.parametrize("case", sorted(VISION_CASES))
def test_vision_layer(case):
    text, shape = VISION_CASES[case]
    check_layer(f'{text} bottom: "x" top: "y"', [_x(shape)], [True], RED)


STOCHASTIC = [((2, 3, 6, 6), 2, 2), ((2, 2, 7, 5), 3, 2), ((1, 4, 5, 5), 3, 1)]


@pytest.mark.parametrize("shape,kernel,stride", STOCHASTIC)
def test_stochastic_pooling_test_phase(shape, kernel, stride):
    x = np.maximum(_x(shape), 0.0)  # post-ReLU, with zero windows among them
    x[0, 0, :3, :3] = 0.0
    check_layer(f'type: "Pooling" pooling_param {{ pool: STOCHASTIC kernel_size: {kernel} '
                f'stride: {stride} }} bottom: "x" top: "y"', [x], [True], RED, train=False)


@pytest.mark.parametrize("shape,kernel,stride", STOCHASTIC)
def test_stochastic_pooling_train_with_injected_draws(shape, kernel, stride):
    """TRAIN with JAX's own uniforms: the same samples, and the gradient at
    the sampled element only."""
    x = np.maximum(_x(shape), 0.0)
    jl, _ = layers(f'type: "Pooling" pooling_param {{ pool: STOCHASTIC '
                   f'kernel_size: {kernel} stride: {stride} }} bottom: "x" top: "y"')
    key = jax.random.PRNGKey(11)
    jy, vjp = jax.vjp(lambda a: jl.apply([], {}, [a], train=True, rng=key).outputs[0],
                      jnp.asarray(x))
    u = np.asarray(jax.random.uniform(key, jy.shape, jnp.float32))
    g = np.random.RandomState(4).randn(*jy.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    y = vision.caffe_stochastic_pool(tx, (kernel, kernel), (stride, stride), train=True,
                                     uniforms=torch.tensor(u))
    (tg,) = torch.autograd.grad(y, tx, torch.tensor(g))
    within(y.detach().numpy(), jy, RED, "stochastic output")
    within(tg.numpy(), jg, RED, "stochastic grad")
    assert int((tg != 0).sum()) <= int(np.prod(jy.shape))


def test_stochastic_pooling_through_the_net_draws_from_gen():
    """In a net, the layer draws from ``gen``: a sample of each window, the
    same for the same seed, and it raises in TRAIN without a generator or
    with a pad."""
    _, pl = layers('type: "Pooling" pooling_param { pool: STOCHASTIC kernel_size: 2 '
                   'stride: 2 } bottom: "x" top: "y"')
    x = torch.tensor(np.maximum(_x((2, 3, 6, 6)), 0.0) + 0.01)
    a = pl.apply([], {}, [x], train=True, gen=torch.Generator().manual_seed(1)).outputs[0]
    b = pl.apply([], {}, [x], train=True, gen=torch.Generator().manual_seed(1)).outputs[0]
    assert torch.equal(a, b)
    windows = torch.nn.functional.unfold(x, 2, stride=2).reshape(2, 3, 4, 3, 3)
    assert bool((windows == a.unsqueeze(2)).any(dim=2).all())
    with pytest.raises(ValueError, match="generator"):
        pl.apply([], {}, [x], train=True)
    _, padded = layers('type: "Pooling" pooling_param { pool: STOCHASTIC kernel_size: 2 '
                       'pad: 1 } bottom: "x" top: "y"')
    with pytest.raises(ValueError, match="pad"):
        padded.apply([], {}, [x], train=False)


DUMMY_CASES = [
    'dummy_data_param { shape { dim: 2 dim: 3 } shape { dim: 4 } '
    'data_filler { type: "constant" value: 1.5 } data_filler { type: "constant" value: -2 } }',
    'dummy_data_param { num: 2 num: 3 channels: 4 height: 2 width: 1 '
    'data_filler { type: "constant" value: 0.25 } }',
    'dummy_data_param { shape { dim: 3 dim: 2 } }',
]


@pytest.mark.parametrize("params", DUMMY_CASES)
def test_dummy_data_constant_values(params):
    jl, pl = layers(f'type: "DummyData" top: "a" top: "b" {params}')
    assert pl.SELF_FEEDING and jl.SELF_FEEDING
    assert pl.blob_shapes() == [tuple(s) for s in jl.blob_shapes()]
    for got, ref in zip(pl.constant_values("cpu"), jl.constant_values(), strict=True):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("filler,mean,std", [
    ('type: "gaussian" mean: 1.0 std: 2.0', 1.0, 2.0),
    ('type: "uniform" min: -1 max: 3', 1.0, 4.0 / np.sqrt(12.0)),
])
def test_dummy_data_random_fillers_by_shape_dtype_and_moments(filler, mean, std):
    """Random fillers draw from a torch generator (not jax.random.key(0)):
    held to JAX's shape and dtype and to the filler's moments."""
    jl, pl = layers(f'type: "DummyData" top: "a" dummy_data_param {{ shape {{ dim: 200 '
                    f'dim: 500 }} data_filler {{ {filler} }} }}')
    (got,), (ref,) = pl.constant_values("cpu"), jl.constant_values()
    assert tuple(got.shape) == ref.shape and str(got.dtype).endswith(str(ref.dtype))
    assert abs(float(got.mean()) - mean) < 0.02 * std
    assert abs(float(got.std()) - std) < 0.01 * std
    assert got is pl.constant_values("cpu")[0]  # made once


def test_dummy_data_feeds_a_net_in_both_packages():
    """A net whose data comes from DummyData needs no feeds; the port's
    forward and loss equal the JAX net's from the same weights."""
    from sparknet_tpu.compiler.graph import Network as JNetwork

    from sparknet_tpu_torch import interop
    from sparknet_tpu_torch.compiler.graph import Network

    text = '''name: "d"
      layer { name: "src" type: "DummyData" top: "x" top: "t"
        dummy_data_param { shape { dim: 4 dim: 6 } shape { dim: 4 dim: 3 }
          data_filler { type: "constant" value: 0.5 } data_filler { type: "constant" value: 1 } } }
      layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y"
        inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.3 } } }
      layer { name: "loss" type: "EuclideanLoss" bottom: "y" bottom: "t" top: "loss" }'''
    jnet = JNetwork(jax_parse(text), JPhase.TRAIN)
    jv = jnet.init(jax.random.PRNGKey(0))
    jblobs, _, jloss = jnet.apply(jv, {}, rng=None)
    net = Network(parse(text), Phase.TRAIN, device="cpu")
    assert net.feed_blobs == [] and net.feed_shapes() == {}
    net.init()
    v = interop.netvars_from_numpy({k: [np.asarray(p) for p in pl]
                                    for k, pl in jv.params.items()}, device="cpu")
    blobs, _, loss = net.apply(v, {})
    within(blobs["y"].numpy(), jblobs["y"], RED, "y")
    within(loss.numpy(), jloss, RED, "loss")
