"""Channels-last (``Config.layout = "nhwc"``) in the port against the JAX
package's nhwc, on the CPU at small sizes.

The contract under test is the JAX package's (``sparknet_tpu/ops/layout.py``):
rank-4 activations run (N, H, W, C) under nhwc, params do not move (conv
OIHW, InnerProduct in wire order) and prototxt axes stay canonical.  So the
same numpy inputs, laid out (N, H, W, C), go through each JAX layer and its
port counterpart under nhwc; the layout helpers are compared one by one in
both layouts; the plain NHWC LRN is held against the JAX package's
``lrn_across_channels_xla(channel_axis=3)`` and its VJP (and is bit for bit
the plain NCHW version permuted, the same arithmetic).  Whole steps, the
device augment and the int8 path are in ``test_torch_port_layout_steps.py``.

Tolerances: layers as ``test_torch_port_layers.py`` holds them (of each
array's largest |value|: 1e-6 elementwise, 1e-5 for reductions, pools,
convolutions and losses); the plain LRN as ``test_torch_port_lrn.py``
(rtol 1e-5 / atol 1e-6 forward; the backward 1e-4 relative against the
autodiff of the reduce_window form, with an absolute 1e-6 of max |dx|).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.ops import create_layer as jax_create_layer  # noqa: E402
from sparknet_tpu.ops import layout as jlayout  # noqa: E402
from sparknet_tpu.ops.pallas_kernels import lrn_across_channels_xla  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402

from sparknet_tpu_torch.common import Phase, get_config, set_config  # noqa: E402
from sparknet_tpu_torch.ops import create_layer, kernels, layout  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402


ELEM, RED = 1e-6, 1e-5


@pytest.fixture
def both():
    """``both(layout)`` sets ``Config.layout`` in both packages for one
    test; both are put back after."""
    saved = (jget_config().layout, get_config().layout)

    def set_both(lay: str) -> None:
        jset_config(layout=lay)
        set_config(layout=lay)

    yield set_both
    jset_config(layout=saved[0])
    set_config(layout=saved[1])


def nhwc(a):
    a = np.asarray(a)
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) if a.ndim == 4 else a


def within(got, ref, tol: float, what: str) -> None:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * float(np.abs(ref).max(initial=0.0)) + 1e-30, (what, err)


# -- the 14 helpers ---------------------------------------------------------


@pytest.mark.parametrize("lay", ["nchw", "nhwc"])
def test_helpers_match_jax(lay, both):
    both(lay)
    assert layout.LAYOUTS == jlayout.LAYOUTS
    assert layout.active_layout() == jlayout.active_layout() == lay
    assert layout.is_nhwc() == jlayout.is_nhwc()
    for other in ("NCHW", "nhwc"):
        assert layout.normalize(other) == jlayout.normalize(other)
        assert layout.is_nhwc(other) == jlayout.is_nhwc(other)
    with pytest.raises(ValueError, match="unknown layout"):
        layout.normalize("hwcn")
    with pytest.raises(ValueError, match="layout must be"):
        set_config(layout="hwcn")
    for nd in (2, 3, 4):
        assert layout.channel_axis(ndim=nd) == jlayout.channel_axis(ndim=nd)
        assert layout.channel_bshape(nd) == jlayout.channel_bshape(nd)
        for a in range(nd):
            assert layout.internal_axis(a, nd) == jlayout.internal_axis(a, nd)
    assert layout.spatial_axes() == jlayout.spatial_axes()
    for shape in ((8, 3, 32, 16), (8, 10), (2, 3, 4)):
        assert layout.internal_shape(shape) == jlayout.internal_shape(shape)
        assert layout.canonical_shape(shape) == jlayout.canonical_shape(shape)
        assert layout.canonical_shape(layout.internal_shape(shape)) == shape
    x = np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5)
    for fn, jfn in ((layout.to_internal, jlayout.to_internal),
                    (layout.from_internal, jlayout.from_internal)):
        np.testing.assert_array_equal(fn(x), jfn(x))
        assert torch.equal(fn(torch.from_numpy(x)), torch.from_numpy(np.asarray(jfn(x))))
    feeds = {"data": x, "label": np.arange(2)}
    got, want = layout.feeds_to_internal(feeds), jlayout.feeds_to_internal(feeds)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    # the permute helpers take the place of conv_dimnums and pool_window:
    # a view with the library's NHWC strides, and its inverse
    t = layout.to_internal(torch.from_numpy(x)).contiguous()
    v = layout.nchw_view(t)
    assert v.shape == (2, 3, 4, 5) and v.data_ptr() == t.data_ptr()
    assert v.is_contiguous(memory_format=torch.channels_last) == (lay == "nhwc")
    assert torch.equal(layout.internal_view(v), t)


# -- the plain NHWC LRN against the JAX formula --------------------------------

LRN_CASES = [
    # (id, canonical shape, size, alpha, beta, k, input scale)
    ("size5_beta075", (2, 16, 5, 7), 5, 1e-4, 0.75, 1.0, 1.0),
    ("size3_beta06", (2, 16, 5, 7), 3, 5e-5, 0.6, 2.0, 1.0),
    ("c_lt_size", (3, 2, 6, 6), 5, 1e-4, 0.75, 1.0, 10.0),
    ("raw_pixel_x50", (2, 24, 9, 9), 5, 1e-4, 0.75, 1.0, 50.0),
]


@pytest.mark.parametrize("case", LRN_CASES, ids=[c[0] for c in LRN_CASES])
def test_nhwc_plain_lrn_matches_jax(case):
    _, shape, size, alpha, beta, k, scale = case
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * scale).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    xh, gh = nhwc(x), nhwc(g)
    jy, vjp = jax.vjp(lambda a: lrn_across_channels_xla(a, size, alpha, beta, k,
                                                          channel_axis=3), jnp.asarray(xh))
    (jdx,) = vjp(jnp.asarray(gh))
    y = kernels.lrn_across_channels_torch(torch.from_numpy(xh), size, alpha, beta, k, 3)
    dx = kernels.lrn_backward_torch(torch.from_numpy(xh), torch.from_numpy(gh), size,
                                    alpha, beta, k, 3)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    jdx = np.asarray(jdx)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-4,
                               atol=1e-6 * float(np.abs(jdx).max()))
    # the same arithmetic as the NCHW plain version, element for element
    y1 = kernels.lrn_across_channels_torch(torch.from_numpy(x), size, alpha, beta, k)
    dx1 = kernels.lrn_backward_torch(torch.from_numpy(x), torch.from_numpy(g), size,
                                     alpha, beta, k)
    assert torch.equal(y, y1.permute(0, 2, 3, 1))
    assert torch.equal(dx, dx1.permute(0, 2, 3, 1))
    # and the autograd Function on the CPU: its backward is the plain one
    xt = torch.from_numpy(xh).requires_grad_(True)
    yt = kernels.lrn_across_channels(xt, size, alpha, beta, k, channel_axis=3)
    (gx,) = torch.autograd.grad(yt, xt, torch.from_numpy(gh))
    assert torch.equal(yt.detach(), y) and torch.equal(gx, dx)


def test_lrn_channel_axis_is_checked():
    x = torch.zeros(2, 3, 4, 5)
    with pytest.raises(ValueError, match="channel_axis 2"):
        kernels.lrn_across_channels(x, 5, 1e-4, 0.75, 1.0, channel_axis=2)
    with pytest.raises(ValueError, match="4-D"):
        kernels.lrn_backward_torch(x[0], x[0], 5, 1e-4, 0.75, 1.0, 3)


# -- each layer type under nhwc against the JAX layer under nhwc -------------

GAUSS = 'weight_filler { type: "gaussian" std: 0.1 } bias_filler { type: "constant" value: 0.1 }'
UNI = 'filler { type: "uniform" min: 0.5 max: 1.5 }'

# (id, layer text, canonical input shapes, differentiate, tolerance, options)
LAYER_CASES = [
    ("conv_group_stride_pad", 'type: "Convolution" convolution_param { num_output: 4 '
     f'kernel_size: 3 stride: 2 pad: 1 group: 2 {GAUSS} }}', [(2, 4, 9, 8)], [1], RED, {}),
    ("conv_dilation_nobias", 'type: "Convolution" convolution_param { num_output: 3 '
     'kernel_size: 3 dilation: 2 bias_term: false weight_filler { type: "gaussian" '
     'std: 0.1 } }', [(2, 3, 9, 9)], [1], RED, {}),
    ("deconv_group_stride", 'type: "Deconvolution" convolution_param { num_output: 4 '
     f'kernel_size: 4 stride: 2 pad: 1 group: 2 {GAUSS} }}', [(2, 4, 5, 5)], [1], RED, {}),
    ("pool_max_ceil", 'type: "Pooling" pooling_param { pool: MAX kernel_size: 3 stride: 2 }',
     [(2, 3, 8, 8)], [1], RED, {}),
    ("pool_ave_pad", 'type: "Pooling" pooling_param { pool: AVE kernel_size: 3 stride: 2 '
     'pad: 1 }', [(2, 3, 7, 8)], [1], RED, {}),
    ("pool_global_ave", 'type: "Pooling" pooling_param { pool: AVE global_pooling: true }',
     [(2, 3, 5, 6)], [1], RED, {}),
    ("pool_stochastic_test", 'type: "Pooling" pooling_param { pool: STOCHASTIC '
     'kernel_size: 2 stride: 2 }', [(2, 3, 6, 5)], [1], RED,
     dict(train=False, positive=True)),
    ("lrn_across_5", 'type: "LRN" lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 }',
     [(2, 7, 4, 5)], [1], RED, dict(scale=10.0)),
    ("lrn_across_3_beta06", 'type: "LRN" lrn_param { local_size: 3 alpha: 0.001 beta: 0.6 '
     'k: 2.0 }', [(2, 7, 4, 5)], [1], RED, dict(scale=10.0)),
    ("lrn_within", 'type: "LRN" lrn_param { local_size: 3 alpha: 0.001 beta: 0.75 '
     'norm_region: WITHIN_CHANNEL }', [(2, 3, 5, 6)], [1], RED, dict(scale=5.0)),
    ("spp_max", 'type: "SPP" spp_param { pyramid_height: 2 }', [(2, 3, 7, 6)], [1], RED, {}),
    ("spp_ave", 'type: "SPP" spp_param { pyramid_height: 3 pool: AVE }', [(2, 3, 7, 6)],
     [1], RED, {}),
    ("ip_4d", 'type: "InnerProduct" inner_product_param { num_output: 5 '
     f'{GAUSS} }}', [(2, 3, 4, 5)], [1], RED, {}),
    ("ip_4d_axis2", 'type: "InnerProduct" inner_product_param { num_output: 5 axis: 2 '
     f'{GAUSS} }}', [(2, 3, 4, 5)], [1], RED, {}),
    ("batchnorm_train", 'type: "BatchNorm"', [(2, 3, 4, 5)], [1], RED, dict(scale=3.0)),
    ("batchnorm_global", 'type: "BatchNorm" batch_norm_param { use_global_stats: true }',
     [(2, 3, 4, 5)], [1], RED, dict(state=True)),
    ("scale_bias", f'type: "Scale" scale_param {{ bias_term: true {UNI} bias_filler {{ '
     'type: "uniform" min: -1 max: 1 } }', [(2, 3, 4, 5)], [1], ELEM, {}),
    ("scale_two_axes", f'type: "Scale" scale_param {{ num_axes: 2 {UNI} }}',
     [(2, 3, 4, 5)], [1], ELEM, {}),
    ("scale_bottom_axis0", 'type: "Scale" scale_param { axis: 0 }',
     [(2, 3, 4, 5), (2, 3)], [1, 1], ELEM, {}),
    ("bias", 'type: "Bias" bias_param { filler { type: "uniform" min: -1 max: 1 } }',
     [(2, 3, 4, 5)], [1], ELEM, {}),
    ("concat", 'type: "Concat"', [(2, 3, 4, 5), (2, 2, 4, 5)], [1, 1], ELEM, {}),
    ("slice", 'type: "Slice" top: "a" top: "b" slice_param { slice_point: 1 }',
     [(2, 3, 4, 5)], [1], ELEM, {}),
    ("flatten", 'type: "Flatten"', [(2, 3, 4, 5)], [1], ELEM, {}),
    ("reshape", 'type: "Reshape" reshape_param { shape { dim: 0 dim: 6 dim: -1 dim: 5 } }',
     [(2, 3, 4, 5)], [1], ELEM, {}),
    ("tile", 'type: "Tile" tile_param { tiles: 2 }', [(2, 3, 4, 5)], [1], ELEM, {}),
    ("argmax", 'type: "ArgMax" argmax_param { top_k: 3 out_max_val: true }',
     [(2, 3, 4, 5)], [0], ELEM, {}),
    ("reduction_sumsq_axis1", 'type: "Reduction" reduction_param { operation: SUMSQ '
     'axis: 1 }', [(2, 3, 4, 5)], [1], RED, {}),
    ("mvn", 'type: "MVN"', [(2, 3, 4, 5)], [1], RED, {}),
    ("mvn_across", 'type: "MVN" mvn_param { across_channels: true }', [(2, 3, 4, 5)], [1],
     RED, {}),
    ("prelu", 'type: "PReLU" prelu_param { filler { type: "uniform" min: -0.5 max: 0.5 } }',
     [(2, 3, 4, 5)], [1], ELEM, {}),
    ("softmax_4d", 'type: "Softmax"', [(2, 4, 3, 3)], [1], RED, {}),
    ("softmax_loss_4d", 'type: "SoftmaxWithLoss"', [(2, 4, 3, 3), (2, 1, 3, 3)], [1, 0],
     RED, dict(labels=4)),
    ("accuracy_4d", 'type: "Accuracy" accuracy_param { top_k: 2 }',
     [(2, 4, 3, 3), (2, 1, 3, 3)], [0, 0], RED, dict(labels=4)),
]


def _layer_inputs(shapes, opts, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i, s in enumerate(shapes):
        if opts.get("labels") and i == 1:
            out.append(nhwc(rs.randint(0, opts["labels"], s).astype(np.float32)))
            continue
        x = rs.randn(*s).astype(np.float32) * opts.get("scale", 1.0)
        out.append(nhwc(np.abs(x) + 0.1 if opts.get("positive") else x))
    return out


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_layer_nhwc_matches_jax(case, both):
    """The layer's outputs and the VJP of a seeded cotangent through its
    params and float inputs, the port's under nhwc against the JAX
    layer's under nhwc; the port's params are made in the JAX layer's
    shapes (weights do not move)."""
    both("nhwc")
    _, text, shapes, diff, tol, opts = case
    train = opts.get("train", True)
    body = f'layer {{ name: "l" {text} }}'
    phase = "TRAIN" if train else "TEST"
    jl = jax_create_layer(jax_parse(body).get_all("layer")[0], JPhase[phase])
    pl = create_layer(parse(body).get_all("layer")[0], Phase[phase])
    inputs = _layer_inputs(shapes, opts)
    in_shapes = [x.shape for x in inputs]
    jparams, jstate = jl.init(jax.random.PRNGKey(7), in_shapes)
    tparams, tstate = pl.init(torch.Generator().manual_seed(0), in_shapes)
    assert [tuple(p.shape) for p in tparams] == [tuple(np.shape(p)) for p in jparams]
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {
        k: tuple(np.shape(v)) for k, v in jstate.items()}
    params = [np.asarray(p) for p in jparams]
    state = {k: np.asarray(v) for k, v in jstate.items()}
    if opts.get("state"):  # accumulated statistics for use_global_stats
        rs = np.random.RandomState(4)
        state = {k: (np.abs(rs.randn(*v.shape)) + 0.5).astype(np.float32)
                 for k, v in state.items()}
    dix = [i for i, d in enumerate(diff) if d]

    def jf(p, dxs):
        full = [jnp.asarray(x) for x in inputs]
        for i, x in zip(dix, dxs):
            full[i] = x
        return jl.apply(p, {k: jnp.asarray(v) for k, v in state.items()}, full,
                        train=train, rng=None).outputs

    outs, vjp = jax.vjp(jf, [jnp.asarray(p) for p in params],
                        [jnp.asarray(inputs[i]) for i in dix])
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    tx = [torch.tensor(x) for x in inputs]
    for i in dix:
        tx[i].requires_grad_(True)
    got = pl.apply(tp, {k: torch.tensor(v) for k, v in state.items()}, tx,
                   train=train).outputs
    assert len(got) == len(outs)
    for k, (o, jo) in enumerate(zip(got, outs)):
        within(o.detach().numpy(), jo, tol, f"output {k}")
    rs = np.random.RandomState(3)
    cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
    live = [(o, torch.tensor(c)) for o, c in zip(got, cots) if o.requires_grad]
    if not live:
        return
    jgp, jgx = vjp([jnp.asarray(c) for c in cots])
    wrt = tp + [tx[i] for i in dix]
    grads = torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                allow_unused=True)
    for k, (g, jg) in enumerate(zip(grads, list(jgp) + list(jgx))):
        g = np.zeros(np.shape(jg), np.float32) if g is None else g.numpy()
        within(g, jg, tol, f"grad {k}")


def test_nhwc_refusals_and_canonical_draws(both):
    """Im2col refuses nhwc as the JAX layer does; Dropout and STOCHASTIC
    pooling draw in canonical order, so one generator gives the same mask
    and the same window positions in both layouts."""
    both("nhwc")
    body = 'layer { name: "l" type: "Im2col" convolution_param { kernel_size: 2 } }'
    x = np.zeros((1, 4, 4, 2), np.float32)
    jl = jax_create_layer(jax_parse(body).get_all("layer")[0], JPhase.TRAIN)
    pl = create_layer(parse(body).get_all("layer")[0], Phase.TRAIN)
    with pytest.raises(ValueError, match="layout=nchw"):
        jl.apply([], {}, [jnp.asarray(x)], train=True, rng=None)
    with pytest.raises(ValueError, match="layout=nchw"):
        pl.apply([], {}, [torch.from_numpy(x)], train=True)
    rs = np.random.RandomState(2)
    xc = np.abs(rs.randn(2, 3, 6, 6)).astype(np.float32)
    for text in ('type: "Dropout" dropout_param { dropout_ratio: 0.5 }',
                 'type: "Pooling" pooling_param { pool: STOCHASTIC kernel_size: 2 '
                 'stride: 2 }'):
        layer = create_layer(parse(f'layer {{ name: "l" {text} }}').get_all("layer")[0],
                             Phase.TRAIN)
        outs = {}
        for lay in ("nchw", "nhwc"):
            set_config(layout=lay)
            xin = torch.from_numpy(nhwc(xc) if lay == "nhwc" else xc)
            y = layer.apply([], {}, [xin], train=True,
                            gen=torch.Generator().manual_seed(5)).outputs[0]
            outs[lay] = layout.from_internal(y, lay)
        assert torch.equal(outs["nchw"], outs["nhwc"]), text
