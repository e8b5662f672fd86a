"""BatchNorm, Scale and Bias in the port against the JAX package's layers.

The same prototxt goes through the JAX layer and the port's on the same
numpy inputs, params and state, on the CPU.  Tolerance: rtol 1e-5, with an
absolute 1e-5 of the reference's largest |value| (``_close``); both
packages compute the statistics in float32 but sum in different orders.
A large-mean input, where E[x^2] - E[x]^2 cancels below float32's
resolution, is held to what the order of sums leaves common: the clamp at
0 in both, and exact outputs where the mean is exact.  bfloat16 outputs
are held to one bfloat16 ulp.
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

RTOL, AREL = 1e-5, 1e-5


def _close(got, want, rtol=RTOL, arel=AREL, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=arel * float(np.abs(want).max()) + 1e-30,
                               err_msg=what)


def _layers(text, train):
    jl = jax_create_layer(jax_parse(text).get_all("layer")[0],
                          JPhase.TRAIN if train else JPhase.TEST)
    tl = create_layer(parse(text).get_all("layer")[0],
                      Phase.TRAIN if train else Phase.TEST)
    return jl, tl


def _run(text, params, state, inputs, train):
    """(jax LayerOutput, port LayerOutput) of the first layer of ``text``."""
    jl, tl = _layers(text, train)
    jout = jl.apply([jnp.asarray(p) for p in params],
                    {k: jnp.asarray(v) for k, v in state.items()},
                    [jnp.asarray(x) for x in inputs], train=train, rng=None)
    tout = tl.apply([torch.from_numpy(p) for p in params],
                    {k: torch.from_numpy(v) for k, v in state.items()},
                    [torch.from_numpy(x) for x in inputs], train=train)
    return jout, tout


def _bn(extra=""):
    return (f'layer {{ name: "bn" type: "BatchNorm" bottom: "x" top: "x" '
            f'batch_norm_param {{ {extra} }} }}')


def _state(rng, c, sf):
    """Accumulated sums as a few decayed batches leave them."""
    return {"mean": (rng.randn(c) * 5 * sf).astype(np.float32),
            "variance": (rng.rand(c) * 30 * sf + 0.5).astype(np.float32),
            "scale_factor": np.array([sf], np.float32)}


@pytest.mark.parametrize("shape", [(4, 6, 5, 7), (8, 6), (3, 4, 10)])
@pytest.mark.parametrize("extra", ["", "moving_average_fraction: 0.9 eps: 0.001"])
def test_batchnorm_train_output_and_state(rng, shape, extra):
    x = (rng.randn(*shape) * 40 + 7).astype(np.float32)
    state = _state(rng, shape[1], 2.71)
    jout, tout = _run(_bn(extra), [], state, [x], train=True)
    _close(tout.outputs[0], jout.outputs[0], what="output")
    for k in ("mean", "variance", "scale_factor"):
        _close(tout.state[k], jout.state[k], what=k)
        assert tout.state[k].dtype == torch.float32


def test_batchnorm_train_large_mean_clamps(rng):
    """Channel 0 ordinary; channel 1 the constant 1000.5, whose plain sums are
    exact in any order (so its mean is, and its output is 0 in both);
    channels 2-7 1000 + 1e-3 noise, a spread below E[x^2]'s float32 ulp
    (0.0625).  The variance the cancellation leaves is order-dependent
    rounding, negative in some channel here, and clamped at 0 in both
    packages."""
    x = (rng.randn(2, 8, 4, 4) * 50).astype(np.float32)
    x[:, 1] = np.float32(1000.5)
    x[:, 2:] = (1000 + rng.randn(2, 6, 4, 4) * 1e-3).astype(np.float32)
    zero = {"mean": np.zeros(8, np.float32), "variance": np.zeros(8, np.float32),
            "scale_factor": np.zeros(1, np.float32)}
    xt = torch.from_numpy(x)
    unclamped = (xt * xt).mean((0, 2, 3)) - xt.mean((0, 2, 3)) ** 2
    assert float(unclamped[1:].min()) < 0  # the clamp matters for this input
    jout, tout = _run(_bn(), [], zero, [x], train=True)
    jy, ty = np.asarray(jout.outputs[0]), tout.outputs[0].numpy()
    _close(ty[:, 0], jy[:, 0], what="ordinary channel")
    assert np.all(ty[:, 1] == 0) and np.all(jy[:, 1] == 0)
    assert np.isfinite(ty).all() and np.isfinite(jy).all()
    # channels 2-7: within the spread over sqrt(eps) in both
    bound = float(np.abs(x[:, 2:] - 1000).max() + 2e-4) / np.sqrt(1e-5)
    assert np.abs(ty[:, 2:]).max() <= bound and np.abs(jy[:, 2:]).max() <= bound
    tv, jv = tout.state["variance"].numpy(), np.asarray(jout.state["variance"])
    _close(tv[0], jv[0], what="ordinary variance")
    for v in (tv[1:], jv[1:]):
        assert np.all(v >= 0) and np.all(v <= 4 * 0.0625)
    _close(tout.state["mean"], jout.state["mean"], what="mean")


@pytest.mark.parametrize("sf", [0.0, 1.0, 9.5])
@pytest.mark.parametrize("train", [False, True], ids=["test", "train_global"])
def test_batchnorm_global_stats(rng, sf, train):
    """Global statistics: the default at TEST, and ``use_global_stats:
    true`` in TRAIN; a scale_factor of 0 counts as 1."""
    x = (rng.randn(3, 5, 6, 6) * 20).astype(np.float32)
    state = _state(rng, 5, max(sf, 1.0))
    state["scale_factor"][0] = sf
    extra = "use_global_stats: true" if train else ""
    jout, tout = _run(_bn(extra), [], state, [x], train=train)
    _close(tout.outputs[0], jout.outputs[0], what="output")
    for k, v in state.items():
        assert np.array_equal(tout.state[k].numpy(), v)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_bf16_input(rng, train):
    """Statistics in float32 from a bfloat16 input; the output comes back
    in bfloat16, within one bfloat16 ulp of JAX's."""
    x = (rng.randn(4, 6, 5, 5) * 30 + 100).astype(np.float32)
    state = _state(rng, 6, 3.0)
    jl, tl = _layers(_bn(), train)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jout = jl.apply([], {k: jnp.asarray(v) for k, v in state.items()}, [xb],
                    train=train, rng=None)
    tout = tl.apply([], {k: torch.from_numpy(v) for k, v in state.items()},
                    [torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)],
                    train=train)
    assert tout.outputs[0].dtype == torch.bfloat16
    ty = tout.outputs[0].float().numpy()
    jy = np.asarray(jout.outputs[0].astype(jnp.float32))
    _, exp = np.frexp(np.maximum(np.abs(jy), 1e-30))
    assert np.all(np.abs(ty - jy) <= np.ldexp(1.0, exp - 8))
    for k in state:
        _close(tout.state[k], jout.state[k], what=k)
        assert tout.state[k].dtype == torch.float32


def _scale(extra, bottoms=("x",)):
    b = " ".join(f'bottom: "{n}"' for n in bottoms)
    return (f'layer {{ name: "sc" type: "Scale" {b} top: "y" '
            f'scale_param {{ {extra} }} }}')


SCALE_CASES = [
    # (scale_param, bottom shape): axis/num_axes variants, bias_term
    ("", (2, 5, 4, 3)),
    ("bias_term: true bias_filler { type: 'constant' value: 0.5 }", (2, 5, 4, 3)),
    ("axis: 1 num_axes: 2", (2, 5, 4, 3)),
    ("axis: 2 num_axes: -1 bias_term: true", (2, 5, 4, 3)),
    ("axis: -1", (3, 4, 6)),
    ("axis: 0 num_axes: 0", (3, 4)),
    ("filler { type: 'gaussian' std: 0.3 }", (6, 8)),
]


@pytest.mark.parametrize("extra,shape", SCALE_CASES)
def test_scale(rng, extra, shape):
    text = _scale(extra)
    jl, tl = _layers(text, train=True)
    jp, _ = jl.init(jax.random.key(0), [shape])
    tp, _ = tl.init(torch.Generator().manual_seed(0), [shape])
    assert [tuple(p.shape) for p in tp] == [tuple(p.shape) for p in jp]
    if "filler" not in extra:
        # the default filler is constant 1, and the bias filler constant
        for a, b in zip(tp, jp):
            assert np.array_equal(a.numpy(), np.asarray(b))
    params = [np.asarray(rng.randn(*p.shape), np.float32) for p in jp]
    x = rng.randn(*shape).astype(np.float32) * 10
    jout, tout = _run(text, params, {}, [x], train=True)
    _close(tout.outputs[0], jout.outputs[0])


@pytest.mark.parametrize("bias_term", [False, True])
@pytest.mark.parametrize("axis,sshape", [(1, (5,)), (1, (5, 4, 3)), (2, (4,))])
def test_scale_from_second_bottom(rng, bias_term, axis, sshape):
    """The scale is the second bottom; a learned bias is shaped like it."""
    text = _scale(f"axis: {axis} bias_term: {str(bias_term).lower()}", ("x", "s"))
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    s = rng.randn(*sshape).astype(np.float32)
    jl, tl = _layers(text, train=True)
    jp, _ = jl.init(jax.random.key(0), [x.shape, s.shape])
    tp, _ = tl.init(torch.Generator().manual_seed(0), [x.shape, s.shape])
    assert [tuple(p.shape) for p in tp] == [tuple(p.shape) for p in jp]
    params = [np.asarray(rng.randn(*p.shape), np.float32) for p in jp]
    jout, tout = _run(text, params, {}, [x, s], train=True)
    _close(tout.outputs[0], jout.outputs[0])


@pytest.mark.parametrize("extra,shape,second", [
    ("", (2, 5, 4, 3), None),
    ("axis: 1 num_axes: -1 filler { type: 'gaussian' std: 1 }", (2, 5, 4, 3), None),
    ("axis: 2", (2, 5, 4, 3), (4,)),
    ("axis: 0 num_axes: 2", (3, 6), None),
])
def test_bias(rng, extra, shape, second):
    bottoms = 'bottom: "x"' + (' bottom: "b"' if second else "")
    text = (f'layer {{ name: "bi" type: "Bias" {bottoms} top: "y" '
            f'bias_param {{ {extra} }} }}')
    in_shapes = [shape] + ([second] if second else [])
    jl, tl = _layers(text, train=True)
    jp, _ = jl.init(jax.random.key(0), in_shapes)
    tp, _ = tl.init(torch.Generator().manual_seed(0), in_shapes)
    assert [tuple(p.shape) for p in tp] == [tuple(p.shape) for p in jp]
    params = [np.asarray(rng.randn(*p.shape), np.float32) for p in jp]
    inputs = [rng.randn(*s).astype(np.float32) for s in in_shapes]
    jout, tout = _run(text, params, {}, inputs, train=True)
    _close(tout.outputs[0], jout.outputs[0])


def test_batchnorm_init_state(rng):
    jl, tl = _layers(_bn(), train=True)
    for shape in [(2, 7, 3, 3), (4, 9)]:
        _, js = jl.init(jax.random.key(0), [shape])
        tp, ts = tl.init(torch.Generator().manual_seed(0), [shape])
        assert tp == [] and set(ts) == set(js)
        for k in js:
            assert ts[k].dtype == torch.float32
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("global_stats", [False, True], ids=["batch", "global"])
def test_gradients_through_batchnorm_and_scale(rng, global_stats):
    """dL/dx, dL/dgamma and dL/dbeta through BatchNorm -> Scale(bias) in
    TRAIN, against ``jax.vjp`` of the JAX layers, for the same cotangent."""
    bn_text = _bn("use_global_stats: true" if global_stats else "")
    sc_text = ('layer { name: "sc" type: "Scale" bottom: "x" top: "x" '
               'scale_param { bias_term: true } }')
    jbn, tbn = _layers(bn_text, train=True)
    jsc, tsc = _layers(sc_text, train=True)
    x = (rng.randn(4, 6, 5, 5) * 30 + 3).astype(np.float32)
    gamma = (rng.rand(6) + 0.5).astype(np.float32)
    beta = rng.randn(6).astype(np.float32)
    cot = rng.randn(4, 6, 5, 5).astype(np.float32)
    state = _state(rng, 6, 4.0)

    def jfn(x, g, b):
        y = jbn.apply([], {k: jnp.asarray(v) for k, v in state.items()}, [x],
                      train=True, rng=None).outputs[0]
        return jsc.apply([g, b], {}, [y], train=True, rng=None).outputs[0]

    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    jgrads = vjp(jnp.asarray(cot))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
    y = tbn.apply([], {k: torch.from_numpy(v) for k, v in state.items()},
                  [leaves[0]], train=True).outputs[0]
    y = tsc.apply(leaves[1:], {}, [y], train=True).outputs[0]
    tgrads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    _close(y.detach(), jy, what="forward")
    for name, a, b in zip(("x", "gamma", "beta"), tgrads, jgrads):
        _close(a, b, rtol=1e-4, arel=1e-5, what=f"d{name}")
