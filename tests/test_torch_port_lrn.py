"""The port's cross-channel LRN module (``sparknet_tpu_torch/ops/kernels.py``)
against the JAX package, forward and backward.

On the CPU the wrapper runs its plain PyTorch versions; the forward is
held against ``lrn_across_channels_xla`` and against the Pallas kernel body
run in interpret mode, the backward against ``jax.vjp`` of
``lrn_across_channels_xla`` and against the hand-derived ``_lrn_fused_bwd``,
on the same numpy inputs.  The CUDA kernels themselves are checked against
the plain versions on the card by ``chip_smoke.py``.
Tolerance: rtol 1e-5, atol 1e-6 in float32 for the forward — the two sides
differ only in the rounding of scale^-beta (rsqrt form vs ``jnp.power``),
a few ulps.  The backward is held to rtol 1e-5 against ``_lrn_fused_bwd``
(the same formula, same rounding of scale^-beta up to that form) and to
rtol 1e-4 against the autodiff of the reduce_window form, which reaches
dx by another sequence of roundings; the absolute term is 1e-6 of the
largest |dx|, because dx = g*p - c*x*wsum(...) cancels to near 0 at some
elements and a relative bound means nothing there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.ops import create_layer as jax_create_layer  # noqa: E402
from sparknet_tpu.ops.pallas_kernels import (  # noqa: E402
    _lrn_fused_bwd,
    lrn_across_channels as jax_lrn,
    lrn_across_channels_xla,
)
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402

from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.ops import create_layer, kernels  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

CASES = [
    # (id, shape, size, alpha, beta, k, input scale)
    ("size5_beta075", (2, 16, 5, 7), 5, 1e-4, 0.75, 1.0, 1.0),
    ("size3_beta075", (2, 16, 5, 7), 3, 1e-4, 0.75, 1.0, 1.0),
    ("size5_beta06", (2, 16, 5, 7), 5, 1e-4, 0.6, 2.0, 1.0),
    ("size3_beta06", (2, 16, 5, 7), 3, 5e-5, 0.6, 1.0, 1.0),
    ("c_lt_size", (3, 2, 6, 6), 5, 1e-4, 0.75, 1.0, 10.0),
    ("c_eq_1", (2, 1, 4, 4), 5, 1e-4, 0.75, 1.0, 10.0),
    ("spatial_not_512_multiple", (1, 8, 23, 29), 5, 1e-4, 0.75, 1.0, 1.0),
    ("raw_pixel_x50", (2, 24, 9, 9), 5, 1e-4, 0.75, 1.0, 50.0),
    ("raw_pixel_x50_beta06", (2, 24, 9, 9), 3, 1e-3, 0.6, 1.0, 50.0),
]


def _x(shape, scale, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,size,alpha,beta,k,scale",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_lrn_matches_jax_xla(shape, size, alpha, beta, k, scale):
    x = _x(shape, scale)
    ref = np.asarray(lrn_across_channels_xla(jnp.asarray(x), size, alpha, beta, k))
    out = kernels.lrn_across_channels(torch.from_numpy(x), size, alpha, beta, k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,size,alpha,beta,k,scale",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_lrn_matches_pallas_interpret(shape, size, alpha, beta, k, scale):
    x = _x(shape, scale, seed=1)
    ref = np.asarray(jax_lrn(jnp.asarray(x), size, alpha, beta, k, force="interpret"))
    out = kernels.lrn_across_channels_torch(torch.from_numpy(x), size, alpha, beta, k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("region", ["ACROSS_CHANNELS", "WITHIN_CHANNEL"])
def test_lrn_layer_matches_jax_layer(region):
    text = f"""layer {{ name: "n" type: "LRN" bottom: "x" top: "n"
      lrn_param {{ local_size: 3 alpha: 5e-5 beta: 0.75 norm_region: {region} }} }}"""
    x = _x((2, 8, 7, 9), 50.0, seed=2)
    jlayer = jax_create_layer(jax_parse(text).get_all("layer")[0], JPhase.TEST)
    ref = np.asarray(jlayer.apply([], {}, [jnp.asarray(x)], train=False).outputs[0])
    layer = create_layer(parse(text).get_all("layer")[0], Phase.TEST)
    out = layer.apply([], {}, [torch.from_numpy(x)], train=False).outputs[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", [kernels.lrn_across_channels,
                                kernels.lrn_across_channels_torch])
def test_even_size_rejected(fn):
    with pytest.raises(ValueError, match="odd"):
        fn(torch.zeros(1, 4, 2, 2), 4, 1e-4, 0.75, 1.0)


def test_cpu_tensor_does_not_launch():
    before = kernels.LRN_LAUNCHES
    x = torch.from_numpy(_x((2, 8, 4, 4), 10.0))
    y = kernels.lrn_across_channels(x, 5, 1e-4, 0.75, 1.0)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert kernels.LRN_LAUNCHES == before


def test_meta_tensor_gives_shape_only():
    before = kernels.LRN_LAUNCHES
    y = kernels.lrn_across_channels(torch.empty(2, 8, 4, 4, device="meta"),
                                    5, 1e-4, 0.75, 1.0)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 8, 4, 4)
    assert kernels.LRN_LAUNCHES == before


def test_bf16_plain_computes_in_f32():
    x = torch.from_numpy(_x((2, 8, 4, 4), 50.0)).to(torch.bfloat16)
    y = kernels.lrn_across_channels(x, 5, 1e-4, 0.75, 1.0)
    ref = kernels.lrn_across_channels_torch(x.float(), 5, 1e-4, 0.75, 1.0)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ref.to(torch.bfloat16))


def test_library_path_names_source_hash():
    """The build is named by a hash of the source and flags, so an edited
    kernel never loads a stale library; nothing is built on import."""
    p = kernels.library_path("lrn")
    assert p.parent == kernels.BUILD_DIR
    assert p.name.startswith("liblrn-") and p.suffix == ".so"
    assert (kernels.CSRC_DIR / "lrn.cu").exists()
    assert kernels.KERNEL_SOURCES == ("lrn", "fused_update", "flash_attention",
                                      "paged_attention")
    for name in kernels.KERNEL_SOURCES:
        assert (kernels.CSRC_DIR / f"{name}.cu").exists()


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

BWD_RTOL_FUSED, BWD_RTOL_XLA = 1e-5, 1e-4


def _bwd_tol(ref, rtol):
    return dict(rtol=rtol, atol=1e-6 * float(np.abs(ref).max()))


def _xg(shape, scale, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * scale).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    return x, g


def _jax_vjp_xla(x, g, size, alpha, beta, k):
    _, vjp = jax.vjp(lambda t: lrn_across_channels_xla(t, size, alpha, beta, k),
                     jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("shape,size,alpha,beta,k,scale",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_lrn_backward_matches_jax_vjp(shape, size, alpha, beta, k, scale):
    x, g = _xg(shape, scale, seed=3)
    ref = _jax_vjp_xla(x, g, size, alpha, beta, k)
    out = kernels.lrn_backward_torch(torch.from_numpy(x), torch.from_numpy(g),
                                     size, alpha, beta, k)
    np.testing.assert_allclose(out.numpy(), ref, **_bwd_tol(ref, BWD_RTOL_XLA))


@pytest.mark.parametrize("shape,size,alpha,beta,k,scale",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_plain_lrn_backward_matches_fused_bwd(shape, size, alpha, beta, k, scale):
    x, g = _xg(shape, scale, seed=4)
    (ref,) = _lrn_fused_bwd(size, alpha, beta, k, 1, jnp.asarray(x), jnp.asarray(g))
    ref = np.asarray(ref)
    out = kernels.lrn_backward(torch.from_numpy(x), torch.from_numpy(g),
                               size, alpha, beta, k)
    np.testing.assert_allclose(out.numpy(), ref, **_bwd_tol(ref, BWD_RTOL_FUSED))


@pytest.mark.parametrize("shape,size,alpha,beta,k,scale",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_autograd_function_matches_jax_vjp(shape, size, alpha, beta, k, scale):
    """The differentiable wrapper (``LRNFunction`` on the CPU) gives the
    JAX gradient and does not launch a kernel."""
    x, g = _xg(shape, scale, seed=5)
    ref = _jax_vjp_xla(x, g, size, alpha, beta, k)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES)
    y = kernels.lrn_across_channels(xt, size, alpha, beta, k)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES) == before
    np.testing.assert_allclose(dx.numpy(), ref, **_bwd_tol(ref, BWD_RTOL_XLA))


def test_lrn_layer_gradient_matches_jax_grad():
    """A gradient pushed through an LRN layer built by ``create_layer`` is
    the ``jax.grad`` of the JAX layer, and it flows through the port's
    ``LRNFunction`` (whose backward is the kernel on the card), not through
    ATen's autograd of the plain ops."""
    text = """layer { name: "n" type: "LRN" bottom: "x" top: "n"
      lrn_param { local_size: 5 alpha: 1e-4 beta: 0.75 } }"""
    x, g = _xg((2, 12, 7, 9), 50.0, seed=6)
    jlayer = jax_create_layer(jax_parse(text).get_all("layer")[0], JPhase.TRAIN)
    ref = np.asarray(jax.grad(lambda t: jnp.sum(
        jlayer.apply([], {}, [t], train=True).outputs[0] * jnp.asarray(g)))(
            jnp.asarray(x)))
    layer = create_layer(parse(text).get_all("layer")[0], Phase.TRAIN)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer.apply([], {}, [xt], train=True).outputs[0]
    assert isinstance(y.grad_fn, kernels.LRNFunction._backward_cls)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(dx.numpy(), ref, **_bwd_tol(ref, BWD_RTOL_XLA))


def test_lrn_backward_plain_computes_in_f32():
    x, g = _xg((2, 8, 4, 4), 50.0, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    dx = kernels.lrn_backward(xb, gb, 5, 1e-4, 0.75, 1.0)
    ref = kernels.lrn_backward_torch(xb.float(), gb.float(), 5, 1e-4, 0.75, 1.0)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, ref.to(torch.bfloat16))


def test_inference_mode_forward_saves_nothing_and_matches():
    """Under inference mode the serving path's forward is the same single
    call with the same bits as the plain version."""
    x = torch.from_numpy(_x((2, 8, 5, 5), 50.0, seed=8))
    with torch.inference_mode():
        y = kernels.lrn_across_channels(x, 5, 1e-4, 0.75, 1.0)
    assert y.grad_fn is None
    assert torch.equal(y, kernels.lrn_across_channels_torch(x, 5, 1e-4, 0.75, 1.0))
