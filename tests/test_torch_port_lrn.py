"""The port's cross-channel LRN module (``sparknet_tpu_torch/ops/kernels.py``)
against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; that version is
held against ``lrn_across_channels_xla`` and against the Pallas kernel body
run in interpret mode, on the same numpy inputs.  The CUDA kernel itself is
checked against the plain version on the card by ``chip_smoke.py``.
Tolerance: rtol 1e-5, atol 1e-6 in float32 — the two sides differ only in
the rounding of scale^-beta (rsqrt form vs ``jnp.power``), a few ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.ops import create_layer as jax_create_layer  # noqa: E402
from sparknet_tpu.ops.pallas_kernels import (  # noqa: E402
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
    assert kernels.KERNEL_SOURCES == ("lrn",)
