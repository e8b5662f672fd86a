"""The port's attention slice on the CPU, against the JAX package.

RoPE, ``MultiHeadAttention``, ``Embed`` and ``Eltwise``, and the plain
versions of the two attention kernels (``flash_attention_torch``,
``paged_attention_torch``) against the JAX kernels run in Pallas interpret
mode and against their XLA versions.  Inputs are seeded numpy arrays
handed to both packages; layer weights come from the JAX layer's ``init``.
Tolerances: 1e-5 (rtol and atol) for the attention cores and layers
(float32, the sums taken in another order); ``rope_at`` against the port's
own ``rope`` is bit for bit.  On the CPU the wrappers take the plain
versions, so no kernel launch is counted.  The flash kernel's 3×TF32
tensor-core products are emulated in float32 here (TF32 rounding by bit
masking) to show that the card's gate can tell them from plain TF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.ops import attention as jattn  # noqa: E402
from sparknet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from sparknet_tpu.ops.registry import create_layer as jcreate  # noqa: E402
from sparknet_tpu.proto.text_format import parse as jparse  # noqa: E402

from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.ops import attention, create_layer, kernels  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    """On CPU tensors the wrappers take the plain versions: no launch is
    counted."""
    kernels.reset_launch_counts()
    yield
    assert kernels.FLASH_LAUNCHES == 0 and kernels.PAGED_LAUNCHES == 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _layers(text):
    """The same prototxt layer built by both packages."""
    jl = jcreate(jparse(text).get_all("layer")[0], JPhase.TEST)
    pl = create_layer(parse(text).get_all("layer")[0], Phase.TEST)
    return jl, pl


# -- RoPE -------------------------------------------------------------------


def test_rope_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 20, 16).astype(np.float32)
    np.testing.assert_allclose(attention.rope(_t(x)).numpy(),
                               np.asarray(jattn.rope(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_rope_at_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 4, 2, 8).astype(np.float32)
    pos = rs.randint(0, 300, (3, 2)).astype(np.int32)
    np.testing.assert_allclose(attention.rope_at(_t(x), _t(pos)).numpy(),
                               np.asarray(jattn.rope_at(jnp.asarray(x), jnp.asarray(pos))),
                               rtol=1e-6, atol=1e-6)


def test_rope_at_is_rope_row_bit_for_bit():
    """The cached K of the decode path equals the full-window K: rope_at at
    position t is the same float expression as rope at row t."""
    rs = np.random.RandomState(2)
    s = 37
    x = _t(rs.randn(2, 4, s, 16).astype(np.float32))
    full = attention.rope(x)
    for t in (0, 1, 8, 36):
        at = attention.rope_at(x[:, :, t:t + 1], torch.full((2, 1), t, dtype=torch.int32))
        assert torch.equal(at[:, :, 0], full[:, :, t])
    # a batch of rows at different positions, the decode step's shape
    pos = torch.tensor([[3], [30]], dtype=torch.int32)
    at = attention.rope_at(torch.stack([x[0, :, 3:4], x[1, :, 30:31]]), pos)
    assert torch.equal(at[0, :, 0], full[0, :, 3])
    assert torch.equal(at[1, :, 0], full[1, :, 30])


def test_rope_rejects_odd_head_dim():
    with pytest.raises(ValueError, match="even head dim"):
        attention.rope(torch.zeros(1, 1, 2, 5))
    with pytest.raises(ValueError, match="even head dim"):
        attention.rope_at(torch.zeros(1, 1, 1, 5), torch.zeros(1, 1, dtype=torch.int32))


# -- MultiHeadAttention -----------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rope", [False, True])
def test_multihead_attention_matches_jax(causal, rope):
    flags = (" causal: true" if causal else "") + (" rope: true" if rope else "")
    text = (f'layer {{ name: "attn" type: "MultiHeadAttention" bottom: "x" top: "y" '
            f'attention_param {{ num_heads: 4{flags} }} }}')
    jl, pl = _layers(text)
    x = np.random.RandomState(3).randn(2, 19, 32).astype(np.float32)
    jparams, _ = jl.init(jax.random.key(5), [x.shape])
    jy = jl.apply(jparams, {}, [jnp.asarray(x)], train=False).outputs[0]
    y = pl.apply([_t(p) for p in jparams], {}, [_t(x)], train=False).outputs[0]
    assert tuple(y.shape) == (2, 19, 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_multihead_attention_init_shapes_and_fillers():
    _, pl = _layers('layer { name: "a" type: "MultiHeadAttention" bottom: "x" '
                    'top: "y" attention_param { num_heads: 2 } }')
    params, state = pl.init(torch.Generator().manual_seed(0), [(3, 5, 8)])
    assert [tuple(p.shape) for p in params] == [(24, 8), (24,), (8, 8), (8,)]
    assert state == {}
    # xavier, fan_in = E: uniform in +-sqrt(3 / 8); biases zero
    assert float(params[0].abs().max()) <= np.sqrt(3.0 / 8) + 1e-6
    assert not params[1].any() and not params[3].any()
    with pytest.raises(ValueError, match="divisible"):
        pl.init(torch.Generator(), [(3, 5, 7)])


def test_multihead_attention_shape_inference_on_meta():
    _, pl = _layers('layer { name: "a" type: "MultiHeadAttention" bottom: "x" '
                    'top: "y" attention_param { num_heads: 2 causal: true rope: true } }')
    params, _ = pl.init(torch.Generator().manual_seed(0), [(3, 5, 8)])
    y = pl.apply([p.to("meta") for p in params], {},
                 [torch.empty(3, 5, 8, device="meta")], train=False).outputs[0]
    assert y.device.type == "meta" and tuple(y.shape) == (3, 5, 8)


# -- Embed and Eltwise ------------------------------------------------------


def test_embed_matches_jax_and_casts_indices():
    text = ('layer { name: "e" type: "Embed" bottom: "d" top: "y" embed_param { '
            'input_dim: 11 num_output: 6 weight_filler { type: "xavier" } '
            'bias_filler { type: "gaussian" std: 0.5 } } }')
    jl, pl = _layers(text)
    ids = np.random.RandomState(4).randint(0, 11, (3, 7)).astype(np.int32)
    jparams, _ = jl.init(jax.random.key(1), [ids.shape])
    jy = np.asarray(jl.apply(jparams, {}, [jnp.asarray(ids)], train=False).outputs[0])
    params = [_t(p) for p in jparams]
    for feed in (ids, ids.astype(np.float32), ids.astype(np.int64)):
        y = pl.apply(params, {}, [_t(feed)], train=False).outputs[0]
        np.testing.assert_array_equal(y.numpy(), jy)
    # Network.init propagates float meta tensors through the lookup
    y = pl.apply([p.to("meta") for p in params], {},
                 [torch.empty(3, 7, device="meta")], train=False).outputs[0]
    assert tuple(y.shape) == (3, 7, 6)
    ps, _ = pl.init(torch.Generator().manual_seed(0), [(3, 7)])
    assert [tuple(p.shape) for p in ps] == [(11, 6), (6,)]


@pytest.mark.parametrize("param", ["", 'eltwise_param { operation: PROD }',
                                   'eltwise_param { operation: MAX }',
                                   'eltwise_param { coeff: 0.5 coeff: -2 coeff: 3 }'])
def test_eltwise_matches_jax(param):
    text = f'layer {{ name: "s" type: "Eltwise" bottom: "a" bottom: "b" bottom: "c" top: "y" {param} }}'
    jl, pl = _layers(text)
    xs = [np.random.RandomState(i).randn(2, 3, 4).astype(np.float32) for i in range(3)]
    jy = jl.apply([], {}, [jnp.asarray(x) for x in xs], train=False).outputs[0]
    y = pl.apply([], {}, [_t(x) for x in xs], train=False).outputs[0]
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_eltwise_refuses_coeff_count_mismatch():
    _, pl = _layers('layer { name: "s" type: "Eltwise" bottom: "a" bottom: "b" '
                    'top: "y" eltwise_param { coeff: 1 } }')
    with pytest.raises(ValueError, match="coeffs"):
        pl.apply([], {}, [torch.ones(2), torch.ones(2)], train=False)


# -- the plain versions of the two kernels ------------------------------------


@pytest.mark.parametrize("shape,causal", [((2, 4, 100, 16), False),
                                          ((2, 4, 100, 16), True),
                                          ((1, 2, 256, 32), True),
                                          # heads above 256 lanes (the
                                          # chunked kernels' widths)
                                          ((1, 2, 40, 320), True),
                                          ((1, 1, 33, 512), False)])
def test_flash_attention_plain_matches_jax_kernel_and_xla(shape, causal):
    rs = np.random.RandomState(sum(shape))
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    got = kernels.flash_attention(_t(q), _t(k), _t(v), causal).numpy()
    np.testing.assert_array_equal(
        got, kernels.flash_attention_torch(_t(q), _t(k), _t(v), causal).numpy())
    interp = jpk.flash_attention(q, k, v, causal=causal, force="interpret")
    np.testing.assert_allclose(got, np.asarray(interp), **TOL)
    np.testing.assert_allclose(got, np.asarray(jpk.attention_xla(q, k, v, causal)), **TOL)


def _paged_inputs(seed, b=4, h=2, d=16, t=4, mb=5, positions=None):
    """Pools full of finite garbage (1e4) except each row's live lines;
    rows own ceil((pos + 1) / T) blocks, the rest of a table is the null
    block 0.  ``positions`` (one a row) defaults to 0, T - 1, T and
    MB * T - 1."""
    rs = np.random.RandomState(seed)
    if positions is not None:
        b = len(positions)
    nb = 1 + b * mb
    k_pool = ((rs.rand(nb, t, h, d) * 2 - 1) * 1e4).astype(np.float32)
    v_pool = ((rs.rand(nb, t, h, d) * 2 - 1) * 1e4).astype(np.float32)
    positions = np.array([0, t - 1, t, mb * t - 1][:b] if positions is None
                         else positions, np.int32)
    tables = np.zeros((b, mb), np.int32)
    perm = rs.permutation(np.arange(1, nb)).astype(np.int32)
    for row in range(b):
        n = positions[row] // t + 1
        tables[row, :n] = perm[row * mb:row * mb + n]
        for c in range(positions[row] + 1):
            k_pool[tables[row, c // t], c % t] = rs.randn(h, d)
            v_pool[tables[row, c // t], c % t] = rs.randn(h, d)
    q = rs.randn(b, h, d).astype(np.float32)
    return q, k_pool, v_pool, tables, positions


@pytest.mark.parametrize("seed,d", [(0, 16), (1, 16), (2, 320), (3, 512)],
                         ids=["0", "1", "d320", "d512"])
def test_paged_attention_plain_matches_jax_kernel_and_xla(seed, d):
    args = _paged_inputs(seed, d=d)
    got = kernels.paged_attention(*map(_t, args)).numpy()
    np.testing.assert_array_equal(got, kernels.paged_attention_torch(*map(_t, args)).numpy())
    interp = jpk.paged_attention(*args, force="interpret")
    np.testing.assert_allclose(got, np.asarray(interp), **TOL)
    np.testing.assert_allclose(got, np.asarray(jpk.paged_attention_xla(*args)), **TOL)
    assert np.isfinite(got).all()


def test_paged_attention_rows_are_independent():
    """A row's output is a function of its own q, table and position."""
    q, kp, vp, tables, pos = map(_t, _paged_inputs(2))
    base = kernels.paged_attention_torch(q, kp, vp, tables, pos)
    q2, tables2, pos2 = q.clone(), tables.clone(), pos.clone()
    q2[1:] = torch.randn(q2[1:].shape)
    tables2[1:] = tables2[1:].flip(0)
    pos2[1:] = torch.tensor([2, 9, 0], dtype=torch.int32)
    assert torch.equal(kernels.paged_attention_torch(q2, kp, vp, tables2, pos2)[0], base[0])


def _paged_tiled(q, k_pool, v_pool, tables, positions):
    """Paged attention in the CUDA kernel's order of sums
    (``csrc/paged_attention.cu``), in float32: columns in tiles of KT =
    4 * CW, each of the 4 warps scoring its own CW columns of every tile
    (CW = 32 / max(1, D / 32)) with its own online softmax (a running max
    from -1e30, p = 0 past the position, the carry rescaled by exp(m -
    m')), and the warps' carries merged once at the end, in warp order.
    A head above 256 lanes is read in chunks of 128 (the chunked kernel):
    CW is the 128-lane instance's, and a column's score is the sum of its
    chunks' dot products, added in chunk order."""
    b, h, d = q.shape
    t, mb = k_pool.shape[1], tables.shape[1]
    chunk = kernels.ATTENTION_CHUNK if d > kernels.ATTENTION_HEAD_DIMS[-1] else d
    cw = 32 // max(1, chunk // 32)
    kt = 4 * cw
    ntiles = -(-mb * t // kt)
    idx = tables.long()
    k = k_pool[idx].reshape(b, mb * t, h, d).transpose(1, 2)
    v = v_pool[idx].reshape(b, mb * t, h, d).transpose(1, 2)
    pad = ntiles * kt - mb * t
    k = torch.nn.functional.pad(k, (0, 0, 0, pad)).reshape(b, h, ntiles, 4, cw, d)
    v = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(b, h, ntiles, 4, cw, d)
    cols = torch.arange(ntiles * kt).reshape(ntiles, 4, cw)
    m = torch.full((b, h, 4), -1e30)
    l = torch.zeros((b, h, 4))
    acc = torch.zeros((b, h, 4, d))
    for x in range(ntiles):
        live = cols[x][None, None] <= positions.long()[:, None, None, None]
        s = sum(torch.einsum("bhd,bhwjd->bhwj", q[..., c:c + chunk],
                             k[:, :, x, ..., c:c + chunk])
                for c in range(0, d, chunk)) * (1.0 / np.sqrt(d))
        s = torch.where(live, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new[..., None]), torch.tensor(0.0))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhwj,bhwjd->bhwd", p, v[:, :, x])
        m = m_new
    f = torch.exp(m - m.amax(-1, keepdim=True))
    num, den = torch.zeros((b, h, d)), torch.zeros((b, h))
    for w in range(4):
        num = num + acc[:, :, w] * f[..., w, None]
        den = den + l[:, :, w] * f[..., w]
    return num / den[..., None]


@pytest.mark.parametrize("d", [8, 128, 512])
@pytest.mark.parametrize("t", [1, 4])
def test_paged_kernel_order_of_sums_matches_jax_and_float64(d, t):
    """The CUDA kernel's tiling and per-warp online softmax, emulated, at
    positions on block edges, on both sides of a warp's share and of a
    tile (KT = 128 at D = 8, 32 at D = 128 and at D = 512, which is read
    in chunks of 128 lanes) and at 0 (three warp shares with no live
    column): within TOL of the XLA version and the Pallas kernel in
    interpret mode, and within rtol 1e-5 / atol 1e-6 of float64."""
    mb = 160 // t
    cw = 32 // max(1, min(d, kernels.ATTENTION_CHUNK) // 32)
    kt = 4 * cw
    positions = [0, t - 1, t, cw - 1, cw, kt - 1, kt, kt + 1, mb * t - 1]
    args = _paged_inputs(10 + d + t, h=2, d=d, t=t, mb=mb, positions=positions)
    got = _paged_tiled(*map(_t, args)).numpy()
    assert np.isfinite(got).all()
    interp = jpk.paged_attention(*args, force="interpret")
    np.testing.assert_allclose(got, np.asarray(interp), **TOL)
    np.testing.assert_allclose(got, np.asarray(jpk.paged_attention_xla(*args)), **TOL)
    q, kp, vp, tables, pos = (torch.from_numpy(a).double() if a.dtype == np.float32
                              else torch.from_numpy(a) for a in args)
    kg = kp[tables.long()].reshape(len(pos), mb * t, 2, d)
    vg = vp[tables.long()].reshape(len(pos), mb * t, 2, d)
    s = torch.einsum("bhd,bshd->bhs", q, kg) / np.sqrt(d)
    s = torch.where(torch.arange(mb * t)[None, None] <= pos.long()[:, None, None], s,
                    -torch.inf)
    ref = torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), vg).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _misaligned(a):
    """A contiguous copy of ``a`` one float past the start of a fresh
    (16-byte aligned) buffer."""
    out = torch.zeros(a.numel() + 1)[1:].view(a.shape)
    out.copy_(a)
    return out


@pytest.mark.parametrize("fault,match", [
    ("misaligned pool", "16-byte aligned"),
    ("head dim 12", "head dim 12"),
    ("head dim 160", "head dim 160 lies between"),
    ("head dim 320", "head dim 320 lies between"),
    ("head dim 9856", "head dim 9856 > 9728"),
    ("int64 tables", "int32 tables"),
    ("strided pool", "contiguous"),
])
def test_paged_kernel_wrapper_refuses_what_the_kernel_cannot_take(fault, match):
    """The CUDA route's checks run before anything is built or launched:
    the kernel copies the pools in 16-byte chunks, takes pools of a width
    of ATTENTION_HEAD_DIMS or, above 256 lanes, a multiple of 128 up to
    PAGED_MAX_HEAD_DIM (a head between them, 12, 160 or 320 lanes, is
    padded when the pools are allocated, not copied per call: an unpadded
    pool is refused with that advice), int32 tables and contiguous pools."""
    q, kp, vp, tables, pos = map(_t, _paged_inputs(3))
    if fault == "misaligned pool":
        kp = _misaligned(kp)
        assert kp.is_contiguous() and kp.data_ptr() % 16
    elif fault in ("head dim 160", "head dim 320", "head dim 9856"):
        n = int(fault.split()[-1]) // 16
        q, kp, vp = (torch.cat([t] * n, dim=-1) for t in (q, kp, vp))
    elif fault == "head dim 12":  # pools not padded to kernel_head_dim(12) = 16
        q, kp, vp = q[..., :12].contiguous(), kp[..., :12].contiguous(), vp[..., :12].contiguous()
    elif fault == "int64 tables":
        tables = tables.long()
    else:  # the same shape, laid out [T, NB, H, D]
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
        assert not kp.is_contiguous()
    with pytest.raises(ValueError, match=match):
        kernels._paged_attention_cuda(q, kp, vp, tables, pos)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does: by integer masking
    of the float32 bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """float32 truncated to TF32: what a tensor core reads of a float32
    register handed to it as tf32."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int,
                 group: int = 1) -> torch.Tensor:
    """``a @ b`` as the flash kernels' m16n8k8 products form it: k in steps
    of 8, each ``group`` steps summed from zero (a_lo·b_hi and a_hi·b_lo,
    then a_hi·b_hi: 3×TF32, small terms first; hi rounded to nearest, lo =
    x - hi truncated; or only the rounded product when ``terms`` is 1,
    plain TF32) and then added to a float32 sum."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8 * group):
        ak, bk = a[..., k0:k0 + 8 * group], b[..., k0:k0 + 8 * group, :]
        ah, bh = _tf32_rna(ak), _tf32_rna(bk)
        d = ah @ bh
        if terms == 3:
            d = (_tf32_rz(ak - ah) @ bh + ah @ _tf32_rz(bk - bh)) + d
        acc = acc + d
    return acc


def _tf32_attention(q, k, v, terms: int) -> torch.Tensor:
    """Causal attention forward with the kernel's products emulated: q
    pre-scaled by 1/sqrt(D), S = Q·Kᵀ and O = P·V through
    ``_tf32_matmul``, softmax and the row sums in float32."""
    s = _tf32_matmul(q * (1.0 / np.sqrt(q.shape[-1])), k.transpose(-1, -2), terms)
    idx = torch.arange(q.shape[2])
    s = torch.where(idx[:, None] >= idx[None, :], s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _tf32_matmul(p, v, terms) / p.sum(-1, keepdim=True)


def test_three_tf32_products_meet_the_flash_gate_and_one_does_not():
    """The premise of the flash kernel's tensor-core design: splitting each
    float32 operand into two TF32 parts and keeping three of the four
    products meets the card's gate (rtol 1e-5, atol 1e-6) against a
    float64 reference; one TF32 product (about 3 decimal digits) does not,
    so the gate tells the two apart."""
    rs = np.random.RandomState(7)
    q, k, v = (_t(rs.randn(1, 2, 512, 64).astype(np.float32)) for _ in range(3))
    s = q.double() @ k.double().transpose(-1, -2) / 8.0
    idx = torch.arange(512)
    s = torch.where(idx[:, None] >= idx[None, :], s, -torch.inf)
    ref = (torch.softmax(s, -1) @ v.double()).numpy()
    np.testing.assert_allclose(_tf32_attention(q, k, v, 3).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(_tf32_attention(q, k, v, 1).numpy(), ref,
                           rtol=1e-5, atol=1e-6)


def test_tf32_rounding_is_nearest_ties_away():
    """The emulation's rounding: 10 stored mantissa bits, ties away from
    zero, and the split with a truncated lo recovers a float32 value to
    within 2^-21 of it."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                      1.0 + 3 * one_ulp / 4], dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp]
    y = _t(np.random.RandomState(8).randn(1000).astype(np.float32))
    hi = _tf32_rna(y)
    err = (hi + _tf32_rz(y - hi) - y).abs() / y.abs()
    assert float(err.max()) <= 2.0 ** -21


# -- head dims between the kernels' widths ------------------------------------


def test_kernel_head_dim():
    """The smallest kernel width >= d up to 256; above, the next multiple
    of the chunked kernels' 128 lanes."""
    want = {1: 8, 8: 8, 9: 16, 12: 16, 16: 16, 24: 32, 48: 64, 64: 64,
            100: 128, 128: 128, 160: 256, 200: 256, 256: 256, 257: 384,
            320: 384, 384: 384, 385: 512, 512: 512, 640: 640, 1000: 1024}
    assert {d: kernels.kernel_head_dim(d) for d in want} == want
    assert all(kernels.kernel_head_dim(d) in kernels.ATTENTION_HEAD_DIMS
               for d in range(1, 257))
    assert all(kernels.kernel_head_dim(d) % kernels.ATTENTION_CHUNK == 0
               and 0 <= kernels.kernel_head_dim(d) - d < kernels.ATTENTION_CHUNK
               for d in range(257, 2049))
    with pytest.raises(ValueError, match=">= 1"):
        kernels.kernel_head_dim(0)


def _pad(t, w):
    return torch.nn.functional.pad(t, (0, w - t.shape[-1]))


@pytest.mark.parametrize("d", [1, 12, 100, 320])
def test_padded_flash_twin_with_the_heads_scale_is_the_unpadded_one(d):
    """Zero lanes to ``kernel_head_dim(d)`` with the scale of the true d:
    the padded twin's first d lanes are the unpadded twin's within the
    kernels' gate (rtol 1e-5, atol 1e-6: the zero lanes add exact zeros,
    but the sums run in another order), its other lanes 0; both agree
    with the JAX package's ``attention_xla``."""
    rs = np.random.RandomState(d)
    q, k, v = (rs.randn(2, 3, 37, d).astype(np.float32) for _ in range(3))
    w = kernels.kernel_head_dim(d)
    ref = kernels.flash_attention_torch(_t(q), _t(k), _t(v), causal=True)
    got = kernels.flash_attention_torch(*(_pad(_t(a), w) for a in (q, k, v)),
                                        causal=True, scale=1.0 / np.sqrt(d))
    assert tuple(got.shape) == (2, 3, 37, w) and not got[..., d:].any()
    np.testing.assert_allclose(got[..., :d].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[..., :d].numpy(),
                               np.asarray(jpk.attention_xla(q, k, v, True)), **TOL)


@pytest.mark.parametrize("d", [1, 12, 100, 320])
def test_padded_paged_twin_with_the_heads_scale_is_the_unpadded_one(d):
    """Pools allocated at ``kernel_head_dim(d)`` lanes, zero beyond d, q
    padded alike and the scale of the true d: the first d lanes are the
    unpadded twin's (within the kernels' gate, as for flash) and the JAX
    package's ``paged_attention_xla``'s."""
    args = _paged_inputs(d, d=d)
    w = kernels.kernel_head_dim(d)
    q, kp, vp, tables, pos = map(_t, args)
    ref = kernels.paged_attention_torch(q, kp, vp, tables, pos)
    got = kernels.paged_attention(_pad(q, w), _pad(kp, w), _pad(vp, w), tables, pos,
                                  scale=1.0 / np.sqrt(d))
    assert tuple(got.shape) == (4, 2, w) and not got[..., d:].any()
    np.testing.assert_allclose(got[..., :d].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[..., :d].numpy(),
                               np.asarray(jpk.paged_attention_xla(*args)), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_with_head_dim_12_matches_jax(causal):
    """E = 48, 4 heads (D = 12, between the kernels' widths): the layer's
    forward against the JAX layer's."""
    flags = " causal: true rope: true" if causal else ""
    jl, pl = _layers(f'layer {{ name: "attn" type: "MultiHeadAttention" bottom: "x" '
                     f'top: "y" attention_param {{ num_heads: 4{flags} }} }}')
    x = np.random.RandomState(12).randn(2, 23, 48).astype(np.float32)
    jparams, _ = jl.init(jax.random.key(12), [x.shape])
    jy = jl.apply(jparams, {}, [jnp.asarray(x)], train=False).outputs[0]
    y = pl.apply([_t(p) for p in jparams], {}, [_t(x)], train=False).outputs[0]
    assert tuple(y.shape) == (2, 23, 48)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_flash_attention_on_meta_is_shape_only():
    q = torch.empty(2, 3, 5, 8, device="meta")
    o = kernels.flash_attention(q, q, q, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape


def test_kernel_registry_lists_the_attention_sources():
    assert {"flash_attention", "paged_attention"} <= set(kernels.KERNEL_SOURCES)
    for name in kernels.KERNEL_SOURCES:
        assert (kernels.CSRC_DIR / f"{name}.cu").exists()
