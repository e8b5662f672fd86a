"""The port's attention slice on the CPU, against the JAX package.

RoPE, ``MultiHeadAttention``, ``Embed`` and ``Eltwise``, and the plain
versions of the two attention kernels (``flash_attention_torch``,
``paged_attention_torch``) against the JAX kernels run in Pallas interpret
mode and against their XLA versions.  Inputs are seeded numpy arrays
handed to both packages; layer weights come from the JAX layer's ``init``.
Tolerances: 1e-5 (rtol and atol) for the attention cores and layers
(float32, the sums taken in another order); ``rope_at`` against the port's
own ``rope`` is bit for bit.  On the CPU the wrappers take the plain
versions, so no kernel launch is counted.
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
                                          ((1, 2, 256, 32), True)])
def test_flash_attention_plain_matches_jax_kernel_and_xla(shape, causal):
    rs = np.random.RandomState(sum(shape))
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    got = kernels.flash_attention(_t(q), _t(k), _t(v), causal).numpy()
    np.testing.assert_array_equal(
        got, kernels.flash_attention_torch(_t(q), _t(k), _t(v), causal).numpy())
    interp = jpk.flash_attention(q, k, v, causal=causal, force="interpret")
    np.testing.assert_allclose(got, np.asarray(interp), **TOL)
    np.testing.assert_allclose(got, np.asarray(jpk.attention_xla(q, k, v, causal)), **TOL)


def _paged_inputs(seed, b=4, h=2, d=16, t=4, mb=5):
    """Pools full of finite garbage (1e4) except each row's live lines;
    rows own ceil((pos + 1) / T) blocks, the rest of a table is the null
    block 0."""
    rs = np.random.RandomState(seed)
    nb = 1 + b * mb
    k_pool = ((rs.rand(nb, t, h, d) * 2 - 1) * 1e4).astype(np.float32)
    v_pool = ((rs.rand(nb, t, h, d) * 2 - 1) * 1e4).astype(np.float32)
    positions = np.array([0, t - 1, t, mb * t - 1][:b], np.int32)
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


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_attention_plain_matches_jax_kernel_and_xla(seed):
    args = _paged_inputs(seed)
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


def test_flash_attention_on_meta_is_shape_only():
    q = torch.empty(2, 3, 5, 8, device="meta")
    o = kernels.flash_attention(q, q, q, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape


def test_kernel_registry_lists_the_attention_sources():
    assert {"flash_attention", "paged_attention"} <= set(kernels.KERNEL_SOURCES)
    for name in kernels.KERNEL_SOURCES:
        assert (kernels.CSRC_DIR / f"{name}.cu").exists()
