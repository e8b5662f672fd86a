"""Flash attention's backward (B3') on the CPU, against the JAX package.

``flash_attention_backward_torch`` (the plain version of the backward
kernel, the formula written out) against ``jax.vjp`` of the JAX package's
``attention_xla`` and of its Pallas ``_flash_diff`` run in interpret mode
(whose VJP is ``_flash_diff_bwd``), and against autograd of the port's own
``flash_attention_torch``; the plain forward's ``lse`` against
``logsumexp`` of the scores.  Inputs are seeded numpy arrays.  Tolerance:
rtol 1e-5 and an absolute 1e-6 of the reference's largest |value| (the
JAX package's float32 sums against the plain backward's float64 ones).
bfloat16 inputs: the port's plain versions upcast first, so their result
is the result on the upcast inputs rounded to bfloat16 (checked bit for
bit against the float32 result cast to bfloat16); against JAX's bfloat16 VJP
they agree within one bfloat16 ulp (the two roundings of values that agree
to 1e-6 may land on either side of a bfloat16 boundary).

``FlashAttentionFunction``, the route a CUDA tensor takes, runs here with
its two launchers replaced by the plain versions (the kernels need the
card): padding to the kernel's width, the true head's scale, the dropped
lanes and the casts are the wrapper's own code.

The backward kernel's order of sums (3xTF32 tensor-core products, k-steps
grouped as its two walks group them) is emulated here against a float64
reference at the card's gates; one TF32 term is shown to miss them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.ops import pallas_kernels as jpk  # noqa: E402

from sparknet_tpu_torch.ops import kernels  # noqa: E402
from test_torch_port_attention import _tf32_matmul  # noqa: E402


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    kernels.reset_launch_counts()
    yield
    assert (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES) == (0, 0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=1e-5, arel=1e-6, err_msg=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max()), err_msg=err_msg)


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]  # q, k, v, g


def _plain_grads(q, k, v, g, causal, dtype=torch.float32):
    tq, tk, tv, tg = (_t(a).to(dtype) for a in (q, k, v, g))
    # o as the kernel route saves it: float32, before the cast to q's type
    o, lse = kernels.flash_attention_forward_lse_torch(tq.float(), tk.float(),
                                                       tv.float(), causal)
    return kernels.flash_attention_backward_torch(tq, tk, tv, o, lse, tg, causal)


CASES = [  # (shape, causal): ragged S (not a multiple of any tile), D 1, 12, 16
    ((2, 3, 37, 16), True), ((2, 3, 37, 16), False),
    ((1, 2, 64, 12), True), ((1, 2, 50, 12), False),
    ((2, 2, 29, 1), True), ((1, 3, 64, 16), True),
    # heads above 256 lanes (the chunked kernels' widths)
    ((1, 2, 37, 320), True), ((1, 1, 50, 512), False),
]


@pytest.mark.parametrize("shape,causal", CASES)
def test_backward_plain_matches_jax_vjp_of_attention_xla(shape, causal):
    q, k, v, g = _inputs(shape, sum(shape) + causal)
    _, vjp = jax.vjp(lambda a, b, c: jpk.attention_xla(a, b, c, causal), q, k, v)
    for got, ref, name in zip(_plain_grads(q, k, v, g, causal), vjp(jnp.asarray(g)),
                              ("dq", "dk", "dv")):
        _close(got.numpy(), ref, err_msg=name)


@pytest.mark.parametrize("shape,causal", CASES[:4])
def test_backward_plain_matches_jax_vjp_of_the_interpret_mode_kernel(shape, causal):
    """The JAX package's differentiable flash path: the Pallas forward (in
    interpret mode) with its custom VJP."""
    q, k, v, g = _inputs(shape, 7 + sum(shape))
    _, vjp = jax.vjp(lambda a, b, c: jpk._flash_diff(a, b, c, causal, True), q, k, v)
    for got, ref, name in zip(_plain_grads(q, k, v, g, causal), vjp(jnp.asarray(g)),
                              ("dq", "dk", "dv")):
        _close(got.numpy(), ref, err_msg=name)


@pytest.mark.parametrize("shape,causal", CASES)
def test_backward_plain_matches_autograd_of_the_plain_forward(shape, causal):
    q, k, v, g = _inputs(shape, 3 + sum(shape))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = kernels.flash_attention_torch(tq, tk, tv, causal)
    refs = torch.autograd.grad(o, (tq, tk, tv), _t(g))
    for got, ref, name in zip(_plain_grads(q, k, v, g, causal), refs, ("dq", "dk", "dv")):
        _close(got.numpy(), ref.numpy(), err_msg=name)


@pytest.mark.parametrize("shape,causal", CASES[:3])
def test_backward_plain_in_bfloat16(shape, causal):
    q, k, v, g = _inputs(shape, 11 + sum(shape))
    got = _plain_grads(q, k, v, g, causal, torch.bfloat16)
    f32 = _plain_grads(*(_t(a).to(torch.bfloat16).float().numpy() for a in (q, k, v, g)),
                       causal)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)]
    _, vjp = jax.vjp(lambda a, b, c: jpk.attention_xla(a, b, c, causal), *bf[:3])
    for a, b, ref, name in zip(got, f32, vjp(bf[3]), ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16)), name
        ref = np.asarray(ref.astype(jnp.float32))
        _, exp = np.frexp(ref)
        ulp = np.ldexp(np.ones_like(ref), exp - 8)  # one bfloat16 ulp
        assert (np.abs(a.float().numpy() - ref) <= ulp).all(), name


@pytest.mark.parametrize("causal", [False, True])
def test_forward_lse_is_the_logsumexp_of_the_scores(causal):
    q, k, v, _ = _inputs((2, 3, 45, 16), 21)
    o, lse = kernels.flash_attention_forward_lse_torch(_t(q), _t(k), _t(v), causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 3, 45)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 4.0
    if causal:
        s = np.where(np.tril(np.ones((45, 45), bool)), s, -np.inf)
    m = s.max(-1)
    np.testing.assert_allclose(lse.numpy(), m + np.log(np.exp(s - m[..., None]).sum(-1)),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(o, kernels.flash_attention_torch(_t(q), _t(k), _t(v), causal))


# -- FlashAttentionFunction, the CUDA route, with plain launchers --------------


@pytest.fixture
def plain_launchers(monkeypatch):
    """The forward and backward launchers replaced by the plain versions at
    the operands' (padded) width and the scale they are given; each call
    is recorded with its operands' width and the padded gradients."""
    calls = []

    def forward(q, k, v, causal, scale, with_lse):
        o, lse = kernels.flash_attention_forward_lse_torch(q, k, v, causal, scale)
        calls.append(("forward", q.shape[-1], with_lse, q.dtype))
        return o, lse if with_lse else None

    def backward(q, k, v, o, lse, g, causal, scale):
        grads = kernels.flash_attention_backward_torch(q, k, v, o, lse, g, causal, scale)
        calls.append(("backward", q.shape[-1], grads))
        return grads

    monkeypatch.setattr(kernels, "_flash_forward_launch", forward)
    monkeypatch.setattr(kernels, "_flash_backward_launch", backward)
    return calls


@pytest.mark.parametrize("d", [12, 16, 200, 320, 512])
def test_cuda_route_pads_slices_and_matches_autograd(d, plain_launchers):
    """Heads of 12, 200 and 320 lanes run at 16, 256 and 384 (the true
    head's scale; 512 as it is); the gradients come back at the head's
    exact shape, equal to autograd of the plain forward, and the padded
    lanes' gradients are exact zeros."""
    q, k, v, g = _inputs((2, 2, 33, d), d)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o = kernels._flash_attention_route(*leaves, True)
    assert tuple(o.shape) == (2, 2, 33, d)
    grads = torch.autograd.grad(o, leaves, _t(g))
    w = kernels.kernel_head_dim(d)
    assert [c[:2] for c in plain_launchers] == [("forward", w), ("backward", w)]
    assert plain_launchers[0][2] is True  # the lse is asked for under autograd
    for padded in plain_launchers[1][2]:
        assert padded.shape[-1] == w and not padded[..., d:].any()
    ref_leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    ref_o = kernels.flash_attention_torch(*ref_leaves, True)
    _close(o.detach().numpy(), ref_o.detach().numpy())
    for got, ref, name in zip(grads, torch.autograd.grad(ref_o, ref_leaves, _t(g)),
                              ("dq", "dk", "dv")):
        assert got.shape == ref.shape
        _close(got.numpy(), ref.numpy(), err_msg=name)


def test_cuda_route_without_grad_writes_no_lse(plain_launchers):
    """Serving (no gradient wanted) launches the forward alone, with no
    lse: the prefill and the rectangle decoder launch what they did."""
    q, k, v, _ = (_t(a) for a in _inputs((1, 2, 20, 16), 5))
    with torch.no_grad():
        kernels._flash_attention_route(q, k, v, True)
    kernels._flash_attention_route(q, k, v, True)  # no leaf wants a gradient
    assert plain_launchers == [("forward", 16, False, torch.float32)] * 2


def test_cuda_route_casts_bfloat16_inputs(plain_launchers):
    """bf16 q, k, v run in float32 (the Pallas body casts each tile): the
    output is the float32 result on the upcast inputs cast back to bf16,
    and the gradients come back in bf16."""
    q, k, v, g = (_t(a).to(torch.bfloat16) for a in _inputs((1, 2, 24, 16), 6))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = kernels._flash_attention_route(*leaves, False)
    assert plain_launchers[0][3] == torch.float32
    assert o.dtype == torch.bfloat16
    assert torch.equal(o, kernels.flash_attention_torch(q.float(), k.float(), v.float())
                       .to(torch.bfloat16))
    grads = torch.autograd.grad(o, leaves, g)
    f32 = _plain_grads(*(t.float().numpy() for t in (q, k, v, g)), False)
    for got, ref in zip(grads, f32):
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref.to(torch.bfloat16))


@pytest.mark.parametrize("fault,match", [
    ("head dim 0", "head dim must be >= 1"),
    ("int64 q", "float32, bfloat16 or float16"),
    ("shapes differ", "one \\[B, H, S, D\\] shape"),
])
def test_flash_wrappers_refuse_what_the_kernels_cannot_take(fault, match):
    """Checked before anything is built or launched, by the forward and
    the backward wrapper alike."""
    q, k, v, g = (_t(a) for a in _inputs((1, 2, 8, 16), 9))
    if fault == "head dim 0":
        q, k, v, g = (t[..., :0] for t in (q, k, v, g))
    elif fault == "int64 q":
        q = q.long()
    else:
        k = k[:, :, :4]
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match=match):
        kernels._flash_attention_cuda(q, k, v, True)
    with pytest.raises(ValueError, match=match):
        kernels._flash_attention_backward_cuda(q, k, v, q, lse, g, True)


def test_backward_wrapper_refuses_mismatched_saved_tensors():
    q, k, v, g = (_t(a) for a in _inputs((1, 2, 8, 16), 10))
    with pytest.raises(ValueError, match="lse"):
        kernels._flash_attention_backward_cuda(q, k, v, q, torch.zeros(1, 2, 7), g, True)
    with pytest.raises(ValueError, match="o and g"):
        kernels._flash_attention_backward_cuda(q, k, v, q, torch.zeros(1, 2, 8), g[..., :4],
                                               True)


# -- the backward kernel's products, emulated ---------------------------------


def _emulated_backward(q, k, v, o, lse, g, causal: bool, terms: int):
    """The kernel's gradients from float32 q, k, v, o, lse and g, each
    product summed by groups of 4 k-steps (32 dims for S and dP, 32 walked
    keys or queries for dQ, dK and dV) as the walks sum them; P = exp(scale
    S - lse) (0 where masked) and dS = P (dP - delta) in float32."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = _tf32_matmul(q, k.transpose(-1, -2), terms, 4)
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        idx = torch.arange(q.shape[2])
        p = torch.where(idx[:, None] >= idx[None, :], p, 0.0)
    dp = _tf32_matmul(g, v.transpose(-1, -2), terms, 4)
    ds = p * (dp - (g * o).sum(-1, keepdim=True))
    dq = _tf32_matmul(ds, k, terms, 4) * scale
    dk = _tf32_matmul(ds.transpose(-1, -2), q, terms, 4) * scale
    dv = _tf32_matmul(p.transpose(-1, -2), g, terms, 4)
    return dq, dk, dv


def _float64_backward(q, k, v, g, causal: bool):
    """(o, lse) rounded to float32, as the forward gives them, and the
    float64 gradients."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    s = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    if causal:
        idx = torch.arange(q.shape[2])
        s = torch.where(idx[:, None] >= idx[None, :], s, -torch.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = p @ v
    ds = p * (g @ v.transpose(-1, -2) - (g * o).sum(-1, keepdim=True))
    scale = 1.0 / np.sqrt(q.shape[-1])
    grads = (ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ g)
    return o.float(), lse.float(), grads


def _emulation_within_gate(n: int, causal: bool, terms: int, d: int = 64):
    """Whether each emulated gradient meets the card's gate against float64
    (rtol 1e-5 and 1e-6 x max|ref| below S = 1024, 1e-4 and 1e-5 from
    there); and each one's largest ratio of error to tolerance.  A head
    above 256 lanes runs chunked (128 lanes a chunk, each chunk's four
    groups of 4 k-steps added in order), which is this same order of sums
    over its dims."""
    rs = np.random.RandomState(n + causal + (d if d != 64 else 0))
    q, k, v, g = (_t(rs.randn(1, 2, n, d).astype(np.float32)) for _ in range(4))
    o, lse, refs = _float64_backward(q, k, v, g, causal)
    rtol, arel = (1e-5, 1e-6) if n < 1024 else (1e-4, 1e-5)
    ratios = []
    for got, ref in zip(_emulated_backward(q, k, v, o, lse, g, causal, terms), refs):
        tol = arel * float(ref.abs().max()) + rtol * ref.abs()
        ratios.append(float(((got.double() - ref).abs() / tol).max()))
    return [r <= 1.0 for r in ratios], ratios


@pytest.mark.parametrize("n,causal,d", [(128, True, 64), (128, False, 64),
                                        (1024, True, 64), (1024, False, 64),
                                        (128, True, 512), (100, False, 320)],
                         ids=["128-True", "128-False", "1024-True", "1024-False",
                              "128-True-d512", "100-False-d320"])
def test_three_tf32_backward_products_meet_the_gate(n, causal, d):
    """The premise of the backward kernel's tensor-core walks: 3xTF32
    products, summed from zero by groups of 4 k-steps, meet the
    flash_backward phase's gates against float64 for dQ, dK and dV, at
    D = 64 and at heads of 512 and 320 lanes (the chunked walks)."""
    oks, ratios = _emulation_within_gate(n, causal, 3, d)
    assert all(oks), dict(zip(("dq", "dk", "dv"), ratios))


def test_one_tf32_backward_term_misses_the_gate():
    """One TF32 product (about 3 decimal digits) misses the same gate for
    every gradient, causal or not, so the gate tells the two designs apart."""
    for causal in (True, False):
        oks, ratios = _emulation_within_gate(128, causal, 1)
        assert not any(oks), dict(zip(("dq", "dk", "dv"), ratios))
