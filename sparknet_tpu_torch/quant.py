"""Post-training int8 quantization for the inference path.

Counterpart of ``sparknet_tpu/quant.py``, with its scheme:

- **Weights**: symmetric per-output-channel int8 (``absmax / 127``),
  quantized once offline.
- **Activations**: symmetric per-tensor int8, the scale calibrated from a
  few representative batches (the absmax of each quantized layer's input
  blob over the calibration stream).
- **Compute**: int8 x int8 -> int32 sums, then dequantize and add the bias
  in float32.

Usage::

    qstate = calibrate(net, variables, feeds_iter)      # offline, once
    with quantized_inference(qstate):
        blobs, _, _ = net.apply(variables, feeds, train=False)  # int8 conv/fc

The context is thread-local and read when ``Convolution.apply`` and
``InnerProduct.apply`` run (``ops/vision.py``, ``ops/blocks.py``), so a
CUDA graph records the int8 path only when it is captured inside the
``with`` on the capturing thread (``serve/engine.py``'s ``int8`` arm).
Training is untouched, and a layer without a record runs in float.

The int32 products.  In the JAX package they are XLA's integer convolution
and dot (``preferred_element_type=int32``), not Pallas kernels.  Here a
convolution is im2col (:func:`im2col_int8`) and one matrix product; grouped
convolutions (CaffeNet's group 2, MobileNet's depthwise layers) multiply
against a block-diagonal weight, whose zeros add nothing to an integer sum.
On a CUDA tensor the product is ``torch._int_mm`` (cuBLAS's int8 GEMM with
int32 sums), which wants more than 16 rows and a K and N that are
multiples of 8: the operands are zero-padded to that, which is exact in
integers.  On a CPU tensor it is the plain int32 product
(:func:`int_matmul_torch`).  Every sum is an exact integer either way, so
the int32 results are bit for bit the JAX package's.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

from sparknet_tpu_torch.ops import kernels

_ACTIVE = threading.local()

_QINT_MAX = 127.0  # symmetric int8, -127..127 (-128 unused)


def quantize_weight(w: torch.Tensor, channel_axis: int = 0):
    """Symmetric per-channel int8: ``(w_q int8, scale float32)`` with
    ``scale`` shaped to broadcast along ``channel_axis``."""
    w = w.detach().float()
    dims = tuple(a for a in range(w.dim()) if a != channel_axis)
    absmax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / _QINT_MAX
    w_q = torch.clamp(torch.round(w / scale), -_QINT_MAX, _QINT_MAX).to(torch.int8)
    return w_q, scale


def quantize_activation(x: torch.Tensor, scale) -> torch.Tensor:
    """Per-tensor symmetric int8 with a calibrated scale (a float32
    scalar); rounding is half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(x.float() / float(scale)),
                       -_QINT_MAX, _QINT_MAX).to(torch.int8)


@contextlib.contextmanager
def quantized_inference(qstate: dict):
    """Activate ``qstate`` (layer name -> quant record) on this thread for
    the forwards run inside the block."""
    prev = getattr(_ACTIVE, "qstate", None)
    _ACTIVE.qstate = qstate
    try:
        yield
    finally:
        _ACTIVE.qstate = prev


def layer_qparams(name: str):
    """The active quant record for layer ``name``, or None (float path)."""
    qstate = getattr(_ACTIVE, "qstate", None)
    return qstate.get(name) if qstate else None


def calibrate(net, variables, feeds_iter, *, num_batches: int = 4,
              layer_types: tuple = ("Convolution", "InnerProduct")) -> dict:
    """The quant state: per-layer int8 weights and activation scales.

    ``feeds_iter``: an iterable of feed dicts (a handful of representative
    batches).  A layer's activation scale is the absmax of its INPUT blob
    over the stream, read from the finished forward's blobs (Caffe nets
    run in-place activations right after their producer, so that is what
    the consumer saw).  The weight's channel axis is 0 for Convolution
    (OIHW) and InnerProduct ((num_output, dim)).  A weight shared by name
    (``param { name: ... }``) is read through its owner
    (``Network.layer_params``), as the JAX package resolves
    ``param_aliases``; a layer whose input is all zeros stays in float.
    ``x_scale`` is ``np.float32(absmax / 127)`` with ``absmax`` a Python
    float, the JAX package's arithmetic."""

    def _weight(layer):
        return net.layer_params(layer.name, variables.params)[0]

    targets = [
        l for l in net.layers
        if getattr(l, "TYPE", "") in layer_types
        and variables.params.get(l.name)
        and _weight(l).numel()
    ]
    absmax = {l.name: 0.0 for l in targets}
    n = 0
    with torch.no_grad():
        for feeds in feeds_iter:
            blobs, _, _ = net.apply(variables, feeds, train=False)
            for l in targets:
                bottom = l.bottoms[0]
                src = feeds.get(bottom) if bottom in feeds else blobs.get(bottom)
                if src is None:
                    continue
                peak = torch.as_tensor(src).abs().max()
                absmax[l.name] = max(absmax[l.name], float(peak))
            n += 1
            if n >= num_batches:
                break
    if n == 0:
        raise ValueError("calibrate() needs at least one feed batch")

    qstate: dict = {}
    for l in targets:
        if absmax[l.name] <= 0.0:
            continue  # dead input: leave the layer in float
        w_q, w_scale = quantize_weight(_weight(l), channel_axis=0)
        qstate[l.name] = {
            "w_q": w_q,
            "w_scale": w_scale,
            "x_scale": np.float32(absmax[l.name] / _QINT_MAX),
        }
    return qstate


def int_matmul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain int32 product of int8 ``a`` [M, K] and ``b`` [K, N]."""
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def _pad_to(t: torch.Tensor, dim: int, multiple: int, least: int = 0) -> torch.Tensor:
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, least)
    if want == n:
        return t
    pad = [0, 0] * t.dim()
    pad[2 * (t.dim() - 1 - dim) + 1] = want - n
    return F.pad(t, pad)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] times int8 ``b`` [K, N] -> int32 [M, N], exact.

    CUDA tensors: one ``torch._int_mm``, on operands zero-padded to more
    than 16 rows and to K and N multiples of 8 (its limits), the padding
    cut from the result; counted in ``kernels.INT_MM_LAUNCHES`` (a library
    call, not one of the port's kernels, counted the same way so that a
    run can show its int8 path went through it).  CPU tensors:
    :func:`int_matmul_torch`."""
    # K zero-padded on both sides alike (a prepared weight matrix already is)
    a, b = _pad_to(a, 1, 8), _pad_to(b, 0, 8)
    if a.device.type == "cpu":
        return int_matmul_torch(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int_matmul: unsupported device {a.device}")
    m, n = a.shape[0], b.shape[1]
    a_p = _pad_to(a, 0, 1, least=17)
    b_p = _pad_to(b, 1, 8)
    out = torch._int_mm(a_p.contiguous(), b_p.contiguous())
    kernels._count("INT_MM_LAUNCHES")
    return out[:m, :n]


def _block_diagonal(w_q: torch.Tensor, groups: int) -> torch.Tensor:
    """OIHW int8 weight of a (grouped) convolution -> the matrix that
    multiplies im2col rows ordered (C, kh, kw): each group's [K_g,
    O / groups] block on the diagonal, zeros elsewhere, the K rows and O
    columns zero-padded to multiples of 8 (``torch._int_mm``'s limits), so
    a product needs no copy of it."""
    o = w_q.shape[0]
    og = o // groups
    kg = w_q[0].numel()
    cols = w_q.reshape(o, kg).t()  # [K_g, O]
    out = torch.zeros((_up8(groups * kg), _up8(o)), dtype=w_q.dtype, device=w_q.device)
    for g in range(groups):
        out[g * kg:(g + 1) * kg, g * og:(g + 1) * og] = cols[:, g * og:(g + 1) * og]
    return out


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def im2col_int8(x_q: torch.Tensor, kernel, *, stride, padding, dilation):
    """int8 NCHW ``x_q`` -> the [rows, K] int8 im2col matrix of a
    convolution (a row an output position in (N, oh, ow) order, a column
    in (C, kh, kw) order) and ``(n, oh, ow)``.  One int8 copy out of
    ``Tensor.unfold`` views (``F.unfold`` takes floating types only); K
    is zero-padded to a multiple of 8 and the rows to more than 16
    (``torch._int_mm``'s limits; zeros add nothing to an integer sum)."""
    n, c, h, w = x_q.shape
    kh, kw = kernel
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    xp = F.pad(x_q, (pw, pw, ph, ph)) if ph or pw else x_q
    v = xp.unfold(2, dh * (kh - 1) + 1, sh).unfold(3, dw * (kw - 1) + 1, sw)
    if dh > 1 or dw > 1:
        v = v[..., ::dh, ::dw]
    _, _, oh, ow, _, _ = v.shape
    m, k = n * oh * ow, c * kh * kw
    rows, cols = max(m, 17), _up8(k)
    make = torch.empty if (rows, cols) == (m, k) else torch.zeros
    a = make((rows, cols), dtype=torch.int8, device=x_q.device)
    a[:m, :k].view(n, oh, ow, c, kh, kw).copy_(v.permute(0, 2, 3, 1, 4, 5))
    return a, (n, oh, ow)


def _conv_rows(x_q, w_q, *, stride, padding, dilation, groups, w_mat):
    """The int32 sums of an int8 convolution as [N*oh*ow, O] (a view) and
    ``(n, oh, ow)``."""
    a, (n, oh, ow) = im2col_int8(x_q, w_q.shape[2:], stride=stride, padding=padding,
                                 dilation=dilation)
    if w_mat is None:
        w_mat = _block_diagonal(w_q, groups)
    y = int_matmul(a, w_mat)
    return y[:n * oh * ow, :w_q.shape[0]], (n, oh, ow)


def conv_int32(x_q: torch.Tensor, w_q: torch.Tensor, *, stride, padding,
               dilation, groups: int, w_mat: torch.Tensor | None = None) -> torch.Tensor:
    """The int32 sums of an int8 NCHW convolution (OIHW weight), contiguous
    NCHW: :func:`im2col_int8`, then :func:`int_matmul` against the
    (block-diagonal for groups > 1) weight matrix (``w_mat`` when made
    already, :func:`prepare`)."""
    y, (n, oh, ow) = _conv_rows(x_q, w_q, stride=stride, padding=padding,
                                dilation=dilation, groups=groups, w_mat=w_mat)
    return y.reshape(n, oh, ow, -1).permute(0, 3, 1, 2).contiguous()


def int8_conv(x: torch.Tensor, q: dict, *, stride, padding, dilation,
              groups: int, out_channel_axis: int = 1) -> torch.Tensor:
    """int8 x int8 -> int32 convolution + float32 dequant: the JAX
    ``int8_conv`` (``q["w_scale"]`` is (Cout, 1, 1, 1); weights are OIHW in
    both layouts).  ``x`` is NCHW-shaped (under nhwc the activation's
    ``layout.nchw_view``); ``out_channel_axis`` says where the output
    channels sit in the internal orientation.  3 (nhwc): the sums come out
    (N, oh, ow, O), which the dequant's product writes as they lie.  1
    (nchw): the product writes the contiguous NCHW output, as a
    convolution returns (channels-last sums would be refused by the NCHW
    LRN kernel)."""
    x_q = quantize_activation(x, q["x_scale"])
    y, (n, oh, ow) = _conv_rows(x_q, q["w_q"], stride=stride, padding=padding,
                                dilation=dilation, groups=groups, w_mat=q.get("w_mat"))
    o = q["w_q"].shape[0]
    scale = q["w_scale"].reshape(-1) * float(q["x_scale"])
    if out_channel_axis == 3:
        return y.reshape(n, oh, ow, o) * scale[None, None, None, :]
    out = torch.empty((n, o, oh, ow), dtype=torch.float32, device=x.device)
    return torch.mul(y.reshape(n, oh, ow, o).permute(0, 3, 1, 2),
                     scale[None, :, None, None], out=out)


def int8_matmul(flat: torch.Tensor, q: dict) -> torch.Tensor:
    """int8 x int8 -> int32 ``flat @ W.T`` + float32 dequant (InnerProduct;
    W is (num_output, dim), scale (num_output, 1))."""
    x_q = quantize_activation(flat, q["x_scale"])
    w_t = q.get("w_mat")
    o = q["w_q"].shape[0]
    y = int_matmul(x_q, q["w_q"].t() if w_t is None else w_t)[:, :o]
    scale = q["w_scale"].reshape(-1) * float(q["x_scale"])
    return y.float() * scale[None, :]


def prepare(qstate: dict, net) -> dict:
    """``qstate`` with each record's weight matrix made once (``w_mat``:
    the block-diagonal im2col matrix of a convolution, the transposed
    weight of an InnerProduct, both zero-padded to multiples of 8), so a
    forward does not rebuild it; the records' other entries are
    unchanged."""
    out = {}
    for name, rec in qstate.items():
        layer = next(l for l in net.layers if l.name == name)
        if layer.TYPE == "Convolution":
            groups = layer.lp.get_msg("convolution_param").get_int("group", 1)
            w_mat = _block_diagonal(rec["w_q"], groups)
        else:
            w_mat = _pad_to(_pad_to(rec["w_q"].t(), 0, 8), 1, 8).contiguous()
        out[name] = {**rec, "w_mat": w_mat}
    return out


def resident_bytes(net, params: dict,
                   layer_types: tuple = ("Convolution", "InnerProduct")) -> int:
    """The device bytes :func:`calibrate` and :func:`prepare` add at most
    for ``net`` with ``params``: for each layer :func:`calibrate` may
    quantize, its int8 weight (``w_q``), its float32 per-channel scales
    and its product matrix (``w_mat``).  A grouped convolution's matrix is
    block-diagonal, ``groups`` times its int8 weight (9·C² bytes for a 3x3
    depthwise layer of C channels).  Sized from the weights' shapes alone;
    the engine's ``int8`` arm prices it on top of the f32 row."""
    total = 0
    for l in net.layers:
        if getattr(l, "TYPE", "") not in layer_types or not params.get(l.name):
            continue
        w = net.layer_params(l.name, params)[0]
        if not w.numel():
            continue
        o, kg = w.shape[0], w[0].numel()
        groups = (l.lp.get_msg("convolution_param").get_int("group", 1)
                  if l.TYPE == "Convolution" else 1)
        total += w.numel() + 4 * o + _up8(groups * kg) * _up8(o)
    return total
