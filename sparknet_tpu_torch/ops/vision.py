"""Vision layers: Convolution, Deconvolution, Pooling, LRN, Im2col, SPP.

Counterpart of ``sparknet_tpu/ops/vision.py``.  Convolution goes to
``F.conv2d`` and Deconvolution to ``F.conv_transpose2d`` (cuDNN on the
card), as the JAX package leaves both to XLA.  Pooling keeps Caffe's
ceil-mode shapes and, for AVE, Caffe's padded-divisor rule, which differs
from ``F.avg_pool2d``'s at the edges; STOCHASTIC pooling samples a window
position with ``F.unfold`` patches.  Cross-channel LRN runs the
hand-written kernel (``ops/kernels.py``).

Under ``Config.layout`` nhwc the activations are (N, H, W, C): each
convolution and pool runs on ``layout.nchw_view`` of its input, a
channels-last view on which cuDNN and ATen take their NHWC kernels, and
``layout.internal_view`` of the result; the LRN kernel takes the NHWC
tensor itself.  Weights stay OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparknet_tpu_torch import quant
from sparknet_tpu_torch.common import get_config
from sparknet_tpu_torch.ops import fillers, layout
from sparknet_tpu_torch.ops.base import (
    Layer,
    LayerOutput,
    conv_out_dim,
    hw_param,
    pool_out_dim,
)
from sparknet_tpu_torch.ops.kernels import lrn_across_channels
from sparknet_tpu_torch.ops.registry import register


@register
class Convolution(Layer):
    """ref: caffe/src/caffe/layers/conv_layer.cpp + base_conv_layer.cpp.

    Supports kernel/stride/pad (square or _h/_w), group, dilation, bias_term.
    Weight blob OIHW = (num_output, in_channels/group, kh, kw); bias (num_output,).
    """

    TYPE = "Convolution"

    def _conf(self):
        p = self.lp.get_msg("convolution_param")
        return dict(
            num_output=p.get_int("num_output"),
            group=p.get_int("group", 1),
            dilation=p.get_int("dilation", 1),
            bias=p.get_bool("bias_term", True),
            kernel=hw_param(p, "kernel"),
            stride=hw_param(p, "stride", default=1),
            pad=hw_param(p, "pad", default=0),
            weight_filler=p.get_msg("weight_filler"),
            bias_filler=p.get_msg("bias_filler"),
        )

    def init(self, gen, in_shapes):
        c = self._conf()
        ch = in_shapes[0][layout.channel_axis(ndim=len(in_shapes[0]))]
        if ch % c["group"]:
            raise ValueError(f"{self.name}: channels {ch} not divisible by "
                             f"group {c['group']}")
        wshape = (c["num_output"], ch // c["group"], *c["kernel"])
        dtype = get_config().param_dtype
        params = [fillers.fill(c["weight_filler"], gen, wshape, dtype)]
        if c["bias"]:
            params.append(fillers.fill(c["bias_filler"], gen, (c["num_output"],), dtype))
        return params, {}

    def apply(self, params, state, inputs, *, train):
        c = self._conf()
        x = inputs[0]
        xv = layout.nchw_view(x)
        if not train:
            # the int8 deploy path: only inside quant.quantized_inference and
            # only for calibrated layers
            q = quant.layer_qparams(self.name)
            if q is not None:
                d = c["dilation"]
                ch_ax = layout.channel_axis(ndim=x.dim())
                y = quant.int8_conv(xv, q, stride=c["stride"], padding=c["pad"],
                                    dilation=(d, d), groups=c["group"],
                                    out_channel_axis=ch_ax)
                if c["bias"]:
                    y = y + params[1].to(y.dtype).reshape(layout.channel_bshape(4))
                return LayerOutput([y.to(x.dtype)])
        bias = params[1].to(x.dtype) if c["bias"] else None
        y = F.conv2d(xv, params[0].to(x.dtype), bias, stride=c["stride"],
                     padding=c["pad"], dilation=c["dilation"], groups=c["group"])
        return LayerOutput([layout.internal_view(y)])


@register
class Deconvolution(Convolution):
    """Transposed convolution (ref: caffe/src/caffe/layers/deconv_layer.cpp).

    Caffe's weight blob is (in_channels, num_output/group, kh, kw), which
    is ``F.conv_transpose2d``'s layout; out = stride*(in-1) + dil*(k-1)+1 -
    2*pad.  (The JAX layer computes it as a forward convolution of the
    stride-dilated input with the flipped, regrouped weight: the same
    function, summed in another order.)"""

    TYPE = "Deconvolution"

    def init(self, gen, in_shapes):
        c = self._conf()
        ch = in_shapes[0][layout.channel_axis(ndim=len(in_shapes[0]))]
        wshape = (ch, c["num_output"] // c["group"], *c["kernel"])
        dtype = get_config().param_dtype
        params = [fillers.fill(c["weight_filler"], gen, wshape, dtype)]
        if c["bias"]:
            params.append(fillers.fill(c["bias_filler"], gen, (c["num_output"],), dtype))
        return params, {}

    def apply(self, params, state, inputs, *, train):
        c = self._conf()
        x = inputs[0]
        bias = params[1].to(x.dtype) if c["bias"] else None
        y = F.conv_transpose2d(layout.nchw_view(x), params[0].to(x.dtype), bias,
                               stride=c["stride"], padding=c["pad"],
                               groups=c["group"], dilation=c["dilation"])
        return LayerOutput([layout.internal_view(y)])


_AVE_DIVISORS: dict = {}


def _ave_pool_divisor(h: int, w: int, kh: int, kw: int, sh: int, sw: int, ph: int, pw: int,
                      device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Caffe AVE-pool divisor: window size measured in *padded* coordinates,
    clipped at (H+pad, W+pad) — includes padding on the leading edge
    (ref: pooling_layer.cpp Forward_cpu AVE branch).

    Built on ``device`` (small integers, exact in any float type), so a
    forward copies nothing from the host, which a CUDA graph capture would
    refuse; and cached per geometry, device and type, so a forward after
    the first launches nothing for it.  The cached tensor is made outside
    inference mode (autograd saves it for the backward, and an inference
    tensor cannot be saved) and, on the card, only outside a capture (a
    tensor made in a capture is written only when the graph replays) and
    after its stream has finished writing it (another stream may read it
    next)."""
    key = (h, w, kh, kw, sh, sw, ph, pw, device, dtype)
    div = _AVE_DIVISORS.get(key)
    if div is not None:
        return div
    oh = pool_out_dim(h, kh, ph, sh)
    ow = pool_out_dim(w, kw, pw, sw)
    with torch.inference_mode(False):
        hs = torch.arange(oh, device=device) * sh - ph
        ws = torch.arange(ow, device=device) * sw - pw
        hlen = torch.clamp(hs + kh, max=h + ph) - hs
        wlen = torch.clamp(ws + kw, max=w + pw) - ws
        div = torch.outer(hlen, wlen).to(dtype)
    if div.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            return div
        torch.cuda.current_stream(device).synchronize()
    _AVE_DIVISORS[key] = div
    return div


def _pool_pads(x, kernel, stride, pad):
    """(left, right, top, bottom) padding for ``F.pad`` (``x`` NCHW-shaped:
    the pools below take ``layout.nchw_view`` of an activation) that makes an
    unpadded floor-mode window over the padded map give Caffe's ceil-mode
    output: ``pad`` on the leading edges, enough on the trailing edges for
    the last ceil-mode window."""
    h, w = x.shape[2], x.shape[3]
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    oh = pool_out_dim(h, kh, ph, sh)
    ow = pool_out_dim(w, kw, pw, sw)
    extra_h = max(0, (oh - 1) * sh + kh - h - ph)
    extra_w = max(0, (ow - 1) * sw + kw - w - pw)
    return (pw, extra_w, ph, extra_h)


def caffe_avg_pool(x, kernel, stride, pad):
    """Average pooling with Caffe's ceil shapes and padded-divisor rule:
    a window sum over the zero-padded map divided by ``_ave_pool_divisor``."""
    summed = F.avg_pool2d(F.pad(x, _pool_pads(x, kernel, stride, pad)),
                          kernel, stride, divisor_override=1)
    return summed / _ave_pool_divisor(x.shape[2], x.shape[3], *kernel, *stride, *pad,
                                      x.device, x.dtype)


def caffe_max_pool(x, kernel, stride, pad):
    """Max pooling with Caffe's ceil shapes: the padding never wins."""
    xp = F.pad(x, _pool_pads(x, kernel, stride, pad), value=float("-inf"))
    return F.max_pool2d(xp, kernel, stride)


def _pool_patches(x, kernel, stride):
    """Window patches with Caffe's ceil-mode output dims, (N, C, kh*kw, oh,
    ow).  Windows that overhang the trailing edge read zeros, which carry
    no activation mass (the reference's hstart/hend clipping)."""
    h, w = x.shape[2], x.shape[3]
    (kh, kw), (sh, sw) = kernel, stride
    oh = pool_out_dim(h, kh, 0, sh)
    ow = pool_out_dim(w, kw, 0, sw)
    xp = F.pad(x, (0, max(0, (ow - 1) * sw + kw - w), 0, max(0, (oh - 1) * sh + kh - h)))
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))
    return patches.reshape(x.shape[0], x.shape[1], kh * kw, oh, ow)


def caffe_stochastic_pool(x, kernel, stride, *, train, gen=None, uniforms=None):
    """Stochastic pooling (ref: pooling_layer.cu:83-160 StoPoolForwardTrain/
    Test; Zeiler & Fergus 2013), the JAX function.  TRAIN: one uniform u a
    window; the output is the first window position whose running sum
    reaches u * the window's sum, and the gradient goes to that element
    alone (StoPoolBackward's index routing).  The uniforms come from
    ``gen``, or are given (``uniforms``, shaped like the output: the parity
    tests inject JAX's draws).  TEST: sum(a^2)/sum(a), 0 for a zero
    window.  Assumes non-negative activations, as the reference does."""
    patches = _pool_patches(x, kernel, stride)
    total = patches.sum(dim=2)
    if not train:
        sq = (patches * patches).sum(dim=2)
        pos = total > 0
        return torch.where(pos, sq / torch.where(pos, total, torch.ones_like(total)),
                           torch.zeros_like(total)).to(x.dtype)
    if uniforms is None:
        if x.device.type == "meta":  # shape inference in Network.init
            uniforms = torch.empty(total.shape, device="meta")
        elif gen is None:
            raise ValueError("stochastic pooling needs a generator (gen) in train mode")
        else:
            uniforms = torch.rand(total.shape, generator=gen, device=x.device)
    thres = uniforms.to(patches.dtype) * total
    reached = (torch.cumsum(patches, dim=2) >= thres.unsqueeze(2)).to(torch.uint8)
    idx = torch.argmax(reached, dim=2, keepdim=True)  # the first position reached
    return torch.gather(patches, 2, idx).squeeze(2).to(x.dtype)


@register
class Pooling(Layer):
    """MAX / AVE / STOCHASTIC pooling with Caffe ceil-mode shapes;
    ``global_pooling`` collapses the spatial dims (ref:
    caffe/src/caffe/layers/pooling_layer.cpp, pooling_layer.cu).
    STOCHASTIC draws its uniforms from the ``gen`` that ``Network.apply``
    passes down, and raises without one in TRAIN; they are drawn in
    canonical (N, C, oh, ow) order in both layouts, so one generator picks
    the same window positions under nchw and nhwc."""

    TYPE = "Pooling"
    NEEDS_GEN = True

    def _conf(self, in_shape):
        """(method, kernel, stride, pad) for an internal ``in_shape``."""
        p = self.lp.get_msg("pooling_param")
        if p.get_bool("global_pooling", False):
            ha, wa = layout.spatial_axes()
            kernel = (in_shape[ha], in_shape[wa])
            stride, pad = (1, 1), (0, 0)
        else:
            kernel = hw_param(p, "kernel")
            stride = hw_param(p, "stride", default=1)
            pad = hw_param(p, "pad", default=0)
        return p.get_str("pool", "MAX"), kernel, stride, pad

    def apply(self, params, state, inputs, *, train, gen=None):
        method, kernel, stride, pad = self._conf(inputs[0].shape)
        x = layout.nchw_view(inputs[0])
        if method == "AVE":
            y = caffe_avg_pool(x, kernel, stride, pad)
        elif method == "MAX":
            y = caffe_max_pool(x, kernel, stride, pad)
        elif method == "STOCHASTIC":
            if pad != (0, 0):
                # the reference CHECKs this in LayerSetUp: padding is
                # implemented only for AVE and MAX (pooling_layer.cpp)
                raise ValueError(f"{self.name}: STOCHASTIC pooling does not support pad")
            y = caffe_stochastic_pool(x, kernel, stride, train=train, gen=gen)
        else:
            raise ValueError(f"{self.name}: unknown pool method {method!r}")
        return LayerOutput([layout.internal_view(y)])


@register
class LRN(Layer):
    """Local response normalization (ref: caffe/src/caffe/layers/lrn_layer.cpp).

    ACROSS_CHANNELS: y = x / (k + alpha/n * sum_{window n} x^2)^beta, through
    the CUDA kernel on the card (``ops/kernels.lrn_across_channels``), its
    NCHW or its NHWC form as ``Config.layout`` gives the channel axis.
    WITHIN_CHANNEL:  y = x * (1 + alpha * avepool_{n x n}(x^2))^(-beta), in
    plain PyTorch (the AVE pool uses pad=(n-1)/2 and Caffe's padded divisor).
    """

    TYPE = "LRN"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("lrn_param")
        size = p.get_int("local_size", 5)
        if size % 2 == 0:
            # Caffe CHECKs local_size is odd (lrn_layer.cpp LayerSetUp)
            raise ValueError(f"{self.name}: LRN local_size must be odd, got {size}")
        alpha = p.get_float("alpha", 1.0)
        beta = p.get_float("beta", 0.75)
        k = p.get_float("k", 1.0)
        region = p.get_str("norm_region", "ACROSS_CHANNELS")
        x = inputs[0]
        if region == "WITHIN_CHANNEL":
            pre_pad = (size - 1) // 2
            pooled = layout.internal_view(caffe_avg_pool(
                layout.nchw_view(x * x), (size, size), (1, 1), (pre_pad, pre_pad)))
            return LayerOutput([x * torch.pow(1.0 + alpha * pooled, -beta)])
        if x.dim() == 4 and layout.is_nhwc():
            return LayerOutput([lrn_across_channels(x, size, alpha, beta, k, channel_axis=3)])
        return LayerOutput([lrn_across_channels(x, size, alpha, beta, k)])


@register
class Im2col(Layer):
    """im2col as a layer (ref: caffe/src/caffe/layers/im2col_layer.cpp):
    (N, C*kh*kw, OH, OW) with the channel slowest, ``F.unfold``'s order."""

    TYPE = "Im2col"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("convolution_param")
        kh, kw = hw_param(p, "kernel")
        sh, sw = hw_param(p, "stride", default=1)
        ph, pw = hw_param(p, "pad", default=0)
        x = inputs[0]
        if layout.is_nhwc():
            # the output's (C*kh*kw, OH, OW) blob order is the layer's
            # contract, as in the JAX layer: run it under nchw
            raise ValueError(
                f"{self.name}: Im2col is a Caffe-parity layer with a "
                "canonical-NCHW output contract; run under layout=nchw")
        n, c, h, w = x.shape
        oh = conv_out_dim(h, kh, ph, sh)
        ow = conv_out_dim(w, kw, pw, sw)
        cols = F.unfold(x, (kh, kw), padding=(ph, pw), stride=(sh, sw))
        return LayerOutput([cols.reshape(n, c * kh * kw, oh, ow)])


@register
class SPP(Layer):
    """Spatial pyramid pooling (ref: caffe/src/caffe/layers/spp_layer.cpp):
    MAX or AVE pools into 2^l x 2^l bins at levels l < ``pyramid_height``,
    each flattened, all concatenated."""

    TYPE = "SPP"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("spp_param")
        pool = caffe_avg_pool if p.get_str("pool", "MAX") == "AVE" else caffe_max_pool
        # pooled on the NCHW-shaped view, each level flattens in canonical
        # (C, bins, bins) order in both layouts, as in the JAX layer
        x = layout.nchw_view(inputs[0])
        n, h, w = x.shape[0], x.shape[2], x.shape[3]
        outs = []
        for level in range(p.get_int("pyramid_height", 3)):
            bins = 2**level
            kh, kw = -(-h // bins), -(-w // bins)
            pad = ((kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2)
            outs.append(pool(x, (kh, kw), (kh, kw), pad).reshape(n, -1))
        return LayerOutput([torch.cat(outs, dim=1)])
