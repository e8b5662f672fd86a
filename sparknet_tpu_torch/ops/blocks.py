"""Common layers: InnerProduct, BatchNorm, Scale, Bias, Embed, Eltwise,
Split, Flatten, Concat.

Counterpart of ``sparknet_tpu/ops/blocks.py`` (ref:
caffe/include/caffe/common_layers.hpp).  InnerProduct is one ``F.linear``
(cuBLAS on the card), as the JAX package leaves this GEMM to XLA;
BatchNorm, Scale and Bias are ATen elementwise work and reductions, as
they are XLA ops there.  The other common layers are ROADMAP Queue A10.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sparknet_tpu_torch.ops import fillers, layout
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.registry import register


def _canon_axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


@register
class InnerProduct(Layer):
    """Fully connected (ref: inner_product_layer.cpp).  Flattens from
    ``axis`` (default 1, i.e. C*H*W in NCHW order — this ordering is what
    makes .caffemodel FC weights line up).  W blob: (num_output, dim)."""

    TYPE = "InnerProduct"

    def _conf(self):
        p = self.lp.get_msg("inner_product_param")
        return (
            p.get_int("num_output"),
            p.get_int("axis", 1),
            p.get_bool("bias_term", True),
            p.get_msg("weight_filler"),
            p.get_msg("bias_filler"),
        )

    def init(self, gen, in_shapes):
        n_out, axis, bias, wf, bf = self._conf()
        shape = tuple(in_shapes[0])
        dim = int(np.prod(shape[_canon_axis(axis, len(shape)):]))
        params = [fillers.fill(wf, gen, (n_out, dim))]
        if bias:
            params.append(fillers.fill(bf, gen, (n_out,)))
        return params, {}

    def apply(self, params, state, inputs, *, train):
        n_out, axis, bias, _, _ = self._conf()
        x = inputs[0]
        axis = _canon_axis(axis, x.dim())
        lead = tuple(x.shape[:axis])
        flat = x.reshape(-1, int(np.prod(x.shape[axis:])))
        b = params[1].to(x.dtype) if bias else None
        y = F.linear(flat, params[0].to(x.dtype), b)
        return LayerOutput([y.reshape(lead + (n_out,))])


@register
class BatchNorm(Layer):
    """ref: batch_norm_layer.cpp (2015 Caffe: no learnable scale/shift;
    a Scale layer follows).  The mutable blobs ``mean``, ``variance`` and
    ``scale_factor`` are the layer's state: accumulated sums that the
    solver never updates, exported under ``state/<layer>/<k>``.

    The JAX layer's function, not ``F.batch_norm``'s: statistics in
    float32 whatever the input type, the biased variance as E[x^2] -
    E[x]^2 clamped at 0, the sums decayed by ``moving_average_fraction``
    with ``scale_factor`` counting the decayed batches, and global
    statistics the sums over ``scale_factor`` (0 counts as 1).  That test
    stays on the device (``torch.where``), so a forward reads nothing back
    to the host and a CUDA graph can capture it."""

    TYPE = "BatchNorm"

    def init(self, gen, in_shapes):
        shape = in_shapes[0]
        ch = shape[layout.channel_axis(ndim=len(shape))] if len(shape) > 1 else 1
        state = {
            "mean": torch.zeros((ch,), dtype=torch.float32),
            "variance": torch.zeros((ch,), dtype=torch.float32),
            "scale_factor": torch.zeros((1,), dtype=torch.float32),
        }
        return [], state

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("batch_norm_param")
        eps = p.get_float("eps", 1e-5)
        frac = p.get_float("moving_average_fraction", 0.999)
        use_global = p.get_bool("use_global_stats", not train)
        x = inputs[0]
        xf = x.float()
        axes = (0,) + tuple(range(2, x.dim()))
        if use_global:
            sf = state["scale_factor"][0]
            scale = torch.where(sf == 0, torch.ones_like(sf),
                                1.0 / torch.clamp(sf, min=1e-30))
            mean = state["mean"].float() * scale
            var = state["variance"].float() * scale
            new_state = state
        else:
            mean = xf.mean(dim=axes)
            # biased, E[x^2]-E[x]^2 as Caffe; clamped, since the
            # cancellation can dip below zero in float32 on large
            # unnormalised activations
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            new_state = {
                "mean": state["mean"] * frac + mean.to(state["mean"].dtype),
                "variance": state["variance"] * frac + var.to(state["variance"].dtype),
                "scale_factor": state["scale_factor"] * frac + 1.0,
            }
        shape = layout.channel_bshape(x.dim())
        # the same clamp at the use site: restored global stats may carry
        # an unclamped accumulation
        denom = torch.sqrt(torch.clamp(var.reshape(shape), min=0.0) + eps)
        y = ((xf - mean.reshape(shape)) / denom).to(x.dtype)
        return LayerOutput([y], new_state)


def _broadcast_canon(vec: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Broadcast a blob ``vec`` against ``x`` from ``axis`` (Scale/Bias
    semantics): the NCHW branch of the JAX helper."""
    cb = (1,) * axis + tuple(vec.shape) + (1,) * (x.dim() - axis - vec.dim())
    return vec.to(x.dtype).reshape(cb)


def _blob_shape(shape, axis: int, num_axes: int) -> tuple:
    """The shape of a Scale/Bias blob: ``num_axes`` axes of the bottom from
    ``axis`` (-1: to the end)."""
    shape = tuple(shape)
    return shape[axis:] if num_axes == -1 else shape[axis:axis + num_axes]


@register
class Scale(Layer):
    """Scale along ``axis``/``num_axes`` (+ an optional bias); the companion
    of BatchNorm in the later zoo nets (ref: scale_layer.cpp).  With a
    second bottom the scale is that blob, and a learned bias, if any, is
    shaped like it."""

    TYPE = "Scale"

    def _axis(self, ndim: int) -> int:
        return _canon_axis(self.lp.get_msg("scale_param").get_int("axis", 1), ndim)

    def init(self, gen, in_shapes):
        p = self.lp.get_msg("scale_param")
        params = []
        if len(in_shapes) > 1:
            if p.get_bool("bias_term", False):
                params.append(fillers.fill(p.get_msg("bias_filler"), gen,
                                           tuple(in_shapes[1])))
            return params, {}
        shape = _blob_shape(in_shapes[0], self._axis(len(in_shapes[0])),
                            p.get_int("num_axes", 1))
        filler = p.get_msg("filler")
        if not filler.has("type"):
            filler = filler.copy()
            filler.set("type", "constant").set("value", 1.0)
        params.append(fillers.fill(filler, gen, shape))
        if p.get_bool("bias_term", False):
            params.append(fillers.fill(p.get_msg("bias_filler"), gen, shape))
        return params, {}

    def apply(self, params, state, inputs, *, train):
        x = inputs[0]
        axis = self._axis(x.dim())
        if len(inputs) > 1:
            scale, bias = inputs[1], (params[0] if params else None)
        else:
            scale, bias = params[0], (params[1] if len(params) > 1 else None)
        y = x * _broadcast_canon(scale, x, axis)
        if bias is not None:
            y = y + _broadcast_canon(bias, x, axis)
        return LayerOutput([y])


@register
class Bias(Layer):
    """Additive bias along ``axis``/``num_axes``: a learned blob, or the
    second bottom (ref: bias_layer.cpp)."""

    TYPE = "Bias"

    def init(self, gen, in_shapes):
        if len(in_shapes) > 1:
            return [], {}
        p = self.lp.get_msg("bias_param")
        shape0 = tuple(in_shapes[0])
        shape = _blob_shape(shape0, _canon_axis(p.get_int("axis", 1), len(shape0)),
                            p.get_int("num_axes", 1))
        return [fillers.fill(p.get_msg("filler"), gen, shape)], {}

    def apply(self, params, state, inputs, *, train):
        x = inputs[0]
        axis = _canon_axis(self.lp.get_msg("bias_param").get_int("axis", 1), x.dim())
        b = inputs[1] if len(inputs) > 1 else params[0]
        return LayerOutput([x + _broadcast_canon(b, x, axis)])


@register
class Embed(Layer):
    """Embedding lookup (ref: embed_layer.cpp): W blob (input_dim,
    num_output), output shape = input shape + (num_output,).  The indices
    are cast to ``long`` first, as the JAX layer casts them to int32:
    ``Network.init`` propagates shapes with float meta tensors for every
    feed, and ids may arrive as int32 or float."""

    TYPE = "Embed"

    def init(self, gen, in_shapes):
        p = self.lp.get_msg("embed_param")
        shape = (p.get_int("input_dim"), p.get_int("num_output"))
        params = [fillers.fill(p.get_msg("weight_filler"), gen, shape)]
        if p.get_bool("bias_term", True):
            params.append(fillers.fill(p.get_msg("bias_filler"), gen, (shape[1],)))
        return params, {}

    def apply(self, params, state, inputs, *, train):
        y = F.embedding(inputs[0].to(torch.long), params[0])
        if len(params) > 1:
            y = y + params[1]
        return LayerOutput([y])


@register
class Eltwise(Layer):
    """PROD / SUM (with coeffs) / MAX over N bottoms (ref:
    eltwise_layer.cpp), in the JAX layer's order of operations."""

    TYPE = "Eltwise"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("eltwise_param")
        op = p.get_str("operation", "SUM")
        if op == "PROD":
            y = inputs[0]
            for x in inputs[1:]:
                y = y * x
        elif op == "MAX":
            y = inputs[0]
            for x in inputs[1:]:
                y = torch.maximum(y, x)
        else:  # SUM
            coeffs = [float(c) for c in p.get_all("coeff")] or [1.0] * len(inputs)
            if len(coeffs) != len(inputs):
                raise ValueError(
                    f"Eltwise {self.name}: {len(coeffs)} coeffs for {len(inputs)} bottoms")
            y = coeffs[0] * inputs[0]
            for c, x in zip(coeffs[1:], inputs[1:]):
                y = y + c * x
        return LayerOutput([y])


@register
class Concat(Layer):
    """ref: concat_layer.cpp (axis, legacy concat_dim)."""

    TYPE = "Concat"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("concat_param")
        axis = p.get_int("axis", p.get_int("concat_dim", 1))
        ndim = inputs[0].dim()
        axis = layout.internal_axis(_canon_axis(axis, ndim), ndim)
        return LayerOutput([torch.cat(inputs, dim=axis)])


@register
class Split(Layer):
    """Identity fan-out (ref: split_layer.cpp)."""

    TYPE = "Split"

    def apply(self, params, state, inputs, *, train):
        return LayerOutput([inputs[0] for _ in self.tops])


@register
class Flatten(Layer):
    """Flatten axis..end_axis (ref: flatten_layer.cpp)."""

    TYPE = "Flatten"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("flatten_param")
        x = inputs[0]
        axis = _canon_axis(p.get_int("axis", 1), x.dim())
        end = _canon_axis(p.get_int("end_axis", -1), x.dim())
        return LayerOutput([torch.flatten(x, axis, end)])
