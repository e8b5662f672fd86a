"""Common layers: InnerProduct, Embed, Eltwise, Split, Flatten, Concat.

Counterpart of ``sparknet_tpu/ops/blocks.py`` (ref:
caffe/include/caffe/common_layers.hpp).  InnerProduct is one ``F.linear``
(cuBLAS on the card), as the JAX package leaves this GEMM to XLA.  The
other common layers are ROADMAP Queue A10.
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
