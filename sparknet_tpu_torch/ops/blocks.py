"""Common layers: InnerProduct, BatchNorm, Scale, Bias, Embed, Eltwise,
Concat, Slice, Split, Flatten, Reshape, Tile, ArgMax, BatchReindex,
Reduction, MVN, Silence and Filter.

Counterpart of ``sparknet_tpu/ops/blocks.py`` (ref:
caffe/include/caffe/common_layers.hpp).  InnerProduct is one ``F.linear``
(cuBLAS on the card), as the JAX package leaves this GEMM to XLA; the
others are ATen elementwise work, reductions, gathers and views, as they
are XLA ops there.

Layer parameters (axis, num_axes, blob dims) speak canonical NCHW blob
coordinates in both layouts (``ops/layout.py``): under nhwc a rank-4
bottom is read through ``layout.canonical_shape``, ``internal_axis`` or a
canonicalizing view where the layer's element order is canonical.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sparknet_tpu_torch import quant
from sparknet_tpu_torch.common import f32_precision, get_config
from sparknet_tpu_torch.ops import fillers, layout
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.registry import register


def _canon_axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


def _nhwc4(x) -> bool:
    return x.dim() == 4 and layout.is_nhwc()


@register
class InnerProduct(Layer):
    """Fully connected (ref: inner_product_layer.cpp).  Flattens from
    ``axis`` (default 1, i.e. C*H*W in NCHW order — this ordering is what
    makes .caffemodel FC weights line up).  W blob: (num_output, dim).

    Under nhwc a rank-4 bottom is flattened in canonical order (its
    ``layout.from_internal`` view, which the flatten copies), so the same
    weight bytes make the same product in both layouts.  (The JAX layer
    lowers this boundary as a full-map VALID convolution: the same
    function; the port's flatten is the NCHW path's own product.)"""

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
        shape = layout.canonical_shape(in_shapes[0])
        dim = int(np.prod(shape[_canon_axis(axis, len(shape)):]))
        dtype = get_config().param_dtype
        params = [fillers.fill(wf, gen, (n_out, dim), dtype)]
        if bias:
            params.append(fillers.fill(bf, gen, (n_out,), dtype))
        return params, {}

    def apply(self, params, state, inputs, *, train):
        n_out, axis, bias, _, _ = self._conf()
        x = inputs[0]
        if _nhwc4(x):
            x = layout.from_internal(x)
        axis = _canon_axis(axis, x.dim())
        lead = tuple(x.shape[:axis])
        flat = x.reshape(-1, int(np.prod(x.shape[axis:])))
        if not train:
            # the int8 deploy path (quant.py), as in Convolution
            q = quant.layer_qparams(self.name)
            if q is not None:
                y = quant.int8_matmul(flat, q)
                if bias:
                    y = y + params[1].to(y.dtype)
                return LayerOutput([y.to(x.dtype).reshape(lead + (n_out,))])
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
        dtype = get_config().param_dtype
        state = {
            "mean": torch.zeros((ch,), dtype=dtype),
            "variance": torch.zeros((ch,), dtype=dtype),
            "scale_factor": torch.zeros((1,), dtype=dtype),
        }
        return [], state

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("batch_norm_param")
        eps = p.get_float("eps", 1e-5)
        frac = p.get_float("moving_average_fraction", 0.999)
        use_global = p.get_bool("use_global_stats", not train)
        x = inputs[0]
        xf = x.float()
        # every axis but the channels'
        axes = (0, 1, 2) if _nhwc4(x) else (0,) + tuple(range(2, x.dim()))
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
    """Broadcast a canonical-ordered blob ``vec`` against internal ``x``
    from canonical ``axis`` (Scale/Bias semantics), the JAX helper: under
    nhwc on a rank-4 ``x`` the broadcast shape is permuted (and the small
    blob permuted when it spans more than one non-unit canonical axis),
    so the same blob scales the same logical elements in both layouts."""
    cb = (1,) * axis + tuple(vec.shape) + (1,) * (x.dim() - axis - vec.dim())
    v = vec.to(x.dtype).reshape(cb)
    if _nhwc4(x):
        if sum(int(d) > 1 for d in cb[1:]) > 1:
            v = v.permute(0, 2, 3, 1)
        else:
            v = v.reshape((cb[0], cb[2], cb[3], cb[1]))
    return v


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
        dtype = get_config().param_dtype
        params = []
        if len(in_shapes) > 1:
            if p.get_bool("bias_term", False):
                params.append(fillers.fill(p.get_msg("bias_filler"), gen,
                                           tuple(in_shapes[1]), dtype))
            return params, {}
        shape = _blob_shape(layout.canonical_shape(in_shapes[0]),
                            self._axis(len(in_shapes[0])), p.get_int("num_axes", 1))
        filler = p.get_msg("filler")
        if not filler.has("type"):
            filler = filler.copy()
            filler.set("type", "constant").set("value", 1.0)
        params.append(fillers.fill(filler, gen, shape, dtype))
        if p.get_bool("bias_term", False):
            params.append(fillers.fill(p.get_msg("bias_filler"), gen, shape, dtype))
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
        shape0 = layout.canonical_shape(in_shapes[0])
        shape = _blob_shape(shape0, _canon_axis(p.get_int("axis", 1), len(shape0)),
                            p.get_int("num_axes", 1))
        return [fillers.fill(p.get_msg("filler"), gen, shape, get_config().param_dtype)], {}

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
        dtype = get_config().param_dtype
        params = [fillers.fill(p.get_msg("weight_filler"), gen, shape, dtype)]
        if p.get_bool("bias_term", True):
            params.append(fillers.fill(p.get_msg("bias_filler"), gen, (shape[1],), dtype))
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
        if _nhwc4(x) and end > axis:
            # the flattened blob's element order is canonical C-major (what
            # downstream fc weights index): a 1x1 map keeps it as it lies,
            # any other pays one canonicalizing copy
            if x.shape[1] == 1 and x.shape[2] == 1:
                x = x.reshape(x.shape[0], x.shape[3], 1, 1)
            else:
                x = layout.from_internal(x)
        return LayerOutput([torch.flatten(x, axis, end)])


@register
class Slice(Layer):
    """ref: slice_layer.cpp — cut at ``slice_point``s, or into #tops equal
    parts, along ``axis`` (legacy ``slice_dim``)."""

    TYPE = "Slice"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("slice_param")
        x = inputs[0]
        axis = layout.internal_axis(
            _canon_axis(p.get_int("axis", p.get_int("slice_dim", 1)), x.dim()), x.dim())
        points = [int(s) for s in p.get_all("slice_point")]
        if not points:
            size = x.shape[axis] // len(self.tops)
            points = [size * i for i in range(1, len(self.tops))]
        return LayerOutput(list(torch.tensor_split(x, points, dim=axis)))


@register
class Reshape(Layer):
    """ref: reshape_layer.cpp — dims 0 (copy the bottom's) and -1 (infer),
    over the axes ``axis`` .. ``axis + num_axes`` (-1: to the end)."""

    TYPE = "Reshape"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("reshape_param")
        dims = [int(d) for d in p.get_msg("shape").get_all("dim")]
        x = inputs[0]
        nhwc4 = _nhwc4(x)
        if nhwc4:
            # reshape dims speak canonical blob order: canonicalize in, and
            # turn a still-4-D result back to the internal orientation
            x = layout.from_internal(x)
        axis = _canon_axis(p.get_int("axis", 0), x.dim())
        num_axes = p.get_int("num_axes", -1)
        end = x.dim() if num_axes == -1 else axis + num_axes
        shape = tuple(x.shape)
        head, mid_in, tail = shape[:axis], shape[axis:end], shape[end:]
        out_mid = [mid_in[i] if d == 0 else d for i, d in enumerate(dims)]
        if -1 in out_mid:
            known = int(np.prod([d for d in out_mid if d != -1]))
            total = int(np.prod(mid_in)) if mid_in else 1
            out_mid[out_mid.index(-1)] = total // max(known, 1)
        y = x.reshape(head + tuple(out_mid) + tail)
        return LayerOutput([layout.to_internal(y) if nhwc4 else y])


@register
class Tile(Layer):
    """ref: tile_layer.cpp — ``tiles`` copies along ``axis``."""

    TYPE = "Tile"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("tile_param")
        x = inputs[0]
        reps = [1] * x.dim()
        reps[layout.internal_axis(_canon_axis(p.get_int("axis", 1), x.dim()),
                                  x.dim())] = p.get_int("tiles")
        return LayerOutput([x.repeat(reps)])


@register
class ArgMax(Layer):
    """ref: argmax_layer.cpp — a sample's ``top_k`` over its flattened
    non-batch dims: (N, 1, top_k) indices, or (N, 2, top_k) indices and
    values with ``out_max_val``.  Ties go to the lower index, as
    ``jax.lax.top_k`` puts them: a stable descending sort, since
    ``torch.topk`` on CUDA promises no order among ties.  The indices come
    out in the input's type, as JAX's do (exact below 2^24 elements a
    sample in float32)."""

    TYPE = "ArgMax"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("argmax_param")
        top_k = p.get_int("top_k", 1)
        x = inputs[0]
        if _nhwc4(x):
            # the indices address the canonical C*H*W flatten
            x = layout.from_internal(x)
        flat = x.reshape(x.shape[0], -1)
        vals, idxs = torch.sort(flat, dim=1, descending=True, stable=True)
        vals, idxs = vals[:, :top_k], idxs[:, :top_k].to(x.dtype)
        if p.get_bool("out_max_val", False):
            return LayerOutput([torch.stack([idxs, vals], dim=1)])
        return LayerOutput([idxs[:, None, :]])


def reindex_backward(g: torch.Tensor, index: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of ``x[index]`` (``x`` of ``rows`` rows) w.r.t. ``x``:
    the rows of ``g`` summed by index as one matrix product in full
    float32, one_hot(index)^T @ g.  A fixed order with no atomics and no
    host read, so its bits repeat from run to run and a CUDA graph can
    capture it.  A non-finite row of ``g``, times the zeros of the other
    rows, makes NaN down its columns."""
    pick = F.one_hot(index, rows).T.to(g.dtype)
    with f32_precision():
        gx = pick @ g.reshape(g.shape[0], -1)
    return gx.reshape((rows,) + tuple(g.shape[1:]))


class _Reindex(torch.autograd.Function):
    """x[index] along the batch axis, with :func:`reindex_backward`."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return reindex_backward(g, index, ctx.rows), None


@register
class BatchReindex(Layer):
    """output = x[permutation] (ref: batch_reindex_layer.cpp)."""

    TYPE = "BatchReindex"

    def apply(self, params, state, inputs, *, train):
        return LayerOutput([_Reindex.apply(inputs[0], inputs[1].reshape(-1).to(torch.long))])


@register
class Reduction(Layer):
    """SUM / ASUM / SUMSQ / MEAN over the tail dims from ``axis``, times
    ``coeff`` (ref: reduction_layer.cpp)."""

    TYPE = "Reduction"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("reduction_param")
        op = p.get_str("operation", "SUM")
        x = inputs[0]
        if _nhwc4(x):
            # the tail flatten is canonical (the kept head axes are not
            # permutation-invariant)
            x = layout.from_internal(x)
        axis = _canon_axis(p.get_int("axis", 0), x.dim())
        flat = x.reshape(tuple(x.shape[:axis]) + (-1,)) if axis < x.dim() else x[..., None]
        if op == "ASUM":
            y = torch.sum(torch.abs(flat), dim=-1)
        elif op == "SUMSQ":
            y = torch.sum(flat * flat, dim=-1)
        elif op == "MEAN":
            y = torch.mean(flat, dim=-1)
        else:
            y = torch.sum(flat, dim=-1)
        return LayerOutput([p.get_float("coeff", 1.0) * y])


@register
class MVN(Layer):
    """Mean-variance normalization a sample (ref: mvn_layer.cpp), per
    channel or ``across_channels``; eps is added to the standard
    deviation, not to the variance."""

    TYPE = "MVN"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("mvn_param")
        x = inputs[0]
        across = p.get_bool("across_channels", False)
        if _nhwc4(x) and not across:
            dims: tuple = layout.spatial_axes()  # per-channel moments
        else:
            dims = tuple(range(1 if across else 2, x.dim()))
        y = x - torch.mean(x, dim=dims, keepdim=True)
        if p.get_bool("normalize_variance", True):
            std = torch.sqrt(torch.mean(torch.square(y), dim=dims, keepdim=True))
            y = y / (std + p.get_float("eps", 1e-9))
        return LayerOutput([y])


@register
class Silence(Layer):
    """Consumes its bottoms, produces nothing (ref: silence_layer.cpp)."""

    TYPE = "Silence"

    def apply(self, params, state, inputs, *, train):
        return LayerOutput([])


@register
class Filter(Layer):
    """ref: filter_layer.cpp — the items whose selector (the last bottom) is
    nonzero.  The port computes the JAX package's jitted function on every
    path: the filtered items are zeroed and the batch keeps its size.  (The
    JAX layer gathers when it runs eagerly; a gather would need
    ``nonzero``, a host sync, which a CUDA graph cannot capture.)"""

    TYPE = "Filter"

    def apply(self, params, state, inputs, *, train):
        *data, selector = inputs
        mask = (selector.reshape(selector.shape[0]) != 0).to(data[0].dtype)
        return LayerOutput([x * mask.reshape((-1,) + (1,) * (x.dim() - 1)) for x in data])
