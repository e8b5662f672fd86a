"""Neuron (elementwise) layers.

Counterpart of ``sparknet_tpu/ops/neuron.py`` (ref:
caffe/src/caffe/layers/*_layer.cpp, decls
caffe/include/caffe/neuron_layers.hpp): ReLU, PReLU, Sigmoid, TanH,
AbsVal, BNLL, Dropout, Exp, Log, Power, Threshold and ELU, each the JAX
layer's formula as ATen elementwise work.  Dropout's mask comes from a
``torch.Generator``, so it is not the JAX package's mask for the same seed;
the parity tests compare its statistics, or run at ratio 0.  It is drawn in
canonical blob order, so the same generator gives the same mask under
nchw and nhwc.
"""

from __future__ import annotations

import numpy as np
import torch

from sparknet_tpu_torch.common import get_config
from sparknet_tpu_torch.ops import fillers, layout
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.registry import register


@register
class ReLU(Layer):
    """ref: relu_layer.cpp — supports leaky slope via ``negative_slope``."""

    TYPE = "ReLU"

    def apply(self, params, state, inputs, *, train):
        slope = self.lp.get_msg("relu_param").get_float("negative_slope", 0.0)
        x = inputs[0]
        if slope:
            return LayerOutput([torch.clamp(x, min=0) + slope * torch.clamp(x, max=0)])
        return LayerOutput([torch.relu(x)])


@register
class PReLU(Layer):
    """ref: prelu_layer.cpp — a learned slope a channel (or one shared,
    ``channel_shared``).  Blob: (channels,) or (1,); default filler
    constant 0.25."""

    TYPE = "PReLU"

    def init(self, gen, in_shapes):
        p = self.lp.get_msg("prelu_param")
        shape = in_shapes[0]
        n = 1 if p.get_bool("channel_shared", False) else shape[layout.channel_axis(ndim=len(shape))]
        filler = p.get_msg("filler")
        if not filler.has("type"):
            filler = filler.copy()
            filler.set("type", "constant").set("value", 0.25)
        return [fillers.fill(filler, gen, (n,), get_config().param_dtype)], {}

    def apply(self, params, state, inputs, *, train):
        x = inputs[0]
        a = params[0].to(x.dtype).reshape(layout.channel_bshape(x.dim()))
        return LayerOutput([torch.clamp(x, min=0) + a * torch.clamp(x, max=0)])


@register
class Sigmoid(Layer):
    TYPE = "Sigmoid"

    def apply(self, params, state, inputs, *, train):
        return LayerOutput([torch.sigmoid(inputs[0])])


@register
class TanH(Layer):
    TYPE = "TanH"

    def apply(self, params, state, inputs, *, train):
        return LayerOutput([torch.tanh(inputs[0])])


@register
class AbsVal(Layer):
    TYPE = "AbsVal"

    def apply(self, params, state, inputs, *, train):
        return LayerOutput([torch.abs(inputs[0])])


@register
class BNLL(Layer):
    """y = log(1 + exp(x)) in the JAX layer's stable split,
    max(x, 0) + log1p(exp(-|x|)) (ref: bnll_layer.cpp); not
    ``F.softplus``, which turns into the identity above its threshold."""

    TYPE = "BNLL"

    def apply(self, params, state, inputs, *, train):
        x = inputs[0]
        return LayerOutput([torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))])


@register
class Dropout(Layer):
    """Inverted dropout: in TRAIN each element is kept with probability
    ``keep = 1 - ratio`` and scaled by ``1/keep``; identity at TEST or at
    ratio 0 (ref: dropout_layer.cpp:28-47).  The mask is drawn from the
    ``torch.Generator`` that ``Network.apply`` passes down (``gen``); in
    TRAIN without one the layer raises, as the JAX layer asserts without
    an rng."""

    TYPE = "Dropout"
    NEEDS_GEN = True

    def apply(self, params, state, inputs, *, train, gen=None):
        ratio = self.lp.get_msg("dropout_param").get_float("dropout_ratio", 0.5)
        x = inputs[0]
        if not train or ratio == 0.0 or x.device.type == "meta":
            # (a meta tensor is shape inference in Network.init)
            return LayerOutput([x])
        if gen is None:
            raise ValueError(f"Dropout layer {self.name} needs a generator "
                             "(gen) in train mode")
        keep = 1.0 - ratio
        # drawn in canonical blob order, so one generator drops the same
        # logical activations in both layouts (the JAX layer's rule)
        mask = torch.empty(layout.canonical_shape(x.shape), dtype=torch.float32,
                           device=x.device)
        mask = layout.to_internal(mask.bernoulli_(keep, generator=gen).bool())
        return LayerOutput([torch.where(mask, x / keep, 0.0).to(x.dtype)])


@register
class Exp(Layer):
    """y = base^(scale*x + shift), e^(...) at base -1 (ref: exp_layer.cpp)."""

    TYPE = "Exp"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("exp_param")
        base = p.get_float("base", -1.0)
        x = p.get_float("scale", 1.0) * inputs[0] + p.get_float("shift", 0.0)
        return LayerOutput([torch.exp(x) if base == -1.0 else torch.pow(base, x)])


@register
class Log(Layer):
    """y = log_base(scale*x + shift), the natural log at base -1
    (ref: log_layer.cpp)."""

    TYPE = "Log"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("log_param")
        base = p.get_float("base", -1.0)
        y = torch.log(p.get_float("scale", 1.0) * inputs[0] + p.get_float("shift", 0.0))
        if base != -1.0:
            y = y / float(np.log(np.float32(base)))
        return LayerOutput([y])


@register
class Power(Layer):
    """y = (shift + scale*x)^power (ref: power_layer.cpp)."""

    TYPE = "Power"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("power_param")
        power = p.get_float("power", 1.0)
        y = p.get_float("shift", 0.0) + p.get_float("scale", 1.0) * inputs[0]
        if power != 1.0:
            y = torch.pow(y, power)
        return LayerOutput([y])


@register
class Threshold(Layer):
    """y = (x > threshold), no gradient (ref: threshold_layer.cpp)."""

    TYPE = "Threshold"

    def apply(self, params, state, inputs, *, train):
        t = self.lp.get_msg("threshold_param").get_float("threshold", 0.0)
        x = inputs[0]
        return LayerOutput([(x > t).to(x.dtype)])


@register
class ELU(Layer):
    """y = x if x > 0 else alpha*(exp(x) - 1); kept for later zoo
    prototxts, as the JAX package keeps it."""

    TYPE = "ELU"

    def apply(self, params, state, inputs, *, train):
        alpha = self.lp.get_msg("elu_param").get_float("alpha", 1.0)
        x = inputs[0]
        return LayerOutput([torch.where(x > 0, x, alpha * torch.expm1(x))])
