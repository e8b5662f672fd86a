"""Neuron (elementwise) layers: ReLU and Dropout.

Counterpart of ``sparknet_tpu/ops/neuron.py`` (ref:
caffe/src/caffe/layers/relu_layer.cpp, dropout_layer.cpp).  The other
neuron layers are ROADMAP Queue A10.  Dropout's mask comes from a
``torch.Generator``, so it is not the JAX package's mask for the same seed;
the parity tests compare its statistics, or run at ratio 0.
"""

from __future__ import annotations

import torch

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
        mask = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        mask = mask.bernoulli_(keep, generator=gen).bool()
        return LayerOutput([torch.where(mask, x / keep, 0.0).to(x.dtype)])
