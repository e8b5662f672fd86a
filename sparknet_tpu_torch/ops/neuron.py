"""Neuron (elementwise) layers: ReLU and Dropout.

Counterpart of ``sparknet_tpu/ops/neuron.py`` (ref:
caffe/src/caffe/layers/relu_layer.cpp, dropout_layer.cpp).  The other
neuron layers are ROADMAP Queue A10.
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
    """Inverted dropout: identity at TEST (ref: dropout_layer.cpp:28-47).
    The TRAIN-phase mask comes with the training path (ROADMAP Queue A5)."""

    TYPE = "Dropout"

    def apply(self, params, state, inputs, *, train):
        ratio = self.lp.get_msg("dropout_param").get_float("dropout_ratio", 0.5)
        if train and ratio != 0.0:
            raise NotImplementedError(
                f"{self.name}: TRAIN-phase dropout is not ported yet "
                "(ROADMAP Queue A5)")
        return LayerOutput([inputs[0]])
