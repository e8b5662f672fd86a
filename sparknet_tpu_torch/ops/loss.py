"""Softmax, SoftmaxWithLoss and Accuracy, forward only.

Counterpart of ``sparknet_tpu/ops/loss.py`` (ref:
caffe/include/caffe/loss_layers.hpp).  Scalar tops; the graph executor
applies ``loss_weight``.  The other loss layers are ROADMAP Queue A10.
"""

from __future__ import annotations

import numpy as np
import torch

from sparknet_tpu_torch.ops import layout
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.registry import register

_FLT_MIN = float(np.finfo(np.float32).tiny)


def _axis(axis: int, ndim: int) -> int:
    return layout.internal_axis(axis + ndim if axis < 0 else axis, ndim)


@register
class Softmax(Layer):
    """Plain softmax along ``axis`` (ref: softmax_layer.cpp)."""

    TYPE = "Softmax"

    def apply(self, params, state, inputs, *, train):
        x = inputs[0]
        axis = _axis(self.lp.get_msg("softmax_param").get_int("axis", 1), x.dim())
        return LayerOutput([torch.softmax(x, dim=axis)])


@register
class SoftmaxWithLoss(Layer):
    """ref: softmax_loss_layer.cpp:50-81 — softmax over ``axis`` (default 1),
    NLL with FLT_MIN clipping, optional ignore_label; normalize=true divides
    by the count of non-ignored positions, else by outer_num (batch)."""

    TYPE = "SoftmaxWithLoss"
    IS_LOSS = True

    def apply(self, params, state, inputs, *, train):
        x, label = inputs[0], inputs[1]
        axis = _axis(self.lp.get_msg("softmax_param").get_int("axis", 1), x.dim())
        lp = self.lp.get_msg("loss_param")
        ignore = lp.get_int("ignore_label") if lp.has("ignore_label") else None
        normalize = lp.get_bool("normalize", True)
        prob = torch.softmax(x, dim=axis)
        p_moved = torch.movedim(prob, axis, -1)
        lab = label.to(torch.long).reshape(p_moved.shape[:-1])
        # clamp ignored labels before the gather: they are masked below
        gather_lab = torch.where(lab == ignore, 0, lab) if ignore is not None else lab
        picked = torch.gather(p_moved, -1, gather_lab.unsqueeze(-1)).squeeze(-1)
        nll = -torch.log(torch.clamp(picked, min=_FLT_MIN))
        if ignore is not None:
            valid = (lab != ignore).to(nll.dtype)
            nll = nll * valid
            count = valid.sum()
        else:
            count = torch.tensor(float(nll.numel()), device=nll.device)
        denom = count if normalize else torch.tensor(float(x.shape[0]), device=nll.device)
        loss = nll.sum() / torch.clamp(denom, min=1)
        outs = [loss]
        if len(self.tops) > 1:
            outs.append(prob)
        return LayerOutput(outs)


@register
class Accuracy(Layer):
    """Top-k accuracy over the label axis, with ignore_label
    (ref: accuracy_layer.cpp).  Evaluation-only; never contributes loss."""

    TYPE = "Accuracy"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("accuracy_param")
        top_k = p.get_int("top_k", 1)
        ignore = p.get_int("ignore_label") if p.has("ignore_label") else None
        x, label = inputs[0], inputs[1]
        scores = torch.movedim(x, _axis(p.get_int("axis", 1), x.dim()), -1)
        lab = label.to(torch.long).reshape(scores.shape[:-1])
        gather_lab = torch.where(lab == ignore, 0, lab) if ignore is not None else lab
        true_score = torch.gather(scores, -1, gather_lab.unsqueeze(-1))
        # rank of true class = #classes strictly greater (ties count as
        # correct, matching Caffe's ">=" comparison scanning in index order)
        higher = (scores > true_score).sum(dim=-1)
        correct = (higher < top_k).to(torch.float32)
        if ignore is not None:
            valid = (lab != ignore).to(torch.float32)
            return LayerOutput([(correct * valid).sum() / torch.clamp(valid.sum(), min=1)])
        return LayerOutput([correct.mean()])
