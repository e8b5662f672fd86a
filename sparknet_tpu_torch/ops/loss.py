"""Loss and evaluation layers: Softmax, the eight Caffe losses and
Accuracy.

Counterpart of ``sparknet_tpu/ops/loss.py`` (ref:
caffe/include/caffe/loss_layers.hpp, caffe/src/caffe/layers/*_loss_layer.cpp).
Scalar tops; the graph executor applies ``loss_weight``, and autograd
replaces every hand-written Backward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sparknet_tpu_torch.ops import layout
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.registry import register

_FLT_MIN = float(np.finfo(np.float32).tiny)
_LOG_THRESHOLD = 1e-20  # ref: loss layers clip probabilities at kLOG_THRESHOLD


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


class _LossBase(Layer):
    IS_LOSS = True

    def _loss_param(self):
        lp = self.lp.get_msg("loss_param")
        ignore = lp.get_int("ignore_label") if lp.has("ignore_label") else None
        return ignore, lp.get_bool("normalize", True)


@register
class SoftmaxWithLoss(_LossBase):
    """ref: softmax_loss_layer.cpp:50-81 — softmax over ``axis`` (default 1),
    NLL with FLT_MIN clipping, optional ignore_label; normalize=true divides
    by the count of non-ignored positions, else by outer_num (batch)."""

    TYPE = "SoftmaxWithLoss"

    def apply(self, params, state, inputs, *, train):
        x, label = inputs[0], inputs[1]
        axis = _axis(self.lp.get_msg("softmax_param").get_int("axis", 1), x.dim())
        ignore, normalize = self._loss_param()
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


def _labels(label: torch.Tensor, n: int) -> torch.Tensor:
    """A label blob as (N,) indices (the JAX layers' int32 cast)."""
    return label.reshape(n).to(torch.long)


@register
class EuclideanLoss(_LossBase):
    """0.5/N * sum((a-b)^2) (ref: euclidean_loss_layer.cpp)."""

    TYPE = "EuclideanLoss"

    def apply(self, params, state, inputs, *, train):
        a, b = inputs[0], inputs[1]
        return LayerOutput([torch.sum(torch.square(a - b)) / (2.0 * a.shape[0])])


@register
class HingeLoss(_LossBase):
    """ref: hinge_loss_layer.cpp — v_nk = x_nk (k != y), -x_ny (k == y);
    loss = sum max(0, 1+v)^p / N with p 1 or 2 (norm L1/L2)."""

    TYPE = "HingeLoss"

    def apply(self, params, state, inputs, *, train):
        norm = self.lp.get_msg("hinge_loss_param").get_str("norm", "L1")
        x = inputs[0]
        n = x.shape[0]
        flat = x.reshape(n, -1)
        onehot = F.one_hot(_labels(inputs[1], n), flat.shape[1]).to(flat.dtype)
        margins = torch.clamp(1.0 + flat * (1.0 - 2.0 * onehot), min=0.0)
        if norm == "L2":
            return LayerOutput([torch.sum(margins * margins) / n])
        return LayerOutput([torch.sum(margins) / n])


@register
class MultinomialLogisticLoss(_LossBase):
    """The bottom is already probabilities (ref:
    multinomial_logistic_loss_layer.cpp): -1/N sum log(max(p[y],
    kLOG_THRESHOLD))."""

    TYPE = "MultinomialLogisticLoss"

    def apply(self, params, state, inputs, *, train):
        p = inputs[0]
        n = p.shape[0]
        picked = torch.gather(p.reshape(n, -1), 1, _labels(inputs[1], n)[:, None])[:, 0]
        return LayerOutput([-torch.sum(torch.log(torch.clamp(picked, min=_LOG_THRESHOLD))) / n])


@register
class InfogainLoss(_LossBase):
    """ref: infogain_loss_layer.cpp — loss = -1/N sum_k H[y,k] log(p_k).
    H is the third bottom, else the ``.binaryproto`` BlobProto named by
    ``infogain_loss_param.source`` (read once), else the identity, as the
    JAX layer takes it without a third bottom."""

    TYPE = "InfogainLoss"

    def __init__(self, lp, phase):
        super().__init__(lp, phase)
        self._h_file: np.ndarray | None = None

    def _matrix(self, inputs, k: int, like: torch.Tensor) -> torch.Tensor:
        if len(inputs) > 2:
            return inputs[2].reshape(k, k)
        source = self.lp.get_msg("infogain_loss_param").get_str("source", "")
        if not source:
            return torch.eye(k, dtype=like.dtype, device=like.device)
        if self._h_file is None:
            from sparknet_tpu_torch.data.io_utils import blobproto_to_array

            with open(source, "rb") as f:
                self._h_file = np.array(blobproto_to_array(f.read()), np.float32)
        if self._h_file.size != k * k:
            raise ValueError(f"{self.name}: infogain matrix {source!r} holds "
                             f"{self._h_file.size} values, want {k}x{k}")
        return torch.from_numpy(self._h_file.reshape(k, k)).to(like.device, like.dtype)

    def apply(self, params, state, inputs, *, train):
        p = inputs[0]
        n = p.shape[0]
        flat = p.reshape(n, -1)
        h = self._matrix(inputs, flat.shape[1], flat)
        logp = torch.log(torch.clamp(flat, min=_LOG_THRESHOLD))
        rows = h[_labels(inputs[1], n)]  # (N, K)
        return LayerOutput([-torch.sum(rows * logp) / n])


@register
class SigmoidCrossEntropyLoss(_LossBase):
    """Elementwise cross-entropy on logits in the stable form, summed and
    divided by the batch size, not the element count (ref:
    sigmoid_cross_entropy_loss_layer.cpp)."""

    TYPE = "SigmoidCrossEntropyLoss"

    def apply(self, params, state, inputs, *, train):
        x, t = inputs[0], inputs[1]
        loss = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
        return LayerOutput([torch.sum(loss) / x.shape[0]])


@register
class ContrastiveLoss(_LossBase):
    """ref: contrastive_loss_layer.cpp:30-62 — d2 = ||a-b||^2; a similar
    pair adds d2, a dissimilar one max(margin - d, 0)^2 (``legacy_version``:
    max(margin - d2, 0)); loss = sum / (2N)."""

    TYPE = "ContrastiveLoss"

    def apply(self, params, state, inputs, *, train):
        p = self.lp.get_msg("contrastive_loss_param")
        margin = p.get_float("margin", 1.0)
        a, b, y = inputs[0], inputs[1], inputs[2]
        n = a.shape[0]
        d2 = torch.sum(torch.square(a.reshape(n, -1) - b.reshape(n, -1)), dim=1)
        sim = y.reshape(n).to(d2.dtype)
        if p.get_bool("legacy_version", False):
            dis = torch.clamp(margin - d2, min=0.0)
        else:
            # the JAX layer's safe square root: sqrt's gradient at 0 is
            # inf, and the outer max does not mask it (margin - 0 > 0),
            # so equal embeddings of a dissimilar pair would make NaN
            pos = d2 > 0.0
            d = torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))) * pos
            dis = torch.square(torch.clamp(margin - d, min=0.0))
        return LayerOutput([torch.sum(sim * d2 + (1.0 - sim) * dis) / (2.0 * n)])


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
