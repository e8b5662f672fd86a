"""In-graph mixture-of-experts FFN: the expert-parallel layer type.

Counterpart of ``sparknet_tpu/ops/moe.py``.  Prototxt surface::

    layer {
      name: "moe" type: "MoE" bottom: "x" top: "y"
      moe_param { num_experts: 8 hidden_dim: 256 }
    }

Input/output blobs are [..., D].  Top-1 (switch) gating: each token is
processed by its argmax expert, scaled by that expert's softmax gate
probability.  Params in Caffe blob order: [W_gate (E, D), W1 (E, H, D),
b1 (E, H), W2 (E, D, H), b2 (E, D)], the JAX layer's, so the weights bridge
(``interop.py``) maps them one to one.  The distributed dispatch lives in
``parallel/expert.py``; this layer is the dense form of the same math.

Expert parallelism by layout: every blob is expert-major, so under a
model axis a ``ParallelTrainer`` gives each model rank E/m whole experts
(``parallel/sharding.py``) and opens :func:`model_parallel` around its
steps.  The layer then computes its own experts' dense outputs; the gate
logits are gathered over the model group before the softmax and argmax
(the gather's backward keeps this rank's columns), the input enters
through Megatron's f (its gradient summed over the group) and the combine
is an all-reduce sum over the group, which is exact: one nonzero term and
zeros.  JAX gets the same from GSPMD partitioning the expert-batched
einsums.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.common import get_config
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.fillers import fill
from sparknet_tpu_torch.ops.registry import register
from sparknet_tpu_torch.proto.text_format import Message

_MP = threading.local()


@contextlib.contextmanager
def model_parallel(mesh):
    """Let MoE layers that hold a model rank's slice of their experts reach
    ``mesh``'s model group while the context is open."""
    prev = getattr(_MP, "mesh", None)
    _MP.mesh = mesh
    try:
        yield
    finally:
        _MP.mesh = prev


def active_model_parallel():
    """The open context's model group (a ``collectives.Comm``), or None."""
    mesh = getattr(_MP, "mesh", None)
    return None if mesh is None else mesh.comm(get_config().model_axis)


def gate_top1(w_gate: torch.Tensor, x: torch.Tensor):
    """Softmax gate -> (expert index, gate probability) per token.
    ``x``: [T, D] tokens; returns ([T] int64, [T] float)."""
    return _top1(x @ w_gate.T)


def _top1(logits: torch.Tensor):
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    return idx, torch.gather(probs, 1, idx[:, None])[:, 0]


def expert_ffn(params_e, x: torch.Tensor) -> torch.Tensor:
    """One expert's FFN on its tokens: ReLU(x W1^T + b1) W2^T + b2.
    ``params_e``: (W1 [H, D], b1 [H], W2 [D, H], b2 [D]); ``x``: [T, D]."""
    w1, b1, w2, b2 = params_e
    return F.relu(x @ w1.T + b1) @ w2.T + b2


def _experts_dense(w1, b1, w2, b2, x: torch.Tensor) -> torch.Tensor:
    """[E, T, D]: every expert of the stack on every token."""
    h = F.relu(torch.einsum("td,ehd->eth", x, w1) + b1[:, None, :])
    return torch.einsum("eth,edh->etd", h, w2) + b2[:, None, :]


def moe_dense(params, x: torch.Tensor) -> torch.Tensor:
    """Dense top-1 MoE on [T, D] tokens: every expert computes every token,
    a one-hot combine keeps the chosen one.  The oracle for the
    expert-parallel dispatch, and the layer's compute."""
    w_gate, w1, b1, w2, b2 = params
    idx, prob = gate_top1(w_gate, x)
    y_all = _experts_dense(w1, b1, w2, b2, x)
    onehot = F.one_hot(idx, w1.shape[0]).to(x.dtype)  # [T, E]
    return torch.einsum("etd,te->td", y_all, onehot) * prob[:, None]


def moe_model_parallel(params, x: torch.Tensor, comm) -> torch.Tensor:
    """:func:`moe_dense` with this model rank's E/m experts (``params``:
    their slices, rank r holding experts r*E/m ... (r+1)*E/m - 1) over the
    model group ``comm``; every rank passes the same tokens and gets the
    whole output."""
    from sparknet_tpu_torch.parallel.collectives import all_gather, copy_to, reduce_from

    w_gate, w1, b1, w2, b2 = params
    e_l = w1.shape[0]
    x = copy_to(x, comm)
    logits = all_gather(x @ w_gate.T, 1, comm, grad="slice")  # [T, E]
    idx, prob = _top1(logits)
    y_mine = _experts_dense(w1, b1, w2, b2, x)
    onehot = F.one_hot(idx, logits.shape[1]).to(x.dtype)[:, comm.rank * e_l:(comm.rank + 1) * e_l]
    part = torch.einsum("etd,te->td", y_mine, onehot)
    return reduce_from(part, comm) * prob[:, None]


@register
class MoELayer(Layer):
    TYPE = "MoE"

    def __init__(self, lp, phase):
        super().__init__(lp, phase)
        p = lp.get_msg("moe_param")
        self.num_experts = p.get_int("num_experts", 1)
        self.hidden_dim = p.get_int("hidden_dim", 0)
        self.weight_filler = (p.get_msg("weight_filler") if p.has("weight_filler")
                              else Message().set("type", "xavier"))

    def init(self, gen, in_shapes):
        d = in_shapes[0][-1]
        h = self.hidden_dim or 4 * d
        e = self.num_experts
        w_gate = fill(self.weight_filler, gen, (e, d))
        w1 = fill(self.weight_filler, gen, (e, h, d))
        w2 = fill(self.weight_filler, gen, (e, d, h))
        return [w_gate, w1, torch.zeros(e, h), w2, torch.zeros(e, d)], {}

    def apply(self, params, state, inputs, *, train):
        x = inputs[0]
        tokens = x.reshape(-1, x.shape[-1])
        held = params[1].shape[0]
        if held == self.num_experts:
            y = moe_dense(params, tokens)
        else:
            comm = active_model_parallel()
            if comm is None or held * comm.size != self.num_experts:
                raise ValueError(
                    f"MoE layer {self.name!r} holds {held} of its {self.num_experts} "
                    "experts, which needs an open model_parallel context over a model "
                    f"axis of {self.num_experts // max(held, 1)} (ParallelTrainer opens it)")
            y = moe_model_parallel(params, tokens, comm)
        return LayerOutput([y.reshape(x.shape)])
