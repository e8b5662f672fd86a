"""The model zoo's builders, rebuilt with the layer DSL, and the cached
decode builders of the transformer families.

Copy of the net builders of ``sparknet_tpu/models/zoo.py`` the serving
and training paths need (ref: caffe/examples/mnist/lenet_train_test.prototxt,
caffe/examples/cifar10/cifar10_{quick,full}_train_test.prototxt,
caffe/models/bvlc_alexnet/train_val.prototxt,
caffe/models/bvlc_reference_caffenet/train_val.prototxt), plus the
sequence models ``transformer`` and ``charlm`` (no reference analog).
Architectures are the published ones; data enters through RDD layers and
batch is a builder argument.  The ``*_solver()`` recipes are the
published solver.prototxt settings of each; the other families are
ROADMAP Queue A10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.common import f32_precision
from sparknet_tpu_torch.layers_dsl import (
    AccuracyLayer,
    ConvolutionLayer,
    DropoutLayer,
    EltwiseLayer,
    EmbedLayer,
    InnerProductLayer,
    LRNLayer,
    MultiHeadAttentionLayer,
    NetParam,
    Pooling,
    PoolingLayer,
    RDDLayer,
    ReLULayer,
    SoftmaxWithLoss,
    _filler,
)
from sparknet_tpu_torch.proto.text_format import Message
from sparknet_tpu_torch.solvers.solver import SolverConfig


def _gauss(std: float) -> Message:
    return _filler("gaussian", std=std)


def _const(v: float) -> Message:
    return _filler("constant", value=v)


# ---------------------------------------------------------------------------
# LeNet (ref: caffe/examples/mnist/lenet_train_test.prototxt)
# ---------------------------------------------------------------------------
def lenet(batch: int = 64, num_classes: int = 10) -> Message:
    return NetParam(
        "LeNet",
        RDDLayer("data", shape=[batch, 1, 28, 28]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(5, 5), num_output=20),
        PoolingLayer("pool1", ["conv1"], Pooling.Max, kernel=(2, 2), stride=(2, 2)),
        ConvolutionLayer("conv2", ["pool1"], kernel=(5, 5), num_output=50),
        PoolingLayer("pool2", ["conv2"], Pooling.Max, kernel=(2, 2), stride=(2, 2)),
        InnerProductLayer("ip1", ["pool2"], num_output=500),
        ReLULayer("relu1", ["ip1"], in_place=True),
        InnerProductLayer("ip2", ["ip1"], num_output=num_classes),
        SoftmaxWithLoss("loss", ["ip2", "label"]),
        AccuracyLayer("accuracy", ["ip2", "label"], phase="TEST"),
    )


def lenet_solver() -> SolverConfig:
    """ref: caffe/examples/mnist/lenet_solver.prototxt."""
    return SolverConfig(
        base_lr=0.01, lr_policy="inv", gamma=1e-4, power=0.75,
        momentum=0.9, weight_decay=5e-4, max_iter=10000,
        solver_type="SGD", display=100,
    )


# ---------------------------------------------------------------------------
# CIFAR-10 quick (ref: caffe/examples/cifar10/cifar10_quick_train_test.prototxt)
# ---------------------------------------------------------------------------
def cifar10_quick(batch: int = 100, num_classes: int = 10) -> Message:
    return NetParam(
        "CIFAR10_quick",
        RDDLayer("data", shape=[batch, 3, 32, 32]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(5, 5), num_output=32,
                         pad=(2, 2), weight_filler=_gauss(1e-4)),
        PoolingLayer("pool1", ["conv1"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        ReLULayer("relu1", ["pool1"], in_place=True),
        ConvolutionLayer("conv2", ["pool1"], kernel=(5, 5), num_output=32,
                         pad=(2, 2), weight_filler=_gauss(0.01)),
        ReLULayer("relu2", ["conv2"], in_place=True),
        PoolingLayer("pool2", ["conv2"], Pooling.Ave, kernel=(3, 3), stride=(2, 2)),
        ConvolutionLayer("conv3", ["pool2"], kernel=(5, 5), num_output=64,
                         pad=(2, 2), weight_filler=_gauss(0.01)),
        ReLULayer("relu3", ["conv3"], in_place=True),
        PoolingLayer("pool3", ["conv3"], Pooling.Ave, kernel=(3, 3), stride=(2, 2)),
        InnerProductLayer("ip1", ["pool3"], num_output=64,
                          weight_filler=_gauss(0.1)),
        InnerProductLayer("ip2", ["ip1"], num_output=num_classes,
                          weight_filler=_gauss(0.1)),
        SoftmaxWithLoss("loss", ["ip2", "label"]),
        AccuracyLayer("accuracy", ["ip2", "label"], phase="TEST"),
    )


def cifar10_quick_solver() -> SolverConfig:
    """ref: caffe/examples/cifar10/cifar10_quick_solver.prototxt."""
    return SolverConfig(
        base_lr=1e-3, lr_policy="fixed", momentum=0.9, weight_decay=0.004,
        max_iter=4000, solver_type="SGD", display=100,
    )


# ---------------------------------------------------------------------------
# CIFAR-10 full — the CifarApp model (ref:
# caffe/examples/cifar10/cifar10_full_train_test.prototxt)
# ---------------------------------------------------------------------------
def cifar10_full(batch: int = 100, num_classes: int = 10) -> Message:
    return NetParam(
        "CIFAR10_full",
        RDDLayer("data", shape=[batch, 3, 32, 32]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(5, 5), num_output=32,
                         pad=(2, 2), weight_filler=_gauss(1e-4)),
        PoolingLayer("pool1", ["conv1"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        ReLULayer("relu1", ["pool1"], in_place=True),
        LRNLayer("norm1", ["pool1"], local_size=3, alpha=5e-5, beta=0.75,
                 norm_region="WITHIN_CHANNEL"),
        ConvolutionLayer("conv2", ["norm1"], kernel=(5, 5), num_output=32,
                         pad=(2, 2), weight_filler=_gauss(0.01)),
        ReLULayer("relu2", ["conv2"], in_place=True),
        PoolingLayer("pool2", ["conv2"], Pooling.Ave, kernel=(3, 3), stride=(2, 2)),
        LRNLayer("norm2", ["pool2"], local_size=3, alpha=5e-5, beta=0.75,
                 norm_region="WITHIN_CHANNEL"),
        ConvolutionLayer("conv3", ["norm2"], kernel=(5, 5), num_output=64,
                         pad=(2, 2), weight_filler=_gauss(0.01)),
        ReLULayer("relu3", ["conv3"], in_place=True),
        PoolingLayer("pool3", ["conv3"], Pooling.Ave, kernel=(3, 3), stride=(2, 2)),
        InnerProductLayer("ip1", ["pool3"], num_output=num_classes,
                          weight_filler=_gauss(0.01)),
        SoftmaxWithLoss("loss", ["ip1", "label"]),
        AccuracyLayer("accuracy", ["ip1", "label"], phase="TEST"),
    )


def cifar10_full_solver() -> SolverConfig:
    """ref: caffe/examples/cifar10/cifar10_full_solver.prototxt (the
    CifarApp recipe)."""
    return SolverConfig(
        base_lr=1e-3, lr_policy="fixed", momentum=0.9, weight_decay=0.004,
        max_iter=60000, solver_type="SGD", display=200,
    )


# ---------------------------------------------------------------------------
# AlexNet (ref: caffe/models/bvlc_alexnet/train_val.prototxt; order is
# conv->relu->norm->pool, vs CaffeNet's conv->relu->pool->norm)
# ---------------------------------------------------------------------------
def _alex_tail(fc6_bottom: str, num_classes: int) -> list[Message]:
    return [
        InnerProductLayer("fc6", [fc6_bottom], num_output=4096,
                          weight_filler=_gauss(0.005), bias_filler=_const(0.1)),
        ReLULayer("relu6", ["fc6"], in_place=True),
        DropoutLayer("drop6", ["fc6"], ratio=0.5, in_place=True),
        InnerProductLayer("fc7", ["fc6"], num_output=4096,
                          weight_filler=_gauss(0.005), bias_filler=_const(0.1)),
        ReLULayer("relu7", ["fc7"], in_place=True),
        DropoutLayer("drop7", ["fc7"], ratio=0.5, in_place=True),
        InnerProductLayer("fc8", ["fc7"], num_output=num_classes,
                          weight_filler=_gauss(0.01)),
        SoftmaxWithLoss("loss", ["fc8", "label"]),
        AccuracyLayer("accuracy", ["fc8", "label"], phase="TEST"),
    ]


def alexnet(batch: int = 256, num_classes: int = 1000, crop: int = 227) -> Message:
    return NetParam(
        "AlexNet",
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(11, 11), num_output=96,
                         stride=(4, 4), weight_filler=_gauss(0.01)),
        ReLULayer("relu1", ["conv1"], in_place=True),
        LRNLayer("norm1", ["conv1"], local_size=5, alpha=1e-4, beta=0.75),
        PoolingLayer("pool1", ["norm1"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        ConvolutionLayer("conv2", ["pool1"], kernel=(5, 5), num_output=256,
                         pad=(2, 2), group=2, weight_filler=_gauss(0.01),
                         bias_filler=_const(0.1)),
        ReLULayer("relu2", ["conv2"], in_place=True),
        LRNLayer("norm2", ["conv2"], local_size=5, alpha=1e-4, beta=0.75),
        PoolingLayer("pool2", ["norm2"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        ConvolutionLayer("conv3", ["pool2"], kernel=(3, 3), num_output=384,
                         pad=(1, 1), weight_filler=_gauss(0.01)),
        ReLULayer("relu3", ["conv3"], in_place=True),
        ConvolutionLayer("conv4", ["conv3"], kernel=(3, 3), num_output=384,
                         pad=(1, 1), group=2, weight_filler=_gauss(0.01),
                         bias_filler=_const(0.1)),
        ReLULayer("relu4", ["conv4"], in_place=True),
        ConvolutionLayer("conv5", ["conv4"], kernel=(3, 3), num_output=256,
                         pad=(1, 1), group=2, weight_filler=_gauss(0.01),
                         bias_filler=_const(0.1)),
        ReLULayer("relu5", ["conv5"], in_place=True),
        PoolingLayer("pool5", ["conv5"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        *_alex_tail("pool5", num_classes),
    )


def alexnet_solver() -> SolverConfig:
    """ref: caffe/models/bvlc_alexnet/solver.prototxt (the ImageNet
    recipe)."""
    return SolverConfig(
        base_lr=0.01, lr_policy="step", gamma=0.1, stepsize=100000,
        momentum=0.9, weight_decay=5e-4, max_iter=450000,
        solver_type="SGD", display=20,
    )


# ---------------------------------------------------------------------------
# CaffeNet — the ImageNetApp model (ref:
# caffe/models/bvlc_reference_caffenet/train_val.prototxt)
# ---------------------------------------------------------------------------
def caffenet(batch: int = 256, num_classes: int = 1000, crop: int = 227) -> Message:
    return NetParam(
        "CaffeNet",
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(11, 11), num_output=96,
                         stride=(4, 4), weight_filler=_gauss(0.01)),
        ReLULayer("relu1", ["conv1"], in_place=True),
        PoolingLayer("pool1", ["conv1"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        LRNLayer("norm1", ["pool1"], local_size=5, alpha=1e-4, beta=0.75),
        ConvolutionLayer("conv2", ["norm1"], kernel=(5, 5), num_output=256,
                         pad=(2, 2), group=2, weight_filler=_gauss(0.01),
                         bias_filler=_const(1.0)),
        ReLULayer("relu2", ["conv2"], in_place=True),
        PoolingLayer("pool2", ["conv2"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        LRNLayer("norm2", ["pool2"], local_size=5, alpha=1e-4, beta=0.75),
        ConvolutionLayer("conv3", ["norm2"], kernel=(3, 3), num_output=384,
                         pad=(1, 1), weight_filler=_gauss(0.01)),
        ReLULayer("relu3", ["conv3"], in_place=True),
        ConvolutionLayer("conv4", ["conv3"], kernel=(3, 3), num_output=384,
                         pad=(1, 1), group=2, weight_filler=_gauss(0.01),
                         bias_filler=_const(1.0)),
        ReLULayer("relu4", ["conv4"], in_place=True),
        ConvolutionLayer("conv5", ["conv4"], kernel=(3, 3), num_output=256,
                         pad=(1, 1), group=2, weight_filler=_gauss(0.01),
                         bias_filler=_const(1.0)),
        ReLULayer("relu5", ["conv5"], in_place=True),
        PoolingLayer("pool5", ["conv5"], Pooling.Max, kernel=(3, 3), stride=(2, 2)),
        *_alex_tail("pool5", num_classes),
    )


def caffenet_solver() -> SolverConfig:
    """ref: caffe/models/bvlc_reference_caffenet/solver.prototxt."""
    return alexnet_solver()


# ---------------------------------------------------------------------------
# Transformer sequence classifier and char-level causal LM (no reference
# analog).  A causal decoder stack built from prototxt-compatible layers.
# ---------------------------------------------------------------------------
def _transformer_block(i: int, bottom: str, embed_dim: int, heads: int,
                       ffn_dim: int, rope: bool = False
                       ) -> tuple[list[Message], str]:
    """Pre-LN-free residual block: attention + residual, per-token FFN
    (InnerProduct axis=2) + residual."""
    attn, res, out = f"attn{i}", f"res{i}", f"blk{i}"
    layers = [
        MultiHeadAttentionLayer(attn, [bottom], num_heads=heads,
                                causal=True, rope=rope, top=attn),
        EltwiseLayer(res, [bottom, attn], top=res),
        InnerProductLayer(f"ffn{i}a", [res], num_output=ffn_dim, axis=2,
                          weight_filler=_gauss(0.05)),
        ReLULayer(f"ffn{i}r", [f"ffn{i}a"], in_place=True),
        InnerProductLayer(f"ffn{i}b", [f"ffn{i}a"], num_output=embed_dim,
                          axis=2, weight_filler=_gauss(0.05)),
        EltwiseLayer(out, [res, f"ffn{i}b"], top=out),
    ]
    return layers, out


def transformer(batch: int = 32, seq_len: int = 32, vocab: int = 64,
                embed_dim: int = 32, heads: int = 4, ffn_dim: int = 64,
                blocks: int = 2, num_classes: int = 10) -> Message:
    """Causal transformer over [batch, seq_len] token ids -> sequence
    class."""
    layers = [
        RDDLayer("data", shape=[batch, seq_len]),
        RDDLayer("label", shape=[batch]),
        EmbedLayer("embed", ["data"], input_dim=vocab, num_output=embed_dim,
                   top="embed"),
    ]
    bottom = "embed"
    for i in range(1, blocks + 1):
        blk, bottom = _transformer_block(i, bottom, embed_dim, heads, ffn_dim)
        layers += blk
    layers += [
        InnerProductLayer("fc", [bottom], num_output=num_classes,
                          weight_filler=_gauss(0.05)),
        SoftmaxWithLoss("loss", ["fc", "label"]),
        AccuracyLayer("accuracy", ["fc", "label"], phase="TEST"),
    ]
    return NetParam("Transformer", *layers)


def transformer_solver() -> SolverConfig:
    return SolverConfig(
        base_lr=0.1, lr_policy="fixed", momentum=0.9, weight_decay=1e-4,
        max_iter=2000, solver_type="SGD", display=100,
    )


def charlm(batch: int = 32, seq_len: int = 128, vocab: int = 128,
           embed_dim: int = 64, heads: int = 4, ffn_dim: int = 128,
           blocks: int = 2) -> Message:
    """Causal char LM over [batch, seq_len] ids -> per-token next-char
    logits (``fc``, [B, S, vocab]), rotary positions in every attention
    layer.  loss is mean cross-entropy per token (nats)."""
    layers = [
        RDDLayer("data", shape=[batch, seq_len]),
        RDDLayer("label", shape=[batch, seq_len]),
        EmbedLayer("embed", ["data"], input_dim=vocab, num_output=embed_dim,
                   top="embed"),
    ]
    bottom = "embed"
    for i in range(1, blocks + 1):
        blk, bottom = _transformer_block(i, bottom, embed_dim, heads, ffn_dim,
                                         rope=True)
        layers += blk
    layers += [
        InnerProductLayer("fc", [bottom], num_output=vocab, axis=2,
                          weight_filler=_gauss(0.05)),
        SoftmaxWithLoss("loss", ["fc", "label"], axis=2),
        AccuracyLayer("accuracy", ["fc", "label"], phase="TEST", axis=2),
    ]
    return NetParam("CharLM", *layers)


def charlm_solver() -> SolverConfig:
    # Adam: the standard small-transformer recipe (no published recipe)
    return SolverConfig(
        base_lr=2e-3, lr_policy="fixed", momentum=0.9, weight_decay=0.0,
        max_iter=2000, solver_type="Adam", display=100,
    )


# ---------------------------------------------------------------------------
# The families the serving engine serves (the JAX package's graph-sweep set)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphFamily:
    """One zoo family as the serving engine (and the JAX graph-contract
    sweep) builds it."""

    solver: Any  # () -> SolverConfig
    net: Any  # (batch: int) -> Message
    feed: str  # "image" | "tokens"
    num_classes: int
    image_shape: tuple = ()  # (C, H, W) for image feeds
    seq_len: int = 0  # for token feeds
    vocab: int = 0


def _mobilenet_not_ported(*_args):
    raise NotImplementedError(
        "the mobilenet family needs BatchNorm, Scale and depthwise "
        "convolution, which are not ported yet (ROADMAP Queue A10)")


GRAPH_SWEEP_FAMILIES: dict[str, GraphFamily] = {
    "cifar10_quick": GraphFamily(
        solver=cifar10_quick_solver, net=lambda b: cifar10_quick(b),
        feed="image", num_classes=10, image_shape=(3, 32, 32)),
    "lenet": GraphFamily(
        solver=lenet_solver, net=lambda b: lenet(b),
        feed="image", num_classes=10, image_shape=(1, 28, 28)),
    "transformer": GraphFamily(
        solver=transformer_solver,
        net=lambda b: transformer(b, seq_len=32, vocab=32, embed_dim=16,
                                  heads=4, ffn_dim=32, blocks=1),
        feed="tokens", num_classes=10, seq_len=32, vocab=32),
    # listed as in the JAX package; building it raises, naming A10
    "mobilenet": GraphFamily(
        solver=_mobilenet_not_ported, net=_mobilenet_not_ported,
        feed="image", num_classes=5, image_shape=(3, 64, 64)),
}

# ---------------------------------------------------------------------------
# Cached per-token decode over a block-paged K/V pool.
#
# ``build_prefill`` runs the ordinary full-window causal forward once
# (flash attention) and also writes every attention layer's K/V through
# the block tables; ``build_decode_step`` replays the same layer graph one
# token at a time against the pool (paged attention).  Both interpret
# ``network.layers`` and call each non-attention layer's own ``apply``;
# the attention layers go through ``ops/attention``'s projections and
# RoPE, with only the core swapped.
#
# Pool layout (shared with serve/paged.py): K/V arenas [n_attn_layers,
# num_blocks, block_tokens, heads, head_dim], written IN PLACE with
# ``index_put_`` (the JAX step returns new pools and donates the old
# ones).  One block table a slot, shared by all layers.  Block 0 is the
# null block every unused table entry points at: pad rows of a prefill
# and idle slots of a decode step write there (several rows at the same
# line, in an order CUDA does not fix), and no row ever reads it
# unmasked, so which write wins does not matter.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static geometry of one transformer family's cached decode path."""

    vocab: int
    embed_dim: int
    heads: int
    head_dim: int
    seq_len: int
    attn_layers: tuple
    end: str


def decode_spec(network, end: str = "fc") -> DecodeSpec:
    """Introspect a TEST-phase transformer ``Network`` into the geometry
    the paged decode step needs.  Raises ``ValueError`` for a graph the
    cached step cannot replay exactly: the head must be a per-token
    InnerProduct (axis=2), attention causal with one head count, and
    every layer up to the head Embed, MultiHeadAttention, Eltwise,
    InnerProduct or ReLU."""
    from sparknet_tpu_torch.ops.attention import MultiHeadAttentionLayer as _Attn
    from sparknet_tpu_torch.ops.blocks import Eltwise, Embed, InnerProduct
    from sparknet_tpu_torch.ops.data_layers import InputLayer
    from sparknet_tpu_torch.ops.neuron import ReLU

    ei = network.layer_index(end)
    head = network.layers[ei]
    if not isinstance(head, InnerProduct) or head.lp.get_msg(
            "inner_product_param").get_int("axis", 1) != 2:
        raise ValueError(
            f"decode head {end!r} must be a per-token InnerProduct "
            "(axis=2); sequence-classifier heads have no cached decode")
    vocab = head.lp.get_msg("inner_product_param").get_int("num_output")
    embed_dim = heads = None
    attn: list = []
    for layer in network.layers[: ei + 1]:
        if isinstance(layer, InputLayer):
            continue
        if isinstance(layer, _Attn):
            if not layer.causal:
                raise ValueError(f"{layer.name}: cached decode needs causal attention")
            if heads is None:
                heads = layer.num_heads
            elif heads != layer.num_heads:
                raise ValueError("cached decode needs one head count across "
                                 "attention layers")
            attn.append(layer.name)
        elif isinstance(layer, Embed):
            embed_dim = layer.lp.get_msg("embed_param").get_int("num_output")
        elif not isinstance(layer, (Eltwise, InnerProduct, ReLU)):
            raise ValueError(f"layer {layer.name!r} ({layer.type}) has no cached "
                             "decode twin")
    if not attn or embed_dim is None or heads is None:
        raise ValueError("cached decode needs an Embed front and at least one "
                         "attention layer")
    seq_len = int(network.feed_shapes()["data"][1])
    return DecodeSpec(vocab=vocab, embed_dim=embed_dim, heads=heads,
                      head_dim=embed_dim // heads, seq_len=seq_len,
                      attn_layers=tuple(attn), end=end)


def _replay(network, variables, ids, attend, end: str):
    """Run ``network``'s layers up to ``end`` on token ids [B, W], with
    every attention layer's core replaced by ``attend(a, layer, q, k, v)``
    (a: the attention layer's index; q, k, v [B, H, W, D] after the
    projection, RoPE not yet applied).  Returns the head's output."""
    from sparknet_tpu_torch.ops.attention import (
        MultiHeadAttentionLayer as _Attn, project_out, project_qkv)
    from sparknet_tpu_torch.ops.data_layers import InputLayer

    ei = network.layer_index(end)
    blob = {"data": ids}
    a = 0
    with torch.no_grad(), f32_precision():
        for layer in network.layers[: ei + 1]:
            if isinstance(layer, InputLayer):
                continue
            p = variables.params.get(layer.name, [])
            ins = [blob[b] for b in layer.bottoms]
            if isinstance(layer, _Attn):
                w_qkv, b_qkv, w_out, b_out = p
                q, k, v = project_qkv(ins[0], w_qkv, b_qkv, layer.num_heads)
                o = attend(a, layer, q, k, v)
                blob[layer.tops[0]] = project_out(o, w_out, b_out)
                a += 1
                continue
            out = layer.apply(p, variables.state.get(layer.name, {}), ins,
                              train=False)
            for top, o in zip(layer.tops, out.outputs):
                blob[top] = o
    return blob[network.layers[ei].tops[0]]


def build_decode_step(network, end: str = "fc"):
    """One cached decode step over a block-paged K/V pool.

    Returns ``step(variables, k_pool, v_pool, tokens, positions, tables)
    -> logits`` [B, 1, vocab]: ``tokens`` [B, 1], ``positions`` [B] int32
    (the absolute position of each row's token), ``tables`` [B, MB] int32,
    all on the pools' device.  Each attention layer writes the token's K/V
    IN PLACE at ``(tables[b, pos // T], pos % T)`` before it attends
    through ``paged_attention``, as the JAX step does; per-token work is
    O(position), and every row's output is a function of its own token,
    position and table alone (interleaved == alone).  Pools wider than the
    head (``kernel_head_dim``) take K/V in their first ``head_dim`` lanes
    and stay zero beyond; q is zero-padded alike and the scale is the
    head's own."""
    from sparknet_tpu_torch.ops.attention import rope_at
    from sparknet_tpu_torch.ops.kernels import paged_attention

    d = decode_spec(network, end=end).head_dim

    def step(variables, k_pool, v_pool, tokens, positions, tables):
        t, w = k_pool.shape[2], k_pool.shape[-1]
        blk = torch.gather(tables, 1, (positions // t).long()[:, None])[:, 0].long()
        off = (positions % t).long()
        pw = positions[:, None]

        def attend(a, layer, q, k, v):
            if layer.rope:
                q, k = rope_at(q, pw), rope_at(k, pw)
            k_pool[a][..., :d].index_put_((blk, off), k[:, :, 0, :])
            v_pool[a][..., :d].index_put_((blk, off), v[:, :, 0, :])
            qq = q[:, :, 0, :]
            qq = F.pad(qq, (0, w - d)) if w != d else qq
            o = paged_attention(qq, k_pool[a], v_pool[a], tables, positions,
                                1.0 / math.sqrt(d))
            return o[:, :, None, :d]

        return _replay(network, variables, tokens, attend, end)

    return step


def build_prefill(network, end: str = "fc"):
    """The prompt pass: one ordinary full-window causal forward (flash
    attention) that also writes every layer's K/V IN PLACE through the
    block tables.  Returns ``prefill(variables, tokens, lengths, k_pool,
    v_pool, tables) -> last_logits`` [B, vocab], taken at each row's
    ``lengths - 1`` (the first generated token's distribution).  Padded
    positions >= length write garbage K/V into the row's own blocks (or
    the null block past its allocation); a decode step overwrites
    position p before any row attends to it, so the garbage is dead.  K/V
    go into the pools' first ``head_dim`` lanes (see
    :func:`build_decode_step`)."""
    from sparknet_tpu_torch.ops.attention import rope
    from sparknet_tpu_torch.ops.kernels import flash_attention

    d = decode_spec(network, end=end).head_dim

    def prefill(variables, tokens, lengths, k_pool, v_pool, tables):
        t = k_pool.shape[2]
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)
        blk = tables.long()[:, pos // t]  # [B, S]
        off = (pos % t).expand(b, s)

        def attend(a, layer, q, k, v):
            if layer.rope:
                q, k = rope(q), rope(k)
            k_pool[a][..., :d].index_put_((blk, off), k.transpose(1, 2))
            v_pool[a][..., :d].index_put_((blk, off), v.transpose(1, 2))
            return flash_attention(q, k, v, causal=layer.causal)

        logits = _replay(network, variables, tokens, attend, end)  # [B, S, V]
        return logits[torch.arange(b, device=logits.device), lengths.long() - 1]

    return prefill
