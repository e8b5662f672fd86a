"""Programmatic model-definition DSL.

Equivalent of the Scala layer constructors (ref:
src/main/scala/libs/Layers.scala:18-137 — RDDLayer, ConvolutionLayer,
PoolingLayer, InnerProductLayer, ReLULayer, SoftmaxWithLoss, NetParam) and
of the README's LeNet example (ref: README.md:115-128).  Builders return
``Message`` objects identical to parsed prototxt, so DSL-built and
file-loaded models flow through the same compiler.
"""

from __future__ import annotations

from typing import Sequence

from sparknet_tpu_torch.proto.text_format import Message


def _layer(name: str, type_: str, bottoms: Sequence[str] = (), tops: Sequence[str] | None = None) -> Message:
    m = Message()
    m.set("name", name).set("type", type_)
    for b in bottoms:
        m.add("bottom", b)
    for t in tops if tops is not None else [name]:
        m.add("top", t)
    return m


def _filler(type_: str = "xavier", value: float | None = None, std: float | None = None) -> Message:
    f = Message().set("type", type_)
    if value is not None:
        f.set("value", value)
    if std is not None:
        f.set("std", std)
    return f


def RDDLayer(name: str, shape: Sequence[int]) -> Message:
    """Named input fed by the host data plane (the JavaData/RDD-callback
    analog, ref: Layers.scala:18-40)."""
    m = _layer(name, "JavaData", [], [name])
    p = Message()
    s = Message()
    for d in shape:
        s.add("dim", int(d))
    p.add("shape", s)
    m.set("java_data_param", p)
    return m


def MemoryDataLayer(name: str, batch: int, channels: int, height: int, width: int, tops=("data", "label")) -> Message:
    m = _layer(name, "MemoryData", [], list(tops))
    p = Message()
    p.set("batch_size", batch).set("channels", channels).set("height", height).set("width", width)
    m.set("memory_data_param", p)
    return m


def ConvolutionLayer(
    name: str,
    bottoms: Sequence[str],
    kernel: tuple[int, int],
    num_output: int,
    stride: tuple[int, int] = (1, 1),
    pad: tuple[int, int] = (0, 0),
    group: int = 1,
    weight_filler: Message | None = None,
    bias_filler: Message | None = None,
    bias_term: bool = True,
) -> Message:
    """ref: Layers.scala:42-63.  ``bias_term=False`` for convs whose bias
    a following BatchNorm/Scale pair absorbs (ResNet-style)."""
    m = _layer(name, "Convolution", bottoms)
    p = Message()
    p.set("num_output", num_output)
    p.set("kernel_h", kernel[0]).set("kernel_w", kernel[1])
    p.set("stride_h", stride[0]).set("stride_w", stride[1])
    p.set("pad_h", pad[0]).set("pad_w", pad[1])
    if group != 1:
        p.set("group", group)
    p.set("weight_filler", weight_filler or _filler("xavier"))
    if bias_term:
        p.set("bias_filler", bias_filler or _filler("constant", value=0.0))
    else:
        p.set("bias_term", False)
    m.set("convolution_param", p)
    return m


class Pooling:
    Max = "MAX"
    Ave = "AVE"


def PoolingLayer(
    name: str,
    bottoms: Sequence[str],
    pooling: str = Pooling.Max,
    kernel: tuple[int, int] = (2, 2),
    stride: tuple[int, int] = (2, 2),
    pad: tuple[int, int] = (0, 0),
    global_pooling: bool = False,
) -> Message:
    """ref: Layers.scala:65-86.  ``global_pooling`` collapses the spatial
    dims regardless of kernel (pooling_layer.cpp's global_pooling)."""
    m = _layer(name, "Pooling", bottoms)
    p = Message()
    p.set("pool", pooling)
    if global_pooling:
        p.set("global_pooling", True)
    else:
        p.set("kernel_h", kernel[0]).set("kernel_w", kernel[1])
        p.set("stride_h", stride[0]).set("stride_w", stride[1])
        if pad != (0, 0):
            p.set("pad_h", pad[0]).set("pad_w", pad[1])
    m.set("pooling_param", p)
    return m


def InnerProductLayer(
    name: str,
    bottoms: Sequence[str],
    num_output: int,
    weight_filler: Message | None = None,
    bias_filler: Message | None = None,
    axis: int | None = None,
) -> Message:
    """ref: Layers.scala:88-100.  ``axis`` flattens from that axis
    (Caffe default 1; axis=2 keeps a [B, S, E] sequence per-token)."""
    m = _layer(name, "InnerProduct", bottoms)
    p = Message()
    p.set("num_output", num_output)
    p.set("weight_filler", weight_filler or _filler("xavier"))
    p.set("bias_filler", bias_filler or _filler("constant", value=0.0))
    if axis is not None:
        p.set("axis", axis)
    m.set("inner_product_param", p)
    return m


def ReLULayer(name: str, bottoms: Sequence[str], in_place: bool = False) -> Message:
    """ref: Layers.scala:102-113.  ``in_place=True`` reproduces the zoo
    prototxts' top==bottom wiring (Caffe computes ReLU in the bottom blob's
    buffer; here it just rebinds the blob name)."""
    return _layer(name, "ReLU", bottoms, tops=bottoms if in_place else None)


def DropoutLayer(
    name: str, bottoms: Sequence[str], ratio: float = 0.5, in_place: bool = False
) -> Message:
    m = _layer(name, "Dropout", bottoms, tops=bottoms if in_place else None)
    m.set("dropout_param", Message().set("dropout_ratio", ratio))
    return m


def LRNLayer(
    name: str,
    bottoms: Sequence[str],
    local_size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    norm_region: str | None = None,
) -> Message:
    m = _layer(name, "LRN", bottoms)
    p = Message().set("local_size", local_size).set("alpha", alpha).set("beta", beta)
    if norm_region:
        p.set("norm_region", norm_region)
    m.set("lrn_param", p)
    return m


def ConcatLayer(name: str, bottoms: Sequence[str], axis: int = 1) -> Message:
    m = _layer(name, "Concat", bottoms)
    if axis != 1:
        m.set("concat_param", Message().set("axis", axis))
    return m


def SigmoidLayer(name: str, bottoms: Sequence[str], in_place: bool = False) -> Message:
    return _layer(name, "Sigmoid", bottoms, bottoms if in_place else None)


def FlattenLayer(name: str, bottoms: Sequence[str]) -> Message:
    return _layer(name, "Flatten", bottoms)


def _loss_layer(
    name: str, type_: str, bottoms: Sequence[str],
    loss_weight: float | None, top: str | None,
) -> Message:
    m = _layer(name, type_, bottoms, [top] if top else None)
    if loss_weight is not None:
        m.add("loss_weight", loss_weight)
    return m


def EuclideanLossLayer(
    name: str, bottoms: Sequence[str], loss_weight: float | None = None,
    top: str | None = None,
) -> Message:
    return _loss_layer(name, "EuclideanLoss", bottoms, loss_weight, top)


def SigmoidCrossEntropyLossLayer(
    name: str, bottoms: Sequence[str], loss_weight: float | None = None,
    top: str | None = None,
) -> Message:
    return _loss_layer(name, "SigmoidCrossEntropyLoss", bottoms, loss_weight, top)


def BatchNormLayer(
    name: str,
    bottoms: Sequence[str],
    in_place: bool = True,
    eps: float = 1e-5,
    moving_average_fraction: float = 0.999,
) -> Message:
    """ref: batch_norm_layer.cpp:10 LayerSetUp, :75 Forward_cpu —
    normalization only; pair with a Scale layer for the learnable affine
    (the convention the published ResNet prototxts use)."""
    m = _layer(name, "BatchNorm", bottoms,
               [bottoms[0]] if in_place else None)
    p = Message()
    if eps != 1e-5:
        p.set("eps", eps)
    if moving_average_fraction != 0.999:
        p.set("moving_average_fraction", moving_average_fraction)
    m.set("batch_norm_param", p)
    return m


def ScaleLayer(
    name: str,
    bottoms: Sequence[str],
    in_place: bool = True,
    bias_term: bool = True,
) -> Message:
    """Channel-wise gamma (+ beta with bias_term), the learnable half of
    the BatchNorm/Scale pair.  No reference counterpart: the SparkNet-era
    Caffe predates ScaleLayer (post-reference BVLC addition); semantics
    follow ops/blocks.py:Scale, which the zoo ResNet wiring requires."""
    m = _layer(name, "Scale", bottoms, [bottoms[0]] if in_place else None)
    if bias_term:
        m.set("scale_param", Message().set("bias_term", True))
    return m


def EltwiseLayer(
    name: str,
    bottoms: Sequence[str],
    operation: str = "SUM",
    top: str | None = None,
) -> Message:
    """ref: eltwise_layer.cpp (PROD / SUM / MAX over bottoms)."""
    m = _layer(name, "Eltwise", bottoms, [top] if top else None)
    if operation != "SUM":
        m.set("eltwise_param", Message().set("operation", operation))
    return m


def SoftmaxLayer(name: str, bottoms: Sequence[str]) -> Message:
    return _layer(name, "Softmax", bottoms)


def SoftmaxWithLoss(
    name: str, bottoms: Sequence[str], loss_weight: float | None = None,
    top: str | None = None, axis: int | None = None,
) -> Message:
    """ref: Layers.scala:115-128 (bottoms = [scores, label]).  ``loss_weight``
    scales this loss term in the total objective — the GoogLeNet auxiliary
    classifiers train at 0.3 (bvlc_googlenet/train_val.prototxt:933,1696).
    ``axis`` picks the class axis (softmax_param.axis, ref:
    softmax_loss_layer.cpp) — e.g. 2 for per-token [B, S, V] LM logits."""
    m = _loss_layer(name, "SoftmaxWithLoss", bottoms, loss_weight, top)
    if axis is not None:
        m.set("softmax_param", Message().set("axis", axis))
    return m


def AccuracyLayer(
    name: str,
    bottoms: Sequence[str],
    top_k: int = 1,
    phase: str | None = None,
    axis: int | None = None,
) -> Message:
    """``phase="TEST"`` adds the include rule the reference prototxts put on
    every Accuracy layer (e.g. caffe/examples/mnist/lenet_train_test.prototxt:
    ``include { phase: TEST }``)."""
    m = _layer(name, "Accuracy", bottoms)
    if top_k != 1 or axis is not None:
        p = Message()
        if top_k != 1:
            p.set("top_k", top_k)
        if axis is not None:
            p.set("axis", axis)
        m.set("accuracy_param", p)
    if phase is not None:
        m.add("include", Message().set("phase", phase))
    return m


def EmbedLayer(
    name: str,
    bottoms: Sequence[str],
    input_dim: int,
    num_output: int,
    weight_filler: Message | None = None,
    top: str | None = None,
) -> Message:
    """Embedding lookup (ref: embed_layer.cpp; ops/blocks.py Embed)."""
    m = _layer(name, "Embed", bottoms, [top] if top else None)
    p = Message()
    p.set("input_dim", input_dim)
    p.set("num_output", num_output)
    p.set("weight_filler", weight_filler or _filler("xavier"))
    return m.set("embed_param", p)


def MultiHeadAttentionLayer(
    name: str,
    bottoms: Sequence[str],
    num_heads: int,
    causal: bool = False,
    rope: bool = False,
    top: str | None = None,
) -> Message:
    """Sequence-model extra (no reference analog; ops/attention.py).
    ``rope=True`` turns on parameter-free rotary position embeddings."""
    m = _layer(name, "MultiHeadAttention", bottoms, [top] if top else None)
    p = Message().set("num_heads", num_heads)
    if causal:
        p.set("causal", True)
    if rope:
        p.set("rope", True)
    return m.set("attention_param", p)


def MoELayer(
    name: str,
    bottoms: Sequence[str],
    num_experts: int,
    hidden_dim: int = 0,
    top: str | None = None,
) -> Message:
    """Mixture-of-experts extra (no reference analog; ops/moe.py)."""
    m = _layer(name, "MoE", bottoms, [top] if top else None)
    p = Message().set("num_experts", num_experts)
    if hidden_dim:
        p.set("hidden_dim", hidden_dim)
    return m.set("moe_param", p)


def NetParam(name: str, *layers: Message) -> Message:
    """Aggregate layers into a NetParameter (ref: Layers.scala:130-137)."""
    net = Message().set("name", name)
    for l in layers:
        net.add("layer", l)
    return net
