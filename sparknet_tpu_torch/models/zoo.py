"""The model zoo's builders, rebuilt with the layer DSL, and the cached
decode builders of the transformer families.

Copy of the net builders of ``sparknet_tpu/models/zoo.py`` the serving
and training paths need (ref: caffe/examples/mnist/lenet_train_test.prototxt,
caffe/examples/cifar10/cifar10_{quick,full}_train_test.prototxt,
caffe/models/bvlc_alexnet/train_val.prototxt,
caffe/models/bvlc_reference_caffenet/train_val.prototxt,
caffe/models/bvlc_googlenet/train_val.prototxt), the later ImageNet
families (ResNet-50, VGG-16, SqueezeNet v1.1, MobileNet v1), the
sequence models ``transformer`` and ``charlm`` (no reference analog), and
the MNIST siamese net (ref: caffe/examples/siamese/) and deep autoencoder
(ref: caffe/examples/mnist/mnist_autoencoder.prototxt).
Architectures are the published ones; data enters through RDD layers and
batch is a builder argument.  The ``*_solver()`` recipes are the
published solver.prototxt settings of each.
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
    BatchNormLayer,
    ConcatLayer,
    ConvolutionLayer,
    DropoutLayer,
    EltwiseLayer,
    EmbedLayer,
    EuclideanLossLayer,
    FlattenLayer,
    InnerProductLayer,
    LRNLayer,
    MultiHeadAttentionLayer,
    NetParam,
    Pooling,
    PoolingLayer,
    RDDLayer,
    ReLULayer,
    ScaleLayer,
    SigmoidCrossEntropyLossLayer,
    SigmoidLayer,
    SoftmaxWithLoss,
    _filler,
)
from sparknet_tpu_torch.proto.text_format import Message
from sparknet_tpu_torch.solvers.solver import SolverConfig


def _gauss(std: float) -> Message:
    return _filler("gaussian", std=std)


def _const(v: float) -> Message:
    return _filler("constant", value=v)


def _msra() -> Message:
    return _filler("msra")


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
# GoogLeNet — 9 inception modules, a multi-tower concat DAG (ref:
# caffe/models/bvlc_googlenet/train_val.prototxt), with its two auxiliary
# loss heads
# ---------------------------------------------------------------------------
def _inception(name: str, bottom: str, c1: int, c3r: int, c3: int,
               c5r: int, c5: int, cp: int) -> list[Message]:
    """One inception module: 1x1 / 3x3(reduced) / 5x5(reduced) / pool-proj
    towers concatenated on channels."""
    w = lambda: _filler("xavier")
    b = lambda: _const(0.2)
    n = f"inception_{name}"
    layers = [
        ConvolutionLayer(f"{n}/1x1", [bottom], kernel=(1, 1), num_output=c1,
                         weight_filler=w(), bias_filler=b()),
        ReLULayer(f"{n}/relu_1x1", [f"{n}/1x1"], in_place=True),
        ConvolutionLayer(f"{n}/3x3_reduce", [bottom], kernel=(1, 1),
                         num_output=c3r, weight_filler=w(), bias_filler=b()),
        ReLULayer(f"{n}/relu_3x3_reduce", [f"{n}/3x3_reduce"], in_place=True),
        ConvolutionLayer(f"{n}/3x3", [f"{n}/3x3_reduce"], kernel=(3, 3),
                         num_output=c3, pad=(1, 1), weight_filler=w(),
                         bias_filler=b()),
        ReLULayer(f"{n}/relu_3x3", [f"{n}/3x3"], in_place=True),
        ConvolutionLayer(f"{n}/5x5_reduce", [bottom], kernel=(1, 1),
                         num_output=c5r, weight_filler=w(), bias_filler=b()),
        ReLULayer(f"{n}/relu_5x5_reduce", [f"{n}/5x5_reduce"], in_place=True),
        ConvolutionLayer(f"{n}/5x5", [f"{n}/5x5_reduce"], kernel=(5, 5),
                         num_output=c5, pad=(2, 2), weight_filler=w(),
                         bias_filler=b()),
        ReLULayer(f"{n}/relu_5x5", [f"{n}/5x5"], in_place=True),
        PoolingLayer(f"{n}/pool", [bottom], Pooling.Max, kernel=(3, 3),
                     stride=(1, 1), pad=(1, 1)),
        ConvolutionLayer(f"{n}/pool_proj", [f"{n}/pool"], kernel=(1, 1),
                         num_output=cp, weight_filler=w(), bias_filler=b()),
        ReLULayer(f"{n}/relu_pool_proj", [f"{n}/pool_proj"], in_place=True),
        ConcatLayer(f"{n}/output",
                    [f"{n}/1x1", f"{n}/3x3", f"{n}/5x5", f"{n}/pool_proj"]),
    ]
    return layers


def _googlenet_aux_head(i: int, bottom: str, num_classes: int) -> list[Message]:
    """Auxiliary classifier tower ``loss{i}`` — ave_pool 5x5/3 → 1x1 conv 128
    → fc 1024 → drop 0.7 → fc num_classes → SoftmaxWithLoss at weight 0.3.
    The published recipe trains with BOTH aux heads in every phase (ref:
    caffe/models/bvlc_googlenet/train_val.prototxt:823-953 loss1,
    :1586-1716 loss2; loss_weight 0.3 at :933 and :1696)."""
    w = lambda: _filler("xavier")
    b = lambda: _const(0.2)
    p = f"loss{i}"
    return [
        PoolingLayer(f"{p}/ave_pool", [bottom], Pooling.Ave,
                     kernel=(5, 5), stride=(3, 3)),
        ConvolutionLayer(f"{p}/conv", [f"{p}/ave_pool"], kernel=(1, 1),
                         num_output=128, weight_filler=w(), bias_filler=b()),
        ReLULayer(f"{p}/relu_conv", [f"{p}/conv"], in_place=True),
        InnerProductLayer(f"{p}/fc", [f"{p}/conv"], num_output=1024,
                          weight_filler=w(), bias_filler=b()),
        ReLULayer(f"{p}/relu_fc", [f"{p}/fc"], in_place=True),
        DropoutLayer(f"{p}/drop_fc", [f"{p}/fc"], ratio=0.7, in_place=True),
        InnerProductLayer(f"{p}/classifier", [f"{p}/fc"],
                          num_output=num_classes, weight_filler=w(),
                          bias_filler=_const(0.0)),
        SoftmaxWithLoss(f"{p}/loss", [f"{p}/classifier", "label"],
                        loss_weight=0.3, top=f"{p}/loss{i}"),
        AccuracyLayer(f"{p}/top-1", [f"{p}/classifier", "label"], phase="TEST"),
        AccuracyLayer(f"{p}/top-5", [f"{p}/classifier", "label"], top_k=5,
                      phase="TEST"),
    ]


def googlenet(batch: int = 32, num_classes: int = 1000, crop: int = 224) -> Message:
    w = lambda: _filler("xavier")
    b = lambda: _const(0.2)
    layers: list[Message] = [
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1/7x7_s2", ["data"], kernel=(7, 7), num_output=64,
                         stride=(2, 2), pad=(3, 3), weight_filler=w(),
                         bias_filler=b()),
        ReLULayer("conv1/relu_7x7", ["conv1/7x7_s2"], in_place=True),
        PoolingLayer("pool1/3x3_s2", ["conv1/7x7_s2"], Pooling.Max,
                     kernel=(3, 3), stride=(2, 2)),
        LRNLayer("pool1/norm1", ["pool1/3x3_s2"], local_size=5, alpha=1e-4,
                 beta=0.75),
        ConvolutionLayer("conv2/3x3_reduce", ["pool1/norm1"], kernel=(1, 1),
                         num_output=64, weight_filler=w(), bias_filler=b()),
        ReLULayer("conv2/relu_3x3_reduce", ["conv2/3x3_reduce"], in_place=True),
        ConvolutionLayer("conv2/3x3", ["conv2/3x3_reduce"], kernel=(3, 3),
                         num_output=192, pad=(1, 1), weight_filler=w(),
                         bias_filler=b()),
        ReLULayer("conv2/relu_3x3", ["conv2/3x3"], in_place=True),
        LRNLayer("conv2/norm2", ["conv2/3x3"], local_size=5, alpha=1e-4,
                 beta=0.75),
        PoolingLayer("pool2/3x3_s2", ["conv2/norm2"], Pooling.Max,
                     kernel=(3, 3), stride=(2, 2)),
    ]
    layers += _inception("3a", "pool2/3x3_s2", 64, 96, 128, 16, 32, 32)
    layers += _inception("3b", "inception_3a/output", 128, 128, 192, 32, 96, 64)
    layers += [PoolingLayer("pool3/3x3_s2", ["inception_3b/output"],
                            Pooling.Max, kernel=(3, 3), stride=(2, 2))]
    layers += _inception("4a", "pool3/3x3_s2", 192, 96, 208, 16, 48, 64)
    layers += _googlenet_aux_head(1, "inception_4a/output", num_classes)
    layers += _inception("4b", "inception_4a/output", 160, 112, 224, 24, 64, 64)
    layers += _inception("4c", "inception_4b/output", 128, 128, 256, 24, 64, 64)
    layers += _inception("4d", "inception_4c/output", 112, 144, 288, 32, 64, 64)
    layers += _googlenet_aux_head(2, "inception_4d/output", num_classes)
    layers += _inception("4e", "inception_4d/output", 256, 160, 320, 32, 128, 128)
    layers += [PoolingLayer("pool4/3x3_s2", ["inception_4e/output"],
                            Pooling.Max, kernel=(3, 3), stride=(2, 2))]
    layers += _inception("5a", "pool4/3x3_s2", 256, 160, 320, 32, 128, 128)
    layers += _inception("5b", "inception_5a/output", 384, 192, 384, 48, 128, 128)
    # pool5 is a GLOBAL average in intent (7x7 == 224/32, the whole 5b
    # map — ref: bvlc_googlenet/train_val.prototxt pool5/7x7_s1); keep
    # that intent at reduced crops by sizing the kernel to the actual map.
    # Non-multiples of 32 would leave a ceil-mode map LARGER than
    # crop//32 and silently break the global intent — reject them.
    if crop % 32:
        raise ValueError(f"googlenet: crop must be a multiple of 32 "
                         f"(got {crop})")
    p5 = max(1, crop // 32)
    layers += [
        PoolingLayer("pool5/7x7_s1", ["inception_5b/output"], Pooling.Ave,
                     kernel=(p5, p5), stride=(1, 1)),
        DropoutLayer("pool5/drop_7x7_s1", ["pool5/7x7_s1"], ratio=0.4, in_place=True),
        InnerProductLayer("loss3/classifier", ["pool5/7x7_s1"],
                          num_output=num_classes, weight_filler=w(),
                          bias_filler=_const(0.0)),
        SoftmaxWithLoss("loss3/loss3", ["loss3/classifier", "label"]),
        AccuracyLayer("loss3/top-1", ["loss3/classifier", "label"], phase="TEST"),
        AccuracyLayer("loss3/top-5", ["loss3/classifier", "label"], top_k=5, phase="TEST"),
    ]
    return NetParam("GoogleNet", *layers)


def googlenet_solver() -> SolverConfig:
    """ref: caffe/models/bvlc_googlenet/solver.prototxt."""
    return SolverConfig(
        base_lr=0.01, lr_policy="step", gamma=0.96, stepsize=320000,
        momentum=0.9, weight_decay=2e-4, max_iter=2400000,
        solver_type="SGD", display=40,
    )


# ---------------------------------------------------------------------------
# ResNet-50 — the first post-reference zoo family.  The reference predates
# residual nets; this follows the published Caffe ResNet-50 deploy wiring
# (He et al. 2016: conv bias_term false + BatchNorm/Scale pairs, bottleneck
# branches named res{stage}{blk}_branch{1,2a,2b,2c}, v1 downsampling via
# stride-2 on branch1 and branch2a).
# ---------------------------------------------------------------------------
def _bn_scale(prefix: str, bottom: str,
              frac: float = 0.999) -> list[Message]:
    """BatchNorm (stats only) + Scale (gamma/beta), Caffe-ResNet naming."""
    return [
        BatchNormLayer(f"bn{prefix}", [bottom],
                       moving_average_fraction=frac),
        ScaleLayer(f"scale{prefix}", [bottom]),
    ]


def _bottleneck(stage: int, blk: str, bottom: str, width: int,
                stride: int, project: bool,
                bn_fraction: float = 0.999) -> tuple[list[Message], str]:
    """res{stage}{blk}: 1x1(width,s) -> 3x3(width) -> 1x1(4*width) with
    identity or stride-s projection shortcut; sum then ReLU."""
    w = _msra
    n = f"{stage}{blk}"
    layers: list[Message] = []
    shortcut = bottom
    if project:
        layers += [
            ConvolutionLayer(f"res{n}_branch1", [bottom], kernel=(1, 1),
                             num_output=4 * width, stride=(stride, stride),
                             weight_filler=w(), bias_term=False),
            *_bn_scale(f"{n}_branch1", f"res{n}_branch1", bn_fraction),
        ]
        shortcut = f"res{n}_branch1"
    layers += [
        ConvolutionLayer(f"res{n}_branch2a", [bottom], kernel=(1, 1),
                         num_output=width, stride=(stride, stride),
                         weight_filler=w(), bias_term=False),
        *_bn_scale(f"{n}_branch2a", f"res{n}_branch2a", bn_fraction),
        ReLULayer(f"res{n}_branch2a_relu", [f"res{n}_branch2a"],
                  in_place=True),
        ConvolutionLayer(f"res{n}_branch2b", [f"res{n}_branch2a"],
                         kernel=(3, 3), num_output=width, pad=(1, 1),
                         weight_filler=w(), bias_term=False),
        *_bn_scale(f"{n}_branch2b", f"res{n}_branch2b", bn_fraction),
        ReLULayer(f"res{n}_branch2b_relu", [f"res{n}_branch2b"],
                  in_place=True),
        ConvolutionLayer(f"res{n}_branch2c", [f"res{n}_branch2b"],
                         kernel=(1, 1), num_output=4 * width,
                         weight_filler=w(), bias_term=False),
        *_bn_scale(f"{n}_branch2c", f"res{n}_branch2c", bn_fraction),
        EltwiseLayer(f"res{n}", [shortcut, f"res{n}_branch2c"]),
        ReLULayer(f"res{n}_relu", [f"res{n}"], in_place=True),
    ]
    return layers, f"res{n}"


def resnet50(batch: int = 32, num_classes: int = 1000,
             crop: int = 224, bn_fraction: float = 0.999) -> Message:
    """``bn_fraction``: BatchNorm moving-average fraction — the recipe
    0.999 assumes thousands of iterations; short schedules (fine-tunes,
    convergence demos) want 0.9-0.95 so eval stats track training."""
    w = _msra
    layers: list[Message] = [
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(7, 7), num_output=64,
                         stride=(2, 2), pad=(3, 3), weight_filler=w(),
                         bias_term=False),
        *_bn_scale("_conv1", "conv1", bn_fraction),
        ReLULayer("conv1_relu", ["conv1"], in_place=True),
        PoolingLayer("pool1", ["conv1"], Pooling.Max, kernel=(3, 3),
                     stride=(2, 2)),
    ]
    bottom = "pool1"
    stages = [(2, 64, 3), (3, 128, 4), (4, 256, 6), (5, 512, 3)]
    for stage, width, blocks in stages:
        for i in range(blocks):
            blk = "abcdef"[i]
            stride = 2 if (i == 0 and stage > 2) else 1
            ls, bottom = _bottleneck(stage, blk, bottom, width,
                                     stride, project=(i == 0),
                                     bn_fraction=bn_fraction)
            layers += ls
    layers += [
        PoolingLayer("pool5", [bottom], Pooling.Ave, global_pooling=True),
        InnerProductLayer("fc1000", ["pool5"], num_output=num_classes,
                          weight_filler=w(), bias_filler=_const(0.0)),
        SoftmaxWithLoss("loss", ["fc1000", "label"]),
        AccuracyLayer("accuracy", ["fc1000", "label"], phase="TEST"),
        AccuracyLayer("accuracy_top5", ["fc1000", "label"], top_k=5,
                      phase="TEST"),
    ]
    return NetParam("ResNet-50", *layers)


def resnet50_solver() -> SolverConfig:
    """The published recipe: SGD 0.9, base_lr 0.1, weight decay 1e-4,
    /10 steps (He et al.; epoch boundaries depend on dataset scale)."""
    return SolverConfig(
        base_lr=0.1, lr_policy="multistep", momentum=0.9,
        weight_decay=1e-4, gamma=0.1, stepvalue=(150000, 300000),
        max_iter=450000, solver_type="SGD", display=20,
        snapshot_prefix="resnet50",
    )


# ---------------------------------------------------------------------------
# VGG-16 — the second post-reference zoo family (Simonyan & Zisserman
# 2015, configuration D), wired as the published Caffe model-zoo
# VGG_ILSVRC_16_layers train_val: 13 conv3x3/pad1 layers in five
# max-pooled blocks, then the AlexNet-style 4096/4096/1000 FC tail with
# dropout (~15.5 GFLOP an image forward).
# ---------------------------------------------------------------------------
def _vgg_block(idx: int, bottom: str, convs: int, width: int,
               filler) -> list[Message]:
    """conv{idx}_1..convs (3x3 pad 1, ReLU) then 2x2/2 max pool."""
    layers: list[Message] = []
    for j in range(1, convs + 1):
        name = f"conv{idx}_{j}"
        layers += [
            ConvolutionLayer(name, [bottom], kernel=(3, 3), num_output=width,
                             pad=(1, 1), weight_filler=filler(),
                             bias_filler=_const(0.0)),
            ReLULayer(f"relu{idx}_{j}", [name], in_place=True),
        ]
        bottom = name
    layers.append(PoolingLayer(f"pool{idx}", [bottom], Pooling.Max,
                               kernel=(2, 2), stride=(2, 2)))
    return layers


def vgg16(batch: int = 64, num_classes: int = 1000, crop: int = 224,
          msra_init: bool = False) -> Message:
    """``msra_init``: the published zoo file keeps gaussian std 0.01 —
    faithful, but activations vanish ~1e-5 by conv5_3 so config D does
    not train from scratch (the paper bootstrapped it from config A;
    He et al. 2015 §2.2 derives msra filling from exactly this failure).
    Flip on for from-scratch training without a warm start."""
    filler = _msra if msra_init else lambda: _gauss(0.01)
    blocks = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]
    layers: list[Message] = [
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
    ]
    bottom = "data"
    for idx, convs, width in blocks:
        layers += _vgg_block(idx, bottom, convs, width, filler)
        bottom = f"pool{idx}"
    layers += _alex_tail(bottom, num_classes)
    return NetParam("VGG-16", *layers)


def vgg16_solver() -> SolverConfig:
    """The published recipe (Simonyan & Zisserman §3.1): SGD momentum
    0.9, base_lr 0.01 decreased 10x on plateau (step schedule here),
    weight decay 5e-4, batch 256 aggregated (the Caffe zoo train_val
    runs batch 64 with iter_size)."""
    return SolverConfig(
        base_lr=0.01, lr_policy="step", gamma=0.1, stepsize=100000,
        momentum=0.9, weight_decay=5e-4, max_iter=370000,
        solver_type="SGD", display=20, snapshot_prefix="vgg16",
    )


def _fire(i: int, bottom: str, squeeze: int, expand: int,
          msra: bool = False) -> list[Message]:
    """fire{i}: 1x1 squeeze -> parallel 1x1 + 3x3(pad 1) expands ->
    channel concat (SqueezeNet §3.1 Fire module)."""
    w = _msra if msra else (lambda: _filler("xavier"))
    p = f"fire{i}"
    return [
        ConvolutionLayer(f"{p}/squeeze1x1", [bottom], kernel=(1, 1),
                         num_output=squeeze, weight_filler=w()),
        ReLULayer(f"{p}/relu_squeeze1x1", [f"{p}/squeeze1x1"],
                  in_place=True),
        ConvolutionLayer(f"{p}/expand1x1", [f"{p}/squeeze1x1"],
                         kernel=(1, 1), num_output=expand,
                         weight_filler=w()),
        ReLULayer(f"{p}/relu_expand1x1", [f"{p}/expand1x1"], in_place=True),
        ConvolutionLayer(f"{p}/expand3x3", [f"{p}/squeeze1x1"],
                         kernel=(3, 3), num_output=expand, pad=(1, 1),
                         weight_filler=w()),
        ReLULayer(f"{p}/relu_expand3x3", [f"{p}/expand3x3"], in_place=True),
        ConcatLayer(f"{p}/concat", [f"{p}/expand1x1", f"{p}/expand3x3"]),
    ]


def squeezenet(batch: int = 32, num_classes: int = 1000,
               crop: int = 227, msra_init: bool = False) -> Message:
    """SqueezeNet v1.1 — post-reference family #3, the deploy-efficiency
    member (Iandola et al. 2016; the official release was a Caffe
    prototxt, forresti/SqueezeNet, which this follows: conv1 64x3x3/2,
    eight Fire modules, all-conv 1x1 classifier over a global average
    pool — no fc layers at all).  1,235,496 params at 1000 classes
    (~50x smaller than AlexNet at comparable published accuracy).  The
    Fire concat of 1x1+3x3 expands is a 2-way DAG per module.

    ``msra_init=True``: swap every conv's xavier filler for msra — the
    published xavier wiring loses ~2.5x activation variance per Fire
    module through the ReLU stack (std 0.39 at conv1 -> 1.7e-3 by fire9
    at unit-scale inputs, gradients ~1e-4, as the JAX package measured),
    the same from-scratch trainability gap ``vgg16`` documents; the
    default stays faithful to the published prototxt for finetune
    parity.  msra fillers expect unit-scale inputs."""
    w = _msra if msra_init else (lambda: _filler("xavier"))
    layers: list[Message] = [
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(3, 3), num_output=64,
                         stride=(2, 2), weight_filler=w()),
        ReLULayer("relu_conv1", ["conv1"], in_place=True),
        PoolingLayer("pool1", ["conv1"], Pooling.Max, kernel=(3, 3),
                     stride=(2, 2)),
    ]
    layers += _fire(2, "pool1", 16, 64, msra_init)
    layers += _fire(3, "fire2/concat", 16, 64, msra_init)
    layers += [PoolingLayer("pool3", ["fire3/concat"], Pooling.Max,
                            kernel=(3, 3), stride=(2, 2))]
    layers += _fire(4, "pool3", 32, 128, msra_init)
    layers += _fire(5, "fire4/concat", 32, 128, msra_init)
    layers += [PoolingLayer("pool5", ["fire5/concat"], Pooling.Max,
                            kernel=(3, 3), stride=(2, 2))]
    layers += _fire(6, "pool5", 48, 192, msra_init)
    layers += _fire(7, "fire6/concat", 48, 192, msra_init)
    layers += _fire(8, "fire7/concat", 64, 256, msra_init)
    layers += _fire(9, "fire8/concat", 64, 256, msra_init)
    layers += [
        DropoutLayer("drop9", ["fire9/concat"], ratio=0.5, in_place=True),
        ConvolutionLayer("conv10", ["fire9/concat"], kernel=(1, 1),
                         num_output=num_classes, weight_filler=_gauss(0.01),
                         bias_filler=_const(0.0)),
        ReLULayer("relu_conv10", ["conv10"], in_place=True),
        PoolingLayer("pool10", ["conv10"], Pooling.Ave,
                     global_pooling=True),
        FlattenLayer("flat10", ["pool10"]),
        SoftmaxWithLoss("loss", ["flat10", "label"]),
        AccuracyLayer("accuracy", ["flat10", "label"], phase="TEST"),
        AccuracyLayer("accuracy_top5", ["flat10", "label"], top_k=5,
                      phase="TEST"),
    ]
    return NetParam("SqueezeNet_v1.1", *layers)


def _dw_sep(name: str, bottom: str, cin: int, cout: int, stride: int,
            bn_fraction: float) -> tuple[list[Message], str]:
    """conv{name}/dw (3x3 depthwise, group=cin) + BN/Scale/ReLU, then
    conv{name}/sep (1x1 pointwise) + BN/Scale/ReLU — the depthwise-
    separable block (Howard et al. 2017 §3.1, the MobileNet-Caffe
    community wiring's layer naming)."""
    dw, sep = f"conv{name}/dw", f"conv{name}/sep"
    layers = [
        ConvolutionLayer(dw, [bottom], kernel=(3, 3), num_output=cin,
                         stride=(stride, stride), pad=(1, 1), group=cin,
                         weight_filler=_msra(), bias_term=False),
        *_bn_scale(f"{name}/dw", dw, bn_fraction),
        ReLULayer(f"relu{name}/dw", [dw], in_place=True),
        ConvolutionLayer(sep, [dw], kernel=(1, 1), num_output=cout,
                         weight_filler=_msra(), bias_term=False),
        *_bn_scale(f"{name}/sep", sep, bn_fraction),
        ReLULayer(f"relu{name}/sep", [sep], in_place=True),
    ]
    return layers, sep


def mobilenet(batch: int = 32, num_classes: int = 1000, crop: int = 224,
              bn_fraction: float = 0.999) -> Message:
    """MobileNet v1 (1.0x, Howard et al. 2017) — post-reference family
    #4, the depthwise-separable member: 13 dw-separable blocks between
    a 3x3/2 stem and a global-average 1x1-conv classifier.  4,231,976
    params at 1000 classes (the standard v1 count; derived conv1 864 +
    dw 44,640 + pointwise 3,139,584 + Scale gamma/beta 21,888 +
    fc 1,025,000).  The only family whose hot op is GROUPED convolution
    at group == channels (a depthwise 3x3 does 9 MACs an output against
    a dense conv's thousands, so the op is bound by memory).
    ``bn_fraction`` as in ``resnet50``."""
    layers: list[Message] = [
        RDDLayer("data", shape=[batch, 3, crop, crop]),
        RDDLayer("label", shape=[batch]),
        ConvolutionLayer("conv1", ["data"], kernel=(3, 3), num_output=32,
                         stride=(2, 2), pad=(1, 1), weight_filler=_msra(),
                         bias_term=False),
        *_bn_scale("1", "conv1", bn_fraction),
        ReLULayer("relu1", ["conv1"], in_place=True),
    ]
    bottom = "conv1"
    plan = [("2_1", 32, 64, 1), ("2_2", 64, 128, 2),
            ("3_1", 128, 128, 1), ("3_2", 128, 256, 2),
            ("4_1", 256, 256, 1), ("4_2", 256, 512, 2),
            ("5_1", 512, 512, 1), ("5_2", 512, 512, 1),
            ("5_3", 512, 512, 1), ("5_4", 512, 512, 1),
            ("5_5", 512, 512, 1), ("5_6", 512, 1024, 2),
            ("6", 1024, 1024, 1)]
    for name, cin, cout, stride in plan:
        ls, bottom = _dw_sep(name, bottom, cin, cout, stride, bn_fraction)
        layers += ls
    layers += [
        PoolingLayer("pool6", [bottom], Pooling.Ave, global_pooling=True),
        ConvolutionLayer("fc7", ["pool6"], kernel=(1, 1),
                         num_output=num_classes, weight_filler=_gauss(0.01),
                         bias_filler=_const(0.0)),
        FlattenLayer("flat7", ["fc7"]),
        SoftmaxWithLoss("loss", ["flat7", "label"]),
        AccuracyLayer("accuracy", ["flat7", "label"], phase="TEST"),
        AccuracyLayer("accuracy_top5", ["flat7", "label"], top_k=5,
                      phase="TEST"),
    ]
    return NetParam("MobileNet_v1", *layers)


def mobilenet_solver() -> SolverConfig:
    """Adapted recipe (the v1 paper trained with RMSProp on an internal
    system and shipped no Caffe solver): SGD momentum 0.9, base_lr 0.01
    stepped /10 — the BN-ful net is schedule-tolerant."""
    return SolverConfig(
        base_lr=0.01, lr_policy="step", gamma=0.1, stepsize=100000,
        momentum=0.9, weight_decay=4e-5, max_iter=300000,
        solver_type="SGD", display=40, snapshot_prefix="mobilenet",
    )


def squeezenet_solver() -> SolverConfig:
    """The official v1.1 recipe: SGD momentum 0.9, base_lr 0.04 with
    linear (poly power 1) decay, weight decay 2e-4 (forresti/SqueezeNet
    solver.prototxt)."""
    return SolverConfig(
        base_lr=0.04, lr_policy="poly", power=1.0, momentum=0.9,
        weight_decay=2e-4, max_iter=170000, solver_type="SGD",
        display=40, snapshot_prefix="squeezenet",
    )


# ---------------------------------------------------------------------------
# The MNIST siamese net (ref: caffe/examples/siamese/
# mnist_siamese_train_test.prototxt): two LeNet towers sharing every param
# by name, a contrastive loss on their embeddings.  The deep autoencoder
# (ref: caffe/examples/mnist/mnist_autoencoder.prototxt).
# ---------------------------------------------------------------------------
def _shared(m: Message, *names: str) -> Message:
    """Attach named param{} messages for cross-layer weight sharing.
    lr_mults follow the reference siamese file: weights 1, biases 2."""
    for n, lr in zip(names, (1.0, 2.0)):
        m.add("param", Message().set("name", n).set("lr_mult", lr))
    return m


def _siamese_tower(suffix: str, bottom: str, embed_dim: int) -> list[Message]:
    s = suffix
    return [
        _shared(ConvolutionLayer(f"conv1{s}", [bottom], kernel=(5, 5),
                                 num_output=20), "conv1_w", "conv1_b"),
        PoolingLayer(f"pool1{s}", [f"conv1{s}"], Pooling.Max,
                     kernel=(2, 2), stride=(2, 2)),
        _shared(ConvolutionLayer(f"conv2{s}", [f"pool1{s}"], kernel=(5, 5),
                                 num_output=50), "conv2_w", "conv2_b"),
        PoolingLayer(f"pool2{s}", [f"conv2{s}"], Pooling.Max,
                     kernel=(2, 2), stride=(2, 2)),
        _shared(InnerProductLayer(f"ip1{s}", [f"pool2{s}"], num_output=500),
                "ip1_w", "ip1_b"),
        ReLULayer(f"relu1{s}", [f"ip1{s}"], in_place=True),
        _shared(InnerProductLayer(f"ip2{s}", [f"ip1{s}"], num_output=10),
                "ip2_w", "ip2_b"),
        _shared(InnerProductLayer(f"feat{s}", [f"ip2{s}"],
                                  num_output=embed_dim), "feat_w", "feat_b"),
    ]


def mnist_siamese(batch: int = 64, embed_dim: int = 2, margin: float = 1.0) -> Message:
    slice_layer = Message()
    slice_layer.set("name", "slice_pair").set("type", "Slice")
    slice_layer.add("bottom", "pair_data")
    slice_layer.add("top", "data")
    slice_layer.add("top", "data_p")
    slice_layer.set(
        "slice_param", Message().set("slice_dim", 1).set("slice_point", 1)
    )
    loss = Message()
    loss.set("name", "loss").set("type", "ContrastiveLoss")
    for b in ("feat", "feat_p", "sim"):
        loss.add("bottom", b)
    loss.add("top", "loss")
    loss.set("contrastive_loss_param", Message().set("margin", margin))
    return NetParam(
        "mnist_siamese",
        RDDLayer("pair_data", shape=[batch, 2, 28, 28]),
        RDDLayer("sim", shape=[batch]),
        slice_layer,
        *_siamese_tower("", "data", embed_dim),
        *_siamese_tower("_p", "data_p", embed_dim),
        loss,
    )


def mnist_siamese_solver() -> SolverConfig:
    """ref: caffe/examples/siamese/mnist_siamese_solver.prototxt."""
    return SolverConfig(
        base_lr=0.01, lr_policy="inv", gamma=1e-4, power=0.75,
        momentum=0.9, weight_decay=0.0, max_iter=50000,
        solver_type="SGD", display=500,
    )


def _sparse_gauss(std: float, sparse: int) -> Message:
    m = _filler("gaussian", std=std)
    m.set("sparse", sparse)
    return m


def _ae_ip(name: str, bottom: str, n: int) -> Message:
    """Autoencoder InnerProduct: gaussian(std=1, sparse=15) weights, lr_mult
    1/1 with decay_mult 1/0 (ref: mnist_autoencoder.prototxt:58-84)."""
    m = InnerProductLayer(
        name, [bottom], num_output=n,
        weight_filler=_sparse_gauss(1.0, 15),
        bias_filler=_filler("constant", value=0.0),
    )
    for decay in (1.0, 0.0):
        m.add("param", Message().set("lr_mult", 1.0).set("decay_mult", decay))
    return m


def mnist_autoencoder(batch: int = 100) -> Message:
    """Deep autoencoder 784-1000-500-250-30-250-500-1000-784 with sigmoid
    cross-entropy reconstruction loss and a loss_weight=0 euclidean monitor
    (ref: caffe/examples/mnist/mnist_autoencoder.prototxt)."""
    layers = [
        RDDLayer("data", shape=[batch, 1, 28, 28]),
        FlattenLayer("flatdata", ["data"]),
        _ae_ip("encode1", "data", 1000),
        SigmoidLayer("encode1neuron", ["encode1"]),
        _ae_ip("encode2", "encode1neuron", 500),
        SigmoidLayer("encode2neuron", ["encode2"]),
        _ae_ip("encode3", "encode2neuron", 250),
        SigmoidLayer("encode3neuron", ["encode3"]),
        _ae_ip("encode4", "encode3neuron", 30),
        _ae_ip("decode4", "encode4", 250),
        SigmoidLayer("decode4neuron", ["decode4"]),
        _ae_ip("decode3", "decode4neuron", 500),
        SigmoidLayer("decode3neuron", ["decode3"]),
        _ae_ip("decode2", "decode3neuron", 1000),
        SigmoidLayer("decode2neuron", ["decode2"]),
        _ae_ip("decode1", "decode2neuron", 784),
        SigmoidCrossEntropyLossLayer(
            "loss", ["decode1", "flatdata"], loss_weight=1.0,
            top="cross_entropy_loss"),
        SigmoidLayer("decode1neuron", ["decode1"]),
        EuclideanLossLayer(
            "l2_monitor", ["decode1neuron", "flatdata"], loss_weight=0.0,
            top="l2_error"),
    ]
    return NetParam("MNISTAutoencoder", *layers)


def mnist_autoencoder_solver() -> SolverConfig:
    """ref: caffe/examples/mnist/mnist_autoencoder_solver.prototxt."""
    return SolverConfig(
        base_lr=0.01, lr_policy="step", gamma=0.1, stepsize=10000,
        momentum=0.9, weight_decay=0.0005, max_iter=65000,
        solver_type="SGD", display=100, snapshot=10000,
    )


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
    # depthwise group conv + BatchNorm state
    "mobilenet": GraphFamily(
        solver=lambda: dataclasses.replace(mobilenet_solver(), base_lr=1e-3),
        net=lambda b: mobilenet(batch=b, num_classes=5, crop=64),
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
            p = network.layer_params(layer.name, variables.params)
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
