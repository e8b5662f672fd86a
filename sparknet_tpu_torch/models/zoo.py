"""The reference model zoo's CNN builders, rebuilt with the layer DSL.

Copy of the net builders of ``sparknet_tpu/models/zoo.py`` the serving
path needs (ref: caffe/examples/mnist/lenet_train_test.prototxt,
caffe/examples/cifar10/cifar10_{quick,full}_train_test.prototxt,
caffe/models/bvlc_alexnet/train_val.prototxt,
caffe/models/bvlc_reference_caffenet/train_val.prototxt).  Architectures are
the published ones; data enters through RDD layers and batch is a builder
argument.  The ``*_solver()`` recipes are the published solver.prototxt
settings of each; the other families are ROADMAP Queue A10.
"""

from __future__ import annotations

from sparknet_tpu_torch.layers_dsl import (
    AccuracyLayer,
    ConvolutionLayer,
    DropoutLayer,
    InnerProductLayer,
    LRNLayer,
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
