"""Layer registry keyed by prototxt ``type`` string.

Counterpart of ``sparknet_tpu/ops/registry.py`` (ref:
caffe/src/caffe/layer_factory.cpp:41-214).  Legacy V1 ALL_CAPS type names
alias to their modern names.  The port registers only the layer types it
has ported; a type the JAX package has but the port does not yet raises
``NotImplementedError`` naming the ROADMAP queue item that ports it.
"""

from __future__ import annotations

from sparknet_tpu_torch.common import Phase
from sparknet_tpu_torch.ops.base import Layer
from sparknet_tpu_torch.proto.text_format import Message

_REGISTRY: dict[str, type[Layer]] = {}

# ref: caffe/src/caffe/util/upgrade_proto.cpp UpgradeV1LayerType
_V1_ALIASES = {
    "CONVOLUTION": "Convolution",
    "DECONVOLUTION": "Deconvolution",
    "POOLING": "Pooling",
    "LRN": "LRN",
    "RELU": "ReLU",
    "PRELU": "PReLU",
    "SIGMOID": "Sigmoid",
    "TANH": "TanH",
    "ABSVAL": "AbsVal",
    "BNLL": "BNLL",
    "DROPOUT": "Dropout",
    "EXP": "Exp",
    "POWER": "Power",
    "THRESHOLD": "Threshold",
    "INNER_PRODUCT": "InnerProduct",
    "CONCAT": "Concat",
    "SLICE": "Slice",
    "SPLIT": "Split",
    "FLATTEN": "Flatten",
    "RESHAPE": "Reshape",
    "ELTWISE": "Eltwise",
    "ARGMAX": "ArgMax",
    "MVN": "MVN",
    "SILENCE": "Silence",
    "ACCURACY": "Accuracy",
    "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "EUCLIDEAN_LOSS": "EuclideanLoss",
    "HINGE_LOSS": "HingeLoss",
    "INFOGAIN_LOSS": "InfogainLoss",
    "CONTRASTIVE_LOSS": "ContrastiveLoss",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "DATA": "Data",
    "IMAGE_DATA": "ImageData",
    "HDF5_DATA": "HDF5Data",
    "HDF5_OUTPUT": "HDF5Output",
    "MEMORY_DATA": "MemoryData",
    "WINDOW_DATA": "WindowData",
    "DUMMY_DATA": "DummyData",
}

# Layer types of the JAX package that the port has not ported yet, with
# the ROADMAP queue item that ports them.
_NOT_YET_PORTED = {
    "HDF5Data": "Queue A9 (HDF5 waits for h5py on the card's machine)",
    "HDF5Output": "Queue A9 (HDF5 waits for h5py on the card's machine)",
}


def register(cls: type[Layer]) -> type[Layer]:
    if not cls.TYPE:
        raise TypeError(f"{cls} missing TYPE")
    _REGISTRY[cls.TYPE] = cls
    return cls


def get_layer_class(type_name: str) -> type[Layer]:
    type_name = _V1_ALIASES.get(type_name, type_name)
    if type_name in _REGISTRY:
        return _REGISTRY[type_name]
    if type_name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"layer type {type_name!r} is not ported to sparknet_tpu_torch "
            f"yet (ROADMAP {_NOT_YET_PORTED[type_name]})")
    raise KeyError(
        f"Unknown layer type {type_name!r}. Registered: {sorted(_REGISTRY)}"
    )


def create_layer(lp: Message, phase: Phase) -> Layer:
    return get_layer_class(lp.get_str("type"))(lp, phase)

