"""Layer/op library: Caffe-semantic ops as functions on torch tensors.

Importing this package registers the layer types the port has ported (the
analog of ``REGISTER_LAYER_CLASS``, ref:
caffe/src/caffe/layer_factory.cpp:41-214).  Any other layer type of the
JAX package raises ``NotImplementedError`` naming its ROADMAP queue item
(``ops/registry.py``).
"""

from sparknet_tpu_torch.ops.base import Layer, LayerOutput  # noqa: F401
from sparknet_tpu_torch.ops.registry import create_layer, get_layer_class, register  # noqa: F401

# Side-effect imports: populate the registry.
from sparknet_tpu_torch.ops import data_layers  # noqa: F401
from sparknet_tpu_torch.ops import vision  # noqa: F401
from sparknet_tpu_torch.ops import neuron  # noqa: F401
from sparknet_tpu_torch.ops import blocks  # noqa: F401
from sparknet_tpu_torch.ops import loss  # noqa: F401
from sparknet_tpu_torch.ops import attention  # noqa: F401
from sparknet_tpu_torch.ops import moe  # noqa: F401
from sparknet_tpu_torch.ops import python_layer  # noqa: F401
