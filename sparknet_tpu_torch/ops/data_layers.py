"""Data layers — graph *inputs*, not ops.

Counterpart of ``sparknet_tpu/ops/data_layers.py``.  A data layer declares
named input blobs and their shapes; the caller feeds the tensors.  The port
carries the feed-shape layers the serving path meets: ``Input`` (deploy
nets), ``MemoryData`` and ``JavaData`` (the RDD-callback layer the zoo
builders use through ``layers_dsl.RDDLayer``).  Declared shapes are
canonical Caffe blob order, (N, C, H, W) for images.
"""

from __future__ import annotations

from sparknet_tpu_torch.ops import layout
from sparknet_tpu_torch.ops.base import Layer
from sparknet_tpu_torch.ops.registry import register


class InputLayer(Layer):
    """Base for all source layers: tops are fed externally, and
    ``Network`` skips the layer when it runs."""

    def blob_shapes(self) -> list[tuple[int, ...]] | None:
        """Static top shapes if declared in the prototxt, else None."""
        return None


@register
class JavaData(InputLayer):
    """SparkNet's RDD-callback layer (ref: java_data_layer.cpp;
    proto JavaDataParameter caffe.proto:991-993).  Shapes are declared
    inline: shape { dim: ... } repeated per top."""

    TYPE = "JavaData"

    def blob_shapes(self):
        shapes = [layout.internal_shape(int(d) for d in s.get_all("dim"))
                  for s in self.lp.get_msg("java_data_param").get_all("shape")]
        return shapes or None


@register
class MemoryData(InputLayer):
    """ref: memory_data_layer.cpp — declares (batch, C, H, W) + labels."""

    TYPE = "MemoryData"

    def blob_shapes(self):
        p = self.lp.get_msg("memory_data_param")
        n = p.get_int("batch_size")
        c, h, w = p.get_int("channels"), p.get_int("height"), p.get_int("width")
        return [layout.internal_shape((n, c, h, w)), (n,)]


@register
class Input(InputLayer):
    """Modern Caffe `Input` layer with input_param { shape {...} }."""

    TYPE = "Input"

    def blob_shapes(self):
        shapes = [layout.internal_shape(int(d) for d in s.get_all("dim"))
                  for s in self.lp.get_msg("input_param").get_all("shape")]
        return shapes or None
