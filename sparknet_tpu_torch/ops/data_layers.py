"""Data layers — graph *inputs*, not ops.

Counterpart of ``sparknet_tpu/ops/data_layers.py``.  A data layer declares
named input blobs and their shapes; the caller feeds the tensors.  The port
carries the feed-shape layers the serving path meets: ``Input`` (deploy
nets), ``MemoryData``, ``JavaData`` (the RDD-callback layer the zoo
builders use through ``layers_dsl.RDDLayer``) and ``Data`` (a DB-backed
source whose geometry comes from its DB, the ``--data db:`` path of the
CLI).  Declared shapes are canonical Caffe blob order, (N, C, H, W) for
images.
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


def _transform_shape(lp, base_shape):
    """Apply transform_param's crop to a declared (C, H, W)."""
    crop = lp.get_msg("transform_param").get_int("crop_size", 0)
    if crop and len(base_shape) == 3:
        return (base_shape[0], crop, crop)
    return base_shape


@register
class Data(InputLayer):
    """LMDB/LevelDB/RecordDB-backed source in the reference (ref:
    data_layer.cpp); here a named input whose batch size comes from
    data_param.  Geometry follows Caffe: the DB defines the blob shape,
    read from its first datum (ref: data_layer.cpp:40-48): peeked from
    ``data_param.source`` when that exists on disk, else from the DB the
    caller streams (the CLI's ``--data db:``), else from the feeds."""

    TYPE = "Data"

    def batch_size(self) -> int:
        return self.lp.get_msg("data_param").get_int("batch_size", 0)

    def shapes_for_chw(self, chw):
        """Top shapes given a record's (C, H, W): the first top is the
        (cropped) image, every further top a per-sample scalar."""
        n = self.batch_size()
        if not n:
            return None
        chw = _transform_shape(self.lp, tuple(chw))
        return [layout.internal_shape((n, *chw))] + [(n,)] * (len(self.tops) - 1)

    def blob_shapes(self):
        import os

        source = self.lp.get_msg("data_param").get_str("source")
        if not (source and os.path.exists(source)):
            return None
        from sparknet_tpu_torch.data.createdb import peek_db_shape

        try:
            chw = peek_db_shape(source)
        except (OSError, ValueError):
            return None  # an unreadable or empty DB: shapes from the feeds
        return self.shapes_for_chw(chw)


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
