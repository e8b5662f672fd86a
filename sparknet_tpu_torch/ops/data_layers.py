"""Data layers — graph *inputs*, not ops.

Counterpart of ``sparknet_tpu/ops/data_layers.py``.  A data layer declares
named input blobs and their shapes; the caller feeds the tensors.  The port
carries ``Input`` (deploy nets), ``MemoryData``, ``JavaData`` (the
RDD-callback layer the zoo builders use through ``layers_dsl.RDDLayer``),
``Data`` (a DB-backed source whose geometry comes from its DB, the
``--data db:`` path of the CLI), ``ImageData`` and ``WindowData`` (list
files, streamed on the host by ``data/listfile.py``) and ``DummyData``, the
one source that feeds itself (``SELF_FEEDING``: its tops are made by the
layer, never fed).
Declared shapes are canonical Caffe blob order, (N, C, H, W) for images.
"""

from __future__ import annotations

import torch

from sparknet_tpu_torch.ops import fillers, layout
from sparknet_tpu_torch.ops.base import Layer
from sparknet_tpu_torch.ops.registry import register


class InputLayer(Layer):
    """Base for all source layers: tops are fed externally, and
    ``Network`` skips the layer when it runs.  A ``SELF_FEEDING`` source
    makes its tops itself (``constant_values``), and ``Network`` takes
    them as present instead of asking for feeds."""

    SELF_FEEDING = False

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
class ImageData(InputLayer):
    """File-list image source (ref: image_data_layer.cpp), fed by the host
    stream ``data.listfile.ImageDataSource``."""

    TYPE = "ImageData"

    def batch_size(self) -> int:
        return self.lp.get_msg("image_data_param").get_int("batch_size", 0)

    def blob_shapes(self):
        """The crop_size, else new_height/new_width, else the size of the
        first listed image decoded, as the reference takes it
        (image_data_layer.cpp:65-77); None when none is known."""
        p = self.lp.get_msg("image_data_param")
        n = p.get_int("batch_size", 0)
        c = 3 if p.get_bool("is_color", True) else 1
        crop = self.lp.get_msg("transform_param").get_int("crop_size", 0)
        h, w = (crop, crop) if crop else (p.get_int("new_height", 0),
                                          p.get_int("new_width", 0))
        if not (h and w):
            import os

            from PIL import Image

            try:
                with open(p.get_str("source", "")) as f:
                    first = f.readline().split()[0]
                with Image.open(os.path.join(p.get_str("root_folder", ""), first)) as img:
                    w, h = img.size
            except (OSError, IndexError):
                return None  # no list or image on this host: shapes from the feeds
        if not (n and h and w):
            return None
        return [layout.internal_shape((n, c, h, w)), (n,)]


@register
class WindowData(InputLayer):
    """R-CNN window source (ref: window_data_layer.cpp), fed by the host
    stream ``data.listfile.WindowDataSource``."""

    TYPE = "WindowData"

    def batch_size(self) -> int:
        return self.lp.get_msg("window_data_param").get_int("batch_size", 0)

    def blob_shapes(self):
        """(batch, 3, crop, crop): WindowData always warps to
        transform_param.crop_size (window_data_layer.cpp:171-177)."""
        n = self.batch_size()
        crop = self.lp.get_msg("transform_param").get_int("crop_size", 0)
        if not (n and crop):
            return None
        return [layout.internal_shape((n, 3, crop, crop)), (n,)]


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


@register
class DummyData(InputLayer):
    """Constant or filler-made blobs (ref: dummy_data_layer.cpp), which need
    no feeding.  The values are made once, on the CPU, from a generator
    seeded with 0 (the JAX layer draws from ``jax.random.key(0)``, so random
    fillers give other values than JAX's, of the same distribution), and
    kept a device."""

    TYPE = "DummyData"
    SELF_FEEDING = True

    def __init__(self, lp, phase):
        super().__init__(lp, phase)
        self._values: dict = {}

    def blob_shapes(self):
        p = self.lp.get_msg("dummy_data_param")
        shapes = [tuple(int(d) for d in s.get_all("dim")) for s in p.get_all("shape")]
        if not shapes:  # legacy num/channels/height/width (the last value repeats)
            nums = p.get_all("num")
            chans = p.get_all("channels") or [1]
            heights = p.get_all("height") or [1]
            widths = p.get_all("width") or [1]

            def pick(lst, i):
                return int(lst[min(i, len(lst) - 1)])

            shapes = [(int(nums[i]), pick(chans, i), pick(heights, i), pick(widths, i))
                      for i in range(len(nums))]
        while len(shapes) < len(self.tops):  # the last shape covers the other tops
            shapes.append(shapes[-1])
        return [layout.internal_shape(s) for s in shapes]

    def constant_values(self, device="cpu") -> list:
        """The tops' tensors on ``device``: zeros without a ``data_filler``,
        else the filler of the top's index (the last one repeats)."""
        device = torch.device(device)
        if device.type == "meta":
            return [torch.empty(s, device="meta") for s in self.blob_shapes()[:len(self.tops)]]
        if "cpu" not in self._values:
            fill_msgs = self.lp.get_msg("dummy_data_param").get_all("data_filler")
            gen = torch.Generator().manual_seed(0)
            self._values["cpu"] = [
                fillers.fill(fill_msgs[min(i, len(fill_msgs) - 1)], gen, shape)
                if fill_msgs else torch.zeros(shape, dtype=torch.float32)
                for i, shape in enumerate(self.blob_shapes()[:len(self.tops)])]
        if str(device) not in self._values:
            self._values[str(device)] = [v.to(device) for v in self._values["cpu"]]
        return self._values[str(device)]
