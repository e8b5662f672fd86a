"""Image and proto helpers — the pycaffe ``caffe.io`` surface.

Copy of ``sparknet_tpu/data/io_utils.py``, which mirrors
``caffe/python/caffe/io.py`` (reference): ``load_image`` (:278),
``resize_image`` (:305), ``oversample`` 10-crop (:340), the ``Transformer``
preprocessing adapter (:100-276), and the proto/ndarray converters
``blobproto_to_array``/``array_to_blobproto`` (:18-46) and
``array_to_datum``/``datum_to_array`` (:66-94).  The converters speak the
serialized wire format (``bytes`` in, ``bytes`` out) through the proto2
codec of ``sparknet_tpu_torch/proto/binary.py``; images decode and resize
with PIL, float images channel by channel.
"""

from __future__ import annotations

import struct

import numpy as np

from sparknet_tpu_torch.proto.binary import (
    _LEN,
    _VARINT,
    _decode_blob,
    _encode_blob,
    _len_field,
    _scan,
    _tag,
    _varint,
)

__all__ = ["load_image", "resize_image", "fivecrop_origins", "oversample",
           "Transformer", "blobproto_to_array", "array_to_blobproto",
           "array_to_datum", "datum_to_array", "save_mean_binaryproto",
           "load_mean_binaryproto"]


# ---------------------------------------------------------------------------
# BlobProto <-> ndarray (serialized wire bytes; ref io.py:18-46)
# ---------------------------------------------------------------------------


def blobproto_to_array(buf: bytes) -> np.ndarray:
    """Decode a serialized ``BlobProto`` into a float32 ndarray, from the
    ``shape`` message or the legacy num/channels/height/width fields (ref
    io.py:30-35)."""
    return _decode_blob(buf)


def array_to_blobproto(arr: np.ndarray) -> bytes:
    """Encode an ndarray as serialized ``BlobProto`` bytes (shape + float
    data)."""
    return _encode_blob(np.asarray(arr, np.float32))


def save_mean_binaryproto(path: str, mean: np.ndarray) -> None:
    """Write a mean image as a ``.binaryproto`` BlobProto file of shape
    (1, C, H, W), as ``save_mean_image`` of the C shim does (ref:
    libccaffe/ccaffe.cpp:83-97)."""
    mean = np.asarray(mean, np.float32)
    if mean.ndim == 3:
        mean = mean[None]
    with open(path, "wb") as f:
        f.write(_encode_blob(mean))


def load_mean_binaryproto(path: str) -> np.ndarray:
    """Read a ``.binaryproto`` mean file to a (C, H, W) float32 array."""
    with open(path, "rb") as f:
        arr = _decode_blob(f.read())
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    return arr


# ---------------------------------------------------------------------------
# Image IO (ref io.py:278-338)
# ---------------------------------------------------------------------------


def load_image(filename: str, color: bool = True) -> np.ndarray:
    """Load an image to float32 in [0, 1], (H, W, 3) RGB or (H, W, 1) gray;
    alpha is dropped (ref io.py:278-303)."""
    from PIL import Image

    with Image.open(filename) as im:
        if color:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
        else:
            arr = (np.asarray(im.convert("L"), np.float32) / 255.0)[:, :, None]
    return arr


def resize_image(
    im: np.ndarray, new_dims: tuple[int, int], interp_order: int = 1
) -> np.ndarray:
    """Resize (H, W, K) float image to ``new_dims`` with interpolation.

    Reference semantics (io.py:305-338): values are interpolated in the
    image's own range (no clipping to [0, 1]); a constant image short-circuits.
    ``interp_order`` 0 = nearest, anything else = bilinear.
    """
    from PIL import Image

    im = np.asarray(im, np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    h, w = int(new_dims[0]), int(new_dims[1])
    if im.size:
        im_min, im_max = float(im.min()), float(im.max())
        if im_max == im_min:
            return np.full((h, w, im.shape[-1]), im_min, np.float32)
    resample = Image.NEAREST if interp_order == 0 else Image.BILINEAR
    out = np.empty((h, w, im.shape[-1]), np.float32)
    # PIL mode "F" resizes one float channel at a time
    for k in range(im.shape[-1]):
        ch = Image.fromarray(im[:, :, k], mode="F")
        out[:, :, k] = np.asarray(ch.resize((w, h), resample), np.float32)
    return out


def fivecrop_origins(image_hw, crop_hw) -> list[tuple[int, int]]:
    """(row, col) origins for the 4 corner crops (row-major) + center.

    The center origin floors to match the reference's truncated
    ``center - crop/2`` arithmetic (io.py:356-359).
    """
    dr, dc = image_hw[0] - crop_hw[0], image_hw[1] - crop_hw[1]
    return [(0, 0), (0, dc), (dr, 0), (dr, dc), (dr // 2, dc // 2)]


def oversample(images, crop_dims) -> np.ndarray:
    """Ten-crop: 4 corners + center, plus horizontal mirrors of each.

    Returns (10*N, h, w, K) float32 in the reference's crop order
    (io.py:340-384: corners row-major, center, then the same five mirrored
    along width).
    """
    batch = np.asarray(list(images), np.float32)  # [N, H, W, K]
    h, w = (int(d) for d in crop_dims)
    five = np.stack(
        [
            batch[:, r : r + h, c : c + w]
            for r, c in fivecrop_origins(batch.shape[1:3], (h, w))
        ],
        axis=1,
    )  # [N, 5, h, w, K]
    ten = np.concatenate([five, five[:, :, :, ::-1]], axis=1)
    return ten.reshape(-1, h, w, batch.shape[-1])


class Transformer:
    """Input formatting adapter: (H', W', K) image -> net input blob.

    Declarative stage pipeline: each stage is ``(settings_attr, apply,
    invert)``; unset stages are skipped.  ``preprocess`` runs the table top
    to bottom after resizing to the input dims, giving the reference's
    operation order (io.py:121-161: resize → transpose → channel swap →
    raw_scale → mean subtract → input_scale); ``deprocess`` runs the
    inverses bottom to top (the resize is not inverted, matching
    io.py:163-184).
    """

    _STAGES = (
        (
            "transpose",
            lambda x, axes: x.transpose(axes),
            lambda x, axes: x.transpose(np.argsort(axes)),
        ),
        (
            "channel_swap",
            lambda x, perm: x[list(perm)],
            lambda x, perm: x[np.argsort(perm)],
        ),
        ("raw_scale", lambda x, k: x * k, lambda x, k: x / k),
        ("mean", lambda x, m: x - m, lambda x, m: x + m),
        ("input_scale", lambda x, k: x * k, lambda x, k: x / k),
    )

    def __init__(self, inputs: dict[str, tuple[int, ...]]):
        self.inputs = dict(inputs)
        self.transpose: dict[str, tuple[int, ...]] = {}
        self.channel_swap: dict[str, tuple[int, ...]] = {}
        self.raw_scale: dict[str, float] = {}
        self.mean: dict[str, np.ndarray] = {}
        self.input_scale: dict[str, float] = {}

    def _check_input(self, in_: str) -> None:
        if in_ not in self.inputs:
            raise ValueError(
                f"{in_} is not one of the net inputs: {sorted(self.inputs)}"
            )

    def preprocess(self, in_: str, data: np.ndarray) -> np.ndarray:
        self._check_input(in_)
        x = np.asarray(data, np.float32)
        spatial = tuple(self.inputs[in_][2:])
        if x.shape[:2] != spatial:
            x = resize_image(x, spatial)
        for attr, apply_stage, _ in self._STAGES:
            setting = getattr(self, attr).get(in_)
            if setting is not None:
                x = apply_stage(x, setting)
        return x

    def deprocess(self, in_: str, data: np.ndarray) -> np.ndarray:
        self._check_input(in_)
        x = np.array(data, np.float32).squeeze()
        for attr, _, invert_stage in reversed(self._STAGES):
            setting = getattr(self, attr).get(in_)
            if setting is not None:
                x = invert_stage(x, setting)
        return x

    def set_transpose(self, in_: str, order) -> None:
        self._check_input(in_)
        if len(order) != len(self.inputs[in_]) - 1:
            raise ValueError(
                "Transpose order needs the same number of dimensions as the input."
            )
        self.transpose[in_] = tuple(order)

    def set_channel_swap(self, in_: str, order) -> None:
        self._check_input(in_)
        if len(order) != self.inputs[in_][1]:
            raise ValueError(
                "Channel swap needs the same number of dimensions as the input channels."
            )
        self.channel_swap[in_] = tuple(order)

    def set_raw_scale(self, in_: str, scale: float) -> None:
        self._check_input(in_)
        self.raw_scale[in_] = float(scale)

    def set_mean(self, in_: str, mean: np.ndarray) -> None:
        """Per-channel (K,) broadcast mean or elementwise (K, H, W) mean
        (ref io.py:235-259)."""
        self._check_input(in_)
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:
            if mean.shape[0] != self.inputs[in_][1]:
                raise ValueError("Mean channels incompatible with input.")
            mean = mean[:, None, None]
        else:
            ms = mean.shape
            if len(ms) == 2:
                ms = (1,) + ms
                mean = mean[None]
            if len(ms) != 3:
                raise ValueError("Mean shape invalid")
            if ms != tuple(self.inputs[in_][1:]):
                raise ValueError("Mean shape incompatible with input shape.")
        self.mean[in_] = mean

    def set_input_scale(self, in_: str, scale: float) -> None:
        self._check_input(in_)
        self.input_scale[in_] = float(scale)


# ---------------------------------------------------------------------------
# Datum <-> ndarray (serialized wire bytes; ref io.py:66-94, caffe.proto:30-41)
# ---------------------------------------------------------------------------

# Datum field numbers (ref: caffe/src/caffe/proto/caffe.proto:30-41)
_DATUM_CHANNELS, _DATUM_HEIGHT, _DATUM_WIDTH = 1, 2, 3
_DATUM_DATA, _DATUM_LABEL, _DATUM_FLOAT = 4, 5, 6


def array_to_datum(arr: np.ndarray, label: int = 0) -> bytes:
    """Encode a (C, H, W) array as serialized ``Datum`` bytes.

    uint8 arrays go into the byte ``data`` field, everything else into
    ``float_data``: the reference's dtype split (io.py:66-80).
    """
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError(f"Incorrect array shape {arr.shape}; want (C, H, W)")
    c, h, w = arr.shape
    out = _tag(_DATUM_CHANNELS, _VARINT) + _varint(c)
    out += _tag(_DATUM_HEIGHT, _VARINT) + _varint(h)
    out += _tag(_DATUM_WIDTH, _VARINT) + _varint(w)
    if arr.dtype == np.uint8:
        out += _len_field(_DATUM_DATA, arr.tobytes())
    else:
        out += _len_field(_DATUM_FLOAT, np.asarray(arr, "<f4").tobytes())
    out += _tag(_DATUM_LABEL, _VARINT) + _varint(int(label))
    return out


def datum_to_array(buf) -> tuple[np.ndarray, int]:
    """Decode serialized ``Datum`` bytes to ``(array(C, H, W), label)``.

    Unlike the reference (io.py:83-94, label read separately), the label is
    returned alongside since there is no message object to hold it.
    """
    c = h = w = label = 0
    raw = None
    floats: list[np.ndarray] = []
    for field, wt, val in _scan(buf):
        if field == _DATUM_CHANNELS and wt == _VARINT:
            c = val
        elif field == _DATUM_HEIGHT and wt == _VARINT:
            h = val
        elif field == _DATUM_WIDTH and wt == _VARINT:
            w = val
        elif field == _DATUM_DATA and wt == _LEN:
            raw = val
        elif field == _DATUM_LABEL and wt == _VARINT:
            # negative int32 arrives as a 64-bit two's-complement varint
            label = val - (1 << 64) if val >= (1 << 63) else val
        elif field == _DATUM_FLOAT:
            if wt == _LEN:
                floats.append(np.frombuffer(val, "<f4"))
            else:
                floats.append(np.frombuffer(struct.pack("<i", val), "<f4"))
    if raw is not None:
        arr = np.frombuffer(raw, np.uint8).reshape(c, h, w)
    else:
        arr = (np.concatenate(floats) if floats else np.zeros(0, np.float32)
               ).astype(np.float32).reshape(c, h, w)
    return arr, int(label)
