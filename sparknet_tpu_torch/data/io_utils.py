"""Image helpers — the pycaffe ``caffe.io`` surface the Classifier needs.

Copy of the host-only part of ``sparknet_tpu/data/io_utils.py``, which
mirrors ``caffe/python/caffe/io.py`` (reference): ``resize_image`` (:305),
``oversample`` 10-crop (:340) and the ``Transformer`` preprocessing adapter
(:100-276).  Image resize uses PIL, as in the JAX package, interpolating
float images channel by channel.  The binaryproto and datum helpers are
ROADMAP Queue A9.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_image", "fivecrop_origins", "oversample", "Transformer"]


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
