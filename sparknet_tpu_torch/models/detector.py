"""Windowed R-CNN-style detector — pycaffe ``caffe.Detector`` parity.

Counterpart of ``sparknet_tpu/models/detector.py`` (ref:
caffe/python/caffe/detector.py:22-211): classify a list of image windows,
each cropped (with ``context_pad`` pixels of surrounding context, padded
with the mean where it runs off the image) and warped to the net input.
The selective-search proposal mode (detector.py:101-124) needed an
external MATLAB package in the reference and is not reproduced; callers
pass explicit windows.  The int8 and BatchNorm-folding arms come from
``DeployNet``.
"""

from __future__ import annotations

import numpy as np

from sparknet_tpu_torch.data import io_utils as cio
from sparknet_tpu_torch.models.deploy import DeployNet


class Detector(DeployNet):
    def __init__(
        self,
        model_file,
        pretrained_file=None,
        mean=None,
        input_scale=None,
        raw_scale=None,
        channel_swap=None,
        context_pad=None,
        device=None,
    ):
        super().__init__(
            model_file,
            pretrained_file,
            mean=mean,
            input_scale=input_scale,
            raw_scale=raw_scale,
            channel_swap=channel_swap,
            device=device,
        )
        self.configure_crop(context_pad)

    def window_inputs(self, images_windows) -> np.ndarray:
        """(image, window-list) pairs -> the preprocessed (M, C, h, w) net
        input of every window, in order."""
        crops = [self.crop(self._load(image_src), window)
                 for image_src, windows in images_windows for window in windows]
        in_ = self.inputs[0]
        in_dims = self.feed_shapes[in_][2:]
        caffe_in = np.zeros((len(crops), crops[0].shape[2]) + tuple(in_dims), np.float32)
        for ix, window_in in enumerate(crops):
            caffe_in[ix] = self.transformer.preprocess(in_, window_in)
        return caffe_in

    def detect_windows(self, images_windows) -> list[dict]:
        """(image, window-list) pairs -> one prediction dict a window.

        ``images_windows`` items are ``(filename_or_array, windows)``, each
        window (ymin, xmin, ymax, xmax) (detector.py:56-99).
        """
        images_windows = [(im, [np.asarray(w) for w in windows])
                          for im, windows in images_windows]
        caffe_in = self.window_inputs(images_windows)
        out = self.forward_all(self.inputs[0], caffe_in)
        predictions = out[self.outputs[0]].reshape(len(caffe_in), -1)
        detections = []
        ix = 0
        for image_src, windows in images_windows:
            fname = image_src if isinstance(image_src, str) else None
            for window in windows:
                detections.append({"window": window, "prediction": predictions[ix],
                                   "filename": fname})
                ix += 1
        return detections

    @staticmethod
    def _load(src) -> np.ndarray:
        if isinstance(src, str):
            return cio.load_image(src).astype(np.float32)
        return np.asarray(src, np.float32)

    def crop(self, im: np.ndarray, window) -> np.ndarray:
        """Crop a window, with scaled surrounding context and mean padding
        where the context runs off the image (detector.py:125-180), as two
        passes a axis (``_inflate_span``, ``_axis_paste``): the window is an
        inclusive box, inflated about its center so that its content fills
        the net input less ``context_pad`` on each side; what falls outside
        the image is the unprocessed-space mean."""
        top, left, bottom, right = (int(v) for v in np.asarray(window)[:4])
        if not self.context_pad:
            return im[top:bottom, left:right]

        size = int(self.feed_shapes[self.inputs[0]][3])  # a square net input
        inflate = size / float(size - 2 * self.context_pad)
        rows = _inflate_span(top, bottom, inflate)
        cols = _inflate_span(left, right, inflate)
        src_r, dst_r = _axis_paste(rows, im.shape[0], size)
        src_c, dst_c = _axis_paste(cols, im.shape[1], size)

        context = cio.resize_image(im[src_r[0]:src_r[1], src_c[0]:src_c[1]],
                                   (dst_r[1] - dst_r[0], dst_c[1] - dst_c[0]))
        canvas = np.array(np.broadcast_to(self.crop_mean, tuple(self.crop_dims)), np.float32)
        canvas[dst_r[0]:dst_r[1], dst_c[0]:dst_c[1]] = context
        return canvas

    def configure_crop(self, context_pad) -> None:
        """The crop dims in input-image space and the unprocessed-space mean
        that pads the context (detector.py:181-211)."""
        in_ = self.inputs[0]
        to_image = np.argsort(self.transformer.transpose[in_])
        self.crop_dims = np.asarray(self.feed_shapes[in_][1:])[to_image]
        self.context_pad = context_pad
        if self.context_pad:
            self.crop_mean = self._unprocessed_mean(in_, to_image)

    def _unprocessed_mean(self, in_: str, to_image: np.ndarray) -> np.ndarray:
        """The Transformer's mean pushed back through its own stages into
        raw image space (H, W, K, input units), for the context padding."""
        xf = self.transformer
        mean = xf.mean.get(in_)
        if mean is None:
            return np.zeros(tuple(self.crop_dims), np.float32)
        m = np.asarray(mean, np.float32).transpose(to_image)
        if m.shape[:2] == (1, 1):  # a per-channel mean, broadcast spatially
            m = np.broadcast_to(m, tuple(self.crop_dims))
        swap = xf.channel_swap.get(in_)
        if swap is not None:
            m = m[:, :, np.argsort(swap)]
        m = np.array(m, np.float32)
        raw_scale = xf.raw_scale.get(in_)
        if raw_scale is not None:
            m /= raw_scale
        return m


def _inflate_span(lo: int, hi: int, factor: float) -> tuple[float, float]:
    """Scale an inclusive 1-D span about its center; rounded endpoints."""
    half = (hi - lo + 1) / 2.0
    mid = lo + half
    return float(np.round(mid - factor * half)), float(np.round(mid + factor * half))


def _axis_paste(span: tuple[float, float], limit: int,
                out_size: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Map one axis of an inclusive source span onto a length-``out_size``
    destination: ``((src_lo, src_hi), (dst_lo, dst_hi))``, the in-bounds
    part of the span and where its resized image lands (the rest is
    padding)."""
    zoom = out_size / (span[1] - span[0] + 1)
    dst_lo = int(round(max(0.0, -span[0]) * zoom))
    src_lo = int(min(max(span[0], 0.0), limit))
    src_hi = int(min(max(span[1], 0.0), limit))
    if src_hi <= src_lo:
        raise ValueError(f"window span {span} lies outside the image")
    dst_len = min(int(round((src_hi - src_lo + 1) * zoom)), out_size - dst_lo)
    return (src_lo, src_hi), (dst_lo, dst_lo + dst_len)
