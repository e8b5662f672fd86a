"""Image classifier specialization — pycaffe ``caffe.Classifier`` parity.

Counterpart of ``sparknet_tpu/models/classifier.py`` (ref:
caffe/python/caffe/classifier.py:11-99): scale input images to
``image_dims``, center-crop or 10-crop oversample to the net's input size,
preprocess through the Transformer, forward, and (for oversampling) average
predictions over the 10 crops.  ``calibrate_int8`` switches it to the int8
deploy path (``quant.py``).
"""

from __future__ import annotations

import numpy as np

from sparknet_tpu_torch.data import io_utils as cio
from sparknet_tpu_torch.models.deploy import DeployNet


class Classifier(DeployNet):
    def __init__(
        self,
        model_file,
        pretrained_file=None,
        image_dims=None,
        mean=None,
        input_scale=None,
        raw_scale=None,
        channel_swap=None,
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
        in_ = self.inputs[0]
        self.crop_dims = np.array(self.feed_shapes[in_][2:])
        self.image_dims = tuple(image_dims) if image_dims else tuple(self.crop_dims)

    def preprocess_images(self, inputs, oversample: bool) -> np.ndarray:
        """resize -> crop(s) -> transformer: the (M, C, h, w) net-ready
        blob batch."""
        resized = np.stack(
            [
                cio.resize_image(np.asarray(im, np.float32), self.image_dims)
                for im in inputs
            ]
        )
        if oversample:
            crops = cio.oversample(resized, self.crop_dims)
        else:
            h, w = (int(d) for d in self.crop_dims)
            r, c = cio.fivecrop_origins(self.image_dims, (h, w))[-1]
            crops = resized[:, r : r + h, c : c + w]
        in_ = self.inputs[0]
        return np.stack(
            [self.transformer.preprocess(in_, im) for im in crops]
        ).astype(np.float32)

    def calibrate_int8(self, images=None, oversample: bool = False, *,
                       blobs=None) -> dict:
        """Calibrate the int8 deploy path on representative images (through
        the preprocessing ``predict`` applies), then switch this
        classifier's forward to it; returns the quant state.  ``blobs`` from
        :meth:`preprocess_images` skip the preprocessing.  Every sample
        counts toward the activation scales: a ragged tail is filled by
        cycling the samples (a dropped outlier would shrink x_scale and
        clip at inference)."""
        if blobs is None:
            blobs = self.preprocess_images(images, oversample)
        in_ = self.inputs[0]
        batch = self.feed_shapes[in_][0]
        reps = -(-batch // len(blobs)) if len(blobs) < batch else 1
        padded = np.concatenate([blobs] * reps) if reps > 1 else blobs
        tail = len(padded) % batch
        if tail:
            padded = np.concatenate([padded, padded[:batch - tail]])
        chunks = [{in_: padded[lo : lo + batch]} for lo in range(0, len(padded), batch)]
        return self.quantize_int8(chunks, num_batches=len(chunks))

    def predict(self, inputs, oversample: bool = True) -> np.ndarray:
        """(N) iterable of (H, W, K) images -> (N, C) class probabilities."""
        return self.predict_blobs(
            self.preprocess_images(inputs, oversample), oversample
        )

    def predict_blobs(self, blobs: np.ndarray,
                      oversample: bool = True) -> np.ndarray:
        """Forward already-preprocessed (M, C, h, w) blobs (one row per
        crop) -> (N, C) probabilities."""
        probs = self.forward_all(self.inputs[0], blobs)[self.outputs[0]]
        probs = probs.reshape(len(blobs), -1)
        if oversample:
            probs = probs.reshape(-1, 10, probs.shape[-1]).mean(axis=1)
        return probs
