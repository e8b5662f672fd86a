"""Real-pixel convergence dataset: scikit-learn's bundled handwritten digits.

Copy of ``sparknet_tpu/data/digits.py``; scikit-learn is imported in the
call, so the module loads without it.  Host only, and never on the
card's path.

The reference's canonical end-to-end checks train on real MNIST/CIFAR
bytes (ref: src/test/scala/libs/CifarSpec.scala:10-94;
caffe/examples/mnist).  This build environment has zero egress and no
MNIST/CIFAR files on disk (the reference ships only download scripts —
caffe/data/mnist/get_mnist.sh), so the strongest available real-pixel
evidence is sklearn's bundled digits set: 1,797 genuine 8x8 handwritten
digit scans (a downsampled UCI/NIST corpus).  `load_digits_dataset`
serves them in the framework's feed convention, optionally upscaled to
LeNet's 28x28 input so the unmodified zoo model trains on them.

docs/CONVERGENCE.md records the accuracy targets this stands in for.
"""

from __future__ import annotations

import numpy as np


def load_digits_dataset(
    upscale: int = 28, test_every: int = 5
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(xtr, ytr, xte, yte): NCHW float32 images in [0, 16] and int32
    labels.  Deterministic split: every ``test_every``-th sample is test.

    Raises ImportError when scikit-learn is unavailable (callers gate).
    """
    from sklearn.datasets import load_digits

    bunch = load_digits()
    images = bunch.images.astype(np.float32)  # [N, 8, 8], values 0..16
    labels = bunch.target.astype(np.int32)

    if upscale and upscale != images.shape[1]:
        images = _bilinear_upscale(images, upscale)

    idx = np.arange(len(labels))
    is_test = idx % test_every == 0
    x = images[:, None]  # NCHW, C=1
    return x[~is_test], labels[~is_test], x[is_test], labels[is_test]


def _bilinear_upscale(batch: np.ndarray, size: int) -> np.ndarray:
    """[N, H, W] -> [N, size, size] bilinear, pure numpy (align-corners
    sampling keeps the stroke geometry without PIL in the loop)."""
    n, h, w = batch.shape
    ys = np.linspace(0, h - 1, size, dtype=np.float32)
    xs = np.linspace(0, w - 1, size, dtype=np.float32)
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    tl = batch[:, y0][:, :, x0]
    tr = batch[:, y0][:, :, x0 + 1]
    bl = batch[:, y0 + 1][:, :, x0]
    br = batch[:, y0 + 1][:, :, x0 + 1]
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def minibatch_fn(
    x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0
) -> "callable":
    """Shuffled epoch-cycling feed fn (it -> feeds dict)."""
    rs = np.random.RandomState(seed)
    order = rs.permutation(len(y))
    per_epoch = len(y) // batch

    def fn(it: int):
        nonlocal order
        slot = it % per_epoch
        if slot == 0 and it:
            order = rs.permutation(len(y))
        sel = order[slot * batch : (slot + 1) * batch]
        return {
            "data": x[sel],
            "label": y[sel],
        }

    return fn
