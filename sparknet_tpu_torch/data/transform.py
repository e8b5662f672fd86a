"""Per-sample augmentation on the host: scale, mirror, crop, mean subtraction.

Copy of ``sparknet_tpu/data/transform.py``, the equivalent of Caffe's
``DataTransformer`` (ref: caffe/src/caffe/util/data_transformer.cpp:19-119:
mean_file/mean_value subtract, random crop + mirror in TRAIN, center crop in
TEST, scale).  Whole-batch vectorized numpy with a seeded RandomState, so
the same seed draws the same windows as the JAX package's transformer.

``backend="native"`` runs uint8 NCHW batches through the multithreaded C++
transform (``sparknet_tpu_torch.native.transform_batch``, built from
``native/sparknet_native.cpp``), seeded per call as the JAX package does;
it raises if that library cannot be built or loaded.  Mean files load from
``.npy`` or Caffe ``.binaryproto``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def load_mean_file(path: str) -> np.ndarray:
    """Load a mean image from ``.npy`` or Caffe ``.binaryproto`` (ref:
    data_transformer.cpp:19-29 reads mean_file as a BlobProto)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from sparknet_tpu_torch.data.io_utils import load_mean_binaryproto

    return load_mean_binaryproto(path)


def resolve_mean_file(path: str, anchor: str = "") -> str:
    """Resolve a transform_param.mean_file the way net: paths resolve:
    CWD-relative first (Caffe), then walking up from ``anchor`` (the
    solver/net file that declared it).  A missing mean_file raises a clear
    error instead of silently training without mean subtraction (Caffe
    CHECK-fails, ref: data_transformer.cpp ReadProtoFromBinaryFile)."""
    if os.path.exists(path):
        return path
    if anchor and not os.path.isabs(path):
        d = os.path.dirname(os.path.abspath(anchor))
        while True:
            cand = os.path.join(d, path)
            if os.path.exists(cand):
                return cand
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    raise ValueError(
        f"transform_param.mean_file {path!r} not found (generate one with "
        "`tpunet compute_image_mean`, or remove the field to train "
        "without mean subtraction)"
    )


@dataclasses.dataclass
class TransformConfig:
    """ref: TransformationParameter (caffe.proto:399-426)."""

    scale: float = 1.0
    mirror: bool = False
    crop_size: int = 0
    mean_value: tuple[float, ...] = ()  # per-channel
    mean_image: np.ndarray | None = None  # full mean image (C,H,W)
    seed: int | None = None
    backend: str = "numpy"  # "numpy" | "native" (multithreaded C++)


class DataTransformer:
    """``layout`` is the WIRE orientation of the batches this instance
    transforms: ``"nchw"`` (default, Caffe blob order) or ``"nhwc"``
    (channels-last, the order image bytes arrive off the wire).  The mean
    image is declared canonical (C, H, W) and reoriented once at
    construction."""

    def __init__(self, config: TransformConfig, layout: str = "nchw"):
        if layout not in ("nchw", "nhwc"):
            raise ValueError(f"unknown layout {layout!r} (nchw|nhwc)")
        if layout == "nhwc" and config.backend == "native":
            raise ValueError(
                "the native transform backend is NCHW-only; use the "
                "numpy backend for channels-last wire batches")
        self.config = config
        self.layout = layout
        self._mean = config.mean_image
        if self._mean is not None and layout == "nhwc":
            # canonical (C, H, W) declaration -> (H, W, C) wire order
            self._mean = np.ascontiguousarray(self._mean.transpose(1, 2, 0))
        self._rs = np.random.RandomState(config.seed)
        if config.mean_image is not None and config.mean_value:
            raise ValueError("specify mean_image or mean_value, not both")
        self._native_calls = 0
        # 32-bit base; per-call seeds are spaced 2^32 apart so the C side's
        # splitmix64(seed + sample) streams never overlap across batches;
        # seed=None draws a random base, as numpy's RandomState does
        self._native_base = (
            config.seed if config.seed is not None
            else int(np.random.SeedSequence().generate_state(1)[0])
        ) & 0xFFFFFFFF
        if config.backend == "native":
            from sparknet_tpu_torch.native import available

            reason = available()
            if reason is not True:
                raise RuntimeError(f"native transform backend: {reason}")

    # ------------------------------------------------------------------
    def __call__(self, images: np.ndarray, train: bool) -> np.ndarray:
        """images: wire-layout uint8/float -> float32 transformed batch
        ((N, C, H, W) under nchw, (N, H, W, C) under nhwc)."""
        cfg = self.config
        if cfg.backend == "native" and np.asarray(images).dtype == np.uint8:
            from sparknet_tpu_torch.native import transform_batch

            self._native_calls += 1
            return transform_batch(
                images, mean=cfg.mean_image, mean_values=cfg.mean_value or None,
                scale=cfg.scale, crop=cfg.crop_size, mirror=cfg.mirror, train=train,
                seed=(self._native_calls << 32) | self._native_base)
        nhwc = self.layout == "nhwc"
        x = images.astype(np.float32, copy=True)
        if self._mean is not None:
            x -= self._mean[None]
        elif cfg.mean_value:
            mv = np.asarray(cfg.mean_value, np.float32)
            x -= mv.reshape((1, 1, 1, -1) if nhwc else (1, -1, 1, 1))
        if cfg.crop_size:
            x = self._crop(x, train)
        if train and cfg.mirror:
            flip = self._rs.randint(0, 2, len(x)).astype(bool)
            if nhwc:
                x[flip] = x[flip, :, ::-1, :]
            else:
                x[flip] = x[flip, :, :, ::-1]
        if cfg.scale != 1.0:
            x *= cfg.scale
        return x

    # ------------------------------------------------------------------
    def _crop(self, x: np.ndarray, train: bool) -> np.ndarray:
        """TRAIN: per-sample random crop; TEST: center crop (ref:
        data_transformer.cpp:49,83).  The RNG draw order (per-sample H
        offsets then W offsets) is identical in both layouts, so the same
        seed crops the same windows regardless of wire order."""
        c = self.config.crop_size
        nhwc = self.layout == "nhwc"
        if nhwc:
            n, h, w, ch = x.shape
        else:
            n, ch, h, w = x.shape
        if h < c or w < c:
            raise ValueError(f"crop {c} larger than image {h}x{w}")
        if not train:
            ho, wo = (h - c) // 2, (w - c) // 2
            if nhwc:
                return x[:, ho:ho + c, wo:wo + c, :]
            return x[:, :, ho:ho + c, wo:wo + c]
        hos = self._rs.randint(0, h - c + 1, n)
        wos = self._rs.randint(0, w - c + 1, n)
        # gather per-sample windows via advanced indexing (no python loop)
        rows = hos[:, None] + np.arange(c)[None]  # (N, c)
        cols = wos[:, None] + np.arange(c)[None]
        if nhwc:
            return x[np.arange(n)[:, None, None],
                     rows[:, :, None],
                     cols[:, None, :]]
        return x[np.arange(n)[:, None, None, None],
                 np.arange(ch)[None, :, None, None],
                 rows[:, None, :, None],
                 cols[:, None, None, :]]
