"""Decode/resize + fixed-size minibatch packing + distributed mean.

Equivalents of the reference's preprocessing stage:
- ``make_minibatches_compressed``: JPEG bytes -> decode -> force-resize ->
  packed minibatch arrays, dropping undecodable images and the ragged tail
  (ref: src/main/scala/preprocessing/ScaleAndConvert.scala:16-70).
- ``make_minibatches``: already-decoded arrays -> packed minibatches
  (ref: ScaleAndConvert.scala:72-91).
- ``compute_mean`` / ``compute_mean_from_minibatches``: mean image over the
  dataset; the reference accumulates Long sums per partition then reduces
  on the driver (ref: preprocessing/ComputeMean.scala:8-76) — here one
  float64 accumulator per shard, summed at the end, so multi-process
  ingest can reduce partial sums the same way.

Copy of ``sparknet_tpu/data/minibatch.py`` (host only).
"""

from __future__ import annotations

import io
from typing import Iterable, Iterator

import numpy as np


def decode_jpeg(data: bytes, height: int, width: int,
                layout: str = "nchw") -> np.ndarray | None:
    """Decode + force-resize to uint8 — (3, height, width) under nchw,
    (height, width, 3) under nhwc; None if broken (the reference drops
    undecodable images, ScaleAndConvert.scala:19-26).

    Decoders produce HWC: the nhwc wire order is the decoder's NATIVE
    output and skips the per-image transpose entirely — the host half of
    the zero-transpose channels-last feed (``ops/layout.py`` contract).

    Ring placement: :class:`~sparknet_tpu_torch.data.records.RecordShardSource`
    calls this INSIDE the pipeline worker that owns the batch, so JPEG
    decode scales with the ring's workers (the feed's ``decode`` stage)
    instead of serializing in the consumer."""
    from PIL import Image  # outside the guard: a missing dep must fail loud

    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        img = img.resize((width, height))  # force-resize, no aspect keep
        arr = np.asarray(img, np.uint8)
        return arr if layout == "nhwc" else arr.transpose(2, 0, 1)
    except Exception:
        return None


def decode_workers(cap: int = 8) -> int:
    """Decode-pool size: ``SPARKNET_DECODE_WORKERS`` (validated, >=1) or
    min(cpu_count, cap).  One resolution rule for every decode path."""
    import os as _os

    raw = _os.environ.get("SPARKNET_DECODE_WORKERS", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            raise ValueError(
                f"SPARKNET_DECODE_WORKERS must be an integer (got {raw!r})"
            ) from None
    return min(_os.cpu_count() or 1, cap)


def _decoded_pairs(samples, height, width, workers, chunk,
                   layout="nchw"):
    """(decoded_or_None, label) stream; ``workers`` > 1 decodes through a
    thread pool (PIL's C decode path releases the GIL — the multi-core
    TPU-VM analog of the reference's per-executor decode parallelism).

    The pool stage is PIPELINED: up to ``chunk`` decodes stay in flight
    ahead of the consumer, refilled one-for-one as results are yielded —
    the pre-fix version flushed ``pool.map`` a batch at a time, so every
    chunk boundary drained the pool and serialized decode against
    iteration.  Output order is identical to the serial path either way
    (FIFO completion window); time-to-first-pair still buffers at most
    ``chunk`` samples."""
    if workers <= 1:
        for data, label in samples:
            yield decode_jpeg(data, height, width, layout), label
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers, thread_name_prefix="decode") as pool:
        window: deque = deque()  # (future, label), submission order
        for data, label in samples:
            window.append(
                (pool.submit(decode_jpeg, data, height, width, layout),
                 label))
            if len(window) >= chunk:
                fut, lbl = window.popleft()  # blocks only on the OLDEST
                yield fut.result(), lbl
        while window:
            fut, lbl = window.popleft()
            yield fut.result(), lbl


def make_minibatches_compressed(
    samples: Iterable[tuple[bytes, int]],
    batch_size: int,
    height: int,
    width: int,
    workers: int = 0,
    layout: str = "nchw",
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(jpeg_bytes, label) stream -> (images uint8, labels) minibatches in
    the wire ``layout`` (NCHW default; nhwc packs the decoder's native
    HWC with no transpose); broken images and the ragged tail dropped
    (ref: ScaleAndConvert.scala:45-70).  ``workers``: 0 =
    ``decode_workers()``, 1 = serial, >1 = thread-pooled decode
    (identical output)."""
    if workers == 0:
        workers = decode_workers()
    imgs, labels = [], []
    for arr, label in _decoded_pairs(samples, height, width, workers,
                                     chunk=batch_size, layout=layout):
        if arr is None:
            continue
        imgs.append(arr)
        labels.append(label)
        if len(imgs) == batch_size:
            yield np.stack(imgs), np.asarray(labels, np.int32)
            imgs, labels = [], []


def make_minibatches(
    images: np.ndarray, labels: np.ndarray, batch_size: int
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Packed fixed-size minibatches, ragged tail dropped
    (ref: ScaleAndConvert.scala:72-91)."""
    n = (len(labels) // batch_size) * batch_size
    for lo in range(0, n, batch_size):
        yield images[lo : lo + batch_size], labels[lo : lo + batch_size]


def compute_mean(images: np.ndarray) -> np.ndarray:
    """Mean image of a decoded array (ref: ComputeMean.scala:8-38)."""
    return images.astype(np.float64).mean(axis=0).astype(np.float32)


def compute_mean_from_minibatches(
    minibatches: Iterable[tuple[np.ndarray, np.ndarray]],
    shape: tuple[int, ...],
) -> np.ndarray:
    """Streaming mean over minibatches — integer-exact accumulation like the
    reference's Long accumulators (ref: ComputeMean.scala:40-76)."""
    acc = np.zeros(shape, np.float64)
    count = 0
    for imgs, _ in minibatches:
        acc += imgs.astype(np.float64).sum(axis=0)
        count += len(imgs)
    if count == 0:
        raise ValueError("no minibatches")
    return (acc / count).astype(np.float32)
