"""CIFAR-10 binary-format loader.

Equivalent of the reference's driver-side loader (ref:
src/main/scala/loaders/CifarLoader.scala:15-86): reads the 6 binary batch
files (per record: 1 label byte + 3072 image bytes, 10000 records/file),
shuffles the train set with a seeded permutation, and computes the mean
image.  Vectorized numpy instead of the reference's per-byte stream loop.
Copy of ``sparknet_tpu/data/cifar.py`` (host only).
"""

from __future__ import annotations

import os

import numpy as np

_RECORD = 1 + 3 * 32 * 32


def _read_batch_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % _RECORD:
        raise ValueError(f"{path}: size {raw.size} not a multiple of {_RECORD}")
    rec = raw.reshape(-1, _RECORD)
    labels = rec[:, 0].astype(np.int32)
    # stored planar RGB, row-major: (3, 32, 32) per record — already NCHW
    images = rec[:, 1:].reshape(-1, 3, 32, 32)
    return images, labels


class CifarLoader:
    """Loads CIFAR-10 train (data_batch_1..5.bin) + test (test_batch.bin).

    ``train_images``/``test_images`` are uint8 NCHW; ``mean_image`` is the
    float32 train-set mean (ref: CifarLoader.scala:57-63).  Train order is
    shuffled by a seeded permutation (ref: CifarLoader.scala:34).
    """

    def __init__(self, path: str, seed: int = 0, normalize: bool = False):
        train_files = [os.path.join(path, f"data_batch_{i}.bin") for i in range(1, 6)]
        test_file = os.path.join(path, "test_batch.bin")
        missing = [f for f in train_files + [test_file] if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(
                f"CIFAR-10 binaries missing under {path!r}: {missing[:2]}..."
            )
        imgs, labels = zip(*(_read_batch_file(f) for f in train_files))
        train_images = np.concatenate(imgs)
        train_labels = np.concatenate(labels)
        perm = np.random.RandomState(seed).permutation(len(train_labels))
        self.train_images = train_images[perm]
        self.train_labels = train_labels[perm]
        self.test_images, self.test_labels = _read_batch_file(test_file)
        from sparknet_tpu_torch.data.minibatch import compute_mean

        self.mean_image = compute_mean(self.train_images)
        self.normalize = normalize

    def train_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Mean-subtracted float32 train set (the preprocessing the CifarApp
        driver applies before sharding, ref: CifarApp.scala:55-59)."""
        x = self.train_images.astype(np.float32) - self.mean_image
        if self.normalize:
            x /= 255.0
        return x, self.train_labels

    def test_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        x = self.test_images.astype(np.float32) - self.mean_image
        if self.normalize:
            x /= 255.0
        return x, self.test_labels


def write_synthetic_cifar(path: str, seed: int = 0, records: int = 100) -> None:
    """Write synthetic files in the CIFAR binary format, ``records`` a file
    (test fixture — plays the role of the downloaded dataset in the
    reference's CifarSpec).  At the default 100 the bytes are the JAX
    package's; a τ-10 round at batch 100 needs 1,000 training records, so
    the card's ``CifarApp`` run writes more."""
    os.makedirs(path, exist_ok=True)
    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        n = records
        rec = np.empty((n, _RECORD), dtype=np.uint8)
        rec[:, 0] = rs.randint(0, 10, n)
        rec[:, 1:] = rs.randint(0, 256, (n, _RECORD - 1))
        rec.tofile(os.path.join(path, name))
