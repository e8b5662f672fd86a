"""ImageNet-style ingest: label map + tar-archive shard explosion.

Equivalent of ``ImageNetLoader`` (ref:
src/main/scala/loaders/ImageNetLoader.scala:21-97): the reference lists an
S3 bucket's tar shards, broadcasts a ``train.txt`` filename->label map, and
streams each tar into (jpeg_bytes, label) pairs on executors.  This build
has zero egress, so the source is a local directory of tar shards (the
layout ``pull.py`` materializes on each worker, ref: ec2/pull.py) — the
S3 walk becomes a filesystem walk; multi-host ingest shards the archive
list by ``worker_index % num_workers`` exactly like the RDD partitioning.

Copy of ``sparknet_tpu/data/archive.py`` for local directories; the
object-store roots (``gs://``, ``s3://``) need ``data/remote.py``, which
is the rest of ROADMAP Queue A9.
"""

from __future__ import annotations

import os
import tarfile
from typing import Iterator



def load_label_map(path: str) -> dict[str, int]:
    """Parse a train.txt-style "filename label" map (ref:
    ImageNetLoader.scala:41-54 getLabels)."""
    out: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, label = line.rsplit(maxsplit=1)
            out[name] = int(label)
    return out


def list_archive_samples(tar_path: str, labels: dict[str, int]) -> Iterator[tuple[bytes, int]]:
    """Explode one tar shard into (jpeg_bytes, label) pairs (ref:
    ImageNetLoader.scala:56-86 loadImagesFromTar).  Members missing from the
    label map are skipped with the same silent-drop semantics."""
    with tarfile.open(tar_path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            key = os.path.basename(member.name)
            if key not in labels:
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            yield f.read(), labels[key]


class ImageNetLoader:
    """Walks a local directory of tar shards, one worker's slice at a time.

    ``shard(worker, num_workers)`` yields this worker's (bytes, label)
    stream — the analog of the reference's ``RDD[(Array[Byte], Int)]``
    partition (ref: ImageNetLoader.scala:91-96).  A ``gs://`` / ``s3://``
    root (the reference's S3 walk, ImageNetLoader.scala:25-39) raises:
    the network stores are ROADMAP Queue A9.
    """

    def __init__(self, root: str, label_file: str,
                 cache_dir: str | None = None):
        if "://" in root and not root.startswith("file://"):
            raise NotImplementedError(
                f"{root!r}: the gs:// and s3:// shard stores (data/remote.py) "
                "are not ported yet (ROADMAP Queue A9: they need a network); copy "
                "the shards to a local directory")
        root = root.removeprefix("file://")
        self.root = root
        self.cache_dir = cache_dir
        self.labels = load_label_map(label_file)
        self.archives = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith((".tar", ".tar.gz", ".tgz"))
        )
        if not self.archives:
            raise FileNotFoundError(f"no tar shards under {root!r}")

    def shard(self, worker: int, num_workers: int) -> Iterator[tuple[bytes, int]]:
        for i, tar_path in enumerate(self.archives):
            if i % num_workers != worker:
                continue
            yield from list_archive_samples(tar_path, self.labels)

    def __len__(self) -> int:
        return len(self.archives)
