"""Scheme-abstracted object-store access for shard ingest.

Counterpart of ``sparknet_tpu/data/remote.py`` (the reference's
``ImageNetLoader`` walks an S3 bucket and streams tar shards to executors,
ref: src/main/scala/loaders/ImageNetLoader.scala:25-86): a small store
interface keyed by URL scheme, which ``cli pull_shards`` reads through
``list_prefix`` and ``fetch``.

- ``file://`` (and bare paths): the local filesystem, NFS mounts
  included; also the fake that stands in for a bucket in tests.
- ``gs://`` / ``s3://``: not ported.  They need a network, which the
  card's machine lacks, and raise naming ROADMAP Queue A9.

``register_store(scheme, factory)`` lets a deployment with a client
library of its own plug a scheme in.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Protocol

REMOTE_ITEM = "Queue A9 (remote.py's gs:// and s3:// stores need a network)"


class ObjectStore(Protocol):
    def list_prefix(self, url: str) -> list[str]:
        """All object URLs under a prefix, sorted."""
        ...

    def fetch(self, url: str, dest_dir: str) -> str:
        """Download one object into dest_dir; returns the local path.
        Files already there are reused (pull.py's idempotent pull)."""
        ...


def _split(url: str) -> tuple[str, str]:
    scheme, _, rest = url.partition("://")
    return (scheme, rest) if "://" in url else ("file", url)


class LocalStore:
    """file:// and bare paths, and the on-disk fake for remote schemes."""

    def list_prefix(self, url: str) -> list[str]:
        _, path = _split(url)
        if os.path.isdir(path):
            return sorted(os.path.join(path, f) for f in os.listdir(path)
                          if os.path.isfile(os.path.join(path, f)))
        d, prefix = os.path.split(path)
        if not os.path.isdir(d):
            return []
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.startswith(prefix) and os.path.isfile(os.path.join(d, f)))

    def fetch(self, url: str, dest_dir: str) -> str:
        _, path = _split(url)
        dest = os.path.join(dest_dir, os.path.basename(path))
        if os.path.abspath(dest) == os.path.abspath(path):
            return path
        if not (os.path.exists(dest) and os.path.getsize(dest) == os.path.getsize(path)):
            os.makedirs(dest_dir, exist_ok=True)
            shutil.copy(path, dest)
        return dest


def _unported(scheme: str) -> Callable[[], ObjectStore]:
    def factory():
        raise NotImplementedError(f"{scheme}:// stores are not ported to sparknet_tpu_torch "
                                  f"yet (ROADMAP {REMOTE_ITEM}); copy the shards to a local "
                                  "or NFS directory, or register_store a client")

    return factory


_REGISTRY: dict[str, Callable[[], ObjectStore]] = {
    "file": LocalStore,
    "gs": _unported("gs"),
    "s3": _unported("s3"),
}


def register_store(scheme: str, factory: Callable[[], ObjectStore]) -> None:
    _REGISTRY[scheme] = factory


def get_store(url: str) -> ObjectStore:
    scheme, _ = _split(url)
    try:
        factory = _REGISTRY[scheme]
    except KeyError:
        raise ValueError(f"no object store registered for scheme {scheme!r} "
                         f"(known: {sorted(_REGISTRY)})") from None
    return factory()
