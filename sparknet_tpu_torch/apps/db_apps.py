"""DB-backed training apps — the reference's "Caffe-native data source" path.

Counterpart of ``sparknet_tpu/apps/db_apps.py`` (ref:
src/main/scala/apps/CifarDBApp.scala:16-171 (train from per-worker
LevelDBs instead of RDD callbacks), ImageNetCreateDBApp.scala:14-135
(materialize per-worker DBs + mean binaryproto + test-batch counts), and
ImageNetRunDBApp.scala:15-117 (train against those DBs, resuming from a
weights file).  Here the native record DB (or LMDB, or LevelDB itself)
holds the records, ``db_minibatches`` plays Caffe's DataLayer cursor and
the host ``DataTransformer`` transforms each batch, as in the JAX apps;
the nets train through ``TPUNet`` on ``device`` (``None``: CUDA, and raise
without a card; the tests pass ``"cpu"``).
"""

from __future__ import annotations

import os

import numpy as np

from sparknet_tpu_torch import models
from sparknet_tpu_torch.common import resolve_device
from sparknet_tpu_torch.data import CifarLoader, DataTransformer, TransformConfig
from sparknet_tpu_torch.data.createdb import create_db, db_mean, db_minibatches
from sparknet_tpu_torch.data.minibatch import make_minibatches_compressed
from sparknet_tpu_torch.net import TPUNet
from sparknet_tpu_torch.utils import EventLogger

_DB_EXTS = {"record": ".sndb", "lmdb": "_lmdb", "leveldb": "_leveldb"}


def _check_backend(backend: str) -> str:
    if backend not in _DB_EXTS:
        raise ValueError(
            f"unknown db backend {backend!r} ({' | '.join(_DB_EXTS)})")
    return _DB_EXTS[backend]


def _clear_db_path(path: str) -> None:
    """Remove a leftover DB (dir or file) so a re-run can materialize
    fresh — LevelDbWriter rightly refuses to overlay an existing env."""
    import shutil

    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


class CifarDBApp:
    """CIFAR via record DB (ref: CifarDBApp.scala): materialize train/test
    DBs once, then train reading through the DB cursor."""

    def __init__(self, data_dir: str, db_dir: str, batch: int = 100,
                 log_dir: str = ".", backend: str = "record", device=None):
        """``backend``: record (native) | lmdb | leveldb — the latter two
        are the reference's own on-disk formats (CifarDBApp.scala writes
        LevelDB through the C API)."""
        # validate BEFORE any side effect (the logger creates a file)
        ext = _check_backend(backend)
        device = resolve_device(device)
        self.log = EventLogger(log_dir, prefix="cifar_db_log")
        self.batch = batch
        self.train_db = os.path.join(db_dir, f"cifar_train{ext}")
        self.test_db = os.path.join(db_dir, f"cifar_test{ext}")
        # a crash mid-materialize leaves readable-but-truncated DBs in
        # EVERY backend (record commits every 1000; the dir backends
        # write at close), so completeness is tracked by a marker
        # written after both DBs + the mean land
        done_marker = os.path.join(db_dir, f".materialized{ext}")
        mean_path = os.path.join(db_dir, "mean.npy")
        os.makedirs(db_dir, exist_ok=True)

        if not os.path.exists(done_marker):
            for p in (self.train_db, self.test_db):
                _clear_db_path(p)  # partial leftovers block LevelDbWriter
            self.log("materializing DBs")
            loader = CifarLoader(data_dir)
            create_db(self.train_db,
                      zip(loader.train_images, loader.train_labels),
                      backend=backend)
            create_db(self.test_db, zip(loader.test_images, loader.test_labels),
                      backend=backend)
            self.mean_image = loader.mean_image
            np.save(mean_path, self.mean_image)
            with open(done_marker, "w") as f:
                f.write("ok\n")
        elif os.path.exists(mean_path):
            self.log("reusing existing DBs + mean")
            from sparknet_tpu_torch.data.transform import load_mean_file

            self.mean_image = load_mean_file(mean_path)
        else:  # DBs from an older materialize: one recovery scan, then cache
            self.log("reusing existing DBs; recomputing mean from train DB")
            self.mean_image = db_mean(self.train_db)
            np.save(mean_path, self.mean_image)
        self.transform = DataTransformer(
            TransformConfig(mean_image=self.mean_image)
        )
        self.net = TPUNet(models.cifar10_full_solver(), models.cifar10_full(batch),
                          device=device)

    def run(self, num_iters: int = 100, test_batches: int = 10) -> dict[str, float]:
        train_stream = db_minibatches(self.train_db, self.batch, loop=True, dtype=np.uint8)

        def train_fn(it):
            b = next(train_stream)
            return {
                "data": self.transform(b["data"], True),
                "label": b["label"],
            }

        def test_feeds():
            stream = db_minibatches(self.test_db, self.batch, loop=True,
                                    dtype=np.uint8)
            for _ in range(test_batches):
                b = next(stream)
                yield {
                    "data": self.transform(b["data"], False),
                    "label": b["label"],
                }

        self.net.set_train_data(train_fn)
        self.net.set_test_data(test_feeds(), length=test_batches)
        pre = self.net.test()
        self.log(f"untrained: {pre}")
        self.net.train(num_iters)
        self.net.set_test_data(test_feeds(), length=test_batches)
        post = self.net.test()
        self.log(f"trained: {post}")
        return post


class ImageNetCreateDBApp:
    """Materialize per-worker ImageNet record DBs + mean + batch counts
    (ref: ImageNetCreateDBApp.scala: per-worker LevelDBs, mean binaryproto,
    infoFiles/ test-batch counts)."""

    def __init__(self, shard_dir: str, label_file: str, out_dir: str,
                 num_workers: int = 1, resize: int = 256, batch: int = 256,
                 backend: str = "record"):
        from sparknet_tpu_torch.data import ImageNetLoader

        self._ext = _check_backend(backend)
        if backend != "record":
            import sys

            # the lmdb/leveldb writers buffer ALL records in RAM and
            # write at close — fine for fixtures/CIFAR, an OOM at real
            # ImageNet scale.  Materialize with the record backend and
            # `tpunet convert_db` afterwards for those.
            print(
                f"ImageNetCreateDBApp: the {backend!r} writer buffers the "
                "whole worker shard in memory; for ImageNet-scale runs "
                "use backend='record' then convert_db",
                file=sys.stderr,
            )
        self.loader = ImageNetLoader(shard_dir, label_file)
        self.out_dir = out_dir
        self.num_workers = num_workers
        self.resize = resize
        self.batch = batch
        self.backend = backend
        os.makedirs(out_dir, exist_ok=True)

    def run(self) -> dict:
        info = {"workers": []}
        mean_acc = None
        count = 0
        for w in range(self.num_workers):
            db_path = os.path.join(
                self.out_dir, f"imagenet_w{w}{self._ext}")
            _clear_db_path(db_path)  # re-runs/crash leftovers rebuild
            batches = 0

            def samples():
                nonlocal mean_acc, count, batches
                for imgs, labels in make_minibatches_compressed(
                    self.loader.shard(w, self.num_workers),
                    self.batch, self.resize, self.resize,
                ):
                    s = imgs.astype(np.float64).sum(axis=0)
                    mean_acc = s if mean_acc is None else mean_acc + s
                    count += len(imgs)
                    batches += 1
                    for img, label in zip(imgs, labels):
                        yield img, int(label)

            n = create_db(db_path, samples(), backend=self.backend)
            info["workers"].append(
                {"db": db_path, "records": n, "batches": batches}
            )
        if count == 0:
            raise ValueError("no decodable images in any shard")
        mean = (mean_acc / count).astype(np.float32)
        mean_path = os.path.join(self.out_dir, "mean.npy")
        np.save(mean_path, mean)
        info["mean"] = mean_path
        # the infoFiles/ role: persist counts for the run app
        import json

        with open(os.path.join(self.out_dir, "info.json"), "w") as f:
            json.dump(info, f)
        return info


class ImageNetRunDBApp:
    """Train AlexNet/CaffeNet from materialized DBs, optionally resuming
    from a weights file (ref: ImageNetRunDBApp.scala:75
    loadWeightsFromFile)."""

    def __init__(self, db_dir: str, worker: int = 0, batch: int = 256,
                 crop: int = 227, model: str = "caffenet",
                 weights: str | None = None, log_dir: str = ".", device=None):
        import json

        device = resolve_device(device)
        self.log = EventLogger(log_dir, prefix="imagenet_db_log")
        with open(os.path.join(db_dir, "info.json")) as f:
            self.info = json.load(f)
        self.db_path = self.info["workers"][worker]["db"]
        from sparknet_tpu_torch.data.transform import load_mean_file

        mean = load_mean_file(self.info["mean"])
        self.transform = DataTransformer(
            TransformConfig(crop_size=crop, mirror=True, mean_image=mean)
        )
        self.batch = batch
        build = models.caffenet if model == "caffenet" else models.alexnet
        self.net = TPUNet(models.caffenet_solver(), build(batch, crop=crop),
                          device=device)
        if weights:
            self.net.load_weights_from_file(weights)
            self.log(f"resumed from {weights}")

    def run(self, num_iters: int) -> float:
        stream = db_minibatches(self.db_path, self.batch, loop=True,
                                dtype=np.uint8)

        def train_fn(it):
            b = next(stream)
            return {
                "data": self.transform(b["data"], True),
                "label": b["label"],
            }

        self.net.set_train_data(train_fn)
        return self.net.train(num_iters)
