"""ImageNet (AlexNet/CaffeNet) distributed training app.

Counterpart of ``sparknet_tpu/apps/imagenet_app.py``.  ref:
src/main/scala/apps/ImageNetApp.scala:19-193 — tar shards → decode/resize
256×256 → mean image → per-phase preprocessing (mean-subtract + random
227×227 crop + mirror, :124-176) → τ=50 sync loop.  Here the ingest is a
local directory of tar shards, decode/augment is vectorized on the host,
and each rank decodes its own slice of the shards (the RDD partition,
ImageNetLoader.scala:91-96).  The uint8-wire recipe (records through the
process ring, augment on the card) is ``data.records.RecordShardSource`` →
``data.pipeline.device_feed`` → ``data.device_transform.DeviceAugment``.
"""

from __future__ import annotations

import numpy as np

from sparknet_tpu_torch import models
from sparknet_tpu_torch.data import (
    DataTransformer,
    ImageNetLoader,
    TransformConfig,
    compute_mean_from_minibatches,
    make_minibatches_compressed,
)
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solvers.solver import Solver
from sparknet_tpu_torch.utils import EventLogger

TAU = 50  # ref: ImageNetApp.scala:151
RESIZE = 256  # ref: ImageNetApp.scala fullHeight/fullWidth
CROP = 227  # ref: ImageNetApp.scala croppedHeight/croppedWidth


class ImageNetApp:
    """``batch`` is a worker's; ``group`` the trainer's worker set;
    ``device`` the solver's (default CUDA)."""

    def __init__(
        self,
        shard_dir: str,
        label_file: str,
        group=None,
        tau: int = TAU,
        batch: int = 256,
        model: str = "caffenet",
        num_classes: int = 1000,
        log_dir: str = ".",
        seed: int = 0,
        mean_image: np.ndarray | None = None,
        device=None,
    ):
        self.log = EventLogger(log_dir, prefix="imagenet_training_log")
        self.loader = ImageNetLoader(shard_dir, label_file)
        self.log(f"{len(self.loader)} tar shards")
        self.batch = batch
        self.tau = tau

        build = models.caffenet if model == "caffenet" else models.alexnet
        solver = Solver(models.caffenet_solver(),
                        build(batch, num_classes=num_classes, crop=CROP), device=device)
        self.trainer = ParallelTrainer(solver, group=group, tau=tau)
        self.num_workers = self.trainer.num_workers

        if mean_image is None:
            self.log("computing mean image over shard 0")
            mean_image = compute_mean_from_minibatches(
                make_minibatches_compressed(
                    self.loader.shard(0, max(len(self.loader), 1)),
                    batch, RESIZE, RESIZE,
                ),
                (3, RESIZE, RESIZE),
            )
        self.mean_image = mean_image
        self.transform = DataTransformer(
            TransformConfig(crop_size=CROP, mirror=True, mean_image=mean_image, seed=seed)
        )

    # ------------------------------------------------------------------
    def minibatch_stream(self, worker: int = 0):
        """Decoded (images, labels) minibatches of this worker's shard slice."""
        return make_minibatches_compressed(
            self.loader.shard(worker, self.num_workers), self.batch, RESIZE, RESIZE
        )

    def _tau_feeds(self, streams):
        """Pack tau consecutive minibatches of each of ``streams`` into
        [tau, B * len(streams), ...] with the train-phase transform applied
        (a rank passes its own stream: its [tau, B_local, ...] feed)."""
        datas, labels = [], []
        for _ in range(self.tau):
            for stream in streams:
                imgs, labs = next(stream)
                datas.append(self.transform(imgs, train=True))
                labels.append(labs)
        b = self.batch * len(streams)
        data = np.concatenate(datas).reshape((self.tau, b, 3, CROP, CROP))
        lab = np.concatenate(labels).reshape((self.tau, b))
        return {"data": data, "label": lab.astype(np.int32)}

    # ------------------------------------------------------------------
    def run(self, num_outer: int = 10) -> float:
        rank = self.trainer.rank
        streams = [self.minibatch_stream(rank)]
        loss = float("nan")
        for outer in range(num_outer):
            try:
                feeds = self._tau_feeds(streams)
            except StopIteration:
                streams = [self.minibatch_stream(rank)]  # new epoch
                try:
                    feeds = self._tau_feeds(streams)
                except StopIteration:
                    raise ValueError(
                        f"dataset too small: tau={self.tau} x batch="
                        f"{self.batch} needs {self.tau * self.batch} decoded "
                        "images per round on every worker (and every worker "
                        "needs >=1 shard) — reduce tau/batch or add shards"
                    ) from None
            self.log("training", i=outer)
            loss = self.trainer.train_round(lambda it: feeds)
            self.log(f"loss: {loss:.5f}", i=outer)
        return loss

    def close(self) -> None:
        """End the trainer (and the world of one it formed, if it did)."""
        self.trainer.close()
