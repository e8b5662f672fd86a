"""CIFAR-10 distributed training app.

Counterpart of ``sparknet_tpu/apps/cifar_app.py``, the canonical training
driver (ref: src/main/scala/apps/CifarApp.scala:14-140): load CIFAR → shard
per worker → outer loop {broadcast weights, τ=10 local steps per worker,
collect+average, test every 10 rounds}.  One process a worker: every rank
draws the same global window (the same seeded RandomState) and feeds its
own slice of it (``parallel.local_shard``); eval uses the reference's
sum-then-normalize score semantics; every phase is stamped into the
EventLogger like the reference's training_log_<ts>.txt.
"""

from __future__ import annotations

import numpy as np

from sparknet_tpu_torch import models
from sparknet_tpu_torch.data import CifarLoader, DataTransformer, TransformConfig
from sparknet_tpu_torch.parallel.sharding import local_shard
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solvers.solver import Solver
from sparknet_tpu_torch.utils import EventLogger, SignalHandler, SolverAction, agree_action

TAU = 10  # ref: CifarApp.scala:119 (syncInterval)
TEST_EVERY = 10  # ref: CifarApp.scala:101
BATCH = 100


class CifarApp:
    """``batch`` is a worker's; ``group`` the trainer's worker set (the
    default group, or a world of one the trainer forms); ``device`` the
    solver's (default CUDA)."""

    def __init__(
        self,
        data_dir: str,
        group=None,
        tau: int = TAU,
        batch: int = BATCH,
        log_dir: str = ".",
        seed: int = 0,
        device=None,
    ):
        self.log = EventLogger(log_dir, prefix="cifar_training_log")
        self.log("loading CIFAR data")
        loader = CifarLoader(data_dir, seed=seed)
        self.transform = DataTransformer(
            TransformConfig(mean_image=loader.mean_image, seed=seed)
        )
        self.train_images, self.train_labels = loader.train_images, loader.train_labels
        self.test_images, self.test_labels = loader.test_images, loader.test_labels
        self.batch = batch
        self.tau = tau
        self._rs = np.random.RandomState(seed)

        self.log("building solver + trainer")
        solver = Solver(
            models.cifar10_full_solver(), models.cifar10_full(batch), device=device
        )
        self.trainer = ParallelTrainer(solver, group=group, tau=tau)
        self.num_workers = self.trainer.num_workers
        self.global_batch = batch * self.num_workers
        self.log(f"group: {self.num_workers} workers, tau={tau}")

    # ------------------------------------------------------------------
    def _global_train_feeds(self, it: int) -> dict[str, np.ndarray]:
        """[tau, B_global, ...] feeds: one contiguous window of the train set
        (the zipPartitions closure, CifarApp.scala:118-130)."""
        n = len(self.train_labels)
        need = self.tau * self.global_batch
        if need > n:
            raise ValueError(
                f"train set holds {n} samples; tau={self.tau} x global batch "
                f"{self.global_batch} needs {need} — reduce tau/batch/workers"
            )
        start = self._rs.randint(0, n - need + 1)
        sl = slice(start, start + need)
        data = self.transform(self.train_images[sl], train=True)
        labels = self.train_labels[sl].astype(np.int32)
        shape = (self.tau, self.global_batch)
        return {
            "data": data.reshape(shape + data.shape[1:]),
            "label": labels.reshape(shape),
        }

    def _train_feeds(self, it: int) -> dict[str, np.ndarray]:
        """This rank's [tau, B_local, ...] slice of the round's window."""
        return local_shard(self._global_train_feeds(it), self.trainer.rank,
                           self.num_workers, with_tau_axis=True)

    def _global_test_feeds(self, b: int) -> dict[str, np.ndarray]:
        if self.global_batch > len(self.test_labels):
            raise ValueError(
                f"test set holds {len(self.test_labels)} samples; global "
                f"batch {self.global_batch} — reduce batch/workers"
            )
        lo = (b * self.global_batch) % (len(self.test_labels) - self.global_batch + 1)
        sl = slice(lo, lo + self.global_batch)
        return {
            "data": self.transform(self.test_images[sl], train=False),
            "label": self.test_labels[sl].astype(np.int32),
        }

    def _test_feeds(self, b: int) -> dict[str, np.ndarray]:
        return local_shard(self._global_test_feeds(b), self.trainer.rank,
                           self.num_workers, with_tau_axis=False)

    # ------------------------------------------------------------------
    def run(self, num_outer: int = 50, num_test_batches: int = 10) -> dict[str, float]:
        """The outer sync loop (ref: CifarApp.scala:95-136).  A signal on
        any rank acts on every rank (``agree_action``)."""
        scores: dict[str, float] = {}
        with SignalHandler() as sig:
            for outer in range(num_outer):
                if outer % TEST_EVERY == 0:
                    self.log("testing", i=outer)
                    scores = self.trainer.test(num_test_batches, self._test_feeds)
                    self.log(f"scores: {scores}", i=outer)
                self.log("training", i=outer)
                loss = self.trainer.train_round(self._train_feeds)
                self.log(f"loss: {loss:.5f}", i=outer)
                action = agree_action(sig.check(), self.trainer.group)
                if action is SolverAction.SNAPSHOT:
                    self.snapshot(f"cifar_iter_{self.trainer.iter}")
                elif action is SolverAction.STOP:
                    self.log("stop requested", i=outer)
                    break
        scores = self.trainer.test(num_test_batches, self._test_feeds)
        self.log(f"final scores: {scores}")
        return scores

    def snapshot(self, prefix: str) -> str:
        self.trainer.sync_to_solver()
        path = self.trainer.solver.save(prefix)
        self.log(f"snapshot -> {path}")
        return path

    def close(self) -> None:
        """End the trainer (and the world of one it formed, if it did)."""
        self.trainer.close()
