"""Minibatch sampling with the reference's contiguous-window semantics.

Copy of ``sparknet_tpu/data/sampler.py`` (host only).

Equivalent of ``MinibatchSampler`` (ref:
src/main/scala/libs/MinibatchSampler.scala:3-60): from a partition's
``total_num_batches`` minibatches, sample a random *contiguous* window of
``num_sampled_batches`` (start index uniform over the valid range, matching
`it.drop(start)`), then serve them in order.  The reference splits the
window into separate image/label pull streams for the two JNA callbacks;
here a single feed-dict stream suffices — the device consumes whole
batches, not per-blob callbacks.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np


class MinibatchSampler:
    def __init__(
        self,
        minibatches: Sequence[dict[str, Any]] | Iterable[dict[str, Any]],
        total_num_batches: int | None = None,
        num_sampled_batches: int = 1,
        seed: int | None = None,
    ):
        if total_num_batches is None:
            minibatches = list(minibatches)
            total_num_batches = len(minibatches)
        if num_sampled_batches > total_num_batches:
            raise ValueError(
                f"cannot sample {num_sampled_batches} of {total_num_batches} batches"
            )
        self._rs = np.random.RandomState(seed)
        # random contiguous window (ref: MinibatchSampler.scala:18-19,27)
        self.start = int(
            self._rs.randint(0, total_num_batches - num_sampled_batches + 1)
        )
        self.num_sampled = num_sampled_batches
        if isinstance(minibatches, Sequence):
            self._window = list(
                minibatches[self.start : self.start + num_sampled_batches]
            )
        else:
            it = iter(minibatches)
            for _ in range(self.start):  # it.drop equivalent
                next(it)
            self._window = [next(it) for _ in range(num_sampled_batches)]
        self._pos = 0

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self._window)

    def next_batch(self) -> dict[str, Any]:
        b = self._window[self._pos]
        self._pos += 1
        return b

    def __len__(self) -> int:
        return self.num_sampled


def partition_feed(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    tau: int,
    seed: int | None = None,
    transform: Callable[[np.ndarray, bool], np.ndarray] | None = None,
) -> Callable[[int], dict[str, np.ndarray]]:
    """data_fn factory: each call samples a contiguous tau-batch window from
    the partition and returns feeds stacked [tau, B, ...] for the trainer's
    tau-round (the per-outer-iteration resampling of the reference's
    zipPartitions closure, ref: CifarApp.scala:118-130)."""
    n_batches = len(labels) // batch_size
    if n_batches < tau:
        raise ValueError(
            f"partition holds {n_batches} batches of {batch_size}, "
            f"cannot sample a contiguous window of tau={tau}"
        )
    rs = np.random.RandomState(seed)

    def data_fn(it: int) -> dict[str, np.ndarray]:
        start = rs.randint(0, n_batches - tau + 1)
        lo = start * batch_size
        imgs = images[lo : lo + tau * batch_size]
        labs = labels[lo : lo + tau * batch_size]
        if transform is not None:
            imgs = transform(imgs, True)
        shape = (tau, batch_size) + imgs.shape[1:]
        return {
            "data": imgs.reshape(shape).astype(np.float32),
            "label": labs.reshape(tau, batch_size).astype(np.int32),
        }

    return data_fn
