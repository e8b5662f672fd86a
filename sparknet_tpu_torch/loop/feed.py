"""Shard feeds for the production loop: data plane -> elastic contract.

Counterpart of ``sparknet_tpu/loop/feed.py``.  The loop trains through
:class:`~sparknet_tpu_torch.parallel.elastic.ElasticTrainer`, whose
``data_fn(g)`` takes a GLOBAL shard id and returns one per-worker feed
dict (the ShardFn contract: membership changes reassign ids, they never
change what shard ``g`` contains).  The data plane's
:class:`~sparknet_tpu_torch.data.pipeline.BatchSource` speaks (epoch,
index), so ``data.pipeline.shard_batches`` adapts one to the other and
this module shapes the zoo family's feed on top: uint8 NCHW pixels become
float32 in [-0.5, 0.5), and token families draw id matrices from an RNG
seeded by the shard id, so shard ``g`` is the same on every rank, in every
round and after a restart, and the same as the JAX package's.

ref: src/main/scala/libs/ScaleAndConvert.scala:1 (the reference's
decode/convert stage feeding training and scoring alike).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_shard_feed"]


def synthetic_shard_feed(family, batch: int, seed: int = 0):
    """A deterministic ShardFn for one zoo family (``GRAPH_SWEEP_FAMILIES``)
    at a PER-WORKER batch."""
    if family.feed == "tokens":
        def token_fn(g: int) -> dict:
            rs = np.random.RandomState((seed * 9176 + int(g)) % (2**31))
            data = rs.randint(0, family.vocab, (batch, family.seq_len)).astype(np.int32)
            label = rs.randint(0, family.num_classes, batch).astype(np.int32)
            return {"data": data, "label": label}
        return token_fn

    from sparknet_tpu_torch.data.pipeline import SyntheticImageSource, shard_batches

    from sparknet_tpu_torch.ops.layout import internal_shape

    raw_fn = shard_batches(SyntheticImageSource(
        batch, shape=tuple(family.image_shape), classes=family.num_classes, seed=seed))
    want = internal_shape((batch, *family.image_shape))

    def image_fn(g: int) -> dict:
        raw = raw_fn(g)
        data = raw["data"].astype(np.float32) * (1.0 / 255.0) - 0.5
        if data.shape != want:  # a channels-last run: NCHW -> NHWC
            data = np.ascontiguousarray(data.transpose(0, 2, 3, 1))
        return {"data": data, "label": raw["label"].astype(np.int32)}
    return image_fn
