"""How the batch lays out over the workers.

Counterpart of the data-parallel part of ``sparknet_tpu/parallel/
sharding.py``.  Every worker holds a whole replica (as the reference's
workers do, ref: SURVEY §2.3), so the one rule is the batch's: worker r
takes the r-th equal slice of the global batch.  In the port each process
feeds its own slice (the reference's contract: each Spark executor reads
its partition); ``local_shard`` cuts it from a global batch.

``ShardingRules`` (the layout knobs of tensor and sequence parallelism)
comes with those (ROADMAP Queue A).
"""

from __future__ import annotations

import numpy as np
import torch


def local_shard(feeds: dict, rank: int, world: int, with_tau_axis: bool) -> dict:
    """Rank ``rank``'s slice of a global batch: axis 0 of ``[B, ...]``
    feeds, axis 1 of ``[tau, B, ...]`` ones (``with_tau_axis``).  B must
    divide by ``world``.  Works on numpy arrays and tensors alike."""
    ax = 1 if with_tau_axis else 0
    out = {}
    for k, v in feeds.items():
        n = v.shape[ax]
        if n % world:
            raise ValueError(f"feed {k!r}: batch {n} does not divide over "
                             f"{world} workers")
        b = n // world
        idx = (slice(None),) * ax + (slice(rank * b, (rank + 1) * b),)
        part = v[idx]
        out[k] = part.contiguous() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)
    return out
