"""Train-to-serve production loop: the model improves while it serves.

Counterpart of ``sparknet_tpu/loop/``.  The reference's pitch was ONE
Spark program owning both training and scoring (ref:
apps/FeaturizerApp.scala:1: train a net, then score with it, in the same
app).  A :class:`ProductionLoop` composes the port's parts into that
system:

    shard feed -> ElasticTrainer rounds -> atomic checkpoint ->
    deploy-arm candidate (f32 / fold_bn / int8) -> hot swap into the
    live ServeEngine

with the hot-reload protocol owned by ``serve/engine.py``
(``build_candidate`` captures off the request path, ``swap_model`` flips
routing under the pump lock and drains the incumbent with its own graphs,
``rollback`` restores the previous ``ServedModel`` bitwise) and every
transition journaled as ``loop``/``serve`` obs events.  The drive:
``python -m sparknet_tpu_torch.cli loop`` (``loop/dryrun.py``).
"""

from sparknet_tpu_torch.loop.controller import ProductionLoop
from sparknet_tpu_torch.loop.deploy import variables_from_checkpoint
from sparknet_tpu_torch.loop.feed import synthetic_shard_feed
from sparknet_tpu_torch.loop.watcher import CheckpointWatcher

__all__ = [
    "CheckpointWatcher",
    "ProductionLoop",
    "synthetic_shard_feed",
    "variables_from_checkpoint",
]
