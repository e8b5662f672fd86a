"""Distribution: process groups, the batch layout and the distributed trainers.

Counterpart of ``sparknet_tpu/parallel/``.  SparkNet's algorithm (ref:
src/main/scala/apps/CifarApp.scala:95-136: broadcast, tau local SGD steps a
worker, collect, average) runs as one process a worker over
``torch.distributed``: NCCL between cards, gloo on the CPU.  Ported:
``ParallelTrainer`` (sync DP, tau-step averaging, EASGD), the elastic
trainer (``ElasticTrainer``, ``FaultPlan``: workers lost, joined and parked
between rounds), process-group setup, the worker sets of either trainer
and the data-parallel batch rule.  Not yet: tensor, sequence, pipeline
and expert parallelism (ROADMAP Queue A12).
"""

from sparknet_tpu_torch.parallel.elastic import (  # noqa: F401
    ElasticTrainer,
    FaultEvent,
    FaultPlan,
    delay,
    join,
    kill,
    round_shards,
)
from sparknet_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_group,
    initialize_distributed,
    worker_group,
)
from sparknet_tpu_torch.parallel.sharding import local_shard  # noqa: F401
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer  # noqa: F401
