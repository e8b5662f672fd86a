"""Distribution: process groups, the batch layout and the distributed trainer.

Counterpart of ``sparknet_tpu/parallel/``.  SparkNet's algorithm (ref:
src/main/scala/apps/CifarApp.scala:95-136: broadcast, tau local SGD steps a
worker, collect, average) runs as one process a worker over
``torch.distributed``: NCCL between cards, gloo on the CPU.  Ported:
``ParallelTrainer`` (sync DP, tau-step averaging, EASGD), process-group
setup and the data-parallel batch rule.  Not yet: ``elastic.py``
(ROADMAP Queue A item 1), tensor, sequence, pipeline and expert
parallelism (item 3).
"""

from sparknet_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_group,
    initialize_distributed,
)
from sparknet_tpu_torch.parallel.sharding import local_shard  # noqa: F401
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer  # noqa: F401
