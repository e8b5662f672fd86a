"""Distribution: process groups, the batch layout and the distributed trainers.

Counterpart of ``sparknet_tpu/parallel/``.  SparkNet's algorithm (ref:
src/main/scala/apps/CifarApp.scala:95-136: broadcast, tau local SGD steps a
worker, collect, average) runs as one process a worker over
``torch.distributed``: NCCL between cards, gloo on the CPU.  Ported:
``ParallelTrainer`` (sync DP, tau-step averaging, EASGD, and over an
``auto_mesh`` the model and seq axes), the elastic trainer
(``ElasticTrainer``, ``FaultPlan``: workers lost, joined and parked between
rounds), process-group setup and the rank grid (``auto_mesh``), the batch,
sequence and param layouts (``ShardingRules``), sequence parallelism (ring
and Ulysses attention), expert parallelism (the MoE layer's model axis and
``expert_parallel_moe``) and the GPipe schedule (``pipeline_blocks``).
Not yet: Megatron tensor parallelism of Convolution, Deconvolution,
InnerProduct and Embed (ROADMAP Queue A12).
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
from sparknet_tpu_torch.parallel.expert import expert_parallel_moe  # noqa: F401
from sparknet_tpu_torch.parallel.mesh import (  # noqa: F401
    ProcessMesh,
    auto_mesh,
    data_parallel_group,
    initialize_distributed,
    process_mesh,
    worker_group,
)
from sparknet_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_blocks,
    sequential_blocks,
    stack_stage_params,
    stage_sharding,
)
from sparknet_tpu_torch.parallel.ring_attention import ring_self_attention  # noqa: F401
from sparknet_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    local_shard,
    param_shardings,
    replicated,
)
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer  # noqa: F401
from sparknet_tpu_torch.parallel.ulysses import ulysses_self_attention  # noqa: F401
