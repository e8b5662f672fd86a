"""Request serving on a torch device: the CNN engine and the token decoders.

Counterpart of ``sparknet_tpu/serve/``:

* ``engine.ServeEngine``: several zoo models resident at once, each load
  priced against the device's memory (``residency.AdmissionPolicy``) and
  captured as one forward CUDA graph per batch bucket (``graphs``), single
  requests coalesced by the ``batcher.DynamicBatcher`` (smallest fitting
  bucket, deadline and full-bucket flushes, deadline-aware shedding), hot
  swap and rollback with zero dropped tickets.
* ``router.ReplicaRouter``: K engine replicas on a pool of device slots,
  join-shortest-projected-wait routing, kill/join with zero-drop
  re-routing, sequential rollout; ``loadgen`` (arrival schedules, the
  load run, the pod run) and ``dryrun.replica_run`` (the fault plan under
  load) drive them.
* ``paged.PagedDecoder`` (greedy generation over a block-paged K/V cache:
  flash-attention prefill, paged-attention decode), its cacheless twin
  ``continuous.ContinuousDecoder``, and ``paged.TokenRouter``.

The engine, the router and ``dryrun.replica_run`` journal their ``serve``,
``request`` and ``replica`` events to the obs journal (``SPARKNET_OBS``),
``paged.PagedDecoder`` its ``token`` events, and ``loadgen.
pod_run(controller=True)`` arms the SLO controller (``loop/autoctl.py``).
"""

from sparknet_tpu_torch.serve.batcher import DynamicBatcher, Ticket
from sparknet_tpu_torch.serve.continuous import ContinuousDecoder
from sparknet_tpu_torch.serve.engine import (
    AdmissionRefused,
    ServeEngine,
    ServedModel,
    build_serve_program,
)
from sparknet_tpu_torch.serve.graphs import BucketProgram
from sparknet_tpu_torch.serve.residency import (
    AdmissionPolicy,
    load_fit_table,
    price_residency,
)
from sparknet_tpu_torch.serve.router import Replica, ReplicaRouter

__all__ = [
    "AdmissionPolicy",
    "AdmissionRefused",
    "BucketProgram",
    "ContinuousDecoder",
    "DynamicBatcher",
    "Replica",
    "ReplicaRouter",
    "ServeEngine",
    "ServedModel",
    "Ticket",
    "build_serve_program",
    "load_fit_table",
    "price_residency",
]
