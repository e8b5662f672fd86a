"""Process-group setup: the worker set of data parallelism.

Counterpart of ``sparknet_tpu/parallel/mesh.py``.  Where the JAX package
cuts a ``Mesh`` over the devices of one program, the port runs one process
a worker (each owning one replica on its device) and joins them through
``torch.distributed``: NCCL between cards, gloo on the CPU.  SparkNet got
its worker set from Spark's executors (ref: CifarApp.scala:27-33); here it
is the ranks of a process group.

Nothing in a cluster tells a program its address, rank or world size: the
caller passes them: a ``host:port`` where rank 0 serves a TCP store (the
CLI's ``--coordinator``, the counterpart of ``jax.distributed``'s
coordinator address), a file for a ``FileStore`` (which needs no port, so
tests and one-host runs cannot collide on one), or ``MASTER_ADDR``/
``MASTER_PORT``/``RANK``/``WORLD_SIZE`` for ``env://``.

``worker_group`` re-cuts the worker set of the elastic trainer
(``parallel/elastic.py``), the counterpart of ``sized_data_mesh``.  Not
ported: ``auto_mesh`` and the model/seq axes (they come with tensor and
sequence parallelism, ROADMAP Queue A).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sparknet_tpu_torch.common import resolve_device


def default_backend(device: str | torch.device | None = None) -> str:
    """NCCL for a CUDA device (``None`` means CUDA, and raises without a
    card), gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_distributed(
    backend: str | None = None,
    store_path: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    device: str | torch.device | None = None,
    coordinator: str | None = None,
) -> None:
    """Join this process to the default process group.

    ``coordinator``: ``host:port`` of a TCP store that rank 0 serves and
    every rank dials (give ``rank`` and ``world_size`` too).
    ``store_path``: a file every rank names (a ``FileStore``; give ``rank``
    and ``world_size`` too).  Without either the group forms through
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT`` and, unless given here,
    ``RANK`` and ``WORLD_SIZE``).  ``backend`` defaults to NCCL when the
    replicas live on CUDA (``device``, ``None`` meaning CUDA) and to gloo
    on the CPU.  NCCL takes one rank a card; several ranks on one card go
    through gloo."""
    if store_path is not None and (rank is None or world_size is None):
        raise ValueError("a FileStore needs rank and world_size")
    if coordinator is not None and (rank is None or world_size is None):
        raise ValueError("a TCP store at a coordinator needs rank and world_size")
    backend = backend or default_backend(device)
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=int(rank), world_size=int(world_size))
        return
    if store_path is not None:
        store = dist.FileStore(str(store_path), int(world_size))
        dist.init_process_group(backend, store=store, rank=int(rank),
                                world_size=int(world_size))
        return
    kwargs = {}
    if rank is not None:
        kwargs["rank"] = int(rank)
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    dist.init_process_group(backend, init_method="env://", **kwargs)


def data_parallel_group(num_workers: int | None = None):
    """The worker set: the first ``num_workers`` ranks of the default group
    (all of them by default), the counterpart of ``data_parallel_mesh``.
    Every rank must call it (``torch.distributed.new_group`` is
    collective); a rank outside the set gets a group it is not in."""
    world = dist.get_world_size()
    if num_workers is None:
        num_workers = world
    if not 1 <= num_workers <= world:
        raise ValueError(f"cannot form {num_workers} workers from a world of "
                         f"{world} (need 1 <= num_workers <= world)")
    return worker_group(range(num_workers))


def worker_group(ranks, cache: dict | None = None):
    """The process group of the worker set ``ranks`` of the default group,
    the counterpart of ``sized_data_mesh`` (which re-cuts a device pool
    into a mesh of a given width): the whole default group is ``WORLD``;
    any other set is made by ``torch.distributed.new_group``, once a set
    when ``cache`` (a dict the caller keeps for one process group) is
    given, as the JAX package keeps one mesh and program a width.
    ``new_group`` is collective: every rank of the default group must ask
    for the same sets in the same order, also a rank outside the set (it
    gets a group it is not in)."""
    key = tuple(sorted(int(r) for r in ranks))
    world = dist.get_world_size()
    if not key or key[0] < 0 or key[-1] >= world or len(set(key)) != len(key):
        raise ValueError(f"ranks {list(key)} are not a worker set of a world of {world}")
    if key == tuple(range(world)):
        return dist.group.WORLD
    if cache is not None and key in cache:
        return cache[key]
    group = dist.new_group(ranks=list(key))
    if cache is not None:
        cache[key] = group
    return group

