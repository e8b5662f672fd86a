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
(``parallel/elastic.py``), the counterpart of ``sized_data_mesh``.

``auto_mesh`` lays the ranks of the default group out as JAX's ``(data,
model[, seq])`` mesh (a :class:`ProcessMesh`): a grid of ranks, seq the
minor-most axis, with one process group for each set of axes (the ranks
that differ only along those axes), as ``Comm``s
(``parallel/collectives.py``).  ``mesh_seq_size``, ``mesh_data_size`` and
``mesh_model_size`` read it as the JAX functions read a ``Mesh``.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from sparknet_tpu_torch.common import get_config, resolve_device
from sparknet_tpu_torch.parallel.collectives import Comm


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
    from sparknet_tpu_torch.obs.recorder import rebuild_from_env

    # an env-built obs recorder is rebuilt for this rank on next use: only
    # rank 0 journals
    rebuild_from_env()
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


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A grid of ranks of the default process group: the port's
    ``jax.sharding.Mesh``.  ``shape`` maps each axis name to its size in
    JAX's order (``Mesh.shape``); ``coords`` are this rank's coordinates
    (None on a rank outside the grid); ``grid`` holds the global ranks
    (``Mesh.devices``).  :meth:`comm` gives the process group over a set
    of axes for this rank."""

    shape: dict
    coords: dict | None
    grid: np.ndarray
    comms: dict = dataclasses.field(repr=False, default_factory=dict)

    def comm(self, *axes: str) -> Comm:
        """This rank's group over ``axes`` (the ranks whose coordinates on
        every other axis equal this rank's), in grid order."""
        key = frozenset(axes)
        if key not in self.comms:
            raise KeyError(f"no group over {sorted(axes)}; the mesh's axes are {list(self.shape)}")
        return self.comms[key]


def process_mesh(shape: dict, device: str | torch.device | None = None) -> ProcessMesh:
    """The grid of the first ``prod(shape)`` ranks of the default group with
    the named axes of ``shape`` (name -> size, major to minor), JAX's
    ``Mesh(np.array(devices).reshape(sizes), names)``.  ``device`` is where
    the ranks' tensors live (None: CUDA, and raise without a card): it
    decides which collectives go through host buffers
    (``collectives.Comm.make``).  Collective: every rank of the default
    group calls it, and each makes the groups of every set of axes in the
    same order."""
    device = resolve_device(device)
    axes, dims = list(shape), [int(d) for d in shape.values()]
    n = int(np.prod(dims))
    world = dist.get_world_size()
    if not 1 <= n <= world:
        raise ValueError(f"cannot lay out {n} devices over a world of {world} ranks")
    grid = np.arange(n).reshape(dims)
    me = dist.get_rank()
    coords = None
    if me < n:
        coords = dict(zip(axes, (int(c) for c in np.unravel_index(me, dims))))
    cache: dict = {}
    comms = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            # the grid's lines along ``sub``: the other axes first, flattened
            rest = [a for a in range(len(axes)) if a not in sub]
            width = int(np.prod([dims[a] for a in sub]))
            for line in np.transpose(grid, rest + list(sub)).reshape(-1, width):
                ranks = [int(r) for r in line]
                group = worker_group(ranks, cache)
                if me in ranks:
                    comms[frozenset(axes[a] for a in sub)] = Comm.make(group, ranks, device)
    return ProcessMesh(shape=dict(zip(axes, dims)), coords=coords, grid=grid, comms=comms)


def auto_mesh(
    num_devices: int | None = None,
    model_parallel: int = 1,
    seq_parallel: int = 1,
    device: str | torch.device | None = None,
) -> ProcessMesh:
    """The ``(data, model[, seq])`` grid over the first ``num_devices``
    ranks of the default group (all of them by default), JAX's
    ``auto_mesh``: ``model_parallel`` ranks on the model axis,
    ``seq_parallel`` on the seq axis (present only above 1, minor-most),
    the rest on the data axis.  ``device`` as :func:`process_mesh`
    takes it.  Collective."""
    cfg = get_config()
    n = dist.get_world_size() if num_devices is None else int(num_devices)
    denom = model_parallel * seq_parallel
    if n % denom != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel} "
            f"* seq_parallel={seq_parallel}"
        )
    shape = {cfg.data_axis: n // denom, cfg.model_axis: model_parallel}
    if seq_parallel > 1:
        shape[cfg.seq_axis] = seq_parallel
    return process_mesh(shape, device)


def mesh_seq_size(mesh: ProcessMesh) -> int:
    return mesh.shape.get(get_config().seq_axis, 1)


def mesh_data_size(mesh: ProcessMesh) -> int:
    return mesh.shape.get(get_config().data_axis, 1)


def mesh_model_size(mesh: ProcessMesh) -> int:
    return mesh.shape.get(get_config().model_axis, 1)
