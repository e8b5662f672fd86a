"""How the batch and the params lay out over the ranks.

Counterpart of ``sparknet_tpu/parallel/sharding.py``.  In the JAX package
layout is the parallelism: arrays carry ``NamedSharding``s and GSPMD
inserts the collectives.  The port runs one process a rank, so a layout is
what each rank holds, and the collectives are explicit:

* the batch: data rank r takes the r-th equal slice of the global batch
  (``local_shard``; each process feeds its own slice, the reference's
  contract: each Spark executor reads its partition);
* the sequence: under a seq axis a rank-2-or-more feed splits its axis 1
  over the seq ranks when it divides (or when ``ShardingRules.seq_feeds``
  names it), JAX's ``_put_feeds`` rule (``seq_shard``);
* the params (``param_shardings``): MoE blobs are expert-major and split
  axis 0 over the model axis whenever E divides (expert parallelism by
  layout); every other blob is replicated.  Megatron's output-channel
  split of Convolution, Deconvolution, InnerProduct and Embed blobs needs
  its collectives written by hand in those layers, which the port has not
  done: such a blob raises ``NotImplementedError`` rather than replicate
  silently (a different memory contract from JAX's).  With
  ``tensor_parallel=False`` they replicate, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sparknet_tpu_torch.common import get_config

# Layer types that take Megatron-style output-channel sharding.
_TP_TYPES = {"Convolution", "Deconvolution", "InnerProduct", "Embed"}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Knobs for the layout pass (the JAX package's)."""

    tensor_parallel: bool = True
    # don't bother sharding tiny blobs — the all-gather costs more than it saves
    min_tp_dim: int = 128
    # Sequence parallelism: when the trainer's mesh has a 'seq' axis, shard
    # feed axis 1 over it and route MultiHeadAttention layers through
    # ring/Ulysses (`ops.attention.sequence_parallel`).
    sequence_parallel: bool = True
    attention_impl: str = "ring"  # 'ring' | 'ulysses'
    # Which feeds carry a sequence axis (axis 1).  None = auto: any feed
    # whose axis-1 size is divisible by the seq-axis degree (others stay
    # whole on every seq rank).  Name feeds explicitly to fail loudly on a
    # non-divisible sequence length instead of silently falling back.
    seq_feeds: tuple[str, ...] | None = None


def _blob_spec(layer_type: str, shape: tuple[int, ...], model_size: int,
               rules: ShardingRules) -> str | None:
    """The mesh axis a param blob's axis 0 splits over, or None
    (replicated)."""
    cfg = get_config()
    if rules.tensor_parallel and model_size > 1 and len(shape) >= 1:
        if (layer_type in _TP_TYPES and shape[0] % model_size == 0
                and shape[0] >= rules.min_tp_dim):
            raise NotImplementedError(
                f"tensor parallelism of {layer_type} blobs (shape {tuple(shape)} over "
                f"a model axis of {model_size}) is not ported to sparknet_tpu_torch "
                "yet (ROADMAP Queue A12: Megatron collectives in Convolution, "
                "Deconvolution, InnerProduct and Embed); pass "
                "ShardingRules(tensor_parallel=False) to replicate them")
        if layer_type == "MoE" and shape[0] % model_size == 0:
            # expert parallelism by layout: every MoE blob is expert-major
            # [E, ...], so splitting axis 0 puts whole experts on ranks.  No
            # min_tp_dim floor: E is small but each expert is big.
            return cfg.model_axis
    return None


def blob_shard_degree(layer_type: str, shape: tuple[int, ...], model_size: int,
                      rules: ShardingRules | None = None) -> int:
    """How many ways one param blob splits: ``model_size`` when
    :func:`_blob_spec` splits it, else 1 (replicated)."""
    rules = rules or ShardingRules()
    return model_size if _blob_spec(layer_type, shape, model_size, rules) else 1


@dataclasses.dataclass(frozen=True)
class BlobSharding:
    """Where one blob lives: split on axis 0 over the mesh axis ``axis``
    (this rank holds slice ``index`` of ``parts``, through ``comm``), or
    replicated (``axis`` None)."""

    axis: str | None = None
    comm: object = None

    @property
    def parts(self) -> int:
        return 1 if self.comm is None else self.comm.size

    @property
    def index(self) -> int:
        return 0 if self.comm is None else self.comm.rank

    def local(self, blob: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole ``blob``."""
        if self.axis is None:
            return blob
        m = blob.shape[0] // self.parts
        return blob[self.index * m:(self.index + 1) * m]


replicated = BlobSharding()


def param_shardings(net, variables, mesh, rules: ShardingRules | None = None):
    """A NetVars-shaped tree of :class:`BlobSharding`s for ``variables``
    (whole blobs): the mesh axis and group each param splits over, or
    ``replicated``; state is replicated."""
    from sparknet_tpu_torch.compiler.graph import NetVars
    from sparknet_tpu_torch.parallel.mesh import mesh_model_size

    rules = rules or ShardingRules()
    model_size = mesh_model_size(mesh)
    params = {}
    for lname, plist in variables.params.items():
        ltype = next(l for l in net.layers if l.name == lname).TYPE
        specs = []
        for p in plist:
            axis = _blob_spec(ltype, tuple(p.shape), model_size, rules)
            specs.append(replicated if axis is None else BlobSharding(axis, mesh.comm(axis)))
        params[lname] = specs
    state = {lname: {k: replicated for k in s} for lname, s in variables.state.items()}
    return NetVars(params=params, state=state)


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


def seq_shard(feeds: dict, rank: int, size: int,
              seq_feeds: tuple[str, ...] | None = None) -> tuple[dict, frozenset]:
    """Seq rank ``rank``'s part of a batch, JAX's ``_put_feeds`` rule: a
    feed of rank 2 or more splits its axis 1 into ``size`` equal blocks
    and keeps block ``rank`` when that axis divides, or when ``seq_feeds``
    names it (raising when it does not divide); with ``seq_feeds`` given,
    only the named feeds split.  Every other feed stays whole.  Returns
    the feeds and the names that were split."""
    out, split = {}, set()
    for name, v in feeds.items():
        wanted = False
        if np.ndim(v) >= 2:
            divisible = np.shape(v)[1] % size == 0
            if seq_feeds is not None and name in seq_feeds:
                if not divisible:
                    raise ValueError(
                        f"feed {name!r}: sequence length {np.shape(v)[1]} not "
                        f"divisible by the 'seq' mesh axis ({size})")
                wanted = True
            else:
                wanted = seq_feeds is None and divisible
        if wanted:
            s = np.shape(v)[1] // size
            part = v[:, rank * s:(rank + 1) * s]
            v = part.contiguous() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)
            split.add(name)
        out[name] = v
    return out, frozenset(split)
