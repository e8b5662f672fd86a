"""Flat param/slot arenas for the one-pass fused optimizer update.

Counterpart of ``sparknet_tpu/solvers/arena.py``.  The blob-wise optimizer
state (``solvers/updates.py``: one history list per param blob, Caffe's
``SGDSolver::history_`` shape) is laid out for the fused sweep
(``ops/kernels.fused_update``): params, grads and each slot history are
one contiguous flat arena per role, built once when the ``Solver`` is
built, with an index map back to the blobs.

Layout invariants (the JAX package's):

* every blob is padded to a whole number of tiles (``ARENA_TILE`` = 2048
  elements), so a tile never spans two blobs and the kernel applies each
  blob's lr_mult and decay_mult through per-tile tables;
* pad elements are zero in every arena and stay zero under all six rules
  (zero grad and zero param are a fixed point of each), so arena
  reductions (the global-norm clip) equal their blob-wise twins;
* the index map is geometry only (offset/size/shape/dtype per blob):
  snapshots stay blob-wise, through ``pack``/``unpack``;
* arenas may be stored in bf16 (``Config.storage_dtype``) while blobs and
  snapshots keep the param dtype; the kernel computes in float32.  Blobs
  that are all bf16 (``Config.param_dtype``) get a bf16 arena whatever
  ``storage_dtype`` says.  Under bf16 compute with float32 params the
  arena stays float32: the update is a float32 sweep on float32 masters.
  A float32 arena that holds some bf16 blobs (the attention weights stay
  float32 under ``param_dtype`` bf16, as in the JAX package) rounds their
  spans to bf16 after each update (:func:`round_to_blobs`), which is the
  JAX step's pack and unpack at each step's boundary.

The PyTorch form: the param arena is the one leaf tensor of the fused
step, and ``unpack`` returns each blob as a view of its span (a cast of it
with bf16 storage).  ``unpack``'s backward is ``pack``, so
``torch.autograd.grad(loss, arena)`` returns the grad arena already
packed, zero in the pad zones: the counterpart of differentiating w.r.t.
the arena at ``sparknet_tpu/solvers/solver.py:289-292``.  The kernel then
updates the param and slot arenas IN PLACE (the TPU kernel aliases its
inputs to its outputs), so both keep their storage from step to step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sparknet_tpu_torch.common import resolve_device
from sparknet_tpu_torch.ops.kernels import (
    ARENA_TILE,
    FUSED_RULE_SLOTS,
    UpdateStatics,
    fused_update,
)
from sparknet_tpu_torch.solvers.updates import adam_correction, clip_scale

__all__ = [
    "ArenaEntry",
    "ArenaLayout",
    "build_layout",
    "pack",
    "unpack",
    "pack_slots",
    "unpack_slots",
    "init_slot_arenas",
    "round_to_blobs",
    "arena_apply_update",
    "update_statics",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ArenaEntry:
    """One blob's span in the flat arenas (the index-map row)."""

    lname: str
    index: int  # blob position within the layer's param list
    shape: tuple
    dtype: str  # the BLOB dtype (unpack casts back to it)
    offset: int  # element offset of the blob's span
    size: int  # true element count
    span: int  # padded element count (multiple of the tile)


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Geometry and per-tile tables, built once per solver.

    ``struct`` records the params-dict shape (layer -> blob count) so
    ``unpack`` gives back the same structure.  ``tile_lr`` /
    ``tile_decay`` hold lr_mult and the folded ``weight_decay *
    decay_mult`` per tile (pad tiles take their blob's values; pad elements
    are zero, so the values do nothing there)."""

    entries: tuple
    struct: tuple  # ((lname, n_blobs), ...) in params-dict order
    tile: int
    total: int  # padded total elements (n_tiles * tile)
    n_tiles: int
    rule: str
    n_slots: int
    storage_dtype: str  # "f32" | "bf16"
    tile_lr: np.ndarray  # [n_tiles] float32
    tile_decay: np.ndarray  # [n_tiles] float32

    @property
    def storage(self) -> torch.dtype:
        return torch.bfloat16 if self.storage_dtype == "bf16" else torch.float32

    @property
    def mixed(self) -> bool:
        """A float32 arena holding bf16 blobs (:func:`round_to_blobs`)."""
        return self.storage_dtype == "f32" and any(
            e.span and e.dtype == "bfloat16" for e in self.entries)

    @property
    def itemsize(self) -> int:
        return 2 if self.storage_dtype == "bf16" else 4

    @property
    def total_bytes(self) -> int:
        return self.total * self.itemsize

    def param_count(self) -> int:
        """True (unpadded) number of param elements."""
        return sum(e.size for e in self.entries)

    def index_map(self) -> list:
        """The blob <-> arena map as plain data."""
        return [
            {"layer": e.lname, "blob": e.index, "offset": e.offset,
             "size": e.size, "span": e.span, "shape": list(e.shape),
             "dtype": e.dtype}
            for e in self.entries
        ]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def build_layout(params: dict, specs: dict, cfg, *,
                 storage_dtype: str | None = None,
                 tile: int = ARENA_TILE) -> ArenaLayout:
    """The arena geometry from a params dict (only ``.shape``/``.dtype``
    are read), the per-blob ParamSpecs and a SolverConfig.  Blobs go in
    the params dict's own order, the order ``updates.apply_update``
    walks."""
    if storage_dtype is None:
        from sparknet_tpu_torch.common import get_config

        storage_dtype = get_config().storage_dtype
        blobs = [p for pl in params.values() for p in pl if p.numel()]
        if blobs and all(p.dtype == torch.bfloat16 for p in blobs):
            storage_dtype = "bf16"
    if storage_dtype not in ("f32", "bf16"):
        raise ValueError(f"storage_dtype must be 'f32' or 'bf16', got {storage_dtype!r}")
    entries: list = []
    struct: list = []
    spans: list = []  # (n_tiles_of_blob, lr_mult, folded_decay)
    offset = 0
    for lname, plist in params.items():
        struct.append((lname, len(plist)))
        for i, p in enumerate(plist):
            size = int(np.prod(tuple(p.shape)))  # () -> 1; any zero dim -> 0
            span = -(-size // tile) * tile if size else 0
            spec = specs[lname][i]
            entries.append(ArenaEntry(
                lname=lname, index=i, shape=tuple(p.shape),
                dtype=_dtype_name(p.dtype), offset=offset, size=size,
                span=span))
            spans.append((span // tile, float(spec.lr_mult),
                          float(cfg.weight_decay) * float(spec.decay_mult)))
            offset += span
    total = offset
    n_tiles = total // tile
    tile_lr = np.zeros((n_tiles,), np.float32)
    tile_decay = np.zeros((n_tiles,), np.float32)
    t = 0
    for n, lr_mult, decay in spans:
        tile_lr[t:t + n] = lr_mult
        tile_decay[t:t + n] = decay
        t += n
    return ArenaLayout(
        entries=tuple(entries), struct=tuple(struct), tile=tile,
        total=total, n_tiles=n_tiles, rule=cfg.solver_type,
        n_slots=FUSED_RULE_SLOTS[cfg.solver_type],
        storage_dtype=storage_dtype, tile_lr=tile_lr, tile_decay=tile_decay)


def pack(layout: ArenaLayout, tree: dict, device=None) -> torch.Tensor:
    """Blob dict ({lname: [blob, ...]}) -> one [total] arena in the storage
    type, pad zones zero, on ``device`` (default: the blobs')."""
    if device is None:
        device = next((b.device for bl in tree.values() for b in bl), "cpu")
    out = torch.zeros((layout.total,), dtype=layout.storage, device=device)
    with torch.no_grad():
        for e in layout.entries:
            if e.span:
                out[e.offset:e.offset + e.size] = (
                    tree[e.lname][e.index].reshape(-1).to(layout.storage))
    return out


class _Unpack(torch.autograd.Function):
    """arena -> blobs (views of their spans, or casts with bf16 storage);
    the backward packs the blobs' grads into one grad arena in the
    arena's type, zero in the pad zones."""

    @staticmethod
    def forward(ctx, layout, arena):
        ctx.layout = layout
        out = []
        for e in layout.entries:
            dtype = _DTYPES[e.dtype]
            if e.span == 0:
                out.append(torch.zeros(e.shape, dtype=dtype, device=arena.device))
                continue
            blob = arena[e.offset:e.offset + e.size].view(e.shape)
            out.append(blob if dtype == arena.dtype else blob.to(dtype))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        layout = ctx.layout
        g = torch.zeros((layout.total,), dtype=layout.storage,
                        device=next(x.device for x in grads if x is not None))
        for e, gb in zip(layout.entries, grads):
            if e.span and gb is not None:
                g[e.offset:e.offset + e.size] = gb.reshape(-1).to(layout.storage)
        return None, g


def round_to_blobs(layout: ArenaLayout, arena: torch.Tensor) -> None:
    """Round, in place, the spans of a float32 arena whose blobs are bf16
    to bf16 values (nothing to do when the types agree)."""
    if arena.dtype != torch.float32:
        return
    with torch.no_grad():
        for e in layout.entries:
            if e.span and e.dtype == "bfloat16":
                seg = arena[e.offset:e.offset + e.size]
                seg.copy_(seg.to(torch.bfloat16))


def unpack(layout: ArenaLayout, arena: torch.Tensor) -> dict:
    """[total] arena -> blob dict, each blob in its recorded dtype: a view of
    the arena when the types agree, else a cast.  Differentiable: the grad
    w.r.t. ``arena`` is the blobs' grads packed (``_Unpack``)."""
    blobs = _Unpack.apply(layout, arena)
    out: dict = {lname: [None] * n for lname, n in layout.struct}
    for e, b in zip(layout.entries, blobs):
        out[e.lname][e.index] = b
    return out


def pack_slots(layout: ArenaLayout, slots: dict, device=None) -> list:
    """Blob-wise history ({lname: [[h0, h1?] per blob]}) -> one arena per
    slot index."""
    return [
        pack(layout, {ln: [hl[k] for hl in per_param]
                      for ln, per_param in slots.items()}, device)
        for k in range(layout.n_slots)
    ]


def unpack_slots(layout: ArenaLayout, arenas: list) -> dict:
    """Inverse of :func:`pack_slots` (blob dtypes restored)."""
    per_k = [unpack(layout, a) for a in arenas]
    return {
        lname: [[per_k[k][lname][i] for k in range(layout.n_slots)]
                for i in range(n)]
        for lname, n in layout.struct
    }


def init_slot_arenas(layout: ArenaLayout, device=None) -> list:
    """Zero history arenas (the PresolveHistory analog, flat) on ``device``
    (``None``: CUDA, or raise)."""
    device = resolve_device(device)
    return [torch.zeros((layout.total,), dtype=layout.storage, device=device)
            for _ in range(layout.n_slots)]


def update_statics(cfg) -> UpdateStatics:
    """SolverConfig -> the kernel's constants."""
    return UpdateStatics(
        momentum=float(cfg.momentum),
        momentum2=float(cfg.momentum2),
        rms_decay=float(cfg.rms_decay),
        delta=float(cfg.delta),
        iter_size=int(cfg.iter_size),
        reg=("none" if cfg.weight_decay == 0.0
             else "l1" if cfg.regularization_type == "L1" else "l2"),
        clip=cfg.clip_gradients > 0,
    )


class ArenaTables:
    """The per-tile tables of a layout on one device, made once."""

    def __init__(self, layout: ArenaLayout, device):
        self.tile_lr = torch.from_numpy(layout.tile_lr).to(device)
        self.tile_decay = torch.from_numpy(layout.tile_decay).to(device)


def arena_apply_update(cfg, layout: ArenaLayout, param_arena: torch.Tensor,
                       grad_arena: torch.Tensor, slot_arenas: list,
                       rate: torch.Tensor, it: int,
                       tables: ArenaTables | None = None) -> None:
    """One full Caffe-ordered update over the arenas, the fused twin of
    ``updates.apply_update``, IN PLACE on ``param_arena`` and
    ``slot_arenas``.  The per-step scalars the kernel takes from the device
    (the lr ``rate``, a 0-dim float32 tensor; the global-norm clip scale,
    computed here from the grad arena; Adam's bias correction) ride a [3]
    float32 tensor, so nothing waits on the host."""
    dev = param_arena.device
    if cfg.clip_gradients > 0:
        # ref: ClipGradients (sgd_solver.cpp:81-100) on raw accumulated
        # grads; the pad zones are zero, so the arena norm is the blob-wise
        # global_grad_norm (up to summation order)
        norm = torch.sqrt(torch.sum(torch.square(grad_arena.float())))
        cs = clip_scale(cfg.clip_gradients, norm)
    else:
        cs = torch.ones((), dtype=torch.float32, device=dev)
    if cfg.solver_type == "Adam":
        corr = adam_correction(cfg.momentum, cfg.momentum2, it, dev)
    else:
        corr = torch.ones((), dtype=torch.float32, device=dev)
    scalars = torch.stack([rate.to(dev, torch.float32), cs, corr])
    if tables is None:
        tables = ArenaTables(layout, dev)
    fused_update(cfg.solver_type, update_statics(cfg), param_arena,
                 grad_arena, slot_arenas, tables.tile_lr, tables.tile_decay,
                 scalars)
