"""Multi-head self-attention and rotary position embeddings.

Counterpart of ``sparknet_tpu/ops/attention.py``.  Prototxt surface::

    layer {
      name: "attn" type: "MultiHeadAttention" bottom: "x" top: "y"
      attention_param { num_heads: 8 causal: true rope: true }
    }

Input/output blobs are [B, S, E].  Params follow Caffe blob order:
[W_qkv (3E, E), b_qkv (3E), W_out (E, E), b_out (E)], the JAX layer's, so
the weights bridge (``interop.py``) maps them one to one.  The attention
core is ``ops/kernels.flash_attention`` (the flash kernel on the card).

Sequence parallelism composes here, as in the JAX layer: under an active
:func:`sequence_parallel` context (a ``ParallelTrainer`` whose mesh has a
'seq' axis opens it around its steps), a layer whose input ``Network.apply``
holds as sequence blocks (axis 1 split over the seq ranks) runs its
attention core through ring or Ulysses attention over the seq group
(``parallel/ring_attention.py``, ``parallel/ulysses.py``), and applies rope
at the block's global positions (``rope_at``, bit for bit the rows of the
whole sequence's ``rope``).

The helpers ``project_qkv`` and ``project_out`` are the layer's own
expressions; the cached decode builders of ``models/zoo.py`` call them, so
the prompt pass, the decode step and the layer share one implementation
around their attention cores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.common import get_config
from sparknet_tpu_torch.ops.base import Layer, LayerOutput
from sparknet_tpu_torch.ops.fillers import fill
from sparknet_tpu_torch.ops.kernels import flash_attention
from sparknet_tpu_torch.ops.registry import register
from sparknet_tpu_torch.proto.text_format import Message

# ---------------------------------------------------------------------------
# Sequence-parallel dispatch.
#
# The JAX layer consults a trace-time context; the port's layers run
# eagerly, so the context is consulted as each forward runs: the trainer
# opens ``sequence_parallel(mesh, impl, feeds)`` around its steps, naming
# the feeds it split, ``Network.apply`` follows the split blobs through
# the layers, and marks the layer calls whose inputs are sequence blocks
# (``seq_blocks``).
# ---------------------------------------------------------------------------

_SP = threading.local()


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """An open sequence-parallel context: the mesh, the attention impl and
    the feeds split along axis 1 over the seq ranks."""

    mesh: object
    impl: str
    feeds: frozenset = frozenset()

    @property
    def comm(self):
        return self.mesh.comm(get_config().seq_axis)


@contextlib.contextmanager
def sequence_parallel(mesh, impl: str = "ring", feeds=()):
    """Route MultiHeadAttention layers whose inputs are sequence blocks
    through sequence parallelism over ``mesh``'s 'seq' axis while the
    context is open.  ``impl``: 'ring' (K/V blocks round the ring, any
    head count) or 'ulysses' (head-scatter all-to-all, num_heads divisible
    by the seq axis's size).  ``feeds``: the feed blobs split along axis 1
    (``parallel.sharding.seq_shard``)."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    prev = getattr(_SP, "ctx", None)
    _SP.ctx = SequenceParallel(mesh, impl, frozenset(feeds))
    try:
        yield
    finally:
        _SP.ctx = prev


def active_sequence_parallel() -> SequenceParallel | None:
    """The open context when its mesh has a real (>1) seq axis, else
    None."""
    ctx = getattr(_SP, "ctx", None)
    if ctx is None:
        return None
    from sparknet_tpu_torch.parallel.mesh import mesh_seq_size

    if mesh_seq_size(ctx.mesh) <= 1:
        return None
    return ctx


@contextlib.contextmanager
def seq_blocks():
    """Open while ``Network.apply`` runs a layer on sequence blocks."""
    prev = getattr(_SP, "blocks", False)
    _SP.blocks = True
    try:
        yield
    finally:
        _SP.blocks = prev


def _sp_attention(sp: SequenceParallel, q, k, v, causal: bool) -> torch.Tensor:
    """The attention core on this rank's blocks [B, H, S_l, D], over the
    seq group."""
    from sparknet_tpu_torch.parallel.ring_attention import ring_attention
    from sparknet_tpu_torch.parallel.ulysses import ulysses_attention

    comm = sp.comm
    if sp.impl == "ulysses" and q.shape[1] % comm.size != 0:
        raise ValueError(
            f"ulysses needs num_heads ({q.shape[1]}) divisible by the "
            f"'{get_config().seq_axis}' mesh axis ({comm.size}); use impl='ring'")
    core = ring_attention if sp.impl == "ring" else ulysses_attention
    return core(q, k, v, comm, causal)


# (half, base, device) -> theta [half] float32.  One tensor per device, so
# ``rope`` and ``rope_at`` multiply by the same bits.
_THETA: dict = {}


def _theta(half: int, base: float, device: torch.device) -> torch.Tensor:
    """theta_i = base^(-i/half), in float32, computed once on the CPU (as
    the JAX package computes it: a float32 divide, then a float32 power)
    and kept per device."""
    key = (half, float(base), str(device))
    t = _THETA.get(key)
    if t is None:
        t = torch.pow(torch.tensor(base, dtype=torch.float32),
                      -torch.arange(half, dtype=torch.float32) / half)
        t = _THETA[key] = t.to(device)
    return t


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]  # rotate-half convention
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over ``x`` [B, H, S, D] (D even):
    position t rotates each head-dim pair (i, i + D/2) by t * theta_i,
    theta_i = base^(-2i/D) (RoFormer, Su et al. 2021)."""
    _, _, s, d = x.shape
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    theta = _theta(d // 2, base, x.device)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * theta[None, :]
    return _rotate(x, ang)


def rope_at(x: torch.Tensor, positions: torch.Tensor,
            base: float = 10000.0) -> torch.Tensor:
    """:func:`rope` at explicit absolute positions, the decode path's twin:
    ``x`` [B, H, W, D], ``positions`` [B, W] integers.  For
    ``positions[b, w] == t`` the rotation is the same float expression
    :func:`rope` applies at row t (the same theta tensor, the same float32
    ``t * theta`` product, the same cos/sin/rotate-half arithmetic), so a K
    cached through this path equals the K the full-window forward computes
    at that row, bit for bit."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    theta = _theta(d // 2, base, x.device)
    ang = positions.to(torch.float32)[..., None] * theta  # [B, W, half]
    return _rotate(x, ang[:, None])  # broadcast over heads


def project_qkv(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                heads: int):
    """[B, S, E] -> q, k, v as [B, H, S, D] views (``x W_qkv^T + b``)."""
    b, s, e = x.shape
    qkv = F.linear(x, w_qkv, b_qkv)
    return [t.reshape(b, s, heads, e // heads).transpose(1, 2)
            for t in qkv.split(e, dim=-1)]


def project_out(o: torch.Tensor, w_out: torch.Tensor,
                b_out: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] attention output -> [B, S, E] (``o W_out^T + b``)."""
    b, h, s, d = o.shape
    return F.linear(o.transpose(1, 2).reshape(b, s, h * d), w_out, b_out)


@register
class MultiHeadAttentionLayer(Layer):
    TYPE = "MultiHeadAttention"

    def __init__(self, lp, phase):
        super().__init__(lp, phase)
        p = lp.get_msg("attention_param")
        self.num_heads = p.get_int("num_heads", 1)
        self.causal = p.get_bool("causal", False)
        self.rope = p.get_bool("rope", False)
        self.weight_filler = (p.get_msg("weight_filler") if p.has("weight_filler")
                              else Message().set("type", "xavier"))

    def init(self, gen, in_shapes):
        (_, _, e) = in_shapes[0]
        if e % self.num_heads != 0:
            raise ValueError(f"attention embed dim ({e}) must be divisible by "
                             f"num_heads ({self.num_heads})")
        w_qkv = fill(self.weight_filler, gen, (3 * e, e))
        w_out = fill(self.weight_filler, gen, (e, e))
        return [w_qkv, torch.zeros(3 * e), w_out, torch.zeros(e)], {}

    def apply(self, params, state, inputs, *, train):
        # the JAX layer's einsum promotes mixed operand types (bf16 rows
        # from a bf16 Embed against float32 weights under param_dtype bf16
        # give float32); F.linear takes one type
        dt = torch.promote_types(inputs[0].dtype, params[0].dtype)
        w_qkv, b_qkv, w_out, b_out = (p.to(dt) for p in params)
        q, k, v = project_qkv(inputs[0].to(dt), w_qkv, b_qkv, self.num_heads)
        sp = active_sequence_parallel()
        if sp is not None and not getattr(_SP, "blocks", False):
            size = sp.comm.size
            if q.shape[2] % size:
                # ring/Ulysses need equal sequence blocks; an indivisible S
                # runs locally instead (correct, just not sequence-parallel)
                warnings.warn(
                    f"{self.name}: sequence length {q.shape[2]} not divisible by the "
                    f"'seq' mesh axis ({size}); attention runs without sequence "
                    "parallelism", stacklevel=2)
            sp = None
        if sp is None:
            if self.rope:
                q, k = rope(q), rope(k)
            o = flash_attention(q, k, v, causal=self.causal)
        else:
            if self.rope:
                # this block's rows of the whole sequence: global positions
                b, _, s_l, _ = q.shape
                pos = sp.comm.rank * s_l + torch.arange(s_l, device=q.device)
                pos = pos.expand(b, s_l)
                q, k = rope_at(q, pos), rope_at(k, pos)
            o = _sp_attention(sp, q, k, v, self.causal)
        return LayerOutput([project_out(o, w_out, b_out)])
