"""The collectives of the parallel modes, with their gradients.

The JAX package gets these from its mesh programs: ``lax.all_gather``,
``lax.all_to_all``, ``lax.ppermute`` and ``lax.psum`` inside a
``shard_map``, differentiated by JAX, and the all-gathers GSPMD inserts.
The port runs one process a rank, so each is a call on a process group
here, and the differentiable ones are ``torch.autograd.Function``s whose
backward is the collective's transpose:

* :func:`all_gather` along an axis.  Its backward depends on what the
  ranks after it compute: ``"reduce_scatter"`` (the sequence axis: each
  rank's loss depends on every rank's rows, so the gradients are summed,
  and the trainer's mean over the seq ranks makes the sum a mean) or
  ``"slice"`` (the model axis: every rank computes the same function of
  the gathered tensor, so each takes its own rows of the one gradient);
* :func:`all_to_all` (Ulysses' head/sequence swap and the expert
  dispatch), whose backward is the inverse all-to-all;
* :func:`ring_shift`, JAX's ``ppermute`` by one: send to the next rank of
  the group, receive from the previous one (``batch_isend_irecv``);
* :func:`reduce_from` and :func:`copy_to`, Megatron's g and f: an
  all-reduce whose backward is the identity, and the identity whose
  backward is an all-reduce.

A :class:`Comm` is one process group with this rank's place in it.  gloo
takes CUDA tensors for some collectives only (several ranks on one card
go through gloo: NCCL takes one rank a card).  The ones it refuses go
through pinned host buffers, copied explicitly: the ``Comm`` decides that
when it is made, from the group's backend and the device
(``host_staged``), never by catching a failed call, and
``STAGED_CALLS``/``STAGED_BYTES`` count what went that way.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# The collectives gloo refuses for CUDA tensors, which go through pinned
# host buffers on a gloo group of CUDA ranks.  On torch 2.11 (CUDA 12.8,
# one H100) gloo takes CUDA tensors for all_reduce, all_gather_into_tensor,
# reduce_scatter_tensor and all_to_all_single, and its send/recv hands the
# device pointer to its TCP transport, which aborts the process ("writev:
# Bad address"): so the ring's hops go through the host.  chip_smoke.py's
# ``seq_parallel`` phase prints gloo's answer for each.
GLOO_CUDA_HOST_STAGED = frozenset({"ring_shift"})

# collectives staged through host buffers, and the bytes they copied each
# way, since the last reset_staged_counts()
STAGED_CALLS = 0
STAGED_BYTES = 0


def reset_staged_counts() -> None:
    global STAGED_CALLS, STAGED_BYTES
    STAGED_CALLS = STAGED_BYTES = 0


def _count_staged(*tensors) -> None:
    global STAGED_CALLS, STAGED_BYTES
    STAGED_CALLS += 1
    STAGED_BYTES += sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass(frozen=True)
class Comm:
    """One process group as a rank of it sees it: ``size``, this rank's
    ``rank`` in it, the global ranks in group order (``ranks``, for
    point-to-point), and the collectives that go through host buffers on
    this group (``host_staged``)."""

    group: object
    ranks: tuple
    rank: int
    device: torch.device
    host_staged: frozenset = frozenset()

    @property
    def size(self) -> int:
        return len(self.ranks)

    @classmethod
    def make(cls, group, ranks, device) -> "Comm":
        """The ``Comm`` of ``group`` (over the global ``ranks``, in order)
        for tensors on ``device``: gloo with CUDA tensors stages
        ``GLOO_CUDA_HOST_STAGED`` through host buffers."""
        device = torch.device(device)
        ranks = tuple(int(r) for r in ranks)
        me = dist.get_rank()
        rank = ranks.index(me) if me in ranks else -1
        staged = frozenset()
        if device.type == "cuda" and dist.get_backend(group) == "gloo":
            staged = GLOO_CUDA_HOST_STAGED
        return cls(group=group, ranks=ranks, rank=rank, device=device, host_staged=staged)

    def staged(self, op: str) -> bool:
        return op in self.host_staged


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (CUDA)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _host_empty(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


# ---------------------------------------------------------------------------
# Plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce_sum_(t: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``t`` := its sum over the group, in place (gloo takes CUDA tensors
    for it)."""
    if comm.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=comm.group)
    return t


def _gather0(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """[n * x.shape[0], ...]: every rank's contiguous ``x`` stacked on axis
    0 in group order."""
    x = x.contiguous()
    out = torch.empty((comm.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=comm.group)
    return out


def _reduce_scatter0(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The sum over the group of ``x`` [n * m, ...], this rank's m rows."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // comm.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=comm.group)
    return out


def _all_to_all0(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``x`` [n, ...]: row i goes to the group's rank i; returns [n, ...]
    with row j from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=comm.group)
    return out


def ring_shift(tensors, comm: Comm) -> list:
    """JAX's ``ppermute`` by one over the group: each of ``tensors`` goes
    to the next rank (group order, wrapping) and the previous rank's
    arrive, as new tensors in the same order."""
    tensors = [t.contiguous() for t in tensors]
    if comm.size == 1:
        return [t.clone() for t in tensors]
    nxt = comm.ranks[(comm.rank + 1) % comm.size]
    prv = comm.ranks[(comm.rank - 1) % comm.size]
    staged = comm.staged("ring_shift")
    if staged:
        _count_staged(*tensors, *tensors)
        sends = [_host(t) for t in tensors]
        recvs = [_host_empty(t) for t in tensors]
    else:
        sends = tensors
        recvs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, s, nxt, group=comm.group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, prv, group=comm.group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        return [r.to(t.device) for r, t in zip(recvs, tensors)]
    return recvs


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, comm, grad):
        ctx.axis, ctx.comm, ctx.grad = axis, comm, grad
        moved = x.movedim(axis, 0)
        out = _gather0(moved, comm)
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        comm, axis = ctx.comm, ctx.axis
        moved = g.movedim(axis, 0)
        if ctx.grad == "reduce_scatter":
            part = _reduce_scatter0(moved, comm)
        else:
            m = moved.shape[0] // comm.size
            part = moved[comm.rank * m:(comm.rank + 1) * m]
        return part.movedim(0, axis), None, None, None


def all_gather(x: torch.Tensor, axis: int, comm: Comm,
               grad: str = "reduce_scatter") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in group order.
    ``grad``: ``"reduce_scatter"`` (the backward sums the ranks' gradients
    and keeps this rank's rows) or ``"slice"`` (the backward keeps this
    rank's rows of its own gradient)."""
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"all_gather: grad must be 'reduce_scatter' or 'slice', got {grad!r}")
    if comm.size == 1:
        return x
    return _AllGather.apply(x, axis % x.dim(), comm, grad)


def _a2a(x: torch.Tensor, split_axis: int, concat_axis: int, comm: Comm) -> torch.Tensor:
    n = comm.size
    chunks = torch.stack(x.chunk(n, dim=split_axis))  # [n, ...] row i to rank i
    got = _all_to_all0(chunks, comm)
    return torch.cat(got.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, comm):
        ctx.args = (split_axis, concat_axis, comm)
        return _a2a(x, split_axis, concat_axis, comm)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, comm = ctx.args
        return _a2a(g, concat_axis, split_axis, comm), None, None, None


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               comm: Comm) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split into ``n`` chunks along
    ``split_axis``, chunk i sent to rank i, the chunks received
    concatenated along ``concat_axis`` in group order.  The backward is the
    inverse all-to-all."""
    if x.shape[split_axis] % comm.size:
        raise ValueError(f"all_to_all: axis {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {comm.size} ranks")
    if comm.size == 1:
        return x
    return _AllToAll.apply(x, split_axis % x.dim(), concat_axis % x.dim(), comm)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return all_reduce_sum_(x.clone(), comm)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.comm), None


def reduce_from(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Megatron's g: the sum of ``x`` over the group; the backward passes
    the gradient through (every rank holds the same one)."""
    return x if comm.size == 1 else _ReduceFrom.apply(x, comm)


def copy_to(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Megatron's f: ``x`` itself; the backward sums the ranks' partial
    gradients of it."""
    return x if comm.size == 1 else _CopyTo.apply(x, comm)
