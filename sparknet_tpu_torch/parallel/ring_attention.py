"""Ring attention: sequence parallelism over a ring of ranks.

Counterpart of ``sparknet_tpu/parallel/ring_attention.py`` (Liu et al.,
"Ring Attention with Blockwise Transformers", 2023, PAPERS.md).  Q, K and
V are split along the sequence over the ranks of a group; each rank
attends its query block to every K/V block while the K/V blocks go round
the ring one hop a step (``collectives.ring_shift``, JAX's ``ppermute``),
so no rank ever holds the whole sequence.

The JAX function accumulates the blocks with an online softmax (its
``_block_attend``'s running max and denominator).  Here each visiting
block is one launch of the flash kernel with its log-sum-exp (B3 with
``lse``), and the blocks merge by log-sum-exp in float32:

    lse = logsumexp_i(lse_i),   o = sum_i exp(lse_i - lse) * o_i

The backward goes round the ring again: the K/V blocks travel with dK/dV
accumulators, and each visiting block is one launch of the backward
kernel (B3') on (q, k_blk, v_blk) with the merged o and lse, whose
P = exp(s - lse) and delta = rowsum(dO * o) are exactly that block's share
of the whole softmax; after n hops the accumulators are home.  B3' takes
``lse`` as an input, so the merge lives inside one ``autograd.Function``.

Causal: the diagonal block is causal, earlier blocks are not, and a block
from a later rank (``src > idx``) is fully masked and skipped (JAX's
``lax.cond``), so rank i launches i + 1 blocks a pass.  On the CPU the same
Function runs the kernels' plain versions
(``flash_attention_forward_lse_torch``, ``flash_attention_backward_torch``).
"""

from __future__ import annotations

import torch

from sparknet_tpu_torch.ops import kernels
from sparknet_tpu_torch.parallel.collectives import all_gather, ring_shift


def _block_forward(q, k, v, causal: bool):
    """One block: (o in q's type, lse float32 [B, H, S])."""
    if q.device.type == "cuda":
        return kernels._flash_attention_cuda(q, k, v, causal, with_lse=True)
    if q.device.type == "cpu":
        return kernels.flash_attention_forward_lse_torch(q, k, v, causal)
    raise ValueError(f"ring_attention: unsupported device {q.device}")


def _block_backward(q, k, v, o, lse, g, causal: bool):
    """One block's (dq, dk, dv) against the merged o and lse."""
    if q.device.type == "cuda":
        return kernels._flash_attention_backward_cuda(q, k, v, o, lse, g, causal)
    return kernels.flash_attention_backward_torch(q, k, v, o, lse, g, causal)


def _visits(idx: int, n: int, causal: bool):
    """(hop, src) of every block rank ``idx`` attends, in ring order: the
    local block, then after s hops the block from ``(idx - s) % n``."""
    for s in range(n):
        src = (idx - s) % n
        if not (causal and src > idx):
            yield s, src


class RingAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, causal):
        n, idx = comm.size, comm.rank
        os, lses = [], []
        k_cur, v_cur, at = k, v, 0
        for s, src in _visits(idx, n, causal):
            while at < s:  # every rank hops n - 1 times, attending or not
                k_cur, v_cur = ring_shift([k_cur, v_cur], comm)
                at += 1
            o_i, lse_i = _block_forward(q, k_cur, v_cur, causal and src == idx)
            os.append(o_i.float())
            lses.append(lse_i)
        while at < n - 1:
            k_cur, v_cur = ring_shift([k_cur, v_cur], comm)
            at += 1
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        o = sum(torch.exp(l - lse)[..., None] * o_i for l, o_i in zip(lses, os))
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.comm, ctx.causal = comm, causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        comm, causal = ctx.comm, ctx.causal
        n, idx = comm.size, comm.rank
        g = g.contiguous()
        dq = torch.zeros_like(q, dtype=torch.float32)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros_like(k, dtype=torch.float32)
        dv_cur = torch.zeros_like(v, dtype=torch.float32)
        visits = dict(_visits(idx, n, causal))
        for s in range(n):
            if s:
                k_cur, v_cur, dk_cur, dv_cur = ring_shift([k_cur, v_cur, dk_cur, dv_cur], comm)
            src = (idx - s) % n
            if s in visits:
                dq_i, dk_i, dv_i = _block_backward(q, k_cur, v_cur, o, lse, g,
                                                   causal and src == idx)
                dq += dq_i
                dk_cur = dk_cur + dk_i
                dv_cur = dv_cur + dv_i
        # the n-th hop takes each block's accumulators home
        dk_cur, dv_cur = ring_shift([dk_cur, dv_cur], comm)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None


def ring_attention(q, k, v, comm, causal: bool = False) -> torch.Tensor:
    """Attention over a ring of sequence blocks: JAX's ``ring_attention``,
    with the process group ``comm`` (a ``collectives.Comm``, e.g.
    ``mesh.comm("seq")``) in place of its axis name.

    q, k, v: [B, H, S_local, D], this rank's block (rank r of the group
    holds rows r * S_local ... (r + 1) * S_local - 1).  Returns this rank's
    block of the output; differentiable (the gradient of a block's K/V
    sums every rank's share)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention: want q, k, v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return RingAttentionFunction.apply(q, k, v, comm, bool(causal))


def reference_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Unsharded full-sequence attention (the correctness oracle)."""
    return kernels.flash_attention_torch(q, k, v, causal)


def seq_block(x: torch.Tensor, comm, axis: int = 2) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis`` (sharded over ``comm``)."""
    s = x.shape[axis] // comm.size
    return x.narrow(axis, comm.rank * s, s)


def ring_self_attention(mesh, q, k, v, seq_axis: str = "seq",
                        causal: bool = False) -> torch.Tensor:
    """The whole-array wrapper, as JAX's over ``shard_map``: every rank
    passes the whole [B, H, S, D] q, k, v and gets the whole output; rank
    r attends block r over ``mesh``'s ``seq_axis`` group and the blocks
    are gathered (the gradient of the output reaches each rank's own
    block of q, k and v)."""
    comm = mesh.comm(seq_axis)
    if q.shape[2] % comm.size:
        raise ValueError(f"sequence length ({q.shape[2]}) must divide evenly over the "
                         f"{seq_axis!r} mesh axis size ({comm.size})")
    o = ring_attention(*(seq_block(t, comm) for t in (q, k, v)), comm, causal)
    return all_gather(o, 2, comm, grad="slice")
