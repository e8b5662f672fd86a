"""Ulysses-style all-to-all sequence parallelism.

Counterpart of ``sparknet_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses,
Jacobs et al. 2023, PAPERS.md): one all-to-all re-splits the [B, H, S, D]
tensors from sequence blocks to head groups, every rank runs whole-sequence
attention for its H/n heads, and a second all-to-all restores the sequence
blocks.  The attention is ``ops/kernels.flash_attention``: the flash kernel
(B3) forward and its backward kernel (B3') under autograd
(``FlashAttentionFunction``) on the card, the plain version on the CPU.
The all-to-alls (``collectives.all_to_all``) have the inverse all-to-all
as their backward.

Against the ring: Ulysses moves each element twice and needs
``num_heads % n == 0``, but its attention is one ordinary kernel call a
pass; the ring needs no head count and never holds a whole sequence.
"""

from __future__ import annotations

import torch

from sparknet_tpu_torch.ops import kernels
from sparknet_tpu_torch.parallel.collectives import all_gather, all_to_all
from sparknet_tpu_torch.parallel.ring_attention import seq_block


def ulysses_attention(q, k, v, comm, causal: bool = False) -> torch.Tensor:
    """This rank's blocks [B, H, S/n, D] in, its output block out: all-to-all
    #1 scatters heads and gathers the sequence ([B, H/n, S, D], q, k and v
    in one call), the flash kernel runs, all-to-all #2 scatters the
    sequence and gathers the heads.  ``comm``: the seq group (JAX's axis
    name)."""
    qkv = all_to_all(torch.stack((q, k, v)), split_axis=2, concat_axis=3, comm=comm)
    oh = kernels.flash_attention(*qkv.unbind(0), causal=causal)
    return all_to_all(oh, split_axis=2, concat_axis=1, comm=comm)


def ulysses_self_attention(mesh, q, k, v, seq_axis: str = "seq",
                           causal: bool = False) -> torch.Tensor:
    """The whole-array wrapper mirroring :func:`ring_self_attention`: every
    rank passes the whole [B, H, S, D] arrays and gets the whole output.
    H and S must divide by the seq axis's size (JAX's errors)."""
    comm = mesh.comm(seq_axis)
    n = comm.size
    H = q.shape[1]
    if H % n != 0:
        raise ValueError(
            f"ulysses needs num_heads ({H}) divisible by the "
            f"{seq_axis!r} mesh axis size ({n}); use ring attention for "
            "head counts below the mesh size")
    S = q.shape[2]
    if S % n != 0:
        raise ValueError(
            f"sequence length ({S}) must divide evenly over the "
            f"{seq_axis!r} mesh axis size ({n})")
    o = ulysses_attention(*(seq_block(t, comm) for t in (q, k, v)), comm, causal)
    return all_gather(o, 2, comm, grad="slice")
