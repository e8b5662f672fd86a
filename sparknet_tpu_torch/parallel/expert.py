"""Expert parallelism: MoE token dispatch by all-to-all over a group.

Counterpart of ``sparknet_tpu/parallel/expert.py``.  Each rank of an
``expert`` axis owns one expert's weights and a slice of the tokens, which
are exchanged by two all-to-alls, the Switch/GShard dispatch:

  1. gate each local token (top-1) and pack it into its expert's
     capacity-bounded send buffer (its rank among the same expert's tokens
     is its position; past the capacity it lands in an overflow bin that
     is cut away);
  2. all-to-all: rank e receives every source's buffer for expert e;
  3. apply the local expert's FFN;
  4. all-to-all back, unpack, scale by the gate probability.

Tokens past an expert's per-source capacity are dropped (output zero), as
in Switch Transformers; with ``capacity_factor`` high enough nothing drops
and the result equals the dense oracle (``ops.moe.moe_dense``).  The
all-to-alls are ``collectives.all_to_all`` (differentiable; gloo takes
CUDA tensors for it).
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.ops.moe import expert_ffn, gate_top1
from sparknet_tpu_torch.parallel.collectives import all_gather, all_to_all


def _capacity(tokens_per_device: int, num_experts: int, factor: float) -> int:
    return max(1, int(tokens_per_device * factor / num_experts))


def expert_dispatch(w_gate, expert_params, x, comm, capacity: int) -> torch.Tensor:
    """One rank's leg of the dispatch: ``x`` [t, D] its tokens,
    ``expert_params`` (W1 [H, D], b1 [H], W2 [D, H], b2 [D]) its expert's,
    ``w_gate`` [E, D] the whole gate, ``comm`` the expert group (E ranks),
    ``capacity`` C tokens a (source, expert) pair.  Returns [t, D]."""
    E, D = comm.size, x.shape[1]
    C = capacity
    idx, prob = gate_top1(w_gate, x)  # [t], [t]
    onehot = F.one_hot(idx, E)  # [t, E]
    pos = (torch.cumsum(onehot, 0) - 1)[torch.arange(idx.numel(), device=x.device), idx]
    keep = pos < C
    slot = torch.where(keep, idx * C + pos, torch.full_like(idx, E * C))  # E*C: overflow
    flat = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device).index_put(
        (slot,), x)[:E * C]
    recv = all_to_all(flat.reshape(E, C, D), 0, 0, comm).reshape(E * C, D)
    out = expert_ffn(expert_params, recv).reshape(E, C, D)
    back = all_to_all(out, 0, 0, comm).reshape(E * C, D)
    y = torch.where(keep[:, None], back[torch.where(keep, slot, torch.zeros_like(slot))],
                    torch.zeros_like(x))
    return y * prob[:, None]


def expert_parallel_moe(mesh, params, x, *, axis_name: str = "expert",
                        capacity_factor: float | None = None) -> torch.Tensor:
    """Top-1 MoE with expert-parallel dispatch, JAX's function over the
    port's mesh: every rank passes the whole ``params`` (W_gate [E, D], W1
    [E, H, D], b1 [E, H], W2 [E, D, H], b2 [E, D], the ``MoELayer`` layout)
    and the whole ``x`` [T, D]; rank e of ``axis_name`` (of size E) runs
    expert e on token slice e, and every rank gets the whole [T, D] output,
    equal to the dense oracle when no token overflows.
    ``capacity_factor``: per-expert buffer size multiplier; default E
    (nothing can drop)."""
    comm = mesh.comm(axis_name)
    E = comm.size
    w_gate = params[0]
    if w_gate.shape[0] != E:
        raise ValueError(
            f"num_experts ({w_gate.shape[0]}) must equal mesh axis "
            f"'{axis_name}' size ({E})")
    if x.shape[0] % E:
        raise ValueError(f"token count {x.shape[0]} not divisible by {E}")
    tokens_local = x.shape[0] // E
    if capacity_factor is None:
        # Exact-parity default: capacity E means nothing can drop, at the
        # price of an [E, tokens_local, D] send buffer.
        if E > 2:
            warnings.warn(
                f"expert_parallel_moe: default capacity_factor={E} "
                f"(loss-free parity) allocates {E}x token memory for send "
                "buffers; pass capacity_factor=1.0-2.0 for production",
                stacklevel=2)
        capacity_factor = float(E)
    C = _capacity(tokens_local, E, capacity_factor)
    e = comm.rank
    mine = tuple(p[e] for p in params[1:])
    y = expert_dispatch(w_gate, mine, x[e * tokens_local:(e + 1) * tokens_local], comm, C)
    return all_gather(y, 0, comm, grad="slice")
