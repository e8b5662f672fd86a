"""Pipeline parallelism: the GPipe microbatch schedule over a group.

Counterpart of ``sparknet_tpu/parallel/pipeline.py``.  One pipeline stage
a rank of a ``stage`` axis: each holds its stage's slice of a stacked
parameter tree, every stage applies the same ``block_fn`` (homogeneous
blocks, e.g. a transformer stack) and activations keep one shape.  ``M``
microbatches fill the pipeline over ``M + S - 1`` ticks: stage 0 feeds
microbatch t, the others the activation stage s - 1 made the tick before,
which hops one rank a tick (``collectives.ring_shift``, JAX's
``ppermute``); the last stage retires microbatch t - (S - 1).  The output
is made replicated as JAX's ``psum`` makes it: every stage but the last
zeroes its buffer and the buffers are all-reduced.  Forward only, as JAX's
test and mode use it (the bubble fraction is (S - 1) / (M + S - 1)).

Trees are dicts, lists and tuples of tensors (``torch.utils._pytree``).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from sparknet_tpu_torch.parallel.collectives import all_reduce_sum_, ring_shift
from sparknet_tpu_torch.parallel.sharding import BlobSharding


def stage_sharding(mesh, stacked_params, axis_name: str = "stage"):
    """Which rank owns which slice: a tree like ``stacked_params`` of
    ``BlobSharding``s over ``axis_name`` (stage s holds leaf[s])."""
    comm = mesh.comm(axis_name)
    return pytree.tree_map(lambda _: BlobSharding(axis_name, comm), stacked_params)


def stack_stage_params(param_trees):
    """Stack S per-stage parameter trees into the leading-axis layout
    ``pipeline_blocks`` takes."""
    leaves = [pytree.tree_flatten(t)[0] for t in param_trees]
    spec = pytree.tree_flatten(param_trees[0])[1]
    return pytree.tree_unflatten([torch.stack(ls) for ls in zip(*leaves)], spec)


def pipeline_blocks(mesh, block_fn, stacked_params, x, *,
                    axis_name: str = "stage") -> torch.Tensor:
    """Apply ``S`` homogeneous blocks as an ``S``-deep pipeline over
    ``mesh``'s ``axis_name`` group (of size S).

    ``block_fn(params_slice, activation) -> activation`` keeps the
    activation's shape; ``stacked_params``: a tree whose leaves have
    leading axis S (every rank may pass the whole stack; stage s uses
    leaf[s]); ``x``: [M, ...] microbatch-major input, the same on every
    rank.  Returns [M, ...] on every rank, equal (up to float
    association) to :func:`sequential_blocks`.  Runs under
    ``torch.no_grad``."""
    comm = mesh.comm(axis_name)
    S, sidx = comm.size, comm.rank
    M = x.shape[0]
    with torch.no_grad():
        mine = pytree.tree_map(lambda a: a[sidx], stacked_params)
        hold = torch.zeros_like(x[0])
        out_buf = torch.zeros_like(x)
        for t in range(M + S - 1):
            out = block_fn(mine, x[min(t, M - 1)] if sidx == 0 else hold)
            m = t - (S - 1)
            if sidx == S - 1 and m >= 0:
                out_buf[m] = out
            (hold,) = ring_shift([out], comm)
        if sidx != S - 1:
            out_buf.zero_()
        return all_reduce_sum_(out_buf, comm)


def sequential_blocks(block_fn, stacked_params, x) -> torch.Tensor:
    """Oracle: the same computation without the pipeline (the S blocks in
    order on every microbatch)."""
    S = pytree.tree_flatten(stacked_params)[0][0].shape[0]
    outs = []
    for xm in x:
        act = xm
        for s in range(S):
            act = block_fn(pytree.tree_map(lambda a, s=s: a[s], stacked_params), act)
        outs.append(act)
    return torch.stack(outs)
