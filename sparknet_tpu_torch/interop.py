"""The bridge between the JAX package's weights and training state and the
port's.

Into the port, two inputs, one output (a ``NetVars`` of float tensors on a
given device; ``device=None`` means CUDA and raises without a card, as
every entry point of the port does, so the tests pass ``device="cpu"``):

* ``netvars_from_numpy(params, state)`` takes ``{layer: [w, b, ...]}``
  params and ``{layer: {name: value}}`` state whose leaves convert with
  ``np.asarray`` — a JAX ``NetVars``'s ``.params``/``.state`` as they are;
* ``netvars_from_solverstate(path)`` reads a ``.solverstate.npz`` snapshot
  (the key scheme of ``sparknet_tpu/solvers/solver.py`` ``Solver.save``:
  ``param/<layer>/<i>`` and ``state/<layer>/<k>``; layer names may contain
  ``/``).  Solver history (``hist/...``), ``__iter__`` and ``__meta__``
  are skipped here; the port's ``Solver.restore`` reads all of them.

Out of the port, ``solverstate_from_port(solver, path)`` writes a port
``Solver``'s (or a ``ParallelTrainer``'s, its model-sharded blobs gathered
whole) training state under the same key scheme (``param/…``,
``state/…``, ``hist/<layer>/<i>/<j>``, ``__iter__``, ``__meta__``), so the
JAX ``Solver.restore`` loads it; a snapshot of either package restores into
the other.

Blob order is Caffe's in both packages (conv OIHW, fc (out, in) in NCHW
flatten order), so every blob crosses as it is, a shared param's 0-size
placeholder (``compiler/graph.py``) too: both packages keep it under its
own key, and the owner's key holds the blob.  Blobs keep their dtype:
bfloat16 params (``Config.param_dtype``) cross as bfloat16
(``common.tensor_from_numpy``).
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from sparknet_tpu_torch.common import resolve_device, tensor_from_numpy
from sparknet_tpu_torch.compiler.graph import NetVars


def _tensor(value: Any, device) -> torch.Tensor:
    return tensor_from_numpy(value).to(device)


def netvars_from_numpy(
    params: Mapping[str, Any],
    state: Mapping[str, Mapping[str, Any]] | None = None,
    device: str | torch.device | None = None,
) -> NetVars:
    """``{layer: [blobs]}`` params (+ ``{layer: {k: v}}`` state) -> NetVars
    on ``device`` (``None``: CUDA, or raise)."""
    device = resolve_device(device)
    return NetVars(
        params={name: [_tensor(b, device) for b in blobs]
                for name, blobs in params.items()},
        state={name: {k: _tensor(v, device) for k, v in s.items()}
               for name, s in (state or {}).items()},
    )


def netvars_from_solverstate(
    path_or_arrays: str | os.PathLike | Mapping[str, Any],
    device: str | torch.device | None = None,
) -> NetVars:
    """A ``.solverstate.npz`` path (or its loaded key->array mapping) ->
    NetVars with the snapshot's params and state on ``device`` (``None``:
    CUDA, or raise)."""
    device = resolve_device(device)
    if isinstance(path_or_arrays, (str, os.PathLike)):
        with np.load(path_or_arrays) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        arrays = dict(path_or_arrays)
    indexed: dict[str, dict[int, Any]] = {}
    state: dict[str, dict[str, Any]] = {}
    for key, value in arrays.items():
        kind, _, rest = key.partition("/")
        if kind == "param":
            layer, _, idx = rest.rpartition("/")
            indexed.setdefault(layer, {})[int(idx)] = value
        elif kind == "state":
            layer, _, name = rest.rpartition("/")
            state.setdefault(layer, {})[name] = value
    params = {}
    for layer, blobs in indexed.items():
        if sorted(blobs) != list(range(len(blobs))):
            raise ValueError(f"snapshot has param blobs {sorted(blobs)} for "
                             f"layer {layer!r}; want 0..{len(blobs) - 1}")
        params[layer] = [blobs[i] for i in range(len(blobs))]
    return netvars_from_numpy(params, state, device)


def solverstate_from_port(solver, path: str | os.PathLike) -> str:
    """Write ``solver``'s (a port ``Solver``, or a ``ParallelTrainer``:
    then a collective, every rank calls it) params, state, history and
    iteration to ``path`` as a ``.solverstate.npz`` in the JAX package's
    key scheme, atomically.  Returns the path."""
    from sparknet_tpu_torch.solvers.solver import _write_npz_atomic

    path = os.fspath(path)
    _write_npz_atomic(path, solver.snapshot_arrays())
    return path
