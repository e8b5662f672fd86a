"""Checkpoint -> deploy candidate: read trained weights for serving.

Counterpart of ``sparknet_tpu/loop/deploy.py``.  The rollout builds its
candidate from the SAVED artifact, not from the live solver: the
checkpoint is the durable hand-off between the training half and the
serving half of the production loop (a restarted serving host rolls out
from the same file), and reading it back exercises the atomic-write
contract every rollout (``Solver.save``: a temp file, then
``os.replace``).

Only ``param/`` and ``state/`` enter the serving ``NetVars``: optimizer
history (``hist/``) is training state the TEST-phase forward never
touches.  Either package's ``.solverstate.npz`` reads here.

ref: src/main/scala/loaders/CifarLoader.scala:1 (the reference's weight
I/O shape: flat named arrays in, model out).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["variables_from_checkpoint"]


def variables_from_checkpoint(path: str):
    """Parse a ``*.solverstate.npz`` archive into the host ``NetVars`` (CPU
    tensors) a :class:`~sparknet_tpu_torch.serve.engine.ServedModel` copies
    onto its device.

    Keys follow the save layout ``param/<layer>/<i>`` and
    ``state/<layer>/<key>``; layer names may themselves contain ``/``
    (googlenet's ``inception_4a/output``), so the index or key splits off
    the RIGHT.
    """
    from sparknet_tpu_torch.compiler.graph import NetVars

    params: dict[str, dict[int, torch.Tensor]] = {}
    state: dict[str, dict[str, torch.Tensor]] = {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("param/"):
                lname, idx = key[len("param/"):].rsplit("/", 1)
                params.setdefault(lname, {})[int(idx)] = torch.from_numpy(np.array(data[key]))
            elif key.startswith("state/"):
                lname, skey = key[len("state/"):].rsplit("/", 1)
                state.setdefault(lname, {})[skey] = torch.from_numpy(np.array(data[key]))
    if not params:
        raise ValueError(f"no param/ entries in checkpoint {path!r}")
    return NetVars(params={ln: [d[i] for i in sorted(d)] for ln, d in params.items()},
                   state={ln: dict(s) for ln, s in state.items()})
