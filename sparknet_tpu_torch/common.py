"""Phase, configuration and device selection.

Counterpart of ``sparknet_tpu/common.py``.  The port keeps what the
serving and training paths read: the ``Phase`` enum, the ``Config`` fields
``seed``, ``fused_update`` and ``storage_dtype`` with ``set_config``, and
two device helpers.  Blobs are NCHW only (``ops/layout.py``).  There is no
PRNG-key threading: fillers and dropout draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os

import torch


class Phase(enum.Enum):
    """Network phase (ref: caffe.proto ``enum Phase { TRAIN = 0; TEST = 1; }``)."""

    TRAIN = 0
    TEST = 1


@dataclasses.dataclass(frozen=True)
class Config:
    """Framework-wide configuration.

    ``seed`` seeds the filler generator when ``Network.init`` is given
    none.

    ``fused_update``: ``True`` routes the ``Solver``'s optimizer update
    through the fused flat-arena kernel (``solvers/arena.py`` +
    ``ops/kernels.fused_update``): params, grads and history viewed as
    one flat arena per role and the whole Caffe update applied in one
    read-modify-write sweep.  ``False`` (default) keeps the per-blob
    ``solvers/updates.py`` chain.  Read when a ``Solver`` is built;
    ``SPARKNET_FUSED_UPDATE=1`` seeds it.

    ``storage_dtype``: ``"f32"`` (default) or ``"bf16"``, the storage type
    of the fused arenas (the kernel computes in float32 either way).  Only
    read with ``fused_update`` on; snapshots stay blob-wise in the net's
    param dtype.  ``SPARKNET_STORAGE_DTYPE`` seeds it.
    """

    seed: int = 1  # ref: common.cpp set_random_seed
    fused_update: bool = os.environ.get("SPARKNET_FUSED_UPDATE", "0") == "1"
    storage_dtype: str = os.environ.get("SPARKNET_STORAGE_DTYPE", "f32").lower()


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**overrides) -> Config:
    """Replace fields of the global config; returns the new config.  A
    ``Solver`` reads the config when it is built, so set it before."""
    global _config
    if "storage_dtype" in overrides:
        sd = str(overrides["storage_dtype"]).lower()
        sd = {"bfloat16": "bf16", "float32": "f32"}.get(sd, sd)
        if sd not in ("f32", "bf16"):
            raise ValueError(f"storage_dtype must be 'f32' or 'bf16', got "
                             f"{overrides['storage_dtype']!r}")
        overrides = {**overrides, "storage_dtype": sd}
    _config = dataclasses.replace(_config, **overrides)
    return _config


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA.  Without a CUDA device that raises: an entry point
    never carries on quietly on the CPU.  The CPU is used only when the
    caller names it (``device="cpu"``), as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


@contextlib.contextmanager
def f32_precision():
    """Full float32 convolutions and matrix products inside the block.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the JAX reference is float32.  Both TF32 switches
    are turned off for the duration and restored after.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
