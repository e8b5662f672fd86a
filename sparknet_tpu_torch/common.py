"""Phase, configuration and device selection.

Counterpart of ``sparknet_tpu/common.py``.  The port keeps only what the
TEST-phase serving path reads: the ``Phase`` enum, the ``Config`` field
``seed``, and two device helpers.  Blobs are NCHW only
(``ops/layout.py``).  There is no PRNG-key threading: fillers draw from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum

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
    """

    seed: int = 1  # ref: common.cpp set_random_seed


_config = Config()


def get_config() -> Config:
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
