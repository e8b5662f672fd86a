"""Phase, configuration and device selection.

Counterpart of ``sparknet_tpu/common.py``.  The port keeps what the
serving and training paths read: the ``Phase`` enum, the ``Config`` fields
``seed``, ``compute_dtype``, ``param_dtype``, ``layout``, ``fused_update``,
``storage_dtype``, ``remat`` and ``activation_dtype`` with ``set_config``
and its checks, ``act_storage_policy``, and two device helpers.  There is
no PRNG-key threading: fillers and dropout draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os

import numpy as np
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

    ``compute_dtype`` (``torch.float32`` or ``torch.bfloat16``) is the type
    activations and the convolutions and matrix products run in inside
    ``Network.apply``; params and optimizer history stay in ``param_dtype``
    (float32 by default), cast to ``compute_dtype`` in each forward, so the
    gradients land on the ``param_dtype`` masters.  Loss layers and
    BatchNorm statistics compute in float32 whatever the setting.
    ``param_dtype`` is read when a net's params are made, ``compute_dtype``
    and ``activation_dtype`` as each forward runs, ``remat`` when a
    ``Solver`` builds its step: set them before building one and keep them
    while it steps (the JAX package reads them once, when it traces).

    ``remat``: ``""`` (off), ``"full"`` (the forward saves nothing and is
    recomputed in the backward), ``"dots"`` (matrix-product outputs saved,
    convolutions recomputed) or ``"blocks"`` (only Pooling outputs saved):
    ``solvers/solver.py`` ``apply_remat``.  ``SPARKNET_REMAT`` seeds it.

    ``activation_dtype``: ``""`` (off), ``"io"`` (feeds stored bf16),
    ``"blocks"`` (Pooling outputs stored bf16) or ``"full"`` (every non-loss
    layer's outputs stored bf16); every layer upcasts its inputs to
    ``compute_dtype`` first, so storage is the only thing that narrows.
    ``SPARKNET_ACT_DTYPE`` seeds it (``"bf16"`` means ``"blocks"``).

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

    ``layout``: the internal orientation of rank-4 image blobs, ``"nchw"``
    (default, Caffe's blob order) or ``"nhwc"`` (channels-last).  Under
    nhwc activations run (N, H, W, C); params do not move (convolution
    weights stay OIHW, InnerProduct weights in Caffe's wire order) and
    prototxt axes stay canonical (``ops/layout.py``).  Read as each
    forward runs, like ``compute_dtype``; ``SPARKNET_LAYOUT`` seeds it,
    ``tpunet --layout`` sets it for one command.

    ``data_axis``, ``model_axis``, ``seq_axis``: the names of the rank
    grid's axes (``parallel/mesh.py``), the JAX package's mesh axis names.
    """

    seed: int = 1  # ref: common.cpp set_random_seed
    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    layout: str = os.environ.get("SPARKNET_LAYOUT", "nchw").lower()
    fused_update: bool = os.environ.get("SPARKNET_FUSED_UPDATE", "0") == "1"
    storage_dtype: str = os.environ.get("SPARKNET_STORAGE_DTYPE", "f32").lower()
    remat: str = os.environ.get("SPARKNET_REMAT", "").lower()
    activation_dtype: str = os.environ.get("SPARKNET_ACT_DTYPE", "").lower()
    data_axis: str = "data"
    model_axis: str = "model"
    seq_axis: str = "seq"


# Canonical Config.activation_dtype policies and the spellings that
# normalize into them (the JAX package's; "bf16" means "blocks")
ACT_POLICIES = ("", "io", "blocks", "full")
ACT_POLICY_ALIASES = {"none": "", "off": "", "f32": "", "float32": "",
                      "bf16": "blocks", "bfloat16": "blocks"}

_FLOAT_DTYPES = {"float32": torch.float32, "f32": torch.float32,
                 "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def act_storage_policy(value: str | None = None) -> str:
    """Normalize an ``activation_dtype`` spelling to its canonical policy
    (default: the current config's), raising on unknowns, so an unchecked
    ``SPARKNET_ACT_DTYPE`` seed never half-applies."""
    raw = get_config().activation_dtype if value is None else value
    ap = ACT_POLICY_ALIASES.get(str(raw).lower(), str(raw).lower())
    if ap not in ACT_POLICIES:
        raise ValueError(f"unknown activation_dtype policy {raw!r} "
                         f"(want one of {ACT_POLICIES} or an alias "
                         f"{tuple(ACT_POLICY_ALIASES)})")
    return ap


def _float_dtype(name: str, value) -> torch.dtype:
    """``torch.float32``/``torch.bfloat16``, or a spelling of one."""
    dt = _FLOAT_DTYPES.get(value.lower()) if isinstance(value, str) else value
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be torch.float32 or torch.bfloat16, "
                         f"got {value!r}")
    return dt


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**overrides) -> Config:
    """Replace fields of the global config; returns the new config.  A
    ``Solver`` reads the config when it is built, so set it before.
    Spellings are checked and normalized with the JAX package's messages."""
    global _config
    if "layout" in overrides:
        lay = str(overrides["layout"]).lower()
        if lay not in ("nchw", "nhwc"):
            raise ValueError(f"layout must be 'nchw' or 'nhwc', got "
                             f"{overrides['layout']!r}")
        overrides = {**overrides, "layout": lay}
    for name in ("compute_dtype", "param_dtype"):
        if name in overrides:
            overrides = {**overrides, name: _float_dtype(name, overrides[name])}
    if "storage_dtype" in overrides:
        sd = str(overrides["storage_dtype"]).lower()
        sd = {"bfloat16": "bf16", "float32": "f32"}.get(sd, sd)
        if sd not in ("f32", "bf16"):
            raise ValueError(f"storage_dtype must be 'f32' or 'bf16', got "
                             f"{overrides['storage_dtype']!r}")
        overrides = {**overrides, "storage_dtype": sd}
    if "remat" in overrides:
        rp = str(overrides["remat"]).lower()
        rp = {"none": "", "off": ""}.get(rp, rp)
        if rp not in ("", "full", "dots", "blocks"):
            raise ValueError(
                f"remat must be one of '', 'full', 'dots', 'blocks', got "
                f"{overrides['remat']!r}")
        overrides = {**overrides, "remat": rp}
    if "activation_dtype" in overrides:
        try:
            ap = act_storage_policy(overrides["activation_dtype"])
        except ValueError:  # the JAX set_config's own text
            raise ValueError(
                f"activation_dtype must be one of '', 'io', 'blocks', "
                f"'full' (or an alias: none/off/f32/float32 -> '', "
                f"bf16/bfloat16 -> 'blocks'), got "
                f"{overrides['activation_dtype']!r}") from None
        overrides = {**overrides, "activation_dtype": ap}
    _config = dataclasses.replace(_config, **overrides)
    return _config


def tensor_from_numpy(a) -> torch.Tensor:
    """A host array as a CPU tensor (a copy), bfloat16 arrays included:
    ``np.asarray`` of a JAX bfloat16 array has ``ml_dtypes``' bfloat16,
    which ``torch.from_numpy`` refuses, so such an array crosses as its
    ``uint16`` bits, read back as bfloat16 (no ``ml_dtypes`` import)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def host_array(t) -> np.ndarray:
    """A tensor (any device) as a host numpy array; bfloat16 is widened to
    float32, which is exact (numpy has no bfloat16 of its own).  Other
    values pass through ``np.asarray``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
    """Full float32 convolutions and matrix products inside the block, and
    float32 sums in bfloat16 matrix products.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the JAX reference is float32.  cuBLAS may reduce
    bfloat16 products in bfloat16; the JAX contract for bf16 compute is
    float32 accumulation.  The three switches are turned off for the
    duration and restored after.
    """
    mm = torch.backends.cuda.matmul
    prev = (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = prev
