"""Hand-written CUDA kernels for Hopper, their builds, wrappers and plain twins.

Counterpart of ``sparknet_tpu/ops/pallas_kernels.py``.  Each kernel lives
in ``sparknet_tpu_torch/csrc/<name>.cu`` as a plain C entry point.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use
(into ``sparknet_tpu_torch/_build/``, named by a hash of the source and
the flags, so a fresh checkout builds it itself) and loaded with
``ctypes``.  Nothing is compiled or imported for the card when this module
is imported.

Beside each kernel:

* a plain PyTorch version of the same function (``*_torch``).  The wrapper
  takes it only for a tensor that lies on the CPU; on a CUDA tensor it
  launches the kernel or raises, with no fallback;
* a launch count (``LRN_LAUNCHES``, ``LRN_BACKWARD_LAUNCHES``,
  ``LRN_NHWC_LAUNCHES``, ``LRN_NHWC_BACKWARD_LAUNCHES``,
  ``FUSED_UPDATE_LAUNCHES``, ``FLASH_LAUNCHES``,
  ``FLASH_BACKWARD_LAUNCHES``, ``PAGED_LAUNCHES``),
  raised by one at each launch and nowhere else, so a run can show that
  its path went through the kernel.  A call inside a CUDA graph capture
  launches nothing: it records a node of the graph, which each replay
  launches.  The capturer opens :func:`recording_launches` around the
  capture, which takes those calls off the counts, and adds what it
  recorded at each replay (:func:`add_launches`).

Kernels ported so far, all from ``sparknet_tpu/ops/pallas_kernels.py``:

* cross-channel LRN forward (``csrc/lrn.cu``, replaces ``_lrn_kernel``) and
  its backward (same source, replaces ``_lrn_fused_bwd``, which is XLA on
  the TPU), joined by the ``torch.autograd.Function`` ``LRNFunction``,
  each in an NCHW form and a channels-last form (``Config.layout`` nhwc;
  the channel window on the contiguous axis);
* the one-pass fused optimizer update (``csrc/fused_update.cu``, replaces
  ``_fused_kernel``);
* flash attention forward (``csrc/flash_attention.cu``, replaces
  ``_flash_kernel``), the prompt pass of token serving and the attention
  core of ``MultiHeadAttention``, and its backward (same source, replaces
  ``_flash_diff_bwd``, which is XLA on the TPU), joined by
  ``FlashAttentionFunction``;
* paged decode attention (``csrc/paged_attention.cu``, replaces
  ``_paged_kernel``), the cached decode step of token serving.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import threading
from operator import attrgetter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source of the package, one shared library each
KERNEL_SOURCES = ("lrn", "fused_update", "flash_attention", "paged_attention")
# --split-compile=0: nvcc optimizes a source's kernels on every core (the
# four sources built together took 35 s without it on the H100's host, 22 s
# with it; the kernels' gates and times did not move, PERF.md)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

_LIBS: dict[str, ctypes.CDLL] = {}

LRN_LAUNCHES = 0
LRN_BACKWARD_LAUNCHES = 0
LRN_NHWC_LAUNCHES = 0
LRN_NHWC_BACKWARD_LAUNCHES = 0
FUSED_UPDATE_LAUNCHES = 0
# gradients the fused update's wrapper copied before a launch (a
# non-contiguous or misaligned segment, or one of another float type): 0
# on the main paths
FUSED_GRAD_COPIES = 0
FLASH_LAUNCHES = 0
FLASH_BACKWARD_LAUNCHES = 0
PAGED_LAUNCHES = 0
# the int8 product of ``quant.int_matmul`` on the card: ``torch._int_mm``, a
# library call (no TPU kernel), counted the same way
INT_MM_LAUNCHES = 0


def reset_launch_counts() -> None:
    """Set every launch count to 0 (``FUSED_GRAD_COPIES`` runs on)."""
    global LRN_LAUNCHES, LRN_BACKWARD_LAUNCHES, FUSED_UPDATE_LAUNCHES
    global LRN_NHWC_LAUNCHES, LRN_NHWC_BACKWARD_LAUNCHES
    global FLASH_LAUNCHES, FLASH_BACKWARD_LAUNCHES, PAGED_LAUNCHES, INT_MM_LAUNCHES
    LRN_LAUNCHES = LRN_BACKWARD_LAUNCHES = FUSED_UPDATE_LAUNCHES = 0
    LRN_NHWC_LAUNCHES = LRN_NHWC_BACKWARD_LAUNCHES = 0
    FLASH_LAUNCHES = FLASH_BACKWARD_LAUNCHES = PAGED_LAUNCHES = INT_MM_LAUNCHES = 0


# the launches a CUDA graph capture open on this thread has recorded
_RECORDING = threading.local()


def _count(name: str) -> None:
    """One launch of the kernel whose count is ``name``, or, while
    :func:`recording_launches` is open on this thread, one node of the
    graph being captured."""
    recorded = getattr(_RECORDING, "counts", None)
    if recorded is None:
        globals()[name] += 1
    else:
        recorded[name] = recorded.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Open around a CUDA graph capture on this thread: the wrappers' calls
    on this thread record into the yielded dict (count name -> calls), the
    launches each replay of the graph makes, and not into the counts.
    Other threads count as before."""
    recorded: dict[str, int] = {}
    _RECORDING.counts = recorded
    try:
        yield recorded
    finally:
        _RECORDING.counts = None


def add_launches(recorded: dict[str, int]) -> None:
    """Count the launches one replay of a graph makes (what
    :func:`recording_launches` gave for its capture)."""
    for name, n in recorded.items():
        globals()[name] += n


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of sparknet_tpu_torch are built at first use and need the CUDA "
            "toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_libraries(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler log}`` for
    the ones built now (ptxas's register and spill report).  Raises if a
    build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"csrc/{n}.cu:\n{logs[n]}" for n in failed))
    return logs


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_libraries([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.sparknet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sparknet_cuda_error_string.restype = ctypes.c_char_p
        if name == "lrn":
            lib.sparknet_lrn_max_size.argtypes = []
            lib.sparknet_lrn_max_size.restype = ctypes.c_int
            lib.max_size = lib.sparknet_lrn_max_size()
            lib.sparknet_lrn_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.sparknet_lrn_forward.restype = ctypes.c_int
            lib.sparknet_lrn_backward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.sparknet_lrn_backward.restype = ctypes.c_int
            lib.sparknet_lrn_nhwc_max_channels.argtypes = []
            lib.sparknet_lrn_nhwc_max_channels.restype = ctypes.c_int
            lib.max_nhwc_channels = lib.sparknet_lrn_nhwc_max_channels()
            lib.sparknet_lrn_nhwc_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.sparknet_lrn_nhwc_forward.restype = ctypes.c_int
            lib.sparknet_lrn_nhwc_backward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.sparknet_lrn_nhwc_backward.restype = ctypes.c_int
        elif name == "fused_update":
            lib.sparknet_fused_update_tile.argtypes = []
            lib.sparknet_fused_update_tile.restype = ctypes.c_int
            if lib.sparknet_fused_update_tile() != ARENA_TILE:
                raise RuntimeError("csrc/fused_update.cu was built for another tile")
            lib.sparknet_fused_update_max_segments.argtypes = []
            lib.sparknet_fused_update_max_segments.restype = ctypes.c_int
            lib.max_segments = lib.sparknet_fused_update_max_segments()
            lib.sparknet_fused_update.argtypes = [
                *[ctypes.c_void_p] * 7, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, *[ctypes.c_float] * 8, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.sparknet_fused_update.restype = ctypes.c_int
        elif name == "flash_attention":
            lib.sparknet_flash_attention_forward.argtypes = [
                *[ctypes.c_void_p] * 5, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.sparknet_flash_attention_forward.restype = ctypes.c_int
            lib.sparknet_flash_attention_backward.argtypes = [
                *[ctypes.c_void_p] * 10, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.sparknet_flash_attention_backward.restype = ctypes.c_int
        elif name == "paged_attention":
            lib.sparknet_paged_attention.argtypes = [
                *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 6, ctypes.c_float,
                ctypes.c_void_p,
            ]
            lib.sparknet_paged_attention.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# Cross-channel LRN, forward and backward
# ---------------------------------------------------------------------------


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sparknet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch: CUDA error {err} ({msg})")


def _pow_neg(u: torch.Tensor, beta: float) -> torch.Tensor:
    """u ** -beta; beta = 0.75 (every zoo LRN) as rsqrt(u) * rsqrt(sqrt(u)),
    the form the kernel and the JAX package's ``_pow_neg`` use."""
    if beta == 0.75:
        return torch.rsqrt(u) * torch.rsqrt(torch.sqrt(u))
    return torch.pow(u, -beta)


def _check_channel_axis(x: torch.Tensor, channel_axis: int, what: str) -> None:
    if x.dim() != 4 or channel_axis not in (1, 3):
        raise ValueError(f"{what}: want a 4-D tensor with channels on axis 1 "
                         f"(NCHW) or 3 (NHWC), got shape {tuple(x.shape)} and "
                         f"channel_axis {channel_axis}")


def _channel_window_sum(t: torch.Tensor, size: int, dim: int = 1) -> torch.Tensor:
    """Sum of ``t`` over the channels (axis ``dim``) within (size-1)/2 of
    each channel, as the JAX package's ``_windowed_channel_sum`` adds them:
    the centre, then +1 and -1, +2 and -2, with zeros past the channel
    edges (shifts past C - 1 are skipped, the clamp for C < size)."""
    c = t.shape[dim]
    acc = t
    for off in range(1, min((size - 1) // 2, c - 1) + 1):
        zeros = torch.zeros_like(t.narrow(dim, 0, off))
        acc = acc + torch.cat([t.narrow(dim, off, c - off), zeros], dim=dim)  # c + off
        acc = acc + torch.cat([zeros, t.narrow(dim, 0, c - off)], dim=dim)  # c - off
    return acc


def lrn_across_channels_torch(x: torch.Tensor, size: int, alpha: float,
                              beta: float, k: float,
                              channel_axis: int = 1) -> torch.Tensor:
    """Plain PyTorch cross-channel LRN on an NCHW tensor (``channel_axis``
    1) or an NHWC one (3):
    ``y = x * (k + alpha/size * sum_{|c'-c| <= (size-1)/2} x[c']^2)^-beta``.

    The window sum is ``_channel_window_sum``.  Math is float32 whatever the
    storage type, as in the kernel; the result is cast back to
    ``x.dtype``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    _check_channel_axis(x, channel_axis, "lrn_across_channels")
    xf = x.float()
    scale = k + (alpha / size) * _channel_window_sum(xf * xf, size, channel_axis)
    return (xf * _pow_neg(scale, beta)).to(x.dtype)


def lrn_backward_torch(x: torch.Tensor, g: torch.Tensor, size: int,
                       alpha: float, beta: float, k: float,
                       channel_axis: int = 1) -> torch.Tensor:
    """Plain PyTorch gradient of ``lrn_across_channels_torch`` w.r.t. ``x``
    for the incoming gradient ``g``, op for op the JAX package's
    ``_lrn_fused_bwd``:

        scale = k + alpha/size * wsum(x^2);  p = scale^-beta
        dx = g * p - (2 alpha beta / size) * x * wsum(g * x * p / scale)

    (the window is symmetric, so the adjoint of wsum is wsum).  scale is
    recomputed from ``x``.  Channels on axis ``channel_axis`` (1: NCHW,
    3: NHWC).  Math is float32; the result has ``x.dtype``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    _check_channel_axis(x, channel_axis, "lrn_backward")
    xf, gf = x.float(), g.float()
    scale = k + (alpha / size) * _channel_window_sum(xf * xf, size, channel_axis)
    p = _pow_neg(scale, beta)
    w = _channel_window_sum(gf * xf * p / scale, size, channel_axis)
    return (gf * p - (2.0 * alpha * beta / size) * xf * w).to(x.dtype)


def _lrn_cuda_checks(x: torch.Tensor, size: int, what: str,
                     channel_axis: int) -> ctypes.CDLL:
    """The library, after the checks every LRN launch needs: a dense
    4-D float32 or bfloat16 tensor in the layout ``channel_axis`` names
    (1: contiguous NCHW; 3: contiguous NHWC, whose channels the kernel
    reads as the rows of a [pixels, C] matrix).  Anything else raises: an
    NHWC tensor is never made NCHW-contiguous for the NCHW kernel."""
    _check_channel_axis(x, channel_axis, what)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: want float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        form = "NCHW" if channel_axis == 1 else "NHWC"
        raise ValueError(f"{what}: input must be contiguous {form}")
    lib = _load("lrn")
    if size > lib.max_size:
        raise ValueError(f"{what}: local_size {size} > "
                         f"{lib.max_size}, the largest the kernel takes")
    if channel_axis == 3 and x.shape[3] > lib.max_nhwc_channels:
        raise ValueError(f"{what}: {x.shape[3]} channels > "
                         f"{lib.max_nhwc_channels}, the most the NHWC kernel takes")
    return lib


def _lrn_forward_cuda(x: torch.Tensor, size: int, alpha: float, beta: float,
                      k: float, channel_axis: int = 1) -> torch.Tensor:
    lib = _lrn_cuda_checks(x, size, "lrn_across_channels", channel_axis)
    y = torch.empty_like(x)
    if channel_axis == 3:
        b, h, w, c = x.shape
        fn, count = lib.sparknet_lrn_nhwc_forward, "LRN_NHWC_LAUNCHES"
        args = (x.data_ptr(), y.data_ptr(), b * h * w, c, size, alpha / size,
                beta, k, int(x.dtype == torch.bfloat16))
    else:
        b, c, h, w = x.shape
        fn, count = lib.sparknet_lrn_forward, "LRN_LAUNCHES"
        args = (x.data_ptr(), y.data_ptr(), b, c, h * w, size, alpha / size,
                beta, k, int(x.dtype == torch.bfloat16))
    index = x.device.index
    if index == torch.cuda.current_device():  # the common case, without a switch
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "lrn_across_channels")
    _count(count)
    return y


def _lrn_backward_cuda(x: torch.Tensor, g: torch.Tensor, size: int,
                       alpha: float, beta: float, k: float,
                       channel_axis: int = 1) -> torch.Tensor:
    lib = _lrn_cuda_checks(x, size, "lrn_backward", channel_axis)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"lrn_backward: gradient {tuple(g.shape)} {g.dtype} "
                         f"{g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} {x.device}")
    g = g.contiguous()
    dx = torch.empty_like(x)
    coef = 2.0 * alpha * beta / size
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if channel_axis == 3:
            b, h, w, c = x.shape
            err = lib.sparknet_lrn_nhwc_backward(
                x.data_ptr(), g.data_ptr(), dx.data_ptr(), b * h * w, c, size,
                alpha / size, beta, k, coef, bf16, stream)
            count = "LRN_NHWC_BACKWARD_LAUNCHES"
        else:
            b, c, h, w = x.shape
            err = lib.sparknet_lrn_backward(
                x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, c, h * w, size,
                alpha / size, beta, k, coef, bf16, stream)
            count = "LRN_BACKWARD_LAUNCHES"
    _check_launch(lib, err, "lrn_backward")
    _count(count)
    return dx


def lrn_backward(x: torch.Tensor, g: torch.Tensor, size: int, alpha: float,
                 beta: float, k: float, channel_axis: int = 1) -> torch.Tensor:
    """Gradient of the cross-channel LRN w.r.t. its input ``x``, channels
    on axis ``channel_axis`` (1: NCHW, 3: NHWC).

    CUDA tensor: launches the backward kernel of ``csrc/lrn.cu`` for that
    layout (x and g f32 or bf16 of one type, 4-D; x contiguous).  CPU
    tensor: ``lrn_backward_torch``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    if x.device.type == "cpu":
        return lrn_backward_torch(x, g, size, alpha, beta, k, channel_axis)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_backward: unsupported device {x.device}")
    return _lrn_backward_cuda(x, g, size, alpha, beta, k, channel_axis)


class LRNFunction(torch.autograd.Function):
    """Cross-channel LRN with its backward: the ``jax.custom_vjp`` of
    ``lrn_across_channels_fused`` in the JAX package.

    Forward launches the forward kernel on a CUDA tensor (the plain version
    on a CPU tensor) and saves ``x`` only; the backward recomputes scale
    from it (``_lrn_fused_bwd``'s choice, which keeps a tensor the size of
    ``x`` out of memory) and launches the backward kernel (the plain
    version on the CPU).  Under ``torch.inference_mode`` nothing is saved
    and the forward is the same one launch."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k, channel_axis=1):
        if x.device.type == "cpu":
            y = lrn_across_channels_torch(x, size, alpha, beta, k, channel_axis)
        else:
            y = _lrn_forward_cuda(x, size, alpha, beta, k, channel_axis)
        ctx.save_for_backward(x)
        ctx.lrn = (size, alpha, beta, k, channel_axis)
        return y

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return lrn_backward(x, g, *ctx.lrn), None, None, None, None, None


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float, beta: float,
                        k: float, channel_axis: int = 1) -> torch.Tensor:
    """Cross-channel LRN forward of an NCHW tensor (``channel_axis`` 1) or
    an NHWC one (3), differentiable.

    CUDA tensor: launches the kernel of ``csrc/lrn.cu`` for that layout on
    the current stream (f32 or bf16, 4-D, contiguous; anything else
    raises), through
    ``LRNFunction``, whose backward is the backward kernel, where a
    gradient is to be taken, else directly.  CPU tensor:
    the same Function over ``lrn_across_channels_torch`` and
    ``lrn_backward_torch``.  Meta tensor (shape inference in
    ``Network.init``): an empty tensor of the same shape."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lrn_across_channels: unsupported device {x.device}")
    if x.device.type == "cuda" and not (x.requires_grad and torch.is_grad_enabled()):
        # no gradient to take: the launch alone, without autograd's host work
        return _lrn_forward_cuda(x, size, alpha, beta, k, channel_axis)
    return LRNFunction.apply(x, size, alpha, beta, k, channel_axis)


# ---------------------------------------------------------------------------
# One-pass fused optimizer update
# ---------------------------------------------------------------------------

# arena tile: elements per lr_mult/decay table entry (the TPU kernel's 16 x
# 128 tile, ``pallas_kernels.ARENA_TILE``); every blob is padded to whole
# tiles, so a tile never spans two blobs
ARENA_TILE = 2048

# rule name -> number of history slots (``pallas_kernels.FUSED_RULE_SLOTS``)
FUSED_RULE_SLOTS = {
    "SGD": 1, "Nesterov": 1, "AdaGrad": 1, "RMSProp": 1,
    "AdaDelta": 2, "Adam": 2,
}
_RULE_IDS = {"SGD": 0, "Nesterov": 1, "AdaGrad": 2, "RMSProp": 3,
             "AdaDelta": 4, "Adam": 5}
_REG_IDS = {"none": 0, "l1": 1, "l2": 2}


@dataclasses.dataclass(frozen=True)
class UpdateStatics:
    """The solver constants fixed for a run (the rate, clip scale and Adam
    correction ride the ``scalars`` tensor instead).  ``reg``: 'none' |
    'l1' | 'l2' (weight_decay == 0 maps to 'none', as the per-blob chain
    skips it).  ``clip``: whether a clip scale is applied
    (clip_gradients > 0)."""

    momentum: float = 0.0
    momentum2: float = 0.999
    rms_decay: float = 0.99
    delta: float = 1e-8
    iter_size: int = 1
    reg: str = "none"
    clip: bool = False


def _fused_prologue(st: UpdateStatics, w, g, clip_scale, decay):
    """Clip, normalize, regularize, in Caffe's ApplyUpdate order and in the
    op order of ``solvers/updates.py`` (the JAX ``_fused_prologue``)."""
    if st.clip:
        g = g * clip_scale
    if st.iter_size > 1:
        g = g / st.iter_size
    if st.reg == "l1":
        g = g + decay * torch.sign(w)
    elif st.reg == "l2":
        g = g + decay * w
    return g


def _fused_rule_math(st: UpdateStatics, rule: str, g, slots, lr, corr):
    """The six Caffe rules on float32 operands, op for op the JAX
    ``_fused_rule_math``.  Returns (delta_w, new_slots)."""
    if rule == "SGD":
        (h,) = slots
        h = st.momentum * h + lr * g
        return h, [h]
    if rule == "Nesterov":
        (h,) = slots
        h_new = st.momentum * h + lr * g
        return (1.0 + st.momentum) * h_new - st.momentum * h, [h_new]
    if rule == "AdaGrad":
        (h,) = slots
        h = h + g * g
        return lr * g / (torch.sqrt(h) + st.delta), [h]
    if rule == "RMSProp":
        (h,) = slots
        h = st.rms_decay * h + (1.0 - st.rms_decay) * g * g
        return lr * g / (torch.sqrt(h) + st.delta), [h]
    if rule == "AdaDelta":
        h, h2 = slots
        mu = st.momentum
        h = mu * h + (1.0 - mu) * g * g
        val = g * torch.sqrt((h2 + st.delta) / (h + st.delta))
        h2 = mu * h2 + (1.0 - mu) * val * val
        return lr * val, [h, h2]
    if rule == "Adam":
        m, v = slots
        b1, b2 = st.momentum, st.momentum2
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        return (lr * corr) * m / (torch.sqrt(v) + st.delta), [m, v]
    raise ValueError(f"unknown fused update rule {rule!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class GradSegments:
    """Where an arena's gradient lies when it is not packed: one segment a
    blob, in arena order.  Segment ``i`` is a tensor of ``size[i]``
    elements (its blob's gradient, any shape) whose span starts at tile
    ``first_tile[i]`` and runs to the next segment's first tile (the last
    to the arena's end); its elements past ``size[i]`` are the blob's pad
    zone and read as 0.  ``tile_seg``: [n_tiles, 2] int32, (segment, its
    first tile) for every tile, on the arenas' device (the kernel's own
    lookup; the plain version reads ``first_tile``).  ``dtypes``: the type
    each gradient comes in (its blob's), or None when one is neither
    float32 nor bfloat16; ``rows``: the C entry's [n, 4] int64 rows
    (pointer 0, count, 1 if bfloat16, first tile) for those types, so a
    launch fills in only the pointers.  Made once per layout
    (``solvers/arena.ArenaTables``)."""

    first_tile: tuple
    size: tuple
    n_tiles: int
    tile_seg: torch.Tensor
    dtypes: tuple | None
    rows: np.ndarray

    def __len__(self) -> int:
        return len(self.size)

    @classmethod
    def build(cls, first_tile, size, n_tiles: int, device,
              dtypes=None) -> "GradSegments":
        first_tile, size = tuple(int(t) for t in first_tile), tuple(int(n) for n in size)
        dtypes = (torch.float32,) * len(size) if dtypes is None else tuple(dtypes)
        ends = (*first_tile[1:], n_tiles)
        if (first_tile[:1] != ((0,) if n_tiles else ()) or len(dtypes) != len(size)
                or any(e <= t or not 0 <= n <= (e - t) * ARENA_TILE
                       for t, e, n in zip(first_tile, ends, size))):
            raise ValueError("gradient segments must start at tile 0, rise, and "
                             "each fit its tiles")
        table = torch.empty((n_tiles, 2), dtype=torch.int32)
        for k, (t, e) in enumerate(zip(first_tile, ends)):
            table[t:e, 0] = k
            table[t:e, 1] = t
        rows = np.zeros((len(size), 4), np.int64)
        rows[:, 1] = size
        rows[:, 2] = [d is torch.bfloat16 for d in dtypes]
        rows[:, 3] = first_tile
        if not all(d is torch.float32 or d is torch.bfloat16 for d in dtypes):
            dtypes = None
        return cls(first_tile=first_tile, size=size, n_tiles=n_tiles,
                   tile_seg=table.to(device), dtypes=dtypes, rows=rows)


def pack_segments(grads, segments: GradSegments, dtype: torch.dtype) -> torch.Tensor:
    """The segments' gradients packed into one float32 [n_tiles *
    ARENA_TILE] arena: each converted to ``dtype`` (the arena's type) and
    back, as packing it into a grad arena of that type would; 0 in the pad
    zones and in the span of a segment that is None."""
    out = torch.zeros((segments.n_tiles * ARENA_TILE,), dtype=torch.float32,
                      device=segments.tile_seg.device)
    for g, t, n in zip(grads, segments.first_tile, segments.size):
        if g is not None:
            start = t * ARENA_TILE
            out[start:start + n] = g.reshape(-1).to(dtype).float()
    return out


def fused_update_torch(rule: str, st: UpdateStatics, w, g, slots, tile_lr,
                       tile_decay, scalars, segments: GradSegments | None = None):
    """Plain PyTorch fused update, the port of the JAX
    ``_fused_update_xla``: the same single-sweep math over the
    ``(n_tiles, ARENA_TILE)`` view, float32 whatever the storage type.
    ``g`` is the packed grad arena, or with ``segments`` one gradient (or
    None) a segment, packed first (:func:`pack_segments`).  Returns
    (new_w, new_slots) in the input types; nothing is written in place."""
    if segments is not None:
        g = pack_segments(g, segments, w.dtype)
    n = tile_lr.shape[0]
    w32 = w.reshape(n, -1).float()
    g32 = g.reshape(n, -1).float()
    s32 = [s.reshape(n, -1).float() for s in slots]
    lr = (scalars[0] * tile_lr)[:, None]
    decay = tile_decay[:, None]
    g32 = _fused_prologue(st, w32, g32, scalars[1], decay)
    dw, new_slots = _fused_rule_math(st, rule, g32, s32, lr, scalars[2])
    new_w = (w32 - dw).to(w.dtype).reshape(w.shape)
    return new_w, [h.to(s.dtype).reshape(s.shape)
                   for h, s in zip(new_slots, slots)]


_data_ptr, _is_contiguous = torch.Tensor.data_ptr, torch.Tensor.is_contiguous
_numel, _get_device, _dtype = torch.Tensor.numel, torch.Tensor.get_device, attrgetter("dtype")


def _segment_rows(w: torch.Tensor, g, segments: GradSegments | None):
    """The C entry's [n, 4] int64 segment rows (pointer, count, is_bf16,
    first tile) and the tensors they point into (kept alive until the
    launch is queued).  When every gradient given is contiguous, 16-byte
    aligned, of its segment's count and type and on ``w``'s device (the
    steps' case), only the pointers are filled into ``segments.rows`` (a
    segment without a gradient keeps its null pointer).  Otherwise each
    row is checked: a gradient that is not contiguous and 16-byte aligned
    in float32 or bfloat16 is copied first (``.to(w.dtype)`` for another
    type, as packing it would), and the copy counted on
    ``FUSED_GRAD_COPIES``."""
    global FUSED_GRAD_COPIES
    if segments is None:
        return np.array([[g.data_ptr(), g.shape[0], int(g.dtype == torch.bfloat16), 0]],
                        np.int64), [g]
    rows = segments.rows.copy()
    dev = w.get_device()
    if segments.dtypes is not None:
        have, dtypes, sizes = g, segments.dtypes, segments.size
        try:
            rows[:, 0] = np.fromiter(map(_data_ptr, g), np.int64, len(rows))
        except TypeError:  # a blob without a gradient: its pointer stays null
            at = [i for i, t in enumerate(g) if t is not None]
            have = [g[i] for i in at]
            dtypes = tuple(dtypes[i] for i in at)
            sizes = tuple(sizes[i] for i in at)
            rows[at, 0] = np.fromiter(map(_data_ptr, have), np.int64, len(at))
        if (not (rows[:, 0] & 15).any() and all(map(_is_contiguous, have))
                and tuple(map(_dtype, have)) == dtypes
                and tuple(map(_numel, have)) == sizes
                and tuple(map(_get_device, have)) == (dev,) * len(have)):
            return rows, ()
    keep = []
    for i, (t, n) in enumerate(zip(g, segments.size)):
        if t is None:
            rows[i, :3] = (0, n, 0)
            continue
        if t.get_device() != dev or t.numel() != n:
            raise ValueError(f"fused_update: a gradient segment of {n} elements on "
                             f"{w.device} got {t.numel()} on {t.device}")
        if t.dtype is not torch.float32 and t.dtype is not torch.bfloat16:
            t = t.to(w.dtype)
            FUSED_GRAD_COPIES += 1
            keep.append(t)
        elif t.data_ptr() % 16 or not t.is_contiguous():
            t = t.clone(memory_format=torch.contiguous_format)
            FUSED_GRAD_COPIES += 1
            keep.append(t)
        rows[i, :3] = (t.data_ptr(), n, int(t.dtype is torch.bfloat16))
    return rows, keep


def _fused_update_cuda(rule, st, w, g, slots, tile_lr, tile_decay, scalars,
                       segments=None):
    lib = _load("fused_update")
    arenas = [w, *slots] if segments is not None else [w, g, *slots]
    for t in arenas:
        if t.device != w.device or t.dtype != w.dtype or t.dim() != 1:
            raise ValueError("fused_update: w, g and the slots must be 1-D "
                             "arenas of one type on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_update: arenas must be contiguous and "
                             "16-byte aligned")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_update: want float32 or bfloat16, got {w.dtype}")
    for t, want in ((tile_lr, tile_lr.shape[0]), (tile_decay, tile_lr.shape[0]),
                    (scalars, 3)):
        if (t.device != w.device or t.dtype != torch.float32 or t.dim() != 1
                or t.shape[0] != want or not t.is_contiguous()):
            raise ValueError("fused_update: tile tables and scalars must be "
                             "contiguous float32 on the arenas' device")
    tile_seg = 0
    if segments is not None:
        ts = segments.tile_seg
        if (ts.device != w.device or ts.dtype != torch.int32 or not ts.is_contiguous()
                or tuple(ts.shape) != (tile_lr.shape[0], 2) or ts.data_ptr() % 8):
            raise ValueError("fused_update: the segments' tile table must be a "
                             "contiguous [n_tiles, 2] int32 on the arenas' device")
        tile_seg = ts.data_ptr()
    rows, keep = _segment_rows(w, g, segments)
    n_segs = len(rows)
    s0 = slots[0]
    s1 = slots[1] if len(slots) > 1 else slots[0]
    m, m2, rms = float(st.momentum), float(st.momentum2), float(st.rms_decay)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.sparknet_fused_update(
            w.data_ptr(), s0.data_ptr(), s1.data_ptr(), tile_lr.data_ptr(),
            tile_decay.data_ptr(), tile_seg, scalars.data_ptr(), w.shape[0],
            rows.ctypes.data, n_segs, _RULE_IDS[rule], _REG_IDS[st.reg], int(st.clip),
            int(st.iter_size), m, 1.0 + m, 1.0 - m, m2, 1.0 - m2, rms,
            1.0 - rms, float(st.delta), int(w.dtype == torch.bfloat16), stream)
    del rows, keep
    _check_launch(lib, err, "fused_update")
    for _ in range(-(-n_segs // lib.max_segments)):
        _count("FUSED_UPDATE_LAUNCHES")


def fused_update(rule: str, st: UpdateStatics, w: torch.Tensor, g,
                 slots: list, tile_lr: torch.Tensor, tile_decay: torch.Tensor,
                 scalars: torch.Tensor, segments: GradSegments | None = None) -> None:
    """One-pass optimizer update over flat arenas, IN PLACE: ``w`` and each
    of ``slots`` are overwritten with their updated values (the TPU
    kernel's ``input_output_aliases``); the gradient is only read.

    ``w``: [T] param arena (T a multiple of ``ARENA_TILE``); ``slots``:
    ``FUSED_RULE_SLOTS[rule]`` [T] history arenas of the same type;
    ``tile_lr``/``tile_decay``: [T / ARENA_TILE] float32 tables (lr_mult
    and folded weight_decay * decay_mult per tile); ``scalars``: [3]
    float32 = (rate, clip_scale, adam_correction), on the arenas' device.
    The gradient ``g`` is the packed [T] grad arena of the same type (the
    one-segment table), or, with ``segments``, one gradient a segment
    where autograd left it (float32 or bfloat16, or None for a blob
    without one), read as the packed arena would hold it.

    CUDA tensors: launches the kernel of ``csrc/fused_update.cu`` (one
    launch for up to ``sparknet_fused_update_max_segments()``, 240,
    segments).
    CPU tensors: ``fused_update_torch``, copied into ``w`` and ``slots``."""
    if rule not in FUSED_RULE_SLOTS:
        raise ValueError(f"unknown fused update rule {rule!r}")
    if st.reg not in _REG_IDS:
        raise ValueError(f"unknown regularization {st.reg!r} (none|l1|l2)")
    if w.shape[0] % ARENA_TILE or w.shape[0] != tile_lr.shape[0] * ARENA_TILE:
        raise ValueError(
            f"arena length {w.shape[0]} is not {tile_lr.shape[0]} tiles of "
            f"ARENA_TILE ({ARENA_TILE}); build it with solvers/arena.build_layout")
    if len(slots) != FUSED_RULE_SLOTS[rule]:
        raise ValueError(
            f"rule {rule!r} takes {FUSED_RULE_SLOTS[rule]} slot arena(s), "
            f"got {len(slots)}")
    if any(t.shape != w.shape for t in slots):
        raise ValueError("fused_update: w and the slots differ in length")
    if segments is None:
        if g.shape != w.shape:
            raise ValueError("fused_update: w and the grad arena differ in length")
    elif len(g) != len(segments) or segments.n_tiles != tile_lr.shape[0]:
        raise ValueError(f"fused_update: {len(g)} gradients for {len(segments)} "
                         f"segments over {segments.n_tiles} tiles")
    if w.device.type == "cpu":
        with torch.no_grad():
            new_w, new_slots = fused_update_torch(rule, st, w, g, slots, tile_lr,
                                                  tile_decay, scalars, segments)
            w.copy_(new_w)
            for s, h in zip(slots, new_slots):
                s.copy_(h)
        return
    if w.device.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {w.device}")
    _fused_update_cuda(rule, st, w, g, slots, tile_lr, tile_decay, scalars, segments)


# ---------------------------------------------------------------------------
# Flash attention, forward and backward
# ---------------------------------------------------------------------------

# head dims the two attention kernels are instantiated for up to 256 lanes
# (the launchers of csrc/flash_attention.cu and csrc/paged_attention.cu
# switch on these); a wider head runs on their chunked kernels, at a
# multiple of ATTENTION_CHUNK lanes
ATTENTION_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
ATTENTION_CHUNK = 128
# the widest head the paged kernel takes: its two-stage chunk ring, q and
# the four warps' O (20 bytes a lane) fill a block's 227 KB of shared memory
PAGED_MAX_HEAD_DIM = 9728
# input types the attention wrappers take: the kernels compute in float32,
# and bfloat16 or float16 operands are cast (flash: in the wrapper; paged:
# q in the wrapper, the pools as the kernel reads them)
ATTENTION_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_KV_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_head_dim(d: int) -> int:
    """The head dim an attention kernel runs a head of ``d`` lanes at: the
    smallest of ``ATTENTION_HEAD_DIMS`` that is >= d for 1 <= d <= 256,
    and above 256 the next multiple of ``ATTENTION_CHUNK`` (the chunked
    kernels read a head in chunks of that many lanes).  A head is
    zero-padded to it: a zero lane adds an exact 0 to every q.k sum, and
    the padded lanes of the output are dropped."""
    if d < 1:
        raise ValueError(f"head dim must be >= 1, got {d}")
    if d > ATTENTION_HEAD_DIMS[-1]:
        return -(-d // ATTENTION_CHUNK) * ATTENTION_CHUNK
    return next(w for w in ATTENTION_HEAD_DIMS if w >= d)


def _scale(scale: float | None, d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """scale * q k^T in float32, the causal upper triangle at -1e30."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[2]
        idx = torch.arange(n, device=q.device)
        s = torch.where(idx[:, None] >= idx[None, :], s, -1e30)
    return s


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch attention on [B, H, S, D]: the unblocked stable
    softmax of the JAX package's ``attention_xla``, float32 math, the
    causal upper triangle at -1e30; the result has ``q.dtype``.  ``scale``
    multiplies q.k (default 1/sqrt(D); a head zero-padded from d lanes
    passes 1/sqrt(d))."""
    s = _scores(q, k, causal, _scale(scale, q.shape[-1]))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def flash_attention_forward_lse_torch(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, causal: bool = False,
                                      scale: float | None = None):
    """``flash_attention_torch`` and each row's log-sum-exp of the scaled
    scores, float32 [B, H, S]: the forward kernel's ``lse`` output, the
    backward's input."""
    s = _scores(q, k, causal, _scale(scale, q.shape[-1]))
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_backward_torch(q, k, v, o, lse, g, causal: bool = False,
                                   scale: float | None = None):
    """Plain PyTorch gradient of ``flash_attention_torch`` for the upstream
    gradient ``g``, the formula the backward kernel computes, written out
    (no autograd):

        P = exp(scale q k^T - lse)  (the causal upper triangle at -1e30)
        dV = P^T g;  dS = P * (g v^T - rowsum(g * o));  dQ = scale dS k;
        dK = scale dS^T q

    in float64 (every float32 input is exact there), each gradient rounded
    once to its type: the reference the kernel is held to.  A float32
    version's own sums over a head of 512 lanes miss the kernel's gate
    against float64 (PERF.md), so float32 math here could not tell a right
    kernel from a wrong one at wide heads.  ``o`` and ``lse`` are the
    forward's (``flash_attention_forward_lse_torch``).  Returns (dq, dk,
    dv) in the types of q, k and v."""
    scale = _scale(scale, q.shape[-1])
    qd, kd, vd, od, gd = (t.double() for t in (q, k, v, o, g))
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) * scale
    if causal:
        idx = torch.arange(q.shape[2], device=q.device)
        s = torch.where(idx[:, None] >= idx[None, :], s, -1e30)
    p = torch.exp(s - lse.double()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gd)
    dp = torch.einsum("bhqd,bhkd->bhqk", gd, vd)
    ds = p * (dp - (gd * od).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kd) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qd) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_checks(name: str, q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: want q, k, v of one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(t.dtype not in ATTENTION_DTYPES or t.device != q.device
           for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel takes float32, bfloat16 or "
                         f"float16 q, k, v on one device, got "
                         f"{[str(t.dtype) for t in (q, k, v)]}")
    kernel_head_dim(q.shape[-1])


def _flash_operand(t: torch.Tensor, w: int) -> torch.Tensor:
    """The [B*H, S, w] fibres a kernel walks, as ``_flash_pallas`` reshapes
    them: float32 (the Pallas body casts each tile), zero-padded from the
    head's lanes to the kernel's width ``w``, contiguous."""
    t = t.float()
    if t.shape[-1] != w:
        t = F.pad(t, (0, w - t.shape[-1]))
    return t.contiguous()


def _flash_forward_launch(q, k, v, causal: bool, scale: float, with_lse: bool):
    """One launch of the forward kernel on operands ``_flash_operand``
    made: (o, lse) float32 at their width, lse [B, H, S] only when
    ``with_lse`` (else None, and the kernel writes none)."""
    lib = _load("flash_attention")
    b, h, n, w = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparknet_flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, n, w,
            int(bool(causal)), scale, stream)
    _check_launch(lib, err, "flash_attention")
    _count("FLASH_LAUNCHES")
    return o, lse


def _flash_backward_launch(q, k, v, o, lse, g, causal: bool, scale: float):
    """One launch of the backward (its delta pre-pass, dK/dV and dQ
    kernels) on operands ``_flash_operand`` made, ``o`` and ``lse`` as the
    forward launch gave them: (dq, dk, dv) float32 at their width."""
    if any(t.data_ptr() % 16 for t in (q, k, v, g)):
        raise ValueError("flash_attention_backward: the kernel loads 16-byte "
                         "vectors of q, k, v and g, which must be 16-byte aligned")
    lib = _load("flash_attention")
    b, h, n, w = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparknet_flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b * h, n, w, int(bool(causal)),
            scale, stream)
    _check_launch(lib, err, "flash_attention_backward")
    _count("FLASH_BACKWARD_LAUNCHES")
    return dq, dk, dv


def _flash_forward(q, k, v, causal: bool, with_lse: bool):
    """The forward kernel on q, k, v as a caller holds them: a head between
    the kernel's widths runs zero-padded, at the true head's scale;
    bfloat16 or float16 operands are cast to float32.  Returns the kernel's
    operands, o (float32, padded) and lse (or None)."""
    _flash_checks("flash_attention", q, k, v)
    d = q.shape[-1]
    w = kernel_head_dim(d)
    operands = [_flash_operand(t, w) for t in (q, k, v)]
    o, lse = _flash_forward_launch(*operands, causal, 1.0 / math.sqrt(d), with_lse)
    return operands, o, lse


def _flash_attention_cuda(q, k, v, causal: bool, with_lse: bool = False):
    """``_flash_forward`` with the padded lanes of o dropped and o cast back
    to q's type.  Returns o, or (o, lse) with ``with_lse``."""
    _, o, lse = _flash_forward(q, k, v, causal, with_lse)
    o = o[..., :q.shape[-1]].to(q.dtype)
    return (o, lse) if with_lse else o


def _flash_attention_backward_cuda(q, k, v, o, lse, g, causal: bool):
    """The backward kernel on tensors as a caller holds them, with the
    forward wrapper's checks, padding and casts: (dq, dk, dv) in the types
    and shapes of q, k and v (the padded lanes, exact zeros, dropped)."""
    _flash_checks("flash_attention_backward", q, k, v)
    d = q.shape[-1]
    if o.shape != q.shape or g.shape != q.shape or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"flash_attention_backward: want o and g of q's shape "
                         f"{tuple(q.shape)} and lse {tuple(q.shape[:3])}, got "
                         f"{tuple(o.shape)}, {tuple(g.shape)}, {tuple(lse.shape)}")
    if any(t.device != q.device for t in (o, lse, g)):
        raise ValueError("flash_attention_backward: o, lse and g must lie on q's device")
    w = kernel_head_dim(d)
    grads = _flash_backward_launch(
        *(_flash_operand(t, w) for t in (q, k, v, o)), lse.float().contiguous(),
        _flash_operand(g, w), causal, 1.0 / math.sqrt(d))
    return tuple(t[..., :d].to(x.dtype) for t, x in zip(grads, (q, k, v)))


class FlashAttentionFunction(torch.autograd.Function):
    """The flash kernel inside the autograd graph: the ``jax.custom_vjp``
    of ``_flash_diff`` in the JAX package.  The forward launches the
    forward kernel with its ``lse`` output and saves the kernel's operands
    (float32, padded to the kernel's width), o and lse; the backward
    launches the backward kernel on them and drops the padded lanes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        operands, o, lse = _flash_forward(q, k, v, causal, True)
        ctx.save_for_backward(*operands, o, lse)
        ctx.attn = (causal, q.shape[-1], q.dtype, k.dtype, v.dtype)
        return o[..., :q.shape[-1]].to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        qp, kp, vp, o, lse = ctx.saved_tensors
        causal, d, *dtypes = ctx.attn
        grads = _flash_backward_launch(qp, kp, vp, o, lse,
                                       _flash_operand(g, qp.shape[-1]), causal,
                                       1.0 / math.sqrt(d))
        return (*(t[..., :d].to(dt) for t, dt in zip(grads, dtypes)), None)


def _flash_attention_route(q, k, v, causal: bool) -> torch.Tensor:
    """The route of CUDA tensors: through ``FlashAttentionFunction`` when a
    gradient may flow to q, k or v, else one forward launch that writes no
    lse (serving: the prefill and the rectangle decoder)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal)
    return _flash_attention_cuda(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention forward on [B, H, S, D] (``softmax(q k^T / sqrt(D)) v``,
    the upper triangle masked when ``causal``), differentiable.

    CUDA tensors: launches the kernels of ``csrc/flash_attention.cu``
    (float32, bfloat16 or float16 q, k, v, computed in float32; a head
    between the kernel's widths zero-padded to ``kernel_head_dim``, one
    above 256 lanes run by the chunked kernels; anything else raises),
    the backward kernel under autograd (``FlashAttentionFunction``).  CPU tensors:
    ``flash_attention_torch`` (differentiable by autograd).  Meta tensors
    (shape inference in ``Network.init``): an empty tensor of q's shape."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_attention_route(q, k, v, causal)


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------


def paged_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          positions: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch paged decode attention, the JAX package's
    ``paged_attention_xla``: gather each row's blocks in table order, then
    one stable softmax over its ``MB * T`` columns with columns past
    ``positions[b]`` at -1e30.

    ``q`` [B, H, D]; pools [NB, T, H, D]; ``tables`` [B, MB] block ids;
    ``positions`` [B] (row b attends to columns 0..positions[b]);
    ``scale`` multiplies q.k (default 1/sqrt(D); pools of heads padded
    from d lanes pass 1/sqrt(d))."""
    b, h, d = q.shape
    t = k_pool.shape[1]
    mb = tables.shape[1]
    idx = tables.long()
    k = k_pool[idx].reshape(b, mb * t, h, d)
    v = v_pool[idx].reshape(b, mb * t, h, d)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * _scale(scale, d)
    cols = torch.arange(mb * t, device=q.device)
    s = torch.where(cols[None, None, :] <= positions.long()[:, None, None], s, -1e30)
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def _paged_attention_cuda(q, k_pool, v_pool, tables, positions,
                          scale: float | None = None) -> torch.Tensor:
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or k_pool.shape[2:] != q.shape[1:]:
        raise ValueError(f"paged_attention: want q [B, H, D] and pools "
                         f"[NB, T, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, h, d = q.shape
    if tables.dim() != 2 or tables.shape[0] != b or tuple(positions.shape) != (b,):
        raise ValueError(f"paged_attention: want tables [{b}, MB] and "
                         f"positions [{b}], got {tuple(tables.shape)}, "
                         f"{tuple(positions.shape)}")
    if (q.dtype not in ATTENTION_DTYPES or k_pool.dtype not in ATTENTION_DTYPES
            or v_pool.dtype != k_pool.dtype
            or any(t.dtype != torch.int32 for t in (tables, positions))
            or any(t.device != q.device for t in (k_pool, v_pool, tables, positions))):
        raise ValueError("paged_attention: the kernel takes float32, bfloat16 or "
                         "float16 q and pools (both pools of one type) and int32 "
                         "tables and positions, on one device")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention: the pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: the kernel copies 16-byte chunks "
                         "of the pools, which must be 16-byte aligned")
    if d > PAGED_MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention: head dim {d} > {PAGED_MAX_HEAD_DIM}: the "
            f"kernel's chunk ring, q and its warps' output no longer fit a "
            f"block's shared memory")
    if d != kernel_head_dim(d):
        raise ValueError(
            f"paged_attention: head dim {d} lies between the kernel's widths "
            f"({ATTENTION_HEAD_DIMS}, then multiples of {ATTENTION_CHUNK}): "
            f"allocate the pools at kernel_head_dim({d}) = {kernel_head_dim(d)} "
            f"lanes (zero beyond {d}), pad q to it and pass scale=1/sqrt({d}), "
            f"as PagedDecoder does")
    lib = _load("paged_attention")
    # q is cast here; the pools are read in their own type by the kernel
    qf = q.float().contiguous()
    tables, positions = tables.contiguous(), positions.contiguous()
    o = torch.empty_like(qf)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparknet_paged_attention(
            qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), positions.data_ptr(), o.data_ptr(), b, h, d,
            k_pool.shape[1], tables.shape[1], _KV_DTYPE_IDS[k_pool.dtype],
            _scale(scale, d), stream)
    _check_launch(lib, err, "paged_attention")
    _count("PAGED_LAUNCHES")
    return o.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    tables: torch.Tensor, positions: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """One query token a row against a block-paged K/V pool (see
    ``paged_attention_torch`` for the shapes and ``scale``).  A row's
    output depends only on its own q, table and position.

    CUDA tensors: launches the kernel of ``csrc/paged_attention.cu``
    (float32, bfloat16 or float16 q, computed in float32 and returned in
    q's type; contiguous, 16-byte aligned pools of one of those types,
    read as stored, never copied; int32 tables and positions; head dim in
    ``ATTENTION_HEAD_DIMS`` or, above 256 lanes, a multiple of
    ``ATTENTION_CHUNK`` up to ``PAGED_MAX_HEAD_DIM`` (the chunked kernel);
    positions in [0, MB * T) and table entries in [0, NB); the kernel
    reads no column past a row's position).  A head of another width runs
    in pools allocated at ``kernel_head_dim`` lanes, zero beyond the head,
    with q padded alike and ``scale`` of the true width: the pools are
    not copied per call.  CPU tensors: ``paged_attention_torch``.
    Forward only."""
    if q.device.type == "cpu":
        return paged_attention_torch(q, k_pool, v_pool, tables, positions, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _paged_attention_cuda(q, k_pool, v_pool, tables, positions, scale)
