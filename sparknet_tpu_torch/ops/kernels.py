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
* a launch count (``LRN_LAUNCHES``), raised by one at each launch and
  nowhere else, so a run can show that its path went through the kernel.

Kernels ported so far: cross-channel LRN forward (replaces
``sparknet_tpu/ops/pallas_kernels.py::_lrn_kernel``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source of the package, one shared library each
KERNEL_SOURCES = ("lrn",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}

LRN_LAUNCHES = 0


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
            lib.sparknet_lrn_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.sparknet_lrn_forward.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# Cross-channel LRN forward
# ---------------------------------------------------------------------------


def _pow_neg(u: torch.Tensor, beta: float) -> torch.Tensor:
    """u ** -beta; beta = 0.75 (every zoo LRN) as rsqrt(u) * rsqrt(sqrt(u)),
    the form the kernel and the JAX package's ``_pow_neg`` use."""
    if beta == 0.75:
        return torch.rsqrt(u) * torch.rsqrt(torch.sqrt(u))
    return torch.pow(u, -beta)


def lrn_across_channels_torch(x: torch.Tensor, size: int, alpha: float,
                              beta: float, k: float) -> torch.Tensor:
    """Plain PyTorch cross-channel LRN on an NCHW tensor:
    ``y = x * (k + alpha/size * sum_{|c'-c| <= (size-1)/2} x[c']^2)^-beta``.

    The window sum is the shifted-add form of the JAX package's
    ``_windowed_channel_sum``: the centre, then +1 and -1, +2 and -2, with
    zeros past the channel edges (shifts past C - 1 are skipped, the clamp
    for C < size).  Math is float32 whatever the storage type, as in the
    kernel; the result is cast back to ``x.dtype``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    xf = x.float()
    sq = xf * xf
    c = sq.shape[1]
    acc = sq
    for off in range(1, min((size - 1) // 2, c - 1) + 1):
        zeros = torch.zeros_like(sq[:, :off])
        acc = acc + torch.cat([sq[:, off:], zeros], dim=1)  # c + off
        acc = acc + torch.cat([zeros, sq[:, : c - off]], dim=1)  # c - off
    scale = k + (alpha / size) * acc
    return (xf * _pow_neg(scale, beta)).to(x.dtype)


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float, beta: float,
                        k: float) -> torch.Tensor:
    """Cross-channel LRN forward of an NCHW tensor.

    CUDA tensor: launches the kernel of ``csrc/lrn.cu`` on the current
    stream (f32 or bf16, 4-D, contiguous; anything else raises).  CPU
    tensor: ``lrn_across_channels_torch``.  Meta tensor (shape inference in
    ``Network.init``): an empty tensor of the same shape."""
    global LRN_LAUNCHES
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    if x.device.type == "cpu":
        return lrn_across_channels_torch(x, size, alpha, beta, k)
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_across_channels: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"lrn_across_channels: want NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lrn_across_channels: want float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("lrn_across_channels: input must be contiguous NCHW")
    lib = _load("lrn")
    if size > lib.sparknet_lrn_max_size():
        raise ValueError(f"lrn_across_channels: local_size {size} > "
                         f"{lib.sparknet_lrn_max_size()}, the largest the kernel takes")
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sparknet_lrn_forward(
            x.data_ptr(), y.data_ptr(), b, c, h * w, size, alpha / size, beta,
            k, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.sparknet_cuda_error_string(err).decode()
        raise RuntimeError(f"lrn_across_channels launch: CUDA error {err} ({msg})")
    LRN_LAUNCHES += 1
    return y
