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
  ``FUSED_UPDATE_LAUNCHES``, ``FLASH_LAUNCHES``, ``PAGED_LAUNCHES``),
  raised by one at each launch and nowhere else, so a run can show that
  its path went through the kernel.

Kernels ported so far, all from ``sparknet_tpu/ops/pallas_kernels.py``:

* cross-channel LRN forward (``csrc/lrn.cu``, replaces ``_lrn_kernel``) and
  its backward (same source, replaces ``_lrn_fused_bwd``, which is XLA on
  the TPU), joined by the ``torch.autograd.Function`` ``LRNFunction``;
* the one-pass fused optimizer update (``csrc/fused_update.cu``, replaces
  ``_fused_kernel``);
* flash attention forward (``csrc/flash_attention.cu``, replaces
  ``_flash_kernel``), the prompt pass of token serving and the attention
  core of ``MultiHeadAttention``;
* paged decode attention (``csrc/paged_attention.cu``, replaces
  ``_paged_kernel``), the cached decode step of token serving.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source of the package, one shared library each
KERNEL_SOURCES = ("lrn", "fused_update", "flash_attention", "paged_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}

LRN_LAUNCHES = 0
LRN_BACKWARD_LAUNCHES = 0
FUSED_UPDATE_LAUNCHES = 0
FLASH_LAUNCHES = 0
PAGED_LAUNCHES = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    global LRN_LAUNCHES, LRN_BACKWARD_LAUNCHES, FUSED_UPDATE_LAUNCHES
    global FLASH_LAUNCHES, PAGED_LAUNCHES
    LRN_LAUNCHES = LRN_BACKWARD_LAUNCHES = FUSED_UPDATE_LAUNCHES = 0
    FLASH_LAUNCHES = PAGED_LAUNCHES = 0


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
            lib.sparknet_lrn_backward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.sparknet_lrn_backward.restype = ctypes.c_int
        elif name == "fused_update":
            lib.sparknet_fused_update_tile.argtypes = []
            lib.sparknet_fused_update_tile.restype = ctypes.c_int
            lib.sparknet_fused_update.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                *[ctypes.c_float] * 8, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.sparknet_fused_update.restype = ctypes.c_int
        elif name == "flash_attention":
            lib.sparknet_flash_attention_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            lib.sparknet_flash_attention_forward.restype = ctypes.c_int
        elif name == "paged_attention":
            lib.sparknet_paged_attention.argtypes = [
                *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 5, ctypes.c_float,
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


def _channel_window_sum(t: torch.Tensor, size: int) -> torch.Tensor:
    """Sum of ``t`` over the channels within (size-1)/2 of each channel, as
    the JAX package's ``_windowed_channel_sum`` adds them: the centre, then
    +1 and -1, +2 and -2, with zeros past the channel edges (shifts past
    C - 1 are skipped, the clamp for C < size)."""
    c = t.shape[1]
    acc = t
    for off in range(1, min((size - 1) // 2, c - 1) + 1):
        zeros = torch.zeros_like(t[:, :off])
        acc = acc + torch.cat([t[:, off:], zeros], dim=1)  # c + off
        acc = acc + torch.cat([zeros, t[:, : c - off]], dim=1)  # c - off
    return acc


def lrn_across_channels_torch(x: torch.Tensor, size: int, alpha: float,
                              beta: float, k: float) -> torch.Tensor:
    """Plain PyTorch cross-channel LRN on an NCHW tensor:
    ``y = x * (k + alpha/size * sum_{|c'-c| <= (size-1)/2} x[c']^2)^-beta``.

    The window sum is ``_channel_window_sum``.  Math is float32 whatever the
    storage type, as in the kernel; the result is cast back to
    ``x.dtype``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    xf = x.float()
    scale = k + (alpha / size) * _channel_window_sum(xf * xf, size)
    return (xf * _pow_neg(scale, beta)).to(x.dtype)


def lrn_backward_torch(x: torch.Tensor, g: torch.Tensor, size: int,
                       alpha: float, beta: float, k: float) -> torch.Tensor:
    """Plain PyTorch gradient of ``lrn_across_channels_torch`` w.r.t. ``x``
    for the incoming gradient ``g``, op for op the JAX package's
    ``_lrn_fused_bwd``:

        scale = k + alpha/size * wsum(x^2);  p = scale^-beta
        dx = g * p - (2 alpha beta / size) * x * wsum(g * x * p / scale)

    (the window is symmetric, so the adjoint of wsum is wsum).  scale is
    recomputed from ``x``.  Math is float32; the result has ``x.dtype``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    xf, gf = x.float(), g.float()
    scale = k + (alpha / size) * _channel_window_sum(xf * xf, size)
    p = _pow_neg(scale, beta)
    w = _channel_window_sum(gf * xf * p / scale, size)
    return (gf * p - (2.0 * alpha * beta / size) * xf * w).to(x.dtype)


def _lrn_cuda_checks(x: torch.Tensor, size: int, what: str) -> ctypes.CDLL:
    if x.dim() != 4:
        raise ValueError(f"{what}: want NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: want float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous NCHW")
    lib = _load("lrn")
    if size > lib.sparknet_lrn_max_size():
        raise ValueError(f"{what}: local_size {size} > "
                         f"{lib.sparknet_lrn_max_size()}, the largest the kernel takes")
    return lib


def _lrn_forward_cuda(x: torch.Tensor, size: int, alpha: float, beta: float,
                      k: float) -> torch.Tensor:
    global LRN_LAUNCHES
    lib = _lrn_cuda_checks(x, size, "lrn_across_channels")
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sparknet_lrn_forward(
            x.data_ptr(), y.data_ptr(), b, c, h * w, size, alpha / size, beta,
            k, int(x.dtype == torch.bfloat16), stream)
    _check_launch(lib, err, "lrn_across_channels")
    LRN_LAUNCHES += 1
    return y


def _lrn_backward_cuda(x: torch.Tensor, g: torch.Tensor, size: int,
                       alpha: float, beta: float, k: float) -> torch.Tensor:
    global LRN_BACKWARD_LAUNCHES
    lib = _lrn_cuda_checks(x, size, "lrn_backward")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"lrn_backward: gradient {tuple(g.shape)} {g.dtype} "
                         f"{g.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} {x.device}")
    g = g.contiguous()
    dx = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sparknet_lrn_backward(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, c, h * w, size,
            alpha / size, beta, k, 2.0 * alpha * beta / size,
            int(x.dtype == torch.bfloat16), stream)
    _check_launch(lib, err, "lrn_backward")
    LRN_BACKWARD_LAUNCHES += 1
    return dx


def lrn_backward(x: torch.Tensor, g: torch.Tensor, size: int, alpha: float,
                 beta: float, k: float) -> torch.Tensor:
    """Gradient of the cross-channel LRN w.r.t. its input ``x``.

    CUDA tensor: launches the backward kernel of ``csrc/lrn.cu`` (x and g
    f32 or bf16 of one type, 4-D; x contiguous).  CPU tensor:
    ``lrn_backward_torch``."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    if x.device.type == "cpu":
        return lrn_backward_torch(x, g, size, alpha, beta, k)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_backward: unsupported device {x.device}")
    return _lrn_backward_cuda(x, g, size, alpha, beta, k)


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
    def forward(ctx, x, size, alpha, beta, k):
        if x.device.type == "cpu":
            y = lrn_across_channels_torch(x, size, alpha, beta, k)
        else:
            y = _lrn_forward_cuda(x, size, alpha, beta, k)
        ctx.save_for_backward(x)
        ctx.lrn = (size, alpha, beta, k)
        return y

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return lrn_backward(x, g, *ctx.lrn), None, None, None, None


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float, beta: float,
                        k: float) -> torch.Tensor:
    """Cross-channel LRN forward of an NCHW tensor, differentiable.

    CUDA tensor: launches the kernel of ``csrc/lrn.cu`` on the current
    stream (f32 or bf16, 4-D, contiguous; anything else raises), through
    ``LRNFunction``, whose backward is the backward kernel.  CPU tensor:
    the same Function over ``lrn_across_channels_torch`` and
    ``lrn_backward_torch``.  Meta tensor (shape inference in
    ``Network.init``): an empty tensor of the same shape."""
    if size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd, got {size}")
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lrn_across_channels: unsupported device {x.device}")
    return LRNFunction.apply(x, size, alpha, beta, k)


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


def fused_update_torch(rule: str, st: UpdateStatics, w, g, slots, tile_lr,
                       tile_decay, scalars):
    """Plain PyTorch fused update, the port of the JAX
    ``_fused_update_xla``: the same single-sweep math over the
    ``(n_tiles, ARENA_TILE)`` view, float32 whatever the storage type.
    Returns (new_w, new_slots) in the input types; nothing is written in
    place."""
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


def _fused_update_cuda(rule, st, w, g, slots, tile_lr, tile_decay, scalars):
    global FUSED_UPDATE_LAUNCHES
    lib = _load("fused_update")
    if lib.sparknet_fused_update_tile() != ARENA_TILE:
        raise RuntimeError("csrc/fused_update.cu was built for another tile")
    arenas = [w, g, *slots]
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
    s0 = slots[0]
    s1 = slots[1] if len(slots) > 1 else slots[0]
    m, m2, rms = float(st.momentum), float(st.momentum2), float(st.rms_decay)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.sparknet_fused_update(
            w.data_ptr(), g.data_ptr(), s0.data_ptr(), s1.data_ptr(),
            tile_lr.data_ptr(), tile_decay.data_ptr(), scalars.data_ptr(),
            w.shape[0], _RULE_IDS[rule], _REG_IDS[st.reg], int(st.clip),
            int(st.iter_size), m, 1.0 + m, 1.0 - m, m2, 1.0 - m2, rms,
            1.0 - rms, float(st.delta), int(w.dtype == torch.bfloat16), stream)
    _check_launch(lib, err, "fused_update")
    FUSED_UPDATE_LAUNCHES += 1


def fused_update(rule: str, st: UpdateStatics, w: torch.Tensor,
                 g: torch.Tensor, slots: list, tile_lr: torch.Tensor,
                 tile_decay: torch.Tensor, scalars: torch.Tensor) -> None:
    """One-pass optimizer update over flat arenas, IN PLACE: ``w`` and each
    of ``slots`` are overwritten with their updated values (the TPU
    kernel's ``input_output_aliases``); ``g`` is only read.

    ``w``/``g``: [T] param and grad arenas (T a multiple of
    ``ARENA_TILE``); ``slots``: ``FUSED_RULE_SLOTS[rule]`` [T] history
    arenas of the same type; ``tile_lr``/``tile_decay``: [T / ARENA_TILE]
    float32 tables (lr_mult and folded weight_decay * decay_mult per tile);
    ``scalars``: [3] float32 = (rate, clip_scale, adam_correction), on the
    arenas' device.

    CUDA tensors: launches the kernel of ``csrc/fused_update.cu``.  CPU
    tensors: ``fused_update_torch``, copied into ``w`` and ``slots``."""
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
    if any(t.shape != w.shape for t in (g, *slots)):
        raise ValueError("fused_update: w, g and the slots differ in length")
    if w.device.type == "cpu":
        with torch.no_grad():
            new_w, new_slots = fused_update_torch(rule, st, w, g, slots,
                                                  tile_lr, tile_decay, scalars)
            w.copy_(new_w)
            for s, h in zip(slots, new_slots):
                s.copy_(h)
        return
    if w.device.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {w.device}")
    _fused_update_cuda(rule, st, w, g, slots, tile_lr, tile_decay, scalars)


# ---------------------------------------------------------------------------
# Flash attention forward
# ---------------------------------------------------------------------------

# head dims the two attention kernels are instantiated for (the launchers of
# csrc/flash_attention.cu and csrc/paged_attention.cu switch on these)
ATTENTION_HEAD_DIMS = (8, 16, 32, 64, 128)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """Plain PyTorch attention on [B, H, S, D]: the unblocked stable
    softmax of the JAX package's ``attention_xla``, float32 math, the
    causal upper triangle at -1e30; the result has ``q.dtype``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[2]
        idx = torch.arange(n, device=q.device)
        s = torch.where(idx[:, None] >= idx[None, :], s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def _flash_attention_cuda(q, k, v, causal: bool) -> torch.Tensor:
    global FLASH_LAUNCHES
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: want q, k, v of one [B, H, S, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.dtype != torch.float32 or t.device != q.device for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes float32 q, k, v "
                         "on one device")
    b, h, n, d = q.shape
    if d not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{ATTENTION_HEAD_DIMS}")
    lib = _load("flash_attention")
    # the [B*H, S, D] fibres the kernel walks, as _flash_pallas reshapes
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparknet_flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, n,
            d, int(bool(causal)), 1.0 / math.sqrt(d), stream)
    _check_launch(lib, err, "flash_attention")
    FLASH_LAUNCHES += 1
    return o


class FlashAttentionFunction(torch.autograd.Function):
    """The flash kernel's forward inside the autograd graph, so that a
    gradient through it raises instead of leaving q, k and v (and the
    projections before them) silently without one.  The kernel has no
    backward yet (ROADMAP Queue B3: it comes with the char LM's training
    slice); serving never differentiates and never reaches ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _flash_attention_cuda(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel has no backward yet, so a "
            "MultiHeadAttention net cannot train on the card (ROADMAP Queue "
            "B3, the char LM's training slice)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention forward on [B, H, S, D] (``softmax(q k^T / sqrt(D)) v``,
    the upper triangle masked when ``causal``).

    CUDA tensors: launches the kernel of ``csrc/flash_attention.cu``
    (float32, head dim in ``ATTENTION_HEAD_DIMS``; anything else raises)
    through ``FlashAttentionFunction``, whose backward raises.  CPU
    tensors: ``flash_attention_torch`` (differentiable by autograd).  Meta
    tensors (shape inference in ``Network.init``): an empty tensor of q's
    shape."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return FlashAttentionFunction.apply(q, k, v, causal)


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------


def paged_attention_torch(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch paged decode attention, the JAX package's
    ``paged_attention_xla``: gather each row's blocks in table order, then
    one stable softmax over its ``MB * T`` columns with columns past
    ``positions[b]`` at -1e30.

    ``q`` [B, H, D]; pools [NB, T, H, D]; ``tables`` [B, MB] block ids;
    ``positions`` [B] (row b attends to columns 0..positions[b])."""
    b, h, d = q.shape
    t = k_pool.shape[1]
    mb = tables.shape[1]
    idx = tables.long()
    k = k_pool[idx].reshape(b, mb * t, h, d)
    v = v_pool[idx].reshape(b, mb * t, h, d)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * (1.0 / math.sqrt(d))
    cols = torch.arange(mb * t, device=q.device)
    s = torch.where(cols[None, None, :] <= positions.long()[:, None, None], s, -1e30)
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def _paged_attention_cuda(q, k_pool, v_pool, tables, positions) -> torch.Tensor:
    global PAGED_LAUNCHES
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
    for t, dtype in ((q, torch.float32), (k_pool, torch.float32),
                     (v_pool, torch.float32), (tables, torch.int32),
                     (positions, torch.int32)):
        if t.dtype != dtype or t.device != q.device:
            raise ValueError("paged_attention: the kernel takes float32 q and "
                             "pools and int32 tables and positions, on one device")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention: the pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: the kernel copies 16-byte chunks "
                         "of the pools, which must be 16-byte aligned")
    if d not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in "
                         f"{ATTENTION_HEAD_DIMS}")
    lib = _load("paged_attention")
    q, tables, positions = q.contiguous(), tables.contiguous(), positions.contiguous()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparknet_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), positions.data_ptr(), o.data_ptr(), b, h, d,
            k_pool.shape[1], tables.shape[1], 1.0 / math.sqrt(d), stream)
    _check_launch(lib, err, "paged_attention")
    PAGED_LAUNCHES += 1
    return o


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    tables: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One query token a row against a block-paged K/V pool (see
    ``paged_attention_torch`` for the shapes).  A row's output depends only
    on its own q, table and position.

    CUDA tensors: launches the kernel of ``csrc/paged_attention.cu``
    (float32 q and contiguous, 16-byte aligned pools, int32 tables and
    positions, head dim in ``ATTENTION_HEAD_DIMS``, positions in
    [0, MB * T) and table entries in [0, NB); the kernel reads no column
    past a row's position).  CPU tensors: ``paged_attention_torch``.
    Forward only."""
    if q.device.type == "cpu":
        return paged_attention_torch(q, k_pool, v_pool, tables, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _paged_attention_cuda(q, k_pool, v_pool, tables, positions)
