"""ctypes bindings for the native data plane, built from the repo's source.

Counterpart of ``sparknet_tpu/native/__init__.py``, over the same C++ file,
``native/sparknet_native.cpp`` (ref: SURVEY §2.2 — the reference keeps its
db layer and data transformer in C++):

- :class:`RecordDB` — append-only key/value record file with committed-
  snapshot cursors (``sndb_*``; the role of Caffe's LMDB/LevelDB
  abstraction and libccaffe's create_db/write_to_db/commit_db_txn);
- :func:`transform_batch` — multithreaded uint8→float32 crop/mirror/mean
  augmenter (``snaug_transform``; the per-sample loop of
  data_transformer.cpp).

:func:`build` compiles the source with ``g++ -O3 -fPIC -std=c++17 -shared
-pthread`` into ``sparknet_tpu_torch/_build/``, under a name keyed by a
hash of the source, the flags and the host (machine and CPU model), so a
tree copied to another host builds its own library and never runs code
compiled for another CPU.  ``native/libsparknet_native.so`` (built with
``-march=native`` wherever the JAX package's tests last ran) is never
loaded here.  A failed build or load raises with the compiler's log;
:func:`available` reports it to a caller that asks, and no path takes a
pure-Python route instead.  Nothing here imports torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["RecordDB", "transform_batch", "build", "available", "library_path"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sparknet_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")

_lib = None
_lock = threading.Lock()


def _host_key() -> str:
    """The machine and the CPU model: a library is built for one host."""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()} {model or platform.processor()}"


def library_path() -> Path:
    """Where the library of this source, these flags and this host is built."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_key().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libsparknet_native-{digest}.so"


def build() -> str:
    """Compile the library unless it is built already; returns its path.
    Raises with the compiler's log if the build fails."""
    path = library_path()
    with _lock:
        if path.exists():
            return str(path)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler for {SOURCE}: {e}") from e
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {SOURCE} failed ({' '.join(cmd)}):\n{out.stdout}{out.stderr}")
        os.replace(tmp, path)
    return str(path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(path)
        lib.sndb_open.restype = ctypes.c_void_p
        lib.sndb_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.sndb_put.restype = ctypes.c_int
        lib.sndb_put.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.sndb_commit.restype = ctypes.c_int
        lib.sndb_commit.argtypes = [ctypes.c_void_p]
        lib.sndb_count.restype = ctypes.c_longlong
        lib.sndb_count.argtypes = [ctypes.c_void_p]
        lib.sndb_close.argtypes = [ctypes.c_void_p]
        lib.sndb_cursor.restype = ctypes.c_void_p
        lib.sndb_cursor.argtypes = [ctypes.c_void_p]
        lib.sndb_next.restype = ctypes.c_int
        lib.sndb_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ]
        lib.sndb_cursor_free.argtypes = [ctypes.c_void_p]
        lib.snaug_transform.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.snative_abi_version.restype = ctypes.c_int
        if lib.snative_abi_version() != 1:
            raise RuntimeError(f"{path}: native ABI {lib.snative_abi_version()}, want 1")
        _lib = lib
        return _lib


def available() -> bool | str:
    """True if the library builds and loads; otherwise the error's text
    (a caller that asks gets the reason; nothing falls back on it)."""
    try:
        _load()
        return True
    except (OSError, RuntimeError) as e:
        return str(e)


# ---------------------------------------------------------------- record DB
class RecordDB:
    """Append-only record DB (ref: db::GetDB + Cursor/Transaction,
    caffe/src/caffe/util/db.hpp).  Write mode: put/commit; read mode:
    iterate committed records.  A handle belongs to the process that
    opened it: open one after a fork, never carry it across."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError("mode must be 'r' or 'w'")
        self._lib = _load()
        self._h = self._lib.sndb_open(os.fsencode(path), 1 if mode == "w" else 0)
        if not self._h:
            raise OSError(f"cannot open record db {path!r} mode={mode}")
        self.mode = mode
        self.path = path

    def put(self, key: bytes, value: bytes) -> None:
        rc = self._lib.sndb_put(self._h, key, len(key), value, len(value))
        if rc != 0:
            raise OSError("sndb_put failed (read-only handle or IO error)")

    def commit(self) -> None:
        if self._lib.sndb_commit(self._h) != 0:
            raise OSError("sndb_commit failed")

    def __len__(self) -> int:
        return int(self._lib.sndb_count(self._h))

    def __iter__(self):
        cur = self._lib.sndb_cursor(self._h)
        if not cur:
            raise OSError("cursors require a read-mode handle")
        try:
            k = ctypes.c_void_p()
            kl = ctypes.c_int()
            v = ctypes.c_void_p()
            vl = ctypes.c_int()
            while self._lib.sndb_next(
                cur, ctypes.byref(k), ctypes.byref(kl), ctypes.byref(v), ctypes.byref(vl)
            ):
                yield (
                    ctypes.string_at(k, kl.value),
                    ctypes.string_at(v, vl.value),
                )
        finally:
            self._lib.sndb_cursor_free(cur)

    def close(self) -> None:
        if self._h:
            self._lib.sndb_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------- augmenter
def transform_batch(
    images: np.ndarray,
    mean: np.ndarray | None = None,
    mean_values: tuple[float, ...] | None = None,
    scale: float = 1.0,
    crop: int = 0,
    mirror: bool = False,
    train: bool = True,
    seed: int = 0,
    nthreads: int = 0,
) -> np.ndarray:
    """Native multithreaded augmenter over a uint8 NCHW batch, the JAX
    package's ``native.transform_batch``: the mean is subtracted before
    the crop, as Caffe's mean_file path does; crop windows and mirrors
    come from ``splitmix64(seed + sample)``."""
    lib = _load()
    x = np.ascontiguousarray(images, np.uint8)
    n, c, h, w = x.shape
    if crop and (crop > h or crop > w):
        raise ValueError(f"crop {crop} larger than image {h}x{w}")
    if mean is not None:
        mdata = np.ascontiguousarray(mean, np.float32)
        if mdata.shape != (c, h, w):
            raise ValueError(f"mean shape {mdata.shape} != {(c, h, w)}")
        mean_mode = 2
    elif mean_values:
        mdata = np.asarray(mean_values, np.float32)
        if mdata.size != c:
            raise ValueError("need one mean value per channel")
        mean_mode = 1
    else:
        mdata = np.zeros(1, np.float32)
        mean_mode = 0
    oh = crop if crop else h
    out = np.empty((n, c, oh, oh if crop else w), np.float32)
    lib.snaug_transform(
        x.ctypes.data_as(ctypes.c_void_p), n, c, h, w,
        mdata.ctypes.data_as(ctypes.c_void_p), mean_mode,
        ctypes.c_float(scale), crop, 1 if mirror else 0, 1 if train else 0,
        ctypes.c_ulonglong(seed),
        out.ctypes.data_as(ctypes.c_void_p), nthreads,
    )
    return out
