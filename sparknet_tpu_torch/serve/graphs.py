"""Per-bucket CUDA graphs: the serving engine's counterpart of the JAX
engine's ahead-of-time bucket executables.

The JAX engine lowers and compiles one forward program per batch bucket
when a model loads (``jax.jit(fn).lower(...).compile()``), so traffic never
traces or compiles.  On the card the counterpart is a CUDA graph captured
per bucket at load: a :class:`BucketProgram` holds

* a static input on the device, ``[exec_batch, *item_shape]`` (float32
  NCHW images or int32 token ids), and a static all-zero label;
* the TEST-phase forward captured once (``CUDAGraph.capture_begin``), after
  warm-up forwards on the capture's own side stream (they load the
  kernels, create the cuBLAS/cuDNN handles and workspaces for that
  stream, build the port's attention library and set its shared-memory
  attributes, none of which may happen inside a capture);
* the static output the graph writes, and pinned host buffers for the
  request batch and the scores.

Calling :meth:`BucketProgram.run` copies the assembled host batch into the
static input, replays the graph and copies the output back to the host, on
the caller's current stream.  On the card this is the only way a bucket
executes: a capture that fails raises, and nothing falls back to eager
execution.  On the CPU (the tests) the same forward runs eagerly at the
same ``exec_batch``.

Capture rules this module keeps:

* **Thread-local capture mode on a private side stream.**  A hot swap or
  a joining replica captures on the caller's thread while the engine's
  pump thread replays and copies on the same card.  The default (global)
  capture mode would make the pump's stream synchronisations errors of
  the capture; ``capture_error_mode="thread_local"`` confines the check to
  the capturing thread.  Captures themselves are serialised by one lock:
  ``common.f32_precision`` and ``cudnn.benchmark`` are process-wide
  switches, and a second capture must not flip them under the first.
  Every capture on a device uses that device's one capture stream: cuBLAS
  keeps a workspace for each (handle, stream) pair (32 MiB and more on an
  H100), so a fresh stream a capture would leave a workspace behind each.
* **TF32 off, ``cudnn.benchmark`` off** for the warm-up and the capture,
  so replay and an eager forward at the same batch pick the same kernels
  and agree bit for bit.
* **One memory pool per model.**  A model's bucket graphs share one graph
  pool; that is safe because every replay's output is copied to the host
  before the model's next replay (the engine serialises a model's
  replays under its own lock).
* **No host synchronisation inside the forward** of the served families
  (no ``.item()``/``.cpu()`` in ``ops/`` or ``compiler/graph.py``).
* **Kernel launch counts follow the replays.**  The port's kernel wrappers
  called inside the capture launch nothing; ``kernels.recording_launches``
  takes them off the launch counts and keeps them as the program's
  ``launches``, which :meth:`BucketProgram.run` adds at each replay.

Captures are counted by the obs capture sentinel (``obs/sentinel.py``),
process-wide (:func:`capture_count`) and per capturing thread.  Only the
:class:`BucketProgram` constructor captures, and the engine's request path
constructs none, so a replay can never trigger a capture: unlike a lazily
recompiling ``jax.jit``, a CUDA graph is recorded once or not at all.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import numpy as np
import torch

from ..obs.sentinel import get_sentinel
from ..ops import kernels

__all__ = ["BucketProgram", "capture_count"]

# eager forwards on the capture stream before a capture
WARMUP_FORWARDS = 2

_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}  # under the lock


def capture_count() -> int:
    """CUDA graph captures made in this process, on every thread."""
    return get_sentinel().count


@contextlib.contextmanager
def _capture_settings():
    """Full float32 convolutions and products, and cuDNN's heuristic (not
    benchmarked) algorithm choice, for a warm-up and its capture."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = prev


class BucketProgram:
    """One bucket's forward at ``batch`` rows (the bucket's exec batch).

    ``forward(data, label)`` is the TEST-phase forward on device tensors,
    returning the score blob.  On a CUDA ``device`` the constructor
    captures it (``pool``: the model's graph pool handle); on the CPU it
    is run eagerly by :meth:`run`.
    """

    def __init__(self, forward, item_shape: tuple, item_dtype, batch: int,
                 device: torch.device, pool=None):
        self.batch = int(batch)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._forward = forward
        dtype = torch.from_numpy(np.zeros(0, item_dtype)).dtype
        self.data = torch.zeros((self.batch, *item_shape), dtype=dtype, device=self.device)
        self.label = torch.zeros((self.batch,), dtype=torch.int32, device=self.device)
        # the request batch is assembled here by the engine, row by row
        host = torch.zeros((self.batch, *item_shape), dtype=dtype, pin_memory=cuda)
        self.host_input = host.numpy()
        self._host = host
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None
        self._host_out: torch.Tensor | None = None
        self.capture_s = 0.0
        # the port's kernel launches one replay makes, by count name
        self.launches: dict[str, int] = {}
        if cuda:
            self._capture(pool)

    def _capture(self, pool) -> None:
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, _capture_settings():
            stream = _CAPTURE_STREAMS.get(self.device)
            if stream is None:
                stream = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_FORWARDS):
                    self._forward(self.data, self.label)
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            # capture_begin/end, not torch.cuda.graph: its entry would
            # synchronize the card and empty the allocator's and the pinned
            # host caches, stalling the pump thread's replays for the length
            # of a build.  No automatic collection while this thread
            # captures: a collected generation's graphs would be destroyed
            # here, mid-capture, which CUDA refuses and which invalidates the
            # capture (torch.cuda.graph collected before it began)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with kernels.recording_launches() as launches, torch.cuda.stream(stream):
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        out = self._forward(self.data, self.label)
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            stream.synchronize()
            get_sentinel().note_capture()
        self.graph, self.out, self.launches = graph, out, launches
        self._host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.capture_s = time.perf_counter() - t0

    def run(self) -> np.ndarray:
        """The forward of ``host_input``: copied to the device, the graph
        replayed, the scores copied back (a numpy array the caller owns).
        The caller holds the model's lock: the static buffers are shared
        by every call."""
        if self.graph is None:
            return self._forward(torch.from_numpy(self.host_input), self.label).numpy().copy()
        with torch.cuda.device(self.device):
            self.data.copy_(self._host, non_blocking=True)
            self.graph.replay()
            kernels.add_launches(self.launches)
            self._host_out.copy_(self.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        return self._host_out.numpy().copy()

    def eager(self, data: torch.Tensor) -> torch.Tensor:
        """The same forward run eagerly on ``data`` (``[batch, *item]``)
        under the capture's settings: the reference a replay is held to
        bit for bit."""
        with _capture_settings():
            return self._forward(data.to(self.device), self.label)
