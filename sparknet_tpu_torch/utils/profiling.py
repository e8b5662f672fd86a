"""torch.profiler integration: device traces for the training loop.

Counterpart of ``sparknet_tpu/utils/profiling.py``, the answer to the
reference's three profiling layers (app event log, cudaEvent Timer,
``caffe time``): a trace context that captures the host's ops and the
card's kernels as a Chrome trace (TensorBoard, Perfetto or
``chrome://tracing`` read it), a step-annotation helper so outer-loop
rounds show up as named spans, and the card's memory counters.

While a :func:`trace` is open, ``Network.apply`` wraps each layer in a
``record_function("L.<name>")`` range (:func:`layer_scopes`), the
counterpart of the JAX graph compiler's ``jax.named_scope``;
``utils/op_profile.py`` attributes the card's kernels to layers through
those ranges.  With no trace open the step runs exactly as without this
module: no range is opened.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time

import torch

# open trace() contexts in this process (the layer scopes' switch)
_OPEN = 0
_EXPORTS = itertools.count()
# Kineto keeps a device record only when its start, converted to the host's
# clock, falls inside the window.  On the H100's host that conversion runs
# early by a different amount in each window, up to 4.3 ms seen (a record
# stamped before its own launch), and the records of the window's first
# milliseconds are then dropped (PERF.md §7).  The caller's work starts this
# long after the window opens.
START_MARGIN_S = 0.1


def layer_scopes() -> bool:
    """True while a :func:`trace` is open in this process."""
    return _OPEN > 0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host + device profile into ``log_dir``: one Chrome trace,
    ``<host>.<pid>.<n>.trace.json.gz``, written when the block ends (the
    name ``op_profile._device_events`` globs for).  CUDA activity is
    recorded when a card is present: the block starts ``START_MARGIN_S``
    after the window opens, so no record of its first launches is dropped
    as earlier than the window, and the device is synchronised before the
    profiler stops, so every kernel launched inside the block has
    finished and left its record.

    Usage::

        with profiling.trace("/tmp/profile"):
            trainer.train(10, data_fn)
    """
    from torch.profiler import ProfilerActivity, profile

    global _OPEN
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    if cuda and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        time.sleep(START_MARGIN_S)
    _OPEN += 1
    try:
        yield log_dir
    finally:
        _OPEN -= 1
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.{next(_EXPORTS)}.trace.json.gz"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def step_span(name: str, step: int):
    """Named span for one training round (shows as a block in the trace,
    ``<name>#<step>``)."""
    return torch.profiler.record_function(f"{name}#{int(step)}")


def device_memory_stats() -> dict:
    """Per-card live, peak and total memory: ``{"cuda:<i>":
    {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}`` (the JAX
    function's keys), from ``torch.cuda.memory_stats`` (the caching
    allocator's) and ``mem_get_info`` (the card's total); empty without a
    card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out
