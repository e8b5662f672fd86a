"""Background device prefetcher: the async host→card feed.

Counterpart of ``sparknet_tpu/data/prefetch.py``, the equivalent of Caffe's
prefetch pipeline (ref: caffe/src/caffe/layers/base_data_layer.cpp:70-118 +
caffe/include/caffe/data_layers.hpp:85-93: ``PREFETCH_COUNT = 3`` batch
slots cycling through free/full queues, the prefetch thread also doing the
host→GPU copy).  A side thread calls ``data_fn(it)``, copies the host
batch into a pinned staging buffer, then ``non_blocking`` onto the card on
its own copy stream, and runs ``device_fn`` on that stream too, so the copy
and the augment overlap the previous step instead of queueing behind it on
the default stream.

Ordering on the card, per batch:
- an event is recorded on the copy stream after the batch's last op; the
  consumer's stream waits on it before the step reads the batch, and each
  tensor is ``record_stream``-ed onto the consumer's stream, so the caching
  allocator does not hand its memory to a later batch while the step still
  reads it;
- the staging buffers come in two sets used in turns: a set is refilled
  only after the event of the copy that last read it has completed.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from sparknet_tpu_torch.common import resolve_device

PREFETCH_COUNT = 3


class DevicePrefetcher:
    """Wraps ``data_fn(it) -> feeds`` (host arrays) into an iterator of
    feeds on ``device`` (default CUDA), produced ahead of consumption by a
    daemon thread, ``depth`` batches deep.

    ``device_fn(feeds, it)`` post-processes the feeds on the card — e.g.
    :class:`~sparknet_tpu_torch.data.device_transform.DeviceAugment`, so the
    host ships uint8 and the crop/mirror/mean run on the card.
    ``on_transfer(seconds)``, when given, makes the thread wait for each
    transfer to complete before it calls ``data_fn`` again, and reports
    the transfer's wall: ``data.pipeline.device_feed`` needs that wait,
    since its next call recycles the ring slot the transfer read.

    On the CPU the transfer is a copy of the host arrays (``data_fn`` may
    hand out views of memory it reuses).  :meth:`close` stops and joins the
    thread; use the prefetcher as a context manager.
    """

    def __init__(
        self,
        data_fn: Callable[[int], dict[str, Any]],
        num_iters: int,
        depth: int = PREFETCH_COUNT,
        start_iter: int = 0,
        device_fn: Callable[[dict[str, Any], int], dict[str, Any]] | None = None,
        device: str | torch.device | None = None,
        on_transfer: Callable[[float], None] | None = None,
    ):
        self.device = resolve_device(device)
        self._data_fn = data_fn
        self._num = num_iters
        self._device_fn = device_fn
        self._on_transfer = on_transfer
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._start = start_iter
        self._stop = threading.Event()
        self._finished = False
        self._staging: list[dict[str, torch.Tensor]] = [{}, {}]
        self._staged: list = [None, None]  # the event of each set's last copy
        self._turn = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    # -- the thread --------------------------------------------------------
    def _worker(self) -> None:
        cuda = self.device.type == "cuda"
        try:
            stream = torch.cuda.Stream(self.device) if cuda else None
            with (torch.cuda.device(self.device) if cuda else contextlib.nullcontext()), \
                    (torch.cuda.stream(stream) if cuda else contextlib.nullcontext()):
                for it in range(self._start, self._start + self._num):
                    if self._stop.is_set():
                        return
                    host = self._data_fn(it)
                    t0 = time.perf_counter()
                    feeds, copied = self._transfer(host)
                    if self._on_transfer is not None:
                        if copied is not None:
                            copied.synchronize()
                        self._on_transfer(time.perf_counter() - t0)
                    if self._device_fn is not None:
                        feeds = self._device_fn(feeds, it)
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not self._put((feeds, ready)):
                        return
            self._put(_DONE)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
            self._put(_DONE)

    def _transfer(self, host: dict[str, Any]):
        """Host feeds -> device tensors; returns (feeds, the copy's event or
        None on the CPU)."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.array(_numpy(v))) for k, v in host.items()}, None
        turn = self._turn
        self._turn ^= 1
        if self._staged[turn] is not None:
            self._staged[turn].synchronize()  # the set's last copy has left it
        staging = self._staging[turn]
        out = {}
        for k, v in host.items():
            a = _numpy(v)
            buf = staging.get(k)
            if buf is None or tuple(buf.shape) != a.shape or buf.numpy().dtype != a.dtype:
                buf = staging[k] = torch.from_numpy(np.empty(a.shape, a.dtype)).pin_memory()
            np.copyto(buf.numpy(), a, casting="no")
            out[k] = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._staged[turn] = event
        return out, event

    def _put(self, item) -> bool:
        """Bounded put that aborts on close() so an abandoned consumer does
        not leave the thread pinning device batches forever."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- the consumer ------------------------------------------------------
    def close(self) -> None:
        """Stop the thread, join it, and release the queued batches."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=30.0)
        self._drain()  # a racing _put may have landed one item mid-drain

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        if self._finished:
            # single-use stream: a second iteration would block forever
            if self._err is not None:
                raise self._err
            return
        while True:
            item = self._q.get()
            if item is _DONE:
                self._finished = True
                if self._err is not None:
                    raise self._err
                return
            feeds, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ready)
                for t in feeds.values():
                    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                        t.record_stream(consumer)
            yield feeds

    def __len__(self) -> int:
        return self._num


def _numpy(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class _Done:
    pass


_DONE = _Done()
