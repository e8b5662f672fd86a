"""Streaming data plane: multi-process shared-memory ingest.

Counterpart of ``sparknet_tpu/data/pipeline.py``.  The reference's #1
*measured* bottleneck was the host feed (the JNA crop+mean callback: ~1.2 s
per 256-image batch, ref: src/test/scala/apps/CallbackBenchmarkSpec.scala:
3-17).  This module is the input pipeline that keeps every host stage
(source read, decode, ``DataTransformer``, batch packing) off the step:

* **N worker processes** produce batches fully outside the consumer's GIL.
* **A shared-memory ring** of fixed-size batch slots carries the bytes:
  one ``multiprocessing.shared_memory`` segment, workers write numpy views
  into free slots, the consumer reads ZERO-COPY views.
* **Bounded-queue backpressure**: slots are PARTITIONED per worker (with
  one shared free list a fast worker can fill every slot with out-of-order
  batches while the consumer waits for the one batch a starved worker has
  nowhere to put — a reorder deadlock).
* **Deterministic shard/epoch assignment**: worker ``w`` produces exactly
  the global batches ``g % workers == w``, ``(epoch, index) = divmod(g,
  batches_per_epoch)``; batches are DELIVERED in global order, so a run's
  data order is a pure function of (source, start_index, workers).
* **Worker-death detection**: a worker that raises ships its traceback; one
  that dies silently is caught by the end of its result pipe and by
  exitcode polling.  ``max_respawns`` replaces a dead worker, which
  resumes its shard bit-identically.  Each worker reports on a pipe of its
  own: on one shared queue, a worker that died while its feeder thread
  held the queue's write lock left every other worker blocked for good.
* **Per-stage walls** (``FEED_STAGES``) accumulate in ``pipeline.stats``
  as plain numbers, and with the obs Recorder armed every ``obs_every``
  batches are journaled as a ``feed`` event carrying the window's global
  batch-index range as its lineage (a worker's respawn and the device
  stage's puts journal ``feed`` events too), as the JAX package does.
* **A double-buffered device stage** (:func:`device_feed`) copies each ring
  batch to the card ahead of the step (``data/prefetch.py``) and releases
  the ring slot only after the transfer that read it completed.

Start method: ``fork`` where available.  Workers run numpy, PIL, mmap and
the multiprocessing queues only: the worker loop and every source and
transform of the ring (this module, ``records``, ``lmdb_io``,
``io_utils``, ``minibatch``, ``archive``, ``transform``) make no torch
call, so a fork from a process that already holds a CUDA context is safe
(torch marks CUDA unusable in a forked child, so a CUDA call there would
raise, not corrupt the parent's context).  ``SPARKNET_FEED_START`` overrides
(``spawn`` pickles the source: ``RecordShardSource`` drops its file
handles for that).
"""

from __future__ import annotations

import dataclasses
import errno
import os
import queue as _queue
import time
import traceback
import warnings
from typing import Callable, Iterator

import numpy as np

from sparknet_tpu_torch.obs import lineage as obs_lineage

__all__ = [
    "FEED_STAGES",
    "FeedSpec",
    "BatchSource",
    "DataFnSource",
    "ArraySource",
    "SyntheticImageSource",
    "PrestagedSource",
    "TransformStage",
    "ProcessPipeline",
    "device_feed",
    "feed_workers",
    "shard_batches",
]

# the stage vocabulary of ``ProcessPipeline.stats``:
# slot_wait  consumer blocked waiting for the next in-order full slot
# source     worker: raw batch production minus decode (read / synthesis)
# decode     worker: record/JPEG decode inside source.get (sources that
#            decode report the wall via ``consume_decode_s``)
# transform  worker: host DataTransformer (crop/mirror/mean/scale)
# write      worker: memcpy of the finished batch into its ring slot (the
#            wait for a free slot before it, the ring's backpressure, is
#            not counted; the JAX package's wall includes it)
# put        device stage: host->device transfer (device_feed only)
FEED_STAGES = ("slot_wait", "source", "decode", "transform", "write", "put")


def feed_workers(cap: int = 4) -> int:
    """Worker-process count: ``SPARKNET_FEED_WORKERS`` (validated, >=1) or
    min(cpu_count, cap)."""
    raw = os.environ.get("SPARKNET_FEED_WORKERS", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            raise ValueError(
                f"SPARKNET_FEED_WORKERS must be an integer (got {raw!r})"
            ) from None
    return min(os.cpu_count() or 1, cap)


def _start_method() -> str:
    """``fork`` where the platform has it (see module docstring), else
    ``spawn``; ``SPARKNET_FEED_START`` overrides."""
    import multiprocessing as mp

    raw = os.environ.get("SPARKNET_FEED_START", "").strip()
    if raw:
        return raw
    return "fork" if "fork" in mp.get_all_start_methods() else "spawn"


def _start(p) -> None:
    """Start a worker process.  Python 3.12 warns on any fork from a
    multi-threaded process (torch's and CUDA's runtime threads); the child
    runs ``_worker_loop`` only, which takes no lock those threads hold."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=r".*use of fork\(\) may lead to deadlocks.*",
            category=DeprecationWarning)
        p.start()


# ---------------------------------------------------------------------------
# Slot geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeedSpec:
    """Fixed per-batch geometry of one ring slot: an ordered ``name ->
    (shape, dtype)`` map plus the derived byte layout.  Every batch through
    the ring must match it exactly — fixed-size slots are what make the
    ring allocation-free and the views zero-copy.

    ``max_respawns`` (policy, not geometry — excluded from equality): how
    many worker deaths the pipeline may absorb by respawning a replacement
    over the run's lifetime; 0 (default) raises on the first death."""

    fields: tuple[tuple[str, tuple[int, ...], str], ...]
    max_respawns: int = dataclasses.field(default=0, compare=False)

    @classmethod
    def from_arrays(cls, feeds: dict[str, np.ndarray]) -> "FeedSpec":
        return cls(tuple(
            (name, tuple(np.asarray(a).shape), np.asarray(a).dtype.str)
            for name, a in feeds.items()))

    @property
    def slot_bytes(self) -> int:
        total = 0
        for _, shape, dtype in self.fields:
            total += int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        return total

    def offsets(self) -> list[tuple[str, tuple[int, ...], np.dtype, int]]:
        out, off = [], 0
        for name, shape, dtype in self.fields:
            dt = np.dtype(dtype)
            out.append((name, shape, dt, off))
            off += int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        return out

    def views(self, buf, base: int) -> dict[str, np.ndarray]:
        """Zero-copy numpy views of one slot at byte offset ``base``."""
        return {
            name: np.ndarray(shape, dtype=dt, buffer=buf, offset=base + off)
            for name, shape, dt, off in self.offsets()
        }

    def check(self, feeds: dict[str, np.ndarray]) -> None:
        got = FeedSpec.from_arrays(feeds)
        if got != self:
            raise ValueError(
                f"batch does not match the ring's FeedSpec: got "
                f"{got.fields}, slot holds {self.fields} (fixed-size "
                "slots require every batch to share one geometry)")


# ---------------------------------------------------------------------------
# Sources — picklable, index-addressable batch producers
# ---------------------------------------------------------------------------


class BatchSource:
    """A deterministic, index-addressable batch producer.

    ``get(epoch, index)`` must be a pure function of its arguments (plus
    construction state): that is what makes the worker assignment
    deterministic and a dead worker's batches re-producible.  The
    reference's analog is an RDD partition — addressable, re-computable.
    ``batches_per_epoch`` 0 means an unbounded stream (epoch stays 0,
    index is the global batch id).
    """

    batches_per_epoch: int = 0

    def get(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def lineage_source(self) -> str | None:
        """A deterministic identity string for lineage (``obs/lineage.py``):
        with a journal's ``(epoch, index)`` cursor range it pins which
        records a feed window delivered.  None (the default): no durable
        identity worth journaling (synthetic feeds)."""
        return None


class DataFnSource(BatchSource):
    """Wraps an INDEX-ADDRESSABLE ``data_fn(it) -> feeds`` (the solver feed
    contract) as a source: calling it with the same ``it`` must always
    return the same feeds — no hidden cursor, no consumed iterator, no
    sequential RandomState — so any worker can (re)produce batch ``it``
    without having produced ``0..it-1`` first."""

    def __init__(self, fn: Callable[[int], dict[str, np.ndarray]],
                 batches_per_epoch: int = 0):
        self.fn = fn
        self.batches_per_epoch = int(batches_per_epoch)

    def get(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        e = self.batches_per_epoch
        return self.fn(epoch * e + index if e else index)


class ArraySource(BatchSource):
    """Fixed-size batch slices of in-memory arrays (the cifar shape).

    Epoch ``e`` visits the batches in a deterministic seeded permutation
    (identity when ``shuffle=False``), a pure function of (seed, epoch) so
    every worker agrees on it without coordination."""

    def __init__(self, arrays: dict[str, np.ndarray], batch: int,
                 shuffle: bool = False, seed: int = 0):
        n = min(len(a) for a in arrays.values())
        if batch > n:
            raise ValueError(f"batch {batch} exceeds dataset size {n}")
        self.arrays = arrays
        self.batch = int(batch)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.batches_per_epoch = n // batch

    def get(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        index = index % self.batches_per_epoch
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + epoch).permutation(self.batches_per_epoch)
            index = int(order[index])
        lo = index * self.batch
        return {k: a[lo:lo + self.batch] for k, a in self.arrays.items()}


class SyntheticImageSource(BatchSource):
    """Deterministic random uint8 image batches + int32 labels, in the
    requested wire layout.  ``shape`` is canonical (C, H, W);
    ``layout="nhwc"`` emits (N, H, W, C) natively."""

    def __init__(self, batch: int, shape: tuple[int, int, int] = (3, 256, 256),
                 classes: int = 10, seed: int = 0, layout: str = "nchw"):
        c, h, w = shape
        self.batch = int(batch)
        self.shape = (h, w, c) if layout == "nhwc" else (c, h, w)
        self.classes = int(classes)
        self.seed = int(seed)
        self.batches_per_epoch = 0

    def get(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        rs = np.random.RandomState((self.seed * 1_000_003 + index) & 0x7FFFFFFF)
        return {
            "data": rs.randint(0, 256, (self.batch, *self.shape), dtype=np.uint8),
            "label": rs.randint(0, self.classes, self.batch).astype(np.int32),
        }


class PrestagedSource(BatchSource):
    """One pre-built batch served for every index — the PURE-INGEST probe:
    the worker's only per-batch work is the slot memcpy, so the delivered
    img/s measures the ring transport itself."""

    def __init__(self, feeds: dict[str, np.ndarray]):
        self.feeds = {k: np.ascontiguousarray(v) for k, v in feeds.items()}
        self.batches_per_epoch = 0

    def get(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        return self.feeds


def shard_batches(source: BatchSource):
    """Adapt a :class:`BatchSource` to the elastic shard-feed contract
    (``parallel/elastic.py`` ``ShardFn``): global shard id ``g`` -> that
    shard's raw batch, deterministically.  ``source.get`` keys on the index
    alone, so a shard reassigned across a resize replays identical data.
    The data plane's hand-off to the train-to-serve loop
    (``loop/feed.py`` turns these raw batches into net feeds)."""
    def data_fn(g: int) -> dict:
        return source.get(0, int(g))

    return data_fn


class TransformStage:
    """The worker-side host augment stage: wraps ``DataTransformer`` with
    the shape algebra the fixed-size ring needs up front (``out_spec``).
    ``out_dtype`` uint8 keeps the wire thin for device-side augmentation
    recipes; float32 matches the host-transform feed contract."""

    def __init__(self, config, train: bool = True, layout: str = "nchw",
                 out_dtype: str = "<f4"):
        self.config = config
        self.train = bool(train)
        self.layout = layout
        self.out_dtype = np.dtype(out_dtype).str
        self._xform = None  # built lazily IN the worker (RNG stays local)

    def out_spec(self, in_spec: FeedSpec) -> FeedSpec:
        crop = getattr(self.config, "crop_size", 0)
        fields = []
        for name, shape, dtype in in_spec.fields:
            if name == "data" and len(shape) == 4:
                if crop:
                    n = shape[0]
                    ch = shape[3] if self.layout == "nhwc" else shape[1]
                    shape = ((n, crop, crop, ch) if self.layout == "nhwc"
                             else (n, ch, crop, crop))
                dtype = self.out_dtype
            fields.append((name, tuple(shape), dtype))
        return FeedSpec(tuple(fields))

    def __call__(self, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        if self._xform is None:
            from sparknet_tpu_torch.data.transform import DataTransformer

            self._xform = DataTransformer(self.config, layout=self.layout)
        out = self._xform(feeds["data"], self.train)
        if out.dtype.str != self.out_dtype:
            out = out.astype(self.out_dtype)
        return {**feeds, "data": out}


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _unregister_shm(shm, start_method: str) -> None:
    """Keep the CONSUMER the sole owner of the segment's lifetime.

    Under ``spawn``/``forkserver`` a worker runs its OWN resource tracker,
    which would unlink the segment when the worker exits (CPython's
    attach-also-registers behavior, bpo-39959) — unregister there.  Under
    ``fork`` the tracker process is shared with the consumer and its cache
    is a set: the duplicate registration is harmless and an extra
    unregister would corrupt the consumer's own unlink bookkeeping."""
    if start_method == "fork":
        return
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass  # best-effort; tracker drift only costs a warning


def _worker_loop(wid: int, nworkers: int, source: BatchSource,
                 transform, ring_name: str, spec: FeedSpec, slots: int,
                 free_q, results, stop, start_index: int, num_batches: int,
                 poll_s: float, start_method: str = "fork",
                 first_g: int | None = None) -> None:
    """One producer: source -> transform -> slot memcpy, for every global
    batch id ``g`` with ``g % nworkers == wid``, each reported on
    ``results`` (this worker's own pipe end).  ``first_g`` overrides the
    iteration start (a RESPAWNED replacement resumes the dead worker's
    shard at its first undelivered id)."""
    from multiprocessing import shared_memory

    shm = None
    try:
        shm = shared_memory.SharedMemory(name=ring_name)
        _unregister_shm(shm, start_method)
        views = [spec.views(shm.buf, s * spec.slot_bytes) for s in range(slots)]
        bpe = source.batches_per_epoch
        for g in range(first_g if first_g is not None else start_index + wid,
                       start_index + num_batches, nworkers):
            epoch, index = divmod(g, bpe) if bpe else (0, g)
            t0 = time.perf_counter()
            dec0 = getattr(source, "consume_decode_s", 0.0)
            raw = source.get(epoch, index)
            dec_s = getattr(source, "consume_decode_s", 0.0) - dec0
            t1 = time.perf_counter()
            batch = transform(raw) if transform is not None else raw
            t2 = time.perf_counter()
            spec.check(batch)
            slot = None
            while slot is None:  # backpressure: wait for a free slot
                if stop.is_set():
                    return
                try:
                    slot = free_q.get(timeout=poll_s)
                except _queue.Empty:
                    continue
            t_slot = time.perf_counter()  # the wait for a slot is no stage's
            view = views[slot]
            for name in view:
                np.copyto(view[name], batch[name], casting="no")
            t3 = time.perf_counter()
            results.send(("batch", wid, g, slot,
                          (max(t1 - t0 - dec_s, 0.0), dec_s, t2 - t1, t3 - t_slot)))
        results.send(("done", wid, 0, 0, ()))
    except BaseException:
        try:
            results.send(("error", wid, 0, 0, traceback.format_exc()))
        except Exception:
            pass  # consumer falls back to exitcode polling
    finally:
        if shm is not None:
            shm.close()


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class _WorkerDeath(Exception):
    """Internal: one identified producer died (raised by ``_next_msg``,
    absorbed by the respawn policy or re-raised as RuntimeError)."""

    def __init__(self, wid: int, message: str):
        super().__init__(message)
        self.wid = wid
        self.message = message


class _StageClock:
    """The consumer's stage walls: run-lifetime ``totals`` (the pipeline's
    ``stats``, kept whether or not a journal is armed) and, with the
    Recorder armed, one obs ``feed`` event every ``every`` batches."""

    def __init__(self, name: str, workers: int, images_per_batch: int, every: int,
                 totals: dict, source_id: str | None = None):
        from sparknet_tpu_torch.obs import get_recorder

        self.rec = get_recorder()
        self.name = name
        self.workers = workers
        self.images = images_per_batch
        self.every = max(int(every), 1)
        self.source_id = source_id
        self.stages = {s: 0.0 for s in FEED_STAGES[:5]}
        self.totals = totals
        self.batches = 0
        self._t0 = time.perf_counter()
        self._first_g: int | None = None
        self._last_g: int | None = None

    def add(self, slot_wait: float, source: float, decode: float, transform: float,
            write: float, g: int) -> None:
        for key, val in (("slot_wait", slot_wait), ("source", source), ("decode", decode),
                         ("transform", transform), ("write", write)):
            self.totals[key] += val
            if self.rec:
                self.stages[key] += val
        self.totals["batches"] += 1
        if not self.rec:
            return
        self.batches += 1
        if self._first_g is None:
            self._first_g = g
        self._last_g = g
        if self.batches % self.every == 0:
            self.flush()

    def flush(self) -> None:
        if not (self.rec and self.batches):
            return
        wall = time.perf_counter() - self._t0
        # lineage: the window's global batch-index range, the deterministic
        # cursor (epoch, index) = divmod(g, batches_per_epoch) the workers
        # decode, so any batch of the window is re-derivable from the journal
        lin = obs_lineage.feed_lineage(self.name, self._first_g, self._last_g)
        if self.source_id:
            lin["source"] = self.source_id
        self.rec.emit(
            "feed", name=self.name, batches=self.batches,
            images=self.batches * self.images, wall_s=round(wall, 6),
            stages={k: round(v, 6) for k, v in self.stages.items()},
            images_per_sec=round(self.batches * self.images / wall, 1) if wall > 0 else 0.0,
            workers=self.workers, lineage=lin)
        self.stages = {s: 0.0 for s in FEED_STAGES[:5]}
        self.batches = 0
        self._t0 = time.perf_counter()
        self._first_g = self._last_g = None


class ProcessPipeline:
    """Multi-process shared-memory batch feed (see module docstring).

    ``with ProcessPipeline(src, num_batches=N) as pipe:`` then iterate
    ``pipe.batches()`` — each yielded dict holds ZERO-COPY views into the
    ring, valid until ``hold`` further batches have been consumed (default
    1: the views of batch ``g`` die when batch ``g+1`` is delivered — copy
    first, or raise ``hold``, to keep them longer; the device stage relies
    on exactly this window to overlap its put).

    ``stats``: the run-lifetime stage walls in seconds (``FEED_STAGES``;
    ``put`` is added by :func:`device_feed`) and ``batches``, the count.
    ``obs_every``: the batches a journaled ``feed`` event covers.
    """

    def __init__(self, source: BatchSource, transform=None, *,
                 num_batches: int, workers: int | None = None,
                 slots: int | None = None, start_index: int = 0,
                 name: str = "feed", hold: int = 1, poll_s: float = 0.2,
                 obs_every: int = 32, spec: FeedSpec | None = None,
                 start_method: str | None = None,
                 max_respawns: int | None = None):
        from multiprocessing import shared_memory

        if num_batches <= 0:
            raise ValueError(f"num_batches must be > 0 (got {num_batches})")
        self.source = source
        self.transform = transform
        self.num_batches = int(num_batches)
        self.start_index = int(start_index)
        self.workers = workers or feed_workers()
        self.hold = max(int(hold), 1)
        self.max_respawns = int(max_respawns) if max_respawns is not None \
            else int(getattr(spec, "max_respawns", 0) or 0)
        self._respawns_used = 0
        self._delivered_max: dict[int, int] = {}
        self._pending: dict[int, tuple] = {}
        self._held: list[int] = []
        # ring depth: every worker needs (hold + 1) OWNED slots — up to
        # ``hold`` of its delivered batches may still be retained by the
        # consumer while it produces the next one
        self.slots = slots or (self.workers * (self.hold + 1))
        if self.slots < self.workers * (self.hold + 1):
            raise ValueError(
                f"ring of {self.slots} slots cannot carry {self.workers} "
                f"worker(s) at hold {self.hold} without deadlocking "
                f"(need >= workers * (hold + 1) = "
                f"{self.workers * (self.hold + 1)})")
        self.name = name
        self._poll_s = float(poll_s)
        self._obs_every = int(obs_every)
        self.stats: dict = {s: 0.0 for s in FEED_STAGES}
        self.stats["batches"] = 0

        if spec is None:
            # probe ONE batch on the host to fix the slot geometry; sources
            # are index-addressable so workers re-produce it identically
            bpe = source.batches_per_epoch
            e, i = divmod(self.start_index, bpe) if bpe else (0, self.start_index)
            spec = FeedSpec.from_arrays(source.get(e, i))
            if transform is not None:
                spec = transform.out_spec(spec)
        self.spec = spec

        import multiprocessing as mp

        method = self._start_method = start_method or _start_method()
        ctx = mp.get_context(method)
        self._shm = None
        self._procs: list = []
        self._closed = False
        try:
            self._shm = shared_memory.SharedMemory(
                create=True, size=max(self.spec.slot_bytes, 1) * self.slots)
        except OSError as e:
            if e.errno in (errno.ENOMEM, errno.ENOSPC):
                raise OSError(
                    e.errno,
                    f"cannot allocate the feed ring ({self.slots} slots x "
                    f"{self.spec.slot_bytes:,} B) in shared memory — shrink "
                    f"the slots or the batch, or check /dev/shm capacity: {e}"
                ) from e
            raise
        try:
            self._views = [self.spec.views(self._shm.buf, s * self.spec.slot_bytes)
                           for s in range(self.slots)]
            # static slot ownership: slot s belongs to worker s % workers
            self._owner = [s % self.workers for s in range(self.slots)]
            self._free_qs = [ctx.Queue() for _ in range(self.workers)]
            # each worker's result pipe (reader ends; None once it ended)
            self._results: list = [None] * self.workers
            self._stop = ctx.Event()
            for s in range(self.slots):
                self._free_qs[self._owner[s]].put(s)
            for w in range(self.workers):
                self._procs.append(self._start_worker(ctx, w, self._free_qs[w]))
        except BaseException:
            self.close()
            raise

    def _start_worker(self, ctx, wid: int, free_q, first_g: int | None = None,
                      suffix: str = ""):
        """Start producer ``wid`` with a fresh result pipe; returns the
        process."""
        reader, writer = ctx.Pipe(duplex=False)
        p = ctx.Process(
            target=_worker_loop,
            args=(wid, self.workers, self.source, self.transform,
                  self._shm.name, self.spec, self.slots,
                  free_q, writer, self._stop,
                  self.start_index, self.num_batches,
                  self._poll_s, self._start_method, first_g),
            daemon=True, name=f"{self.name}-worker-{wid}{suffix}")
        try:
            _start(p)
        finally:
            writer.close()  # the worker holds the only writer: its exit ends the pipe
        if self._results[wid] is not None:
            self._results[wid].close()
        self._results[wid] = reader
        return p

    # -- consumption -------------------------------------------------------

    def batches(self) -> Iterator[dict[str, np.ndarray]]:
        """In-order batch views (see class docstring for the lifetime
        contract).  Raises RuntimeError naming the worker on any producer
        death; always safe to ``close()`` after."""
        clock = _StageClock(self.name, self.workers, self._images_per_batch(),
                            self._obs_every, self.stats, self.source.lineage_source())
        pending, held = self._pending, self._held
        try:
            for g in range(self.start_index, self.start_index + self.num_batches):
                t0 = time.perf_counter()
                while g not in pending:
                    try:
                        msg = self._next_msg()
                    except _WorkerDeath as death:
                        self._respawn_or_raise(death.wid, death.message)
                        continue
                    kind, wid, gg, slot, extra = msg
                    if kind == "batch":
                        if gg in pending:
                            # duplicate after a respawn raced an in-flight
                            # message from the dead worker: keep the
                            # newest, recycle the older slot
                            self._release(pending[gg][0])
                        pending[gg] = (slot, extra)
                        if gg > self._delivered_max.get(wid, -1):
                            self._delivered_max[wid] = gg
                    elif kind == "error":
                        self._respawn_or_raise(
                            wid, f"feed worker {wid} raised:\n{extra}")
                    # "done" needs no handling: the loop bound already
                    # knows how many batches are owed
                slot, (src_s, dec_s, tr_s, wr_s) = pending.pop(g)
                clock.add(time.perf_counter() - t0, src_s, dec_s, tr_s, wr_s, g)
                held.append(slot)
                while len(held) > self.hold:
                    self._release(held.pop(0))
                yield self._views[slot]
        finally:
            clock.flush()
            for slot in held:
                try:
                    self._release(slot)
                except Exception:
                    pass  # ring already torn down
            self._pending, self._held = {}, []

    def _release(self, slot: int) -> None:
        """Hand a consumed slot back to the worker that owns it."""
        self._free_qs[self._owner[slot]].put(slot)

    def _images_per_batch(self) -> int:
        for _, shape, _ in self.spec.fields:
            if shape:
                return int(shape[0])
        return 0

    def as_data_fn(self, copy: bool = False) -> Callable[[int], dict]:
        """Adapt to the solver's ``data_fn(it)`` contract: each call returns
        the next in-order batch (``it`` is accepted but the stream's own
        deterministic order governs).  ``copy=True`` hands out stable copies
        — required if batches outlive the next call AND no device stage
        re-copies them (``device_feed`` does)."""
        it = self.batches()

        def fn(_it: int) -> dict[str, np.ndarray]:
            feeds = next(it)
            if copy:
                feeds = {k: np.array(v) for k, v in feeds.items()}
            return feeds

        return fn

    def _next_msg(self, timeout_s: float = 60.0):
        """One message from any worker's result pipe, polling worker
        liveness: a producer that died silently must surface as an error
        (or a respawn), not a hang."""
        from multiprocessing.connection import wait

        deadline = time.monotonic() + timeout_s
        while True:
            live = [r for r in self._results if r is not None]
            for reader in wait(live, timeout=self._poll_s):
                wid = self._results.index(reader)
                try:
                    return reader.recv()
                except EOFError:  # the worker exited: its pipe is drained
                    reader.close()
                    self._results[wid] = None
                    p = self._procs[wid]
                    p.join(timeout=5.0)
                    if p.exitcode not in (None, 0):
                        raise _WorkerDeath(
                            wid,
                            f"feed worker {p.name} died with exitcode "
                            f"{p.exitcode} (killed? OOM?) before delivering "
                            "its batches")
            for wid, p in enumerate(self._procs):
                if p.exitcode not in (None, 0):
                    raise _WorkerDeath(
                        wid,
                        f"feed worker {p.name} died with exitcode "
                        f"{p.exitcode} (killed? OOM?) before delivering "
                        "its batches")
            if all(r is None for r in self._results):
                raise RuntimeError(
                    "all feed workers exited but batches are still owed "
                    "— worker/consumer accounting bug")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no feed batch arrived in {timeout_s:.0f}s "
                    f"({self.name}: {self.workers} workers alive but "
                    "silent)")

    def _respawn_or_raise(self, wid: int, message: str) -> None:
        """The bounded respawn policy: with budget left, replace dead worker
        ``wid`` with a fresh process resuming its shard at the first
        undelivered id and reclaim its idle ring slots; with the budget
        exhausted (default 0), raise RuntimeError."""
        if self._respawns_used >= self.max_respawns:
            raise RuntimeError(message)
        self._respawns_used += 1
        old = self._procs[wid]
        old.join(timeout=2.0)
        if old.is_alive():
            old.terminate()
            old.join(timeout=2.0)
        # Rebuild the worker's free list in a FRESH queue: a worker SIGKILLed
        # inside ``free_q.get`` can die holding the queue's reader lock.
        # Only this worker ever got from the queue, so abandoning it loses
        # nothing; the free set is slot ownership minus what the consumer
        # still references.
        import multiprocessing as mp

        method = self._start_method
        ctx = mp.get_context(method)
        in_use = {slot for slot, _ in self._pending.values()}
        in_use.update(self._held)
        self._free_qs[wid].cancel_join_thread()
        q = self._free_qs[wid] = ctx.Queue()
        for s in range(self.slots):
            if self._owner[s] == wid and s not in in_use:
                q.put(s)
        last = self._delivered_max.get(wid)
        first_g = (last + self.workers) if last is not None \
            else self.start_index + wid
        self._procs[wid] = self._start_worker(ctx, wid, q, first_g,
                                              f"r{self._respawns_used}")
        from sparknet_tpu_torch.obs import get_recorder

        rec = get_recorder()
        if rec:
            rec.emit(
                "feed", name=f"{self.name}.respawn", batches=0, images=0, wall_s=0.0,
                stages={}, workers=self.workers,
                note=f"worker {wid} died; shard re-owned from batch {first_g} (respawn "
                     f"{self._respawns_used}/{self.max_respawns}): "
                     f"{message.splitlines()[0]}")

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop workers, release queues, and UNLINK the ring segment.
        Idempotent; the segment must never outlive the pipeline."""
        if self._closed:
            return
        self._closed = True
        if getattr(self, "_stop", None) is not None:
            self._stop.set()
        for p in self._procs:
            p.join(timeout=2.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        for q in getattr(self, "_free_qs", ()):
            try:
                while True:
                    q.get_nowait()
            except Exception:
                pass
            q.close()
            q.join_thread()
        for reader in getattr(self, "_results", ()):
            if reader is not None:
                reader.close()
        self._results = []
        self._views = []
        if self._shm is not None:
            try:
                self._shm.close()
            finally:
                try:
                    self._shm.unlink()
                except FileNotFoundError:
                    pass  # already unlinked (double close)
                self._shm = None

    def __enter__(self) -> "ProcessPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        return self.num_batches


# ---------------------------------------------------------------------------
# Device stage
# ---------------------------------------------------------------------------


def device_feed(pipeline: ProcessPipeline, depth: int = 2, device_fn=None,
                device=None):
    """Double-buffered host→device stage over a pipeline: a
    :class:`~sparknet_tpu_torch.data.prefetch.DevicePrefetcher` whose thread
    copies each ring batch to ``device`` (default CUDA) ahead of
    consumption, ``depth`` batches in flight.

    Slot-lifetime contract: the thread confirms each transfer COMPLETED
    (its event) before it pulls the next batch, which is what recycles the
    previous slot (``hold=1``), so the card never reads a slot the ring has
    handed back to a producer.  On the CPU the "transfer" copies (a tensor
    made with ``torch.from_numpy`` would alias the slot).  ``device_fn(feeds,
    it)`` (e.g. ``DeviceAugment.device_fn``) runs after the gate, on the
    prefetcher's stream.  The gate's wall accumulates in
    ``pipeline.stats["put"]``, and with the Recorder armed every
    ``obs_every`` puts are journaled as a ``<name>.put`` ``feed`` event."""
    from sparknet_tpu_torch.data.prefetch import DevicePrefetcher
    from sparknet_tpu_torch.obs import get_recorder

    it = pipeline.batches()
    rec = get_recorder()
    window = {"put_s": 0.0, "puts": 0, "done": 0}

    def data_fn(_it: int) -> dict[str, np.ndarray]:
        return next(it)

    def on_transfer(put_s: float) -> None:
        pipeline.stats["put"] += put_s
        window["done"] += 1
        if rec:
            window["put_s"] += put_s
            window["puts"] += 1
            if window["puts"] % pipeline._obs_every == 0:
                rec.emit("feed", name=pipeline.name + ".put", batches=window["puts"],
                         images=window["puts"] * pipeline._images_per_batch(),
                         wall_s=round(window["put_s"], 6),
                         stages={"put": round(window["put_s"], 6)}, workers=1)
                window["put_s"], window["puts"] = 0.0, 0
        if window["done"] == pipeline.num_batches:
            # the last batch's copy completed: end the ring's stream now (its
            # slots go back, its last stage window is journaled), not when
            # the generator is collected
            it.close()

    return DevicePrefetcher(
        data_fn, num_iters=pipeline.num_batches, depth=depth,
        start_iter=pipeline.start_index, device_fn=device_fn, device=device,
        on_transfer=on_transfer)
