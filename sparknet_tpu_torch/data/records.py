"""Record-streaming ring sources: byte-offset shard indexes over DB files.

Counterpart of ``sparknet_tpu/data/records.py``.  The reference's DB data
path is a STATEFUL cursor — Caffe's DataReader walks an LMDB sequentially
and rewinds at the tail (ref: caffe/src/caffe/data_reader.cpp:79-99,
db_lmdb.cpp:40-72) — which a ring worker cannot re-produce.
:class:`RecordShardSource` converts the cursor into the pipeline's
index-addressable contract (``data/pipeline.py`` ``BatchSource``): one pass
at open builds a **byte-offset locator index** (for every record, the
absolute ``(offset, size)`` of its value bytes in the backing file), and
``get(epoch, index)`` then assembles any batch directly off an ``mmap``, in
any order, from any process: deterministic ``(epoch, index)`` addressing,
``g % workers == w`` shard assignment, and a dead worker's batches
re-produced bit-identically by its replacement.

Decode runs **inside** ``get`` — i.e. inside the ring worker that calls it —
so record decode scales with the ring's workers; its wall is surfaced
through ``consume_decode_s`` (the feed's ``decode`` stage).

Backends (auto-detected from the file):

- ``lmdb`` — Caffe LMDB environments via the clean-room codec's locator
  walk (:meth:`sparknet_tpu_torch.data.lmdb_io.LmdbReader.iter_locators`);
  values are protobuf ``Datum`` bytes.
- ``tar`` — a PLAIN (uncompressed) tar shard of JPEGs plus a train.txt-style
  label map (``archive.load_label_map``); member payload offsets come from
  the tar index (``TarInfo.offset_data``) and decode goes through
  ``minibatch.decode_jpeg``.  ``.tar.gz``/``.tgz`` are refused: a gzip
  stream has no random-access byte offsets.
- ``record`` — the native append-only RecordDB of
  ``native/sparknet_native.cpp``: one sequential header scan in Python
  (no ``ctypes`` call, no value bytes touched) locates every committed
  record; values decode with ``createdb.decode_datum``.
- ``leveldb`` — refused as in the JAX package: LevelDB blocks are
  snappy-compressed, so per-record byte offsets do not exist.

Pickling/fork contract: the index (numpy offset/size/label arrays) is built
ONCE in the parent and rides into workers by fork page-sharing (or pickle
under spawn); the mmap/file handles are opened lazily per process
(``__getstate__`` drops them), so a source is safe under any start method.
Nothing here imports torch: the ring's workers make no CUDA call.
"""

from __future__ import annotations

import mmap
import os
import struct
import time

import numpy as np

from sparknet_tpu_torch.data.pipeline import BatchSource

__all__ = ["RecordShardSource", "probe_record_backend"]

_SNDB_HDR = struct.Struct("<IIQ")  # magic, version, committed
_SNDB_MAGIC = 0x534E4442  # "SNDB"
_SNDB_REC = struct.Struct("<II")  # klen, vlen


def probe_record_backend(path: str) -> str:
    """``record`` | ``lmdb`` | ``leveldb`` | ``tar`` | ``unknown`` —
    which indexing strategy (if any) fits the file at ``path``."""
    from sparknet_tpu_torch.data.leveldb_io import is_leveldb
    from sparknet_tpu_torch.data.lmdb_io import is_lmdb

    if is_lmdb(path):
        return "lmdb"
    if is_leveldb(path):
        return "leveldb"
    low = path.lower()
    if low.endswith((".tar", ".tar.gz", ".tgz")):
        return "tar"
    if os.path.isfile(path):
        with open(path, "rb") as f:
            head = f.read(_SNDB_HDR.size)
        if len(head) == _SNDB_HDR.size and \
                _SNDB_HDR.unpack(head)[0] == _SNDB_MAGIC:
            return "record"
    return "unknown"


def _index_record(path: str):
    """Locator walk of the native RecordDB: one sequential header scan
    (no value bytes touched) -> (value_offsets, value_sizes)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(_SNDB_HDR.size)
        magic, version, committed = _SNDB_HDR.unpack(head)
        if magic != _SNDB_MAGIC:
            raise ValueError(f"{path}: not a RecordDB (bad magic)")
        if version != 1:
            raise ValueError(f"{path}: RecordDB version {version} "
                             "(supported: 1)")
        offs = np.empty(committed, np.int64)
        lens = np.empty(committed, np.int64)
        pos = _SNDB_HDR.size
        for i in range(committed):
            if pos + _SNDB_REC.size > size:
                raise ValueError(
                    f"{path}: truncated at record {i}/{committed}")
            f.seek(pos)
            klen, vlen = _SNDB_REC.unpack(f.read(_SNDB_REC.size))
            voff = pos + _SNDB_REC.size + klen
            if voff + vlen > size:
                raise ValueError(
                    f"{path}: record {i} value runs past EOF")
            offs[i] = voff
            lens[i] = vlen
            pos = voff + vlen
    return offs, lens


def _index_lmdb(path: str):
    """Locator walk of an LMDB environment (key order — the reference's
    cursor order, so indexes agree with ``db_minibatches``)."""
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader, _data_file

    locs = []
    with LmdbReader(path) as db:
        for _key, off, size in db.iter_locators():
            locs.append((off, size))
    offs = np.asarray([o for o, _ in locs], np.int64)
    lens = np.asarray([s for _, s in locs], np.int64)
    return _data_file(path), offs, lens


def _index_tar(path: str, label_map: str):
    """Member-payload locators of a PLAIN tar shard + labels resolved
    through the train.txt map (``archive.load_label_map``); members
    missing from the map are skipped (the reference's silent-drop,
    ref: ImageNetLoader.scala:56-86)."""
    import tarfile

    from sparknet_tpu_torch.data.archive import load_label_map

    if path.lower().endswith((".tar.gz", ".tgz")):
        raise ValueError(
            f"{path}: compressed tar shards have no random-access byte "
            "offsets — repack as plain .tar (or stream it through the "
            "threaded feed)")
    if not label_map:
        raise ValueError(
            f"{path}: tar record sources need a label map "
            "(train.txt-style 'filename label' lines)")
    labels = load_label_map(label_map)
    offs, lens, labs = [], [], []
    with tarfile.open(path, "r:") as tf:
        for member in tf:
            if not member.isfile():
                continue
            key = os.path.basename(member.name)
            if key not in labels:
                continue
            offs.append(member.offset_data)
            lens.append(member.size)
            labs.append(labels[key])
    return (np.asarray(offs, np.int64), np.asarray(lens, np.int64),
            np.asarray(labs, np.int32))


class RecordShardSource(BatchSource):
    """Epoch-addressable batches off a record DB / LMDB / tar shard.

    ``get(epoch, index)`` is a pure function of its arguments plus
    construction state (the ``BatchSource`` contract): batch ``index``
    of epoch ``e`` always assembles the same records, record order per
    epoch is a seeded permutation (identity when ``shuffle=False``),
    and ``stride``/``offset`` interleave batches across a multi-process
    job the way the shared-db thread path does (process ``p`` takes
    batches ``p, p+n, ...``).

    Emits RAW wire batches — ``data`` uint8 in the requested layout
    (CHW records transpose here, IN the worker, under nhwc; tar JPEGs
    decode natively HWC), ``label`` int32 — so the thin-wire device-
    augment recipe gets its natural input; compose a
    ``TransformStage`` after it for the host-transform arm.

    ``decode_size``: (height, width) force-resize for the tar/JPEG
    backend (required there — JPEG geometry is per-member); ignored for
    DB backends whose records carry their own shape.
    """

    def __init__(self, path: str, batch: int, *, layout: str = "nchw",
                 shuffle: bool = False, seed: int = 0,
                 decode_size: tuple[int, int] | None = None,
                 label_map: str = "", stride: int = 1, offset: int = 0):
        if batch <= 0:
            raise ValueError(f"batch must be > 0 (got {batch})")
        if stride < 1 or not 0 <= offset < stride:
            raise ValueError(
                f"need stride >= 1 and 0 <= offset < stride "
                f"(got stride={stride}, offset={offset})")
        self.path = path
        self.batch = int(batch)
        self.layout = layout
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.decode_size = tuple(decode_size) if decode_size else None
        self.stride = int(stride)
        self.offset = int(offset)
        self.backend = probe_record_backend(path)
        self._labels = None
        self._data_path = path
        if self.backend == "record":
            self._offs, self._lens = _index_record(path)
        elif self.backend == "lmdb":
            self._data_path, self._offs, self._lens = _index_lmdb(path)
        elif self.backend == "tar":
            self._offs, self._lens, self._labels = _index_tar(
                path, label_map)
            if self.decode_size is None:
                raise ValueError(
                    f"{path}: tar/JPEG records need decode_size=(h, w) "
                    "(per-member geometry varies; the ring's slots are "
                    "fixed-size)")
        elif self.backend == "leveldb":
            raise ValueError(
                f"{path}: LevelDB blocks are snappy-compressed — no "
                "per-record byte offsets exist to index, so this "
                "backend cannot join the process ring.  Re-materialize "
                "with sparknet_tpu_torch.data.createdb.convert_db to the "
                "'record' or 'lmdb' backend (both index natively).")
        else:
            raise ValueError(
                f"{path}: not a RecordDB / LMDB / plain tar shard "
                "(RecordShardSource indexes those three)")
        n = len(self._offs)
        total = n // self.batch
        if total < 1:
            raise ValueError(
                f"{path}: {n} record(s) < batch {self.batch}")
        if self.stride > total:
            raise ValueError(
                f"{path}: stride {self.stride} exceeds the {total} "
                f"batch(es) the shard holds")
        self._total_batches = total
        # one epoch = one full interleave cycle over the shard: index i
        # maps to batch (i*stride + offset) % total, which reproduces
        # the threaded shared-db path exactly (process p takes batches
        # p, p+n, ... of the LOOPED stream; coverage per process is
        # full iff gcd(stride, total) == 1, partial otherwise — same
        # physics as the thread interleave it replaces)
        self.batches_per_epoch = total
        # in-worker decode wall since the last read (pipeline workers
        # harvest + reset this around each get — the `decode` stage)
        self.consume_decode_s = 0.0
        self._mm = None
        self._f = None

    # -- lazy per-process file access -----------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_mm"] = None  # handles never cross a process boundary
        state["_f"] = None
        return state

    def _map(self) -> mmap.mmap:
        if self._mm is None:
            self._f = open(self._data_path, "rb")
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        return self._mm

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def lineage_source(self) -> str | None:
        """The source's durable identity for lineage: names the shard file
        and every :meth:`_record_ids` input but the cursor, so a journal's
        ``(epoch, index)`` window plus this string re-derives the record ids
        each batch assembled (the JAX source's string, character for
        character)."""
        shuffle = f"seed{self.seed}" if self.shuffle else "off"
        return (f"{self.backend}:{os.path.basename(self.path)}"
                f"#batch={self.batch},stride={self.stride},"
                f"offset={self.offset},shuffle={shuffle}")

    # -- the index walk -------------------------------------------------
    def _record_ids(self, epoch: int, index: int) -> np.ndarray:
        """The record ids batch (epoch, index) assembles — the
        deterministic heart of the contract."""
        index = index % self.batches_per_epoch
        b = (index * self.stride + self.offset) % self._total_batches
        if self.shuffle:
            order = np.random.RandomState(
                (self.seed + epoch) & 0x7FFFFFFF).permutation(
                    self._total_batches * self.batch)
            return order[b * self.batch:(b + 1) * self.batch]
        return np.arange(b * self.batch, (b + 1) * self.batch)

    def _decode_value(self, rid: int):
        mm = self._map()
        off, size = int(self._offs[rid]), int(self._lens[rid])
        if self.backend == "record":
            from sparknet_tpu_torch.data.createdb import decode_datum

            return decode_datum(mm[off:off + size])
        if self.backend == "lmdb":
            from sparknet_tpu_torch.data.io_utils import datum_to_array

            return datum_to_array(mm[off:off + size])
        # tar/JPEG
        from sparknet_tpu_torch.data.minibatch import decode_jpeg

        h, w = self.decode_size
        img = decode_jpeg(mm[off:off + size], h, w, layout=self.layout)
        if img is None:
            raise ValueError(
                f"{self.path}: undecodable JPEG member (record {rid}) — "
                "fixed-size ring slots cannot drop records; repack the "
                "shard without it")
        return img, int(self._labels[rid])

    def get(self, epoch: int, index: int) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        imgs, labels = [], []
        for rid in self._record_ids(epoch, index):
            img, label = self._decode_value(int(rid))
            if self.backend != "tar" and self.layout == "nhwc":
                img = img.transpose(1, 2, 0)  # CHW record -> HWC wire
            imgs.append(img)
            labels.append(label)
        batch = {
            "data": np.ascontiguousarray(np.stack(imgs)),
            "label": np.asarray(labels, np.int32),
        }
        self.consume_decode_s += time.perf_counter() - t0
        return batch
