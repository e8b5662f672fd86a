"""Clean-room LevelDB read/write compatibility (no leveldb dependency).

Copy of ``sparknet_tpu/data/leveldb_io.py``; its varints come from the
port's proto2 codec (``sparknet_tpu_torch/proto/binary.py``).  The CRC32C
below is a table walk in pure Python (a few MB/s): LevelDB suits
CIFAR-sized DBs, and ImageNet-sized ones go through the ``record`` backend.

The reference's other DB backend (ref: caffe/src/caffe/util/db_leveldb.cpp
wraps the leveldb library; src/main/scala/preprocessing/CreateDB.scala and
CifarDBApp write LevelDBs through it, and cifar10_full_train_test.prototxt
declares ``backend: LEVELDB``).  No libleveldb exists in this environment,
so — like the sibling ``lmdb_io`` — the published on-disk format is
implemented from its spec:

- **Log files** (``*.log``, also MANIFEST): 32 KiB blocks of
  ``[crc32c(4) len(2) type(1) payload]`` records, fragmented across block
  boundaries as FIRST/MIDDLE/LAST; payloads of data logs are write
  batches ``[seq(8) count(4) entries...]``, each entry
  ``type varint32(klen) key [varint32(vlen) value]``.
- **SSTables** (``*.ldb``/``*.sst``): delta-encoded key blocks with a
  uint32 restart array, 5-byte ``[compression crc32c]`` trailers, an
  index block of BlockHandles, and a 48-byte footer ending in the magic
  ``0xdb4775248b80fb57``.  Values may be snappy-compressed — decoded by
  the pure-Python decoder below.
- **MANIFEST / CURRENT**: VersionEdit records (tagged varint fields)
  naming the comparator, live log number, and per-level table files.
- **CRC32C** (Castagnoli) with LevelDB's rotate+add masking.

Reading merges live SSTs with a replay of the live log (memtable
recovery order), newest sequence wins, deletions drop — so a DB written
by Caffe's CreateDB (which typically leaves every record in the log:
leveldb only flushes the memtable on overflow) reads back exactly.

Writing emits a log-only DB (MANIFEST + CURRENT + one data log), the
state a real leveldb produces before its first compaction and recovers
from on open; ``sst=True`` writes one Level-0 SSTable instead, which
pins the table read path in tests.

Scope bounds (loud, like lmdb_io): no filter/meta blocks are written and
bloom filters in read DBs are ignored (harmless — reads here are full
scans, not point lookups); writing compresses blocks only when
``compress=True`` (a greedy literal+copy2 snappy encoder, kept per
leveldb's >=12.5%-shrink rule); comparators other than
``leveldb.BytewiseComparator`` are rejected.
"""

from __future__ import annotations

import os
import struct

__all__ = [
    "LevelDbReader",
    "LevelDbWriter",
    "is_leveldb",
    "snappy_compress",
    "snappy_decompress",
]

BLOCK_SIZE = 32768  # log block
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4
_TYPE_DELETION, _TYPE_VALUE = 0, 1
_TABLE_MAGIC = 0xDB4775248B80FB57
_MASK_DELTA = 0xA282EAD8
_COMPARATOR = b"leveldb.BytewiseComparator"

# -- CRC32C (Castagnoli 0x82F63B78, table-driven) -----------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc_mask(crc: int) -> int:
    """LevelDB stores CRCs rotated+offset so CRCs of CRCs stay sane."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def crc_unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# -- varints: LevelDB's varint32/64 is the protobuf base-128 varint, so
# reuse the codec the proto wire format already pins (one implementation
# to maintain; data/io_utils.py sets the same precedent)

from sparknet_tpu_torch.proto.binary import _read_varint as _get_varint  # noqa: E402
from sparknet_tpu_torch.proto.binary import _varint as _varint_bytes  # noqa: E402


def _put_varint(out: bytearray, v: int) -> None:
    out += _varint_bytes(v)


# -- snappy block codec -------------------------------------------------


def snappy_compress(src: bytes) -> bytes:
    """Greedy snappy block encoder (literals + 2-byte-offset copies) —
    the format stock leveldb writes per table block.  Correctness over
    ratio: a simple 4-byte-hash matcher, always a valid stream for
    :func:`snappy_decompress` (and real snappy) to decode."""
    out = bytearray()
    _put_varint(out, len(src))
    n = len(src)

    def emit_literal(lo: int, hi: int) -> None:
        while lo < hi:
            ln = min(hi - lo, 60)
            out.append((ln - 1) << 2)
            out.extend(src[lo : lo + ln])
            lo += ln

    table: dict[int, int] = {}
    pos = lit_start = 0
    while pos + 4 <= n:
        key = int.from_bytes(src[pos : pos + 4], "little")
        cand = table.get(key)
        table[key] = pos
        if (
            cand is not None
            and pos - cand <= 0xFFFF
            and src[cand : cand + 4] == src[pos : pos + 4]
        ):
            length = 4
            while (
                pos + length < n
                and length < 64
                and src[cand + length] == src[pos + length]
            ):
                length += 1
            emit_literal(lit_start, pos)
            out.append(((length - 1) << 2) | 2)  # copy, 2-byte offset
            out += (pos - cand).to_bytes(2, "little")
            pos += length
            lit_start = pos
        else:
            pos += 1
    emit_literal(lit_start, n)
    return bytes(out)


def snappy_decompress(src: bytes) -> bytes:
    """Pure-Python snappy frame-less block decode (the format LevelDB
    embeds per block): varint uncompressed length, then literal/copy
    tagged elements."""
    n, pos = _get_varint(src, 0)
    out = bytearray()
    while pos < len(src):
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:  # length stored in the next 1-4 bytes
                extra = ln - 59
                ln = int.from_bytes(src[pos : pos + extra], "little")
                pos += extra
            ln += 1
            out += src[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos : pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("snappy: bad copy offset")
        # overlapping copies are the RLE trick: copy byte-at-a-time
        for _ in range(ln):
            out.append(out[-off])
    if len(out) != n:
        raise ValueError(f"snappy: declared {n} bytes, produced {len(out)}")
    return bytes(out)


# -- log format ---------------------------------------------------------


def _log_records(raw: bytes):
    """Yield logical records from a log file (fragments reassembled);
    stops cleanly at a truncated tail (leveldb treats that as EOF —
    a crashed writer's half record is not corruption)."""
    pos = 0
    partial = bytearray()
    while pos + 7 <= len(raw):
        block_left = BLOCK_SIZE - (pos % BLOCK_SIZE)
        if block_left < 7:  # trailer padding
            pos += block_left
            continue
        masked, length, rtype = struct.unpack_from("<IHB", raw, pos)
        if rtype == 0 and masked == 0 and length == 0:
            break  # zeroed preallocated space = end
        payload = raw[pos + 7 : pos + 7 + length]
        if len(payload) < length:
            break  # truncated tail
        if crc_unmask(masked) != crc32c(bytes([rtype]) + payload):
            raise ValueError("log record CRC mismatch")
        pos += 7 + length
        if rtype == _FULL:
            yield bytes(payload)
        elif rtype == _FIRST:
            partial = bytearray(payload)
        elif rtype == _MIDDLE:
            partial += payload
        elif rtype == _LAST:
            partial += payload
            yield bytes(partial)
            partial = bytearray()
        else:
            raise ValueError(f"unknown log record type {rtype}")


def _write_log_records(payloads) -> bytes:
    """Serialize logical records into 32 KiB-blocked log format."""
    out = bytearray()
    for payload in payloads:
        first = True
        mv = memoryview(bytes(payload))
        while True:
            block_left = BLOCK_SIZE - (len(out) % BLOCK_SIZE)
            if block_left < 7:
                out += b"\x00" * block_left
                continue
            avail = block_left - 7
            frag, mv = mv[:avail], mv[avail:]
            end = len(mv) == 0
            rtype = (
                _FULL if first and end else
                _FIRST if first else
                _LAST if end else _MIDDLE
            )
            out += struct.pack(
                "<IHB", crc_mask(crc32c(bytes([rtype]) + bytes(frag))),
                len(frag), rtype,
            )
            out += frag
            first = False
            if end:
                break
    return bytes(out)


# -- write batches ------------------------------------------------------


def _decode_batch(payload: bytes):
    """Yield (seq, type, key, value) from a write-batch log payload."""
    if len(payload) < 12:
        raise ValueError("short write batch")
    seq, count = struct.unpack_from("<QI", payload, 0)
    pos = 12
    for i in range(count):
        t = payload[pos]
        pos += 1
        klen, pos = _get_varint(payload, pos)
        key = payload[pos : pos + klen]
        pos += klen
        if t == _TYPE_VALUE:
            vlen, pos = _get_varint(payload, pos)
            value = payload[pos : pos + vlen]
            pos += vlen
        elif t == _TYPE_DELETION:
            value = b""
        else:
            raise ValueError(f"unknown batch entry type {t}")
        yield seq + i, t, bytes(key), bytes(value)


def _encode_batch(seq: int, items) -> bytes:
    out = bytearray(struct.pack("<QI", seq, len(items)))
    for key, value in items:
        out.append(_TYPE_VALUE)
        _put_varint(out, len(key))
        out += key
        _put_varint(out, len(value))
        out += value
    return bytes(out)


# -- SSTable ------------------------------------------------------------


def _decode_block(data: bytes):
    """Yield (key, value) from one table block (delta-encoded entries)."""
    if len(data) < 4:
        raise ValueError("short table block")
    n_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    limit = len(data) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _get_varint(data, pos)
        non_shared, pos = _get_varint(data, pos)
        vlen, pos = _get_varint(data, pos)
        key = key[:shared] + data[pos : pos + non_shared]
        pos += non_shared
        value = data[pos : pos + vlen]
        pos += vlen
        yield bytes(key), bytes(value)


def _read_table_block(raw: bytes, offset: int, size: int) -> bytes:
    data = raw[offset : offset + size]
    ctype = raw[offset + size]
    stored = struct.unpack_from("<I", raw, offset + size + 1)[0]
    if crc_unmask(stored) != crc32c(raw[offset : offset + size + 1]):
        raise ValueError("table block CRC mismatch")
    if ctype == 0:
        return data
    if ctype == 1:
        return snappy_decompress(data)
    raise ValueError(f"unsupported block compression {ctype}")


def _sst_entries(raw: bytes):
    """Yield (seq, type, user_key, value) from an SSTable's data blocks."""
    if len(raw) < 48:
        raise ValueError("SSTable shorter than its footer")
    footer = raw[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError("bad SSTable magic")
    pos = 0
    _mi_off, pos = _get_varint(footer, pos)
    _mi_size, pos = _get_varint(footer, pos)
    idx_off, pos = _get_varint(footer, pos)
    idx_size, pos = _get_varint(footer, pos)
    index = _read_table_block(raw, idx_off, idx_size)
    for _key, handle in _decode_block(index):
        hpos = 0
        b_off, hpos = _get_varint(handle, hpos)
        b_size, hpos = _get_varint(handle, hpos)
        block = _read_table_block(raw, b_off, b_size)
        for ikey, value in _decode_block(block):
            if len(ikey) < 8:
                raise ValueError("internal key shorter than its trailer")
            trailer = struct.unpack("<Q", ikey[-8:])[0]
            yield trailer >> 8, trailer & 0xFF, ikey[:-8], value


def _encode_block(entries, restart_interval: int = 16) -> bytes:
    out = bytearray()
    restarts = []
    prev = b""
    for i, (key, value) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            for a, b in zip(prev, key):
                if a != b:
                    break
                shared += 1
        _put_varint(out, shared)
        _put_varint(out, len(key) - shared)
        _put_varint(out, len(value))
        out += key[shared:]
        out += value
        prev = key
    for r in restarts or [0]:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts) or 1)
    return bytes(out)


def _append_block(out: bytearray, block: bytes,
                  compress: bool = False) -> tuple[int, int]:
    """Write block + [compression, crc] trailer; return its handle.
    ``compress``: snappy the block, kept only if it actually shrinks by
    >=12.5% (leveldb's own keep-compressed rule, table/table_builder.cc)."""
    data, ctype = block, 0
    if compress:
        packed = snappy_compress(block)
        if len(packed) < len(block) - len(block) // 8:
            data, ctype = packed, 1
    handle = (len(out), len(data))
    out += data
    out.append(ctype)
    out += struct.pack("<I", crc_mask(crc32c(data + bytes([ctype]))))
    return handle


def _encode_sst(items, seq_base: int = 1, compress: bool = False) -> bytes:
    """One SSTable holding ``items`` (sorted (key, value) pairs)."""
    out = bytearray()
    index_entries = []
    BLOCK_TARGET = 4096  # leveldb's block_size option default
    batch: list[tuple[bytes, bytes]] = []
    batch_bytes = 0

    def flush():
        nonlocal batch, batch_bytes
        if not batch:
            return
        handle = _append_block(out, _encode_block(batch), compress)
        h = bytearray()
        _put_varint(h, handle[0])
        _put_varint(h, handle[1])
        # index key: the block's last internal key (>= separator works)
        index_entries.append((batch[-1][0], bytes(h)))
        batch, batch_bytes = [], 0

    for i, (key, value) in enumerate(items):
        ikey = key + struct.pack("<Q", ((seq_base + i) << 8) | _TYPE_VALUE)
        batch.append((ikey, value))
        batch_bytes += len(ikey) + len(value)
        if batch_bytes >= BLOCK_TARGET:
            flush()
    flush()
    mi_handle = _append_block(out, _encode_block([]))  # empty metaindex
    idx_handle = _append_block(out, _encode_block(index_entries))
    footer = bytearray()
    for v in (*mi_handle, *idx_handle):
        _put_varint(footer, v)
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    return bytes(out)


# -- VersionEdit --------------------------------------------------------

_TAG_COMPARATOR = 1
_TAG_LOG_NUMBER = 2
_TAG_NEXT_FILE = 3
_TAG_LAST_SEQ = 4
_TAG_COMPACT_POINTER = 5
_TAG_DELETED_FILE = 6
_TAG_NEW_FILE = 7
_TAG_PREV_LOG = 9


def _decode_version_edit(payload: bytes, state: dict) -> None:
    pos = 0
    while pos < len(payload):
        tag, pos = _get_varint(payload, pos)
        if tag == _TAG_COMPARATOR:
            ln, pos = _get_varint(payload, pos)
            state["comparator"] = payload[pos : pos + ln]
            pos += ln
        elif tag in (_TAG_LOG_NUMBER, _TAG_NEXT_FILE, _TAG_LAST_SEQ,
                     _TAG_PREV_LOG):
            v, pos = _get_varint(payload, pos)
            state[{
                _TAG_LOG_NUMBER: "log_number",
                _TAG_NEXT_FILE: "next_file",
                _TAG_LAST_SEQ: "last_seq",
                _TAG_PREV_LOG: "prev_log",
            }[tag]] = v
        elif tag == _TAG_COMPACT_POINTER:
            _lvl, pos = _get_varint(payload, pos)
            ln, pos = _get_varint(payload, pos)
            pos += ln
        elif tag == _TAG_DELETED_FILE:
            lvl, pos = _get_varint(payload, pos)
            fnum, pos = _get_varint(payload, pos)
            state.setdefault("files", {}).pop((lvl, fnum), None)
        elif tag == _TAG_NEW_FILE:
            lvl, pos = _get_varint(payload, pos)
            fnum, pos = _get_varint(payload, pos)
            fsize, pos = _get_varint(payload, pos)
            ln, pos = _get_varint(payload, pos)
            smallest = payload[pos : pos + ln]
            pos += ln
            ln, pos = _get_varint(payload, pos)
            largest = payload[pos : pos + ln]
            pos += ln
            state.setdefault("files", {})[(lvl, fnum)] = (
                fsize, smallest, largest)
        else:
            raise ValueError(f"unknown VersionEdit tag {tag}")


def _encode_version_edit(*, comparator=None, log_number=None,
                         next_file=None, last_seq=None,
                         new_files=()) -> bytes:
    out = bytearray()
    if comparator is not None:
        _put_varint(out, _TAG_COMPARATOR)
        _put_varint(out, len(comparator))
        out += comparator
    if log_number is not None:
        _put_varint(out, _TAG_LOG_NUMBER)
        _put_varint(out, log_number)
    if next_file is not None:
        _put_varint(out, _TAG_NEXT_FILE)
        _put_varint(out, next_file)
    if last_seq is not None:
        _put_varint(out, _TAG_LAST_SEQ)
        _put_varint(out, last_seq)
    for lvl, fnum, fsize, smallest, largest in new_files:
        _put_varint(out, _TAG_NEW_FILE)
        _put_varint(out, lvl)
        _put_varint(out, fnum)
        _put_varint(out, fsize)
        _put_varint(out, len(smallest))
        out += smallest
        _put_varint(out, len(largest))
        out += largest
    return bytes(out)


# -- public API ---------------------------------------------------------


def is_leveldb(path: str) -> bool:
    """A LevelDB env is a directory holding a CURRENT file that names a
    MANIFEST."""
    current = os.path.join(path, "CURRENT")
    try:
        with open(current, "rb") as f:
            name = f.read(64).strip()
        return name.startswith(b"MANIFEST-")
    except OSError:
        return False


class LevelDbReader:
    """Merged view of a LevelDB directory: SSTs + live-log replay,
    newest sequence wins, deletions dropped.  Iterates (key, value)
    sorted by key — the Cursor contract ``db_leveldb.cpp`` exposes.

    Memory model: SSTables stream lazily (a heap-merge over per-table
    sorted iterators — an ImageNet-scale DB never materializes), while
    the live LOG loads into a dict overlay.  The log is the recovered
    memtable, which a real leveldb bounds at ``write_buffer_size``
    (~4 MB) before flushing to L0 — only DBs written by this module's
    own log-only writer carry everything in the log, and those are
    bounded by what this process chose to write."""

    def __init__(self, path: str):
        self.path = path
        if not is_leveldb(path):
            raise ValueError(f"{path!r} is not a LevelDB directory")
        with open(os.path.join(path, "CURRENT"), "rb") as f:
            manifest = f.read().strip().decode()
        state: dict = {}
        with open(os.path.join(path, manifest), "rb") as f:
            for payload in _log_records(f.read()):
                _decode_version_edit(payload, state)
        comparator = state.get("comparator", _COMPARATOR)
        if comparator != _COMPARATOR:
            raise ValueError(
                f"unsupported comparator {comparator!r} (scope bound: "
                "only leveldb.BytewiseComparator)"
            )
        self._tables = []
        for (_lvl, fnum), _meta in sorted(state.get("files", {}).items()):
            fname = os.path.join(path, f"{fnum:06d}.ldb")
            if not os.path.exists(fname):
                fname = os.path.join(path, f"{fnum:06d}.sst")
            self._tables.append(fname)
        self._live_log = state.get("log_number", 0)
        # memtable overlay (newest-wins dict of (seq, type, value)) —
        # built LAZILY at first iteration: opening a DB for a one-record
        # probe (peek_db_shape) must not replay the whole live log, and
        # the auto-SST writer keeps bulk data out of the log anyway
        self._overlay_cache: dict[bytes, tuple[int, int, bytes]] | None = None
        self._count: int | None = None

    @property
    def _overlay(self) -> dict[bytes, tuple[int, int, bytes]]:
        if self._overlay_cache is None:
            overlay: dict[bytes, tuple[int, int, bytes]] = {}
            logs = sorted(
                int(n.split(".")[0]) for n in os.listdir(self.path)
                if n.endswith(".log") and int(n.split(".")[0]) >= self._live_log
            )
            for fnum in logs:
                with open(os.path.join(self.path, f"{fnum:06d}.log"), "rb") as f:
                    for payload in _log_records(f.read()):
                        for seq, t, key, value in _decode_batch(payload):
                            cur = overlay.get(key)
                            if cur is None or seq >= cur[0]:
                                overlay[key] = (seq, t, value)
            self._overlay_cache = overlay
        return self._overlay_cache

    def _merged(self):
        """Lazy (key, seq, type, value) stream, sorted by key, newest
        sequence winning across tables and the log overlay."""
        import heapq
        import mmap

        def table_iter(fname):
            # mmap instead of read(): a short iteration (the DataLayer
            # geometry peek) touches only the first blocks; the OS pages
            # in what the parse actually slices
            with open(fname, "rb") as f:
                raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                try:
                    for seq, t, key, value in _sst_entries(raw):
                        yield key, seq, t, value
                finally:
                    raw.close()

        streams = [table_iter(f) for f in self._tables]
        streams.append(
            (k, s, t, v)
            for k, (s, t, v) in sorted(self._overlay.items())
        )
        # order by (key, -seq): the first entry of each key group is the
        # newest version; skip the rest of the group
        merged = heapq.merge(*streams, key=lambda e: (e[0], -e[1]))
        current = None
        for key, seq, t, value in merged:
            if key == current:
                continue
            current = key
            yield key, seq, t, value

    def __len__(self) -> int:
        if self._count is None:
            self._count = sum(
                1 for _k, _s, t, _v in self._merged() if t == _TYPE_VALUE
            )
        return self._count

    def __iter__(self):
        for key, _seq, t, value in self._merged():
            if t == _TYPE_VALUE:
                yield key, value

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class LevelDbWriter:
    """Write a LevelDB env from scratch.  ``sst=None`` (default) mimics a
    real leveldb's memtable policy: small writes stay in the live log
    (recovered on open — CreateDB's typical end state), but once the
    buffered payload passes ``write_buffer_size`` (~4 MB, the bound a
    real memtable flushes at) the records are written as one Level-0
    SSTable instead, so readers heap-merge from disk rather than replay
    a dataset-sized log into RAM.  ``sst=True``/``False`` force either.

    Same buffered-commit contract as ``LmdbWriter``: everything is
    written durably at ``close()``."""

    WRITE_BUFFER_SIZE = 4 << 20  # leveldb options.write_buffer_size default

    def __init__(self, path: str, *, sst: bool | None = None,
                 compress: bool = False):
        self.path = path
        self.sst = sst
        self.compress = compress
        self._items: dict[bytes, bytes] = {}
        self._bytes = 0
        self._closed = False
        os.makedirs(path, exist_ok=True)
        # refuse a live destination: leftover NNNNNN.log/.ldb files would
        # be merged into the new DB at read time (log replay picks up
        # every log >= the manifest's number, and stale records carry
        # higher sequences than a fresh writer's — silent corruption)
        stale = [
            n for n in os.listdir(path)
            if n.endswith((".log", ".ldb", ".sst"))
            or n.startswith("MANIFEST-") or n == "CURRENT"
        ]
        if stale:
            raise ValueError(
                f"{path!r} already holds LevelDB files ({sorted(stale)[:3]}"
                f"...); refusing to overlay a new DB on an old one — "
                "remove the directory first"
            )

    def put(self, key: bytes, value: bytes) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        if not isinstance(key, bytes) or not key:
            raise ValueError("key must be non-empty bytes")
        old = self._items.get(key)
        if old is not None:
            self._bytes -= len(key) + len(old)
        self._items[key] = value
        self._bytes += len(key) + len(value)

    _commit_warned = False

    def commit(self) -> None:
        """Deferred like LmdbWriter.commit (durability at close)."""
        if not LevelDbWriter._commit_warned:
            LevelDbWriter._commit_warned = True
            import sys

            print(
                "LevelDbWriter.commit() is deferred: all records are "
                "buffered in memory and written durably at close(); for "
                "incremental commit durability use the RecordDB backend",
                file=sys.stderr,
            )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        items = sorted(self._items.items())
        seq = len(items)
        sst = (self._bytes > self.WRITE_BUFFER_SIZE
               if self.sst is None else self.sst)
        if sst:
            table = (_encode_sst(items, compress=self.compress)
                     if items else None)
            new_files = []
            if table is not None:
                smallest = items[0][0] + struct.pack(
                    "<Q", (1 << 8) | _TYPE_VALUE)
                largest = items[-1][0] + struct.pack(
                    "<Q", (seq << 8) | _TYPE_VALUE)
                with open(os.path.join(self.path, "000005.ldb"), "wb") as f:
                    f.write(table)
                new_files.append((0, 5, len(table), smallest, largest))
            log_number, next_file = 6, 7
            with open(os.path.join(self.path, "000006.log"), "wb") as f:
                f.write(b"")  # fresh empty live log
            edit = _encode_version_edit(
                comparator=_COMPARATOR, log_number=log_number,
                next_file=next_file, last_seq=seq, new_files=new_files,
            )
        else:
            with open(os.path.join(self.path, "000003.log"), "wb") as f:
                if items:
                    f.write(_write_log_records([_encode_batch(1, items)]))
            edit = _encode_version_edit(
                comparator=_COMPARATOR, log_number=3, next_file=4,
                last_seq=seq,
            )
        with open(os.path.join(self.path, "MANIFEST-000002"), "wb") as f:
            f.write(_write_log_records([edit]))
        with open(os.path.join(self.path, "CURRENT"), "wb") as f:
            f.write(b"MANIFEST-000002\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
