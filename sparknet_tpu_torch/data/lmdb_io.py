"""Clean-room pure-Python LMDB codec — Caffe dataset compatibility.

Copy of ``sparknet_tpu/data/lmdb_io.py`` (mmap and struct only), so the
port reads and writes the same environments as the JAX package.

The reference reads and writes its datasets as LMDB environments
(ref: caffe/src/caffe/util/db_lmdb.cpp:1-100 — Cursor/Transaction over
liblmdb; ref: src/main/scala/preprocessing/CreateDB.scala writes them
through the shim), so "drop-in on existing Caffe data" means speaking the
LMDB on-disk format.  liblmdb is not present in this environment and no
binding ships with the framework, so this module implements the format
itself, from the published layout (Symas LMDB, file format v1):

- 4096-byte pages; pages 0 and 1 are dual meta pages (the reader picks
  the one with the higher ``txnid``), magic ``0xBEEFC0DE``.
- B+tree of BRANCH/LEAF pages.  A page holds a sorted ``uint16`` node
  offset array growing up from the 16-byte header and nodes growing down
  from the page end; ``lower``/``upper`` bound the free gap.
- Leaf node: ``u16 lo, hi, flags, ksize`` + key + value; value length is
  ``lo | hi<<16``.  ``F_BIGDATA`` (0x01) stores an 8-byte overflow page
  number instead of the value; OVERFLOW page runs carry the value with a
  ``u32`` page count overlaying ``lower``/``upper``.
- Branch node: same header with the child page number packed into
  ``lo | hi<<16 | flags<<32``; the first node of a branch has an empty
  key.  Keys order by memcmp, matching Caffe's ``%08d`` string keys.

Scope: the main (unnamed) database with default flags — exactly what
Caffe's ``db::GetDB("lmdb")`` produces.  Named/DUPSORT/LEAF2 sub-DBs are
out of scope and rejected loudly.  The writer emits a single-transaction
environment (txnid 1) that this reader — and, by the format, liblmdb —
can open; there is no liblmdb in this image to cross-validate against,
so the round-trip tests pin the layout via byte-level invariants
(the JAX package's tests/test_lmdb.py; the port's environments read back in
the JAX reader and the other way round, tests/test_torch_port_feed.py).
"""

from __future__ import annotations

import mmap
import os
import struct

PAGESIZE = 4096
PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

P_INVALID = 2**64 - 1

_PAGEHDR = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")  # lo, hi, flags, ksize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf, entries, root
_META_HEAD = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_META_TAIL = struct.Struct("<QQ")  # last_pg, txnid

# Values whose node would not fit half a page go to overflow pages
# (liblmdb's nodemax rule, mdb.c: full node <= (pagesize - 16) / 2).
_NODE_MAX = (PAGESIZE - PAGEHDRSZ) // 2 - _NODEHDR.size


def _data_file(path: str) -> str:
    """LMDB environments are directories holding ``data.mdb``; a bare
    file (MDB_NOSUBDIR) is accepted too."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


def is_lmdb(path: str) -> bool:
    """True when ``path`` looks like an LMDB environment (meta magic)."""
    f = _data_file(path)
    if not os.path.isfile(f):
        return False
    with open(f, "rb") as fh:
        page = fh.read(PAGEHDRSZ + 8)
    if len(page) < PAGEHDRSZ + 8:
        return False
    magic, _ = struct.unpack_from("<II", page, PAGEHDRSZ)
    return magic == MAGIC


class LmdbReader:
    """Read-only cursor over an LMDB environment's main database.

    Iterates ``(key, value)`` byte pairs in key order — the role of
    ``LMDBCursor`` (ref: db_lmdb.cpp:40-72) without liblmdb.
    """

    def __init__(self, path: str):
        self._path = _data_file(path)
        self._f = open(self._path, "rb")
        try:
            self._map = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            self._f.close()
            raise ValueError(f"{path}: empty file is not an LMDB environment")
        try:
            self._root, self._entries, self._depth = self._read_meta()
        except Exception:
            self.close()
            raise

    # -- low level ----------------------------------------------------
    def _page(self, pgno: int) -> memoryview:
        off = pgno * PAGESIZE
        if off + PAGESIZE > len(self._map):
            raise ValueError(f"{self._path}: page {pgno} out of bounds")
        return memoryview(self._map)[off : off + PAGESIZE]

    def _read_meta(self):
        best = None
        for pgno in (0, 1):
            # plain-bytes slice (no exported memoryview: close() must
            # stay possible on the error path)
            raw = self._map[pgno * PAGESIZE : (pgno + 1) * PAGESIZE]
            if len(raw) < PAGEHDRSZ + _META_HEAD.size:
                continue
            magic, version, _, _ = _META_HEAD.unpack_from(raw, PAGEHDRSZ)
            if magic != MAGIC:
                continue
            if version != VERSION:
                raise ValueError(
                    f"{self._path}: LMDB format version {version} "
                    f"(supported: {VERSION})"
                )
            db_off = PAGEHDRSZ + _META_HEAD.size + _DB.size  # main DB
            main = _DB.unpack_from(raw, db_off)
            txnid = _META_TAIL.unpack_from(raw, db_off + _DB.size)[1]
            if best is None or txnid > best[0]:
                best = (txnid, main)
        if best is None:
            raise ValueError(f"{self._path}: no valid LMDB meta page")
        _, (pad, flags, depth, _, _, _, entries, root) = best
        if flags != 0:  # main DB with non-default flags (dupsort etc.)
            raise NotImplementedError(
                f"{self._path}: main DB flags {flags:#x} unsupported "
                "(only default Caffe-style environments)"
            )
        return root, entries, depth

    # -- iteration ----------------------------------------------------
    def __len__(self) -> int:
        return self._entries

    def __iter__(self):
        if self._root == P_INVALID:
            return
        yield from self._walk(self._root)

    def _walk(self, pgno: int):
        page = self._page(pgno)
        _, _, flags, lower, upper = _PAGEHDR.unpack_from(page)
        if flags & P_LEAF2:
            raise NotImplementedError("LEAF2 (fixed-key) pages unsupported")
        n = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{n}H", page, PAGEHDRSZ)
        if flags & P_LEAF:
            for off in ptrs:
                yield self._leaf_node(page, off)
        elif flags & P_BRANCH:
            for off in ptrs:
                lo, hi, nflags, _ = _NODEHDR.unpack_from(page, off)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        else:
            raise ValueError(f"{self._path}: page {pgno} flags {flags:#x}")

    def iter_locators(self):
        """``(key, absolute_value_offset, value_size)`` per record, in
        key order — the byte-offset shard index the process-ring record
        source builds once at open (``data/records.py``): the bytes at
        ``[offset, offset + size)`` of the data file are exactly the
        value ``__iter__`` yields.  Inline values locate inside their
        leaf page; ``F_BIGDATA`` values at their overflow run's payload
        (one page header, then the value contiguous — the writer's
        OVPAGES rule)."""
        if self._root == P_INVALID:
            return
        yield from self._walk_locators(self._root)

    def _walk_locators(self, pgno: int):
        page = self._page(pgno)
        _, _, flags, lower, _ = _PAGEHDR.unpack_from(page)
        if flags & P_LEAF2:
            raise NotImplementedError("LEAF2 (fixed-key) pages unsupported")
        n = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{n}H", page, PAGEHDRSZ)
        base = pgno * PAGESIZE
        if flags & P_LEAF:
            for off in ptrs:
                lo, hi, nflags, ksize = _NODEHDR.unpack_from(page, off)
                if nflags & (F_SUBDATA | F_DUPDATA):
                    raise NotImplementedError("DUPSORT nodes unsupported")
                key = bytes(
                    page[off + _NODEHDR.size : off + _NODEHDR.size + ksize])
                dsize = lo | (hi << 16)
                dstart = off + _NODEHDR.size + ksize
                if nflags & F_BIGDATA:
                    (ovf,) = struct.unpack_from("<Q", page, dstart)
                    yield key, ovf * PAGESIZE + PAGEHDRSZ, dsize
                else:
                    yield key, base + dstart, dsize
        elif flags & P_BRANCH:
            for off in ptrs:
                lo, hi, nflags, _ = _NODEHDR.unpack_from(page, off)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk_locators(child)
        else:
            raise ValueError(f"{self._path}: page {pgno} flags {flags:#x}")

    def _leaf_node(self, page: memoryview, off: int) -> tuple[bytes, bytes]:
        lo, hi, nflags, ksize = _NODEHDR.unpack_from(page, off)
        if nflags & (F_SUBDATA | F_DUPDATA):
            raise NotImplementedError("DUPSORT nodes unsupported")
        key = bytes(page[off + _NODEHDR.size : off + _NODEHDR.size + ksize])
        dsize = lo | (hi << 16)
        dstart = off + _NODEHDR.size + ksize
        if nflags & F_BIGDATA:
            (ovf,) = struct.unpack_from("<Q", page, dstart)
            return key, self._overflow(ovf, dsize)
        return key, bytes(page[dstart : dstart + dsize])

    def _overflow(self, pgno: int, size: int) -> bytes:
        start = pgno * PAGESIZE + PAGEHDRSZ
        return bytes(memoryview(self._map)[start : start + size])

    # -- lifecycle ----------------------------------------------------
    def close(self) -> None:
        if getattr(self, "_map", None) is not None:
            self._map.close()
            self._map = None
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LmdbWriter:
    """Single-transaction LMDB environment writer.

    Collects puts in memory, then materializes a valid environment on
    ``close``: sorted leaf pages, branch levels up to a root, dual meta
    pages with txnid 1.  The role of ``LMDBTransaction::Put/Commit``
    (ref: db_lmdb.cpp:74-100) for dataset creation jobs.

    Memory bound: the whole dataset is held in RAM while building (put
    order is unconstrained, so sorting happens at close; peak ~2x the
    value bytes).  Right-sized for fixtures and CIFAR-scale sets; for
    ingesting a huge existing Caffe LMDB convert the *other* direction
    (`LmdbReader` streams).
    """

    def __init__(self, path: str, subdir: bool = True):
        self._path = path
        self._subdir = subdir
        self._items: dict[bytes, bytes] = {}
        self._closed = False

    def put(self, key: bytes, value: bytes) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        if not 0 < len(key) <= 511:  # liblmdb's default MDB_MAXKEYSIZE
            raise ValueError(f"key length {len(key)} outside (0, 511]")
        self._items[bytes(key)] = bytes(value)

    def commit(self) -> None:
        """Accepted for API symmetry with a cursor writer; the single
        durable commit happens at close.  Warn once so large ingests
        relying on the reference's every-1000-records durability cadence
        know the data stays in RAM until close()."""
        if not getattr(self, "_commit_warned", False):
            self._commit_warned = True
            import logging

            logging.getLogger(__name__).warning(
                "LmdbWriter.commit() is deferred: all records are buffered "
                "in memory and written durably at close()"
            )

    # -- page assembly -------------------------------------------------
    def _build(self) -> bytes:
        pages: list[bytes | None] = [None, None]  # metas patched last

        def alloc() -> int:
            pages.append(None)
            return len(pages) - 1

        def page_bytes(pgno, flags, nodes) -> bytes:
            """nodes: [(header+key+data bytes)] already sized to fit."""
            ptrs, blobs = [], []
            top = PAGESIZE
            for blob in nodes:
                size = len(blob) + (len(blob) & 1)  # 2-byte alignment
                top -= size
                ptrs.append(top)
                blobs.append((top, blob))
            lower = PAGEHDRSZ + 2 * len(nodes)
            if lower > top:
                raise AssertionError("page overflow (packing bug)")
            buf = bytearray(PAGESIZE)
            _PAGEHDR.pack_into(buf, 0, pgno, 0, flags, lower, top)
            struct.pack_into(f"<{len(ptrs)}H", buf, PAGEHDRSZ, *ptrs)
            for off, blob in blobs:
                buf[off : off + len(blob)] = blob
            return bytes(buf)

        items = sorted(self._items.items())
        n_overflow = 0

        # -- leaves (+ overflow runs for big values) --
        leaf_specs: list[tuple[int, bytes, list[bytes]]] = []
        cur_nodes: list[bytes] = []
        cur_used = 0

        def flush_leaf():
            nonlocal cur_nodes, cur_used
            if cur_nodes:
                pgno = alloc()
                leaf_specs.append((pgno, cur_first_key[0], list(cur_nodes)))
                cur_nodes, cur_used = [], 0

        cur_first_key = [b""]
        flat_nodes: list[bytearray] = []

        for key, value in items:
            inline = _NODEHDR.size + len(key) + len(value) <= _NODE_MAX
            if inline:
                blob = bytearray(_NODEHDR.size + len(key) + len(value))
                _NODEHDR.pack_into(
                    blob, 0, len(value) & 0xFFFF, len(value) >> 16, 0, len(key)
                )
                blob[_NODEHDR.size : _NODEHDR.size + len(key)] = key
                blob[_NODEHDR.size + len(key) :] = value
            else:
                blob = bytearray(_NODEHDR.size + len(key) + 8)
                _NODEHDR.pack_into(
                    blob,
                    0,
                    len(value) & 0xFFFF,
                    len(value) >> 16,
                    F_BIGDATA,
                    len(key),
                )
                blob[_NODEHDR.size : _NODEHDR.size + len(key)] = key
                # overflow pgno patched once allocated (below)
            size = len(blob) + (len(blob) & 1)
            if cur_used + size + 2 > PAGESIZE - PAGEHDRSZ:
                flush_leaf()
            if not cur_nodes:
                cur_first_key[0] = key
            cur_nodes.append(blob)
            flat_nodes.append(blob)
            cur_used += size + 2
            if not inline:
                # liblmdb's OVPAGES: the value sits contiguously after ONE
                # 16-byte page header, so pages = ceil((size+hdr)/pagesize)
                # — not ceil(size/(pagesize-hdr)), which over-allocates.
                npages = -(-(len(value) + PAGEHDRSZ) // PAGESIZE)
                first = alloc()
                for i in range(1, npages):
                    alloc()
                n_overflow += npages
                struct.pack_into("<Q", blob, _NODEHDR.size + len(key), first)
                hdr = bytearray(PAGEHDRSZ)
                _PAGEHDR.pack_into(hdr, 0, first, 0, P_OVERFLOW, 0, 0)
                struct.pack_into("<I", hdr, 12, npages)  # page-count union
                run = bytes(hdr) + value
                run += b"\x00" * (npages * PAGESIZE - len(run))
                for i in range(npages):
                    pages[first + i] = run[i * PAGESIZE : (i + 1) * PAGESIZE]
        flush_leaf()

        for pgno, _, nodes in leaf_specs:
            pages[pgno] = page_bytes(pgno, P_LEAF, [bytes(b) for b in nodes])

        # -- branch levels --
        level = [(pgno, first) for pgno, first, _ in leaf_specs]
        depth = 1 if level else 0
        n_branch = 0
        while len(level) > 1:
            next_level = []
            i = 0
            while i < len(level):
                nodes, first_key = [], level[i][1]
                used = 0
                j = i
                while j < len(level):
                    child, key = level[j]
                    ksize = 0 if j == i else len(key)
                    blob = bytearray(_NODEHDR.size + ksize)
                    _NODEHDR.pack_into(
                        blob,
                        0,
                        child & 0xFFFF,
                        (child >> 16) & 0xFFFF,
                        (child >> 32) & 0xFFFF,
                        ksize,
                    )
                    if ksize:
                        blob[_NODEHDR.size :] = key
                    size = len(blob) + (len(blob) & 1)
                    if used + size + 2 > PAGESIZE - PAGEHDRSZ:
                        break
                    nodes.append(bytes(blob))
                    used += size + 2
                    j += 1
                pgno = alloc()
                pages[pgno] = page_bytes(pgno, P_BRANCH, nodes)
                n_branch += 1
                next_level.append((pgno, first_key))
                i = j
            level = next_level
            depth += 1
        root = level[0][0] if level else P_INVALID

        # -- metas --
        last_pg = len(pages) - 1
        mapsize = max(len(pages) * PAGESIZE, 1 << 20)
        for meta_pgno, txnid in ((0, 0), (1, 1)):
            buf = bytearray(PAGESIZE)
            _PAGEHDR.pack_into(buf, 0, meta_pgno, 0, P_META, 0, 0)
            _META_HEAD.pack_into(buf, PAGEHDRSZ, MAGIC, VERSION, 0, mapsize)
            off = PAGEHDRSZ + _META_HEAD.size
            # free DB: empty
            _DB.pack_into(buf, off, 0, 0, 0, 0, 0, 0, 0, P_INVALID)
            # main DB
            _DB.pack_into(
                buf,
                off + _DB.size,
                0,
                0,
                depth,
                n_branch,
                len(leaf_specs),
                n_overflow,
                len(items),
                root,
            )
            _META_TAIL.pack_into(
                buf, off + 2 * _DB.size, max(last_pg, 1), txnid
            )
            pages[meta_pgno] = bytes(buf)

        assert all(p is not None for p in pages)
        return pages

    def close(self) -> None:
        if self._closed:
            return
        pages = self._build()
        self._items.clear()
        target = self._path
        if self._subdir:
            os.makedirs(target, exist_ok=True)
            target = os.path.join(target, "data.mdb")
        with open(target, "wb") as f:
            for page in pages:  # page-by-page: no second full-file copy
                f.write(page)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
