"""Dataset -> DB materialization and DB-backed minibatch reading.

Copy of ``sparknet_tpu/data/createdb.py``.  The reference's alternative
"Caffe-native data source" path: executors write their partition into
per-worker LMDB/LevelDBs through the C API (ref:
src/main/scala/preprocessing/CreateDB.scala:10-52, commit every 1000
records) and training reads them through Caffe's own DataLayer (ref:
src/main/scala/apps/CifarDBApp.scala:96-131).  Three backends:

- ``record`` — the native RecordDB (``sparknet_tpu_torch.native``, built
  from ``native/sparknet_native.cpp``), value layout: little-endian u32
  c,h,w, i32 label, then c*h*w raw uint8 pixels (the Datum role, ref:
  caffe.proto:30-41, without the protobuf dependency);
- ``lmdb`` — real LMDB environments with protobuf ``Datum`` values, the
  reference's own format (ref: db_lmdb.cpp), via ``data/lmdb_io.py``;
- ``leveldb`` — real LevelDB environments (ref: db_leveldb.cpp — the
  backend CifarDBApp/CreateDB use), via ``data/leveldb_io.py``.

``db_minibatches`` detects the backend per path.  The native library is
loaded only when a ``record`` DB is opened.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Iterable, Iterator

import numpy as np

_HDR = struct.Struct("<IIIi")
COMMIT_EVERY = 1000  # ref: CreateDB.scala commit_db_txn cadence


def encode_datum(image: np.ndarray, label: int) -> bytes:
    c, h, w = image.shape
    return _HDR.pack(c, h, w, int(label)) + np.ascontiguousarray(
        image, np.uint8
    ).tobytes()


def decode_datum(value: bytes) -> tuple[np.ndarray, int]:
    c, h, w, label = _HDR.unpack_from(value)
    img = np.frombuffer(value, np.uint8, c * h * w, _HDR.size).reshape(c, h, w)
    return img, label


def create_db(
    path: str,
    samples: Iterable[tuple[np.ndarray, int]],
    commit_every: int = COMMIT_EVERY,
    backend: str = "record",
) -> int:
    """Write (uint8 CHW image, label) samples; returns the record count.

    ``backend='lmdb'`` writes a real LMDB environment with protobuf
    Datum values (Caffe-readable); default is the native RecordDB."""
    writer = _open_writer(path, backend)
    encode = _value_encoder(backend)
    n = 0
    with writer as db:
        for image, label in samples:
            db.put(f"{n:08d}".encode(), encode(image, label))
            n += 1
            if n % commit_every == 0:
                db.commit()
        db.commit()
    return n


def _open_writer(path: str, backend: str):
    if backend == "record":
        from sparknet_tpu_torch.native import RecordDB

        return RecordDB(path, "w")
    if backend == "lmdb":
        from sparknet_tpu_torch.data.lmdb_io import LmdbWriter

        return LmdbWriter(path)
    if backend == "leveldb":
        from sparknet_tpu_torch.data.leveldb_io import LevelDbWriter

        return LevelDbWriter(path)
    raise ValueError(
        f"unknown db backend {backend!r} (record | lmdb | leveldb)")


def _value_encoder(backend: str):
    if backend in ("lmdb", "leveldb"):
        from sparknet_tpu_torch.data.io_utils import array_to_datum

        return lambda image, label: array_to_datum(
            np.ascontiguousarray(image, np.uint8), label
        )
    return encode_datum


def _open_reader(path: str):
    """(db, decode) for any backend; LMDB detected by meta magic,
    LevelDB by its CURRENT file (both hold Caffe Datum values)."""
    from sparknet_tpu_torch.data.io_utils import datum_to_array
    from sparknet_tpu_torch.data.leveldb_io import LevelDbReader, is_leveldb
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader, is_lmdb

    if is_lmdb(path):
        return LmdbReader(path), datum_to_array
    if is_leveldb(path):
        return LevelDbReader(path), datum_to_array
    from sparknet_tpu_torch.native import RecordDB

    return RecordDB(path, "r"), decode_datum


def convert_db(src: str, dst: str, backend: str = "record") -> int:
    """Re-materialize ``src`` (either backend) as ``dst`` in ``backend``
    format — the LMDB-ingest bridge: existing Caffe LMDBs convert to the
    native RecordDB (or the reverse) with keys preserved."""
    db, decode = _open_reader(src)
    writer = _open_writer(dst, backend)
    encode = _value_encoder(backend)
    n = 0
    with db, writer:
        for key, value in db:
            image, label = decode(value)
            writer.put(key, encode(image, label))
            n += 1
            if n % COMMIT_EVERY == 0:
                writer.commit()
        writer.commit()
    return n


def _db_stamp(path: str) -> tuple:
    """mtime/size fingerprint of the DB path (recursed one level for
    directory-shaped DBs), so the shape cache invalidates when a DB is
    REBUILT at the same path in-process (CifarDBApp re-materialize,
    convert_db, tests) instead of serving stale geometry."""
    try:
        st = os.stat(path)
        stamp = [st.st_mtime_ns, st.st_size]
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                try:
                    s2 = os.stat(os.path.join(path, name))
                    stamp += [name, s2.st_mtime_ns, s2.st_size]
                except OSError:
                    continue
        return tuple(stamp)
    except OSError:
        return ()


def peek_db_shape(path: str) -> tuple[int, ...]:
    """(C, H, W) of the first record — Caffe parity: a DataLayer's blob
    geometry is defined by its DB, read at setup from datum 0 (ref:
    data_layer.cpp:40-48 DataLayerSetUp -> data_transformer InferBlobShape).
    Cached per (path, content fingerprint): shape inference consults it
    from several sites per run, and the fingerprint keys out stale
    entries when the DB is rebuilt at the same path."""
    return _peek_db_shape_cached(path, _db_stamp(path))


@functools.lru_cache(maxsize=64)
def _peek_db_shape_cached(path: str, _stamp: tuple) -> tuple[int, ...]:
    db, decode = _open_reader(path)
    with db:
        for _, value in db:
            image, _ = decode(value)
            return tuple(image.shape)
    raise ValueError(f"record db {path!r} is empty")


def db_mean(path: str, batch_size: int = 256) -> np.ndarray:
    """Mean image over every record in a DB (the compute_image_mean job:
    probe the shape from one record, then stream with the remainder kept)."""
    from sparknet_tpu_torch.data.minibatch import compute_mean_from_minibatches

    try:
        first = next(db_minibatches(path, 1))
    except StopIteration:
        raise ValueError(f"record db {path!r} is empty") from None
    return compute_mean_from_minibatches(
        (
            (b["data"], b["label"])
            for b in db_minibatches(path, batch_size, drop_remainder=False)
        ),
        first["data"].shape[1:],
    )


def db_minibatches(
    path: str,
    batch_size: int,
    loop: bool = False,
    drop_remainder: bool = True,
    dtype=np.float32,
) -> Iterator[dict[str, np.ndarray]]:
    """Feed dicts from a record DB.  ``drop_remainder=True`` (the training
    contract) yields only full batches; ``False`` yields the final short
    batch too (stats passes — compute_image_mean must see every record).
    ``loop=True`` restarts the cursor each epoch (the DataLayer's rewind).
    ``dtype=np.uint8`` hands back raw pixels (skip the float cast when a
    transformer will cast anyway)."""
    db, decode = _open_reader(path)
    with db:
        if loop and (
            len(db) == 0 or (len(db) < batch_size and drop_remainder)
        ):
            raise ValueError(
                f"db holds {len(db)} records < batch_size {batch_size}; "
                "loop=True would spin forever yielding nothing"
            )
        while True:
            imgs, labels = [], []
            for _, value in db:
                img, label = decode(value)
                imgs.append(img)
                labels.append(label)
                if len(imgs) == batch_size:
                    yield {
                        "data": np.stack(imgs).astype(dtype),
                        "label": np.asarray(labels, np.int32),
                    }
                    imgs, labels = [], []
            if imgs and not drop_remainder:
                yield {
                    "data": np.stack(imgs).astype(dtype),
                    "label": np.asarray(labels, np.int32),
                }
            if not loop:
                return
