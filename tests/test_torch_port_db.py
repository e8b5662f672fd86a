"""The port's DB formats and native data plane against the JAX package's.

``native`` (``RecordDB``, ``transform_batch``, built from
``native/sparknet_native.cpp`` into ``sparknet_tpu_torch/_build/``),
``data/leveldb_io.py``, ``data/createdb.py``, the ``record`` backend of
``RecordShardSource`` and the io_utils helpers, on the CPU, on fixtures
made from numpy seeds.  Files are compared byte for byte, decoded arrays
bit for bit: every format here is exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import native as jnative  # noqa: E402
from sparknet_tpu.data import createdb as jcreatedb  # noqa: E402
from sparknet_tpu.data import io_utils as jio  # noqa: E402
from sparknet_tpu.data import leveldb_io as jlevel  # noqa: E402
from sparknet_tpu.data import records as jrec  # noqa: E402
from sparknet_tpu.data import transform as jtr  # noqa: E402

from sparknet_tpu_torch import native  # noqa: E402
from sparknet_tpu_torch.data import createdb, io_utils, leveldb_io, records, transform  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("record", "lmdb", "leveldb")
EXT = {"record": ".sndb", "lmdb": "_lmdb", "leveldb": "_leveldb"}


def _samples(n=10, shape=(3, 9, 7), seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, shape).astype(np.uint8), int(rs.randint(0, 1000)))
            for _ in range(n)]


def _tree_bytes(path):
    """{relative name: bytes} of a DB file or directory."""
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return {"": f.read()}
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


# ---------------------------------------------------------------- RecordDB
def test_recorddb_round_trip_commit_and_missing(tmp_path):
    p = str(tmp_path / "x.sndb")
    w = native.RecordDB(p, "w")
    w.put(b"a", b"1")
    w.commit()
    w.put(b"b", b"22")  # not committed: invisible to a reader
    with native.RecordDB(p) as r:
        assert len(r) == 1 and list(r) == [(b"a", b"1")]
    w.commit()
    w.close()
    with native.RecordDB(p) as r, jnative.RecordDB(p) as jr:
        assert list(r) == list(jr) == [(b"a", b"1"), (b"b", b"22")]
    with native.RecordDB(p, "w") as db, pytest.raises(OSError):
        list(db)  # a write handle has no cursor
    with pytest.raises(OSError):
        native.RecordDB(str(tmp_path / "nope.sndb"))
    with pytest.raises(ValueError):
        native.RecordDB(p, "a")


def test_native_build_is_the_ports_own(tmp_path, monkeypatch):
    """The library is built from the repo's source into
    ``sparknet_tpu_torch/_build/`` under a name keyed by source, flags and
    host; ``native/libsparknet_native.so`` is never mapped; a failed build
    raises with the compiler's log, and ``available`` reports it."""
    code = (
        "import sys; sys.path.insert(0, {repo!r})\n"
        "from sparknet_tpu_torch import native\n"
        "native.RecordDB({p!r}, 'w').close()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(str(native.library_path()) in maps, 'libsparknet_native.so' in maps)\n"
    ).format(repo=REPO, p=str(tmp_path / "m.sndb"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert lib.parent.name == "_build" and lib.parent.parent.name == "sparknet_tpu_torch"
    assert "-march=native" not in native.CXX_FLAGS
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build()
    reason = native.available()
    assert reason is not True and "broken.cpp" in reason
    with pytest.raises(RuntimeError, match="native transform backend"):
        transform.DataTransformer(transform.TransformConfig(backend="native"))


# ---------------------------------------------------------------- formats
@pytest.mark.parametrize("backend,opts", [
    ("record", {}), ("lmdb", {}), ("leveldb", {}), ("leveldb", {"sst": True}),
    ("leveldb", {"sst": True, "compress": True})])
def test_db_files_byte_equal_and_cross_read(backend, opts, tmp_path):
    """``create_db`` in each package writes the same files from the same
    samples; each package reads the other's records bit for bit."""
    samples = _samples(12, seed=1)
    if opts:  # LevelDB writer options: write through the writers directly
        values = [(f"{i:08d}".encode(), io_utils.array_to_datum(im, lab))
                  for i, (im, lab) in enumerate(samples)]
        for mod, name in ((leveldb_io, "port"), (jlevel, "jax")):
            with mod.LevelDbWriter(str(tmp_path / name), **opts) as w:
                for k, v in values:
                    w.put(k, v)
        port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    else:
        port, jax_ = str(tmp_path / f"p{EXT[backend]}"), str(tmp_path / f"j{EXT[backend]}")
        assert createdb.create_db(port, samples, commit_every=5, backend=backend) == 12
        assert jcreatedb.create_db(jax_, samples, commit_every=5, backend=backend) == 12
    assert _tree_bytes(port) == _tree_bytes(jax_)
    for path in (port, jax_):
        got = list(createdb.db_minibatches(path, 5, drop_remainder=False, dtype=np.uint8))
        want = list(jcreatedb.db_minibatches(path, 5, drop_remainder=False, dtype=np.uint8))
        assert [len(b["label"]) for b in got] == [5, 5, 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["data"], w["data"])
            np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(got[0]["data"][1], samples[1][0])


def test_snappy_and_crc32c_agree():
    rs = np.random.RandomState(2)
    blobs = [b"", b"a", rs.bytes(1000), b"abc" * 700, bytes(rs.randint(0, 4, 5000).astype(np.uint8))]
    for b in blobs:
        assert leveldb_io.crc32c(b) == jlevel.crc32c(b)
        assert leveldb_io.crc_mask(leveldb_io.crc32c(b)) == jlevel.crc_mask(jlevel.crc32c(b))
        c = leveldb_io.snappy_compress(b)
        assert c == jlevel.snappy_compress(b)
        assert leveldb_io.snappy_decompress(c) == jlevel.snappy_decompress(c) == b
    assert leveldb_io.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_create_convert_mean_and_minibatches_agree(tmp_path):
    """``convert_db`` through all three backends keeps every record and
    key; ``db_mean``, ``peek_db_shape`` and ``db_minibatches`` (loop,
    drop_remainder, dtype) agree with the JAX functions; a looping stream
    refuses a DB smaller than its batch."""
    samples = _samples(7, seed=3)
    src = str(tmp_path / "src.sndb")
    createdb.create_db(src, samples)
    prev = src
    for i, backend in enumerate(("leveldb", "lmdb", "record")):
        dst = str(tmp_path / f"c{i}{EXT[backend]}")
        jdst = str(tmp_path / f"j{i}{EXT[backend]}")
        assert createdb.convert_db(prev, dst, backend=backend) == 7
        assert jcreatedb.convert_db(prev, jdst, backend=backend) == 7
        assert _tree_bytes(dst) == _tree_bytes(jdst)
        assert createdb.peek_db_shape(dst) == jcreatedb.peek_db_shape(dst) == (3, 9, 7)
        np.testing.assert_array_equal(createdb.db_mean(dst, 3), jcreatedb.db_mean(dst, 3))
        stream = createdb.db_minibatches(dst, 3, loop=True)
        jstream = jcreatedb.db_minibatches(dst, 3, loop=True)
        for _ in range(5):
            g, w = next(stream), next(jstream)
            np.testing.assert_array_equal(g["data"], w["data"])
            np.testing.assert_array_equal(g["label"], w["label"])
            assert g["data"].dtype == np.float32
        with pytest.raises(ValueError, match="loop=True"):
            next(createdb.db_minibatches(dst, 8, loop=True))
        prev = dst
    db, decode = createdb._open_reader(prev)
    with db:
        assert [k for k, _ in db] == [f"{i:08d}".encode() for i in range(7)]
    img, label = createdb.decode_datum(createdb.encode_datum(samples[0][0], samples[0][1]))
    np.testing.assert_array_equal(img, samples[0][0])
    assert label == samples[0][1]


def test_record_shard_source_matches_jax(tmp_path):
    p = str(tmp_path / "r.sndb")
    createdb.create_db(p, _samples(11, seed=4))
    assert records.probe_record_backend(p) == jrec.probe_record_backend(p) == "record"
    for kw in (dict(), dict(shuffle=True, seed=3), dict(stride=2, offset=1, layout="nhwc")):
        port = records.RecordShardSource(p, 2, **kw)
        ref = jrec.RecordShardSource(p, 2, **kw)
        assert port.batches_per_epoch == ref.batches_per_epoch == 5
        for e, i in ((0, 0), (0, 4), (1, 2), (3, 7)):
            g, w = port.get(e, i), ref.get(e, i)
            np.testing.assert_array_equal(g["data"], w["data"])
            np.testing.assert_array_equal(g["label"], w["label"])
            assert g["data"].dtype == np.uint8
        port.close()
    trunc = tmp_path / "t.sndb"
    trunc.write_bytes(open(p, "rb").read()[:100])
    with pytest.raises(ValueError, match="truncated|past EOF"):
        records.RecordShardSource(str(trunc), 2)


# ---------------------------------------------------------------- transform
@pytest.mark.parametrize("mean_kind", ["none", "values", "image"])
def test_native_transform_matches_jax(mean_kind):
    rs = np.random.RandomState(5)
    x = rs.randint(0, 256, (6, 3, 11, 10)).astype(np.uint8)
    mean = {"none": {}, "values": {"mean_values": (104.0, 117.0, 123.0)},
            "image": {"mean": rs.rand(3, 11, 10).astype(np.float32) * 255}}[mean_kind]
    for kw in (dict(crop=7, mirror=True, train=True, seed=9),
               dict(crop=7, train=False), dict(scale=0.00390625, seed=2, train=True)):
        got = native.transform_batch(x, **mean, **kw)
        want = jnative.transform_batch(x, **mean, **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    cfg = dict(crop_size=7, mirror=True, seed=4, scale=0.5,
               mean_image=mean.get("mean"), mean_value=mean.get("mean_values") or ())
    port = transform.DataTransformer(transform.TransformConfig(backend="native", **cfg))
    ref = jtr.DataTransformer(jtr.TransformConfig(backend="native", **cfg))
    for train in (True, True, False):
        np.testing.assert_array_equal(port(x, train), ref(x, train))
    # float input takes the numpy path in both packages
    np.testing.assert_array_equal(port(x.astype(np.float32), False),
                                  ref(x.astype(np.float32), False))


# ---------------------------------------------------------------- io_utils
def test_binaryproto_and_load_image_match_jax(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(6)
    mean = rs.rand(3, 5, 4).astype(np.float32) * 255
    for mod, name in ((io_utils, "p"), (jio, "j")):
        mod.save_mean_binaryproto(str(tmp_path / f"{name}.binaryproto"), mean)
    assert (tmp_path / "p.binaryproto").read_bytes() == (tmp_path / "j.binaryproto").read_bytes()
    got = io_utils.load_mean_binaryproto(str(tmp_path / "j.binaryproto"))
    np.testing.assert_array_equal(got, mean)
    np.testing.assert_array_equal(got, jio.load_mean_binaryproto(str(tmp_path / "p.binaryproto")))
    blob = io_utils.array_to_blobproto(mean[None])
    assert blob == jio.array_to_blobproto(mean[None])
    np.testing.assert_array_equal(io_utils.blobproto_to_array(blob), mean[None])
    img = rs.randint(0, 256, (7, 6, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "i.png")
    Image.fromarray(img[:, :, 0]).save(tmp_path / "g.png")
    for f in ("i.png", "g.png"):
        for color in (True, False):
            a = io_utils.load_image(str(tmp_path / f), color)
            np.testing.assert_array_equal(a, jio.load_image(str(tmp_path / f), color))
            assert a.dtype == np.float32 and a.shape == (7, 6, 3 if color else 1)
