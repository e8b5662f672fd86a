"""The port's data plane (``sparknet_tpu_torch/data``) against the JAX
package's, on the CPU at a small size, on fixtures the tests write.

Every case feeds both packages the same numpy inputs.  The host modules
(transformer, Datum codec, LMDB codec, CIFAR and tar loaders, minibatch
packers, record sources, the process ring) are copies, so every comparison
is bit for bit (``np.testing.assert_array_equal``, bytes ``==``).
``DeviceAugment`` is held bit for bit too: in TEST against the JAX
``DeviceAugment`` and the host transformer; in TRAIN with the JAX
package's draws, recomputed here from its key (``split``, ``randint``,
``bernoulli``) and injected.  The trainers' ``feed_device_fn`` is held
bit for bit to an in-process oracle (a lone ``Solver`` stepping on the
same augmented feeds).  The device stage runs on the CPU (the card's
pinned staging, copy stream and events run in ``chip_smoke.py``).
"""

import ast
import io
import os
import tarfile
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.data import archive as jarchive  # noqa: E402
from sparknet_tpu.data import cifar as jcifar  # noqa: E402
from sparknet_tpu.data import io_utils as jio  # noqa: E402
from sparknet_tpu.data import lmdb_io as jlmdb  # noqa: E402
from sparknet_tpu.data import minibatch as jmb  # noqa: E402
from sparknet_tpu.data import pipeline as jpipe  # noqa: E402
from sparknet_tpu.data import records as jrec  # noqa: E402
from sparknet_tpu.data import sampler as jsampler  # noqa: E402
from sparknet_tpu.data import transform as jtr  # noqa: E402
from sparknet_tpu.data.device_transform import DeviceAugment as JDeviceAugment  # noqa: E402

from sparknet_tpu_torch import layers_dsl  # noqa: E402
from sparknet_tpu_torch.data import archive, cifar, io_utils, lmdb_io, minibatch  # noqa: E402
from sparknet_tpu_torch.data import pipeline, records, sampler, transform  # noqa: E402
from sparknet_tpu_torch.data.device_transform import DeviceAugment, draw_seed  # noqa: E402
from sparknet_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: E402
from sparknet_tpu_torch.parallel import ElasticTrainer, ParallelTrainer  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig  # noqa: E402

from test_torch_port_solver import narrow_alexnet  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_leaked_shm():
    """Ring tests leave /dev/shm as they found it (the segment is unlinked
    on close, as in the JAX package's pipeline tests)."""
    if not os.path.isdir("/dev/shm"):
        yield
        return
    before = set(os.listdir("/dev/shm"))
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        leaked = set(os.listdir("/dev/shm")) - before
        if not leaked:
            return
        time.sleep(0.1)
    assert not leaked, f"leaked shared-memory segments: {leaked}"


def _images(n, shape=(3, 12, 12), seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n, *shape)).astype(np.uint8)


def _write_lmdb(writer_cls, path, images, datum=io_utils.array_to_datum):
    with writer_cls(path) as w:
        for i, im in enumerate(images):
            w.put(f"{i:08d}".encode(), datum(im, (i * 7) % 10))


@pytest.fixture(scope="module")
def lmdb_path(tmp_path_factory):
    """An LMDB of 40 Datums of 3x12x12, written by the port."""
    p = str(tmp_path_factory.mktemp("lmdb") / "db")
    _write_lmdb(lmdb_io.LmdbWriter, p, _images(40))
    return p


def _jpeg_tar(d, n=10, side=16, mapped=None):
    """A plain tar of JPEGs + a train.txt label map naming ``mapped`` of
    them (the rest must be skipped)."""
    from PIL import Image

    rs = np.random.RandomState(3)
    tar_p = os.path.join(d, "shard.tar")
    names = []
    with tarfile.open(tar_p, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rs.randint(0, 255, (side, side + 3, 3), np.uint8)).save(
                buf, format="JPEG")
            data = buf.getvalue()
            info = tarfile.TarInfo(f"img_{i}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            names.append(info.name)
    lm = os.path.join(d, "train.txt")
    with open(lm, "w") as f:
        for i, name in enumerate(names[:mapped or n]):
            f.write(f"{name} {i * 3}\n")
    return tar_p, lm


@pytest.fixture(scope="module")
def jpeg_tar(tmp_path_factory):
    return _jpeg_tar(str(tmp_path_factory.mktemp("tar")), n=12, mapped=10)


def _assert_feeds_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ------------------------------------------------------------ transformer


TRANSFORMS = {
    "crop_mirror_mean_image_scale": lambda m: dict(
        crop_size=9, mirror=True, mean_image=m, scale=0.0039),
    "crop_mean_value": lambda m: dict(crop_size=10, mean_value=(104.0, 117.0, 123.0)),
    "mirror_only": lambda m: dict(mirror=True),
}


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_data_transformer_matches_jax(case, train, layout):
    """Same config, same seed, same uint8 batch: the same float32 batch bit
    for bit, over three calls (the RandomState advances alike)."""
    rs = np.random.RandomState(1)
    mean = (rs.rand(3, 12, 12) * 255).astype(np.float32)
    cfg = TRANSFORMS[case](mean)
    port = transform.DataTransformer(transform.TransformConfig(seed=5, **cfg), layout)
    ref = jtr.DataTransformer(jtr.TransformConfig(seed=5, **cfg), layout)
    x = _images(6)
    if layout == "nhwc":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for _ in range(3):
        got, want = port(x, train), ref(x, train)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_transform_refusals_and_mean_files(tmp_path):
    """The native backend refuses nhwc as the JAX one does; ``.npy`` and
    ``.binaryproto`` means load as the JAX package loads them;
    ``resolve_mean_file`` walks up from its anchor like the JAX one."""
    with pytest.raises(ValueError, match="NCHW-only"):
        transform.DataTransformer(transform.TransformConfig(backend="native"), layout="nhwc")
    with pytest.raises(ValueError, match="NCHW-only"):
        jtr.DataTransformer(jtr.TransformConfig(backend="native"), layout="nhwc")
    with pytest.raises(ValueError, match="not both"):
        transform.DataTransformer(transform.TransformConfig(
            mean_image=np.zeros((3, 2, 2), np.float32), mean_value=(1.0,)))
    mean = np.arange(12, dtype=np.float64).reshape(3, 2, 2)
    np.save(tmp_path / "mean.npy", mean)
    got = transform.load_mean_file(str(tmp_path / "mean.npy"))
    np.testing.assert_array_equal(got, jtr.load_mean_file(str(tmp_path / "mean.npy")))
    assert got.dtype == np.float32
    from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

    save_mean_binaryproto(str(tmp_path / "mean.binaryproto"), mean)
    got = transform.load_mean_file(str(tmp_path / "mean.binaryproto"))
    np.testing.assert_array_equal(got, jtr.load_mean_file(str(tmp_path / "mean.binaryproto")))
    assert got.shape == (3, 2, 2) and got.dtype == np.float32
    (tmp_path / "a" / "b").mkdir(parents=True)
    anchor = str(tmp_path / "a" / "b" / "solver.prototxt")
    assert transform.resolve_mean_file("mean.npy", anchor) == \
        jtr.resolve_mean_file("mean.npy", anchor)
    with pytest.raises(ValueError, match="not found"):
        transform.resolve_mean_file("missing.npy", anchor)


# ------------------------------------------------------------ Datum, LMDB


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_datum_codec_matches_jax(dtype):
    """``array_to_datum`` writes the JAX package's bytes; each package
    decodes the other's (negative labels too)."""
    rs = np.random.RandomState(2)
    arr = (rs.randint(0, 256, (3, 5, 7)) if dtype == "uint8"
           else rs.randn(3, 5, 7)).astype(dtype)
    for label in (0, 9, 999, -3):
        buf = io_utils.array_to_datum(arr, label)
        assert buf == jio.array_to_datum(arr, label)
        for decode in (io_utils.datum_to_array, jio.datum_to_array):
            got, lab = decode(buf)
            np.testing.assert_array_equal(got, arr.astype(got.dtype))
            assert lab == label
    with pytest.raises(ValueError, match="want \\(C, H, W\\)"):
        io_utils.array_to_datum(arr[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lmdb_written_by_either_reads_in_the_other(tmp_path, writer):
    """An LMDB written by one package reads back in the other, values and
    locators alike, and the files are byte for byte the same; big values
    (overflow pages) and small ones (inline) both."""
    small, big = _images(30, (1, 6, 6), seed=4), _images(6, (3, 32, 32), seed=5)
    for name, imgs in (("small", small), ("big", big)):
        p = {w: str(tmp_path / f"{w}_{name}") for w in ("port", "jax")}
        _write_lmdb(lmdb_io.LmdbWriter, p["port"], imgs)
        _write_lmdb(jlmdb.LmdbWriter, p["jax"], imgs, jio.array_to_datum)
        with open(os.path.join(p["port"], "data.mdb"), "rb") as a, \
                open(os.path.join(p["jax"], "data.mdb"), "rb") as b:
            assert a.read() == b.read()
        path = p[writer]
        assert lmdb_io.is_lmdb(path) and jlmdb.is_lmdb(path)
        with lmdb_io.LmdbReader(path) as r, jlmdb.LmdbReader(path) as jr:
            assert len(r) == len(jr) == len(imgs)
            assert list(r) == list(jr)
            assert list(r.iter_locators()) == list(jr.iter_locators())
            for (_, v), im in zip(r, imgs):
                np.testing.assert_array_equal(io_utils.datum_to_array(v)[0], im)


# ------------------------------------------------------------ loaders


def test_cifar_loader_matches_jax(tmp_path):
    """The synthetic CIFAR files are the JAX package's bytes; the loader's
    arrays, labels, mean and float views are equal."""
    cifar.write_synthetic_cifar(str(tmp_path / "port"), seed=3)
    jcifar.write_synthetic_cifar(str(tmp_path / "jax"), seed=3)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    port = cifar.CifarLoader(str(tmp_path / "port"), seed=7, normalize=True)
    ref = jcifar.CifarLoader(str(tmp_path / "jax"), seed=7, normalize=True)
    for name in ("train_images", "train_labels", "test_images", "test_labels",
                 "mean_image"):
        got, want = getattr(port, name), getattr(ref, name)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype, name
    for a, b in zip(port.train_arrays() + port.test_arrays(),
                    ref.train_arrays() + ref.test_arrays()):
        np.testing.assert_array_equal(a, b)
    cifar.write_synthetic_cifar(str(tmp_path / "big"), seed=3, records=250)
    assert len(cifar.CifarLoader(str(tmp_path / "big")).train_labels) == 1250
    with pytest.raises(FileNotFoundError):
        cifar.CifarLoader(str(tmp_path / "none"))


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_compressed_minibatches_and_imagenet_loader_match_jax(jpeg_tar, workers, layout):
    """``ImageNetLoader`` shards and ``make_minibatches_compressed`` (serial
    and thread-pooled decode) give the JAX package's bytes; so do the
    streaming mean and the packers over them."""
    d = os.path.dirname(jpeg_tar[0])
    port = archive.ImageNetLoader(d, jpeg_tar[1])
    ref = jarchive.ImageNetLoader(d, jpeg_tar[1])
    assert port.archives == ref.archives and port.labels == ref.labels
    assert len(port) == len(ref) == 1
    for w, n in ((0, 1), (0, 2), (1, 2)):
        assert list(port.shard(w, n)) == list(ref.shard(w, n))
    got = list(minibatch.make_minibatches_compressed(port.shard(0, 1), 3, 20, 18,
                                                     workers, layout))
    want = list(jmb.make_minibatches_compressed(ref.shard(0, 1), 3, 20, 18, workers,
                                                layout))
    assert len(got) == len(want) == 3  # 10 mapped members, the tail dropped
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    shape = (20, 18, 3) if layout == "nhwc" else (3, 20, 18)
    np.testing.assert_array_equal(
        minibatch.compute_mean_from_minibatches(iter(got), shape),
        jmb.compute_mean_from_minibatches(iter(want), shape))
    imgs = np.concatenate([g for g, _ in got])
    labs = np.concatenate([lab for _, lab in got])
    np.testing.assert_array_equal(minibatch.compute_mean(imgs), jmb.compute_mean(imgs))
    for (a, b), (c, e) in zip(minibatch.make_minibatches(imgs, labs, 4),
                              jmb.make_minibatches(imgs, labs, 4)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)
    assert minibatch.decode_jpeg(b"not a jpeg", 4, 4) is None
    with pytest.raises(NotImplementedError, match="A9"):
        archive.ImageNetLoader("gs://bucket/shards", jpeg_tar[1])


def test_sampler_and_partition_feed_match_jax():
    """``MinibatchSampler``'s window and ``partition_feed``'s tau windows,
    with a host transform, equal the JAX package's."""
    batches = [{"data": np.full((2,), i)} for i in range(9)]
    for seed in (0, 1, 2):
        got = sampler.MinibatchSampler(batches, num_sampled_batches=4, seed=seed)
        want = jsampler.MinibatchSampler(batches, num_sampled_batches=4, seed=seed)
        assert got.start == want.start
        assert [b["data"][0] for b in got] == [b["data"][0] for b in want]
        assert got.next_batch()["data"][0] == want.next_batch()["data"][0]
    imgs, labels = _images(24), np.arange(24) % 10
    cfg = dict(crop_size=8, mirror=True, seed=1)
    fn = sampler.partition_feed(imgs, labels, 4, 2, seed=3,
                                transform=transform.DataTransformer(
                                    transform.TransformConfig(**cfg)))
    jfn = jsampler.partition_feed(imgs, labels, 4, 2, seed=3,
                                  transform=jtr.DataTransformer(jtr.TransformConfig(**cfg)))
    for it in range(3):
        _assert_feeds_equal(fn(it), jfn(it))
    with pytest.raises(ValueError, match="contiguous window"):
        sampler.partition_feed(imgs, labels, 8, 4)


# ------------------------------------------------------------ record sources


ADDRESSES = [(0, 0), (0, 3), (1, 2), (2, 4), (5, 1)]


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True, seed=3), dict(stride=2, offset=1),
    dict(shuffle=True, seed=1, stride=3, offset=2), dict(layout="nhwc")],
    ids=["plain", "shuffle", "stride", "shuffle_stride", "nhwc"])
def test_record_source_lmdb_matches_jax(lmdb_path, kw):
    """Batch (epoch, index) of an LMDB is the JAX source's, bit for bit."""
    port = records.RecordShardSource(lmdb_path, 8, **kw)
    ref = jrec.RecordShardSource(lmdb_path, 8, **kw)
    assert port.backend == ref.backend == "lmdb"
    assert port.batches_per_epoch == ref.batches_per_epoch == 5
    for e, i in ADDRESSES:
        _assert_feeds_equal(port.get(e, i), ref.get(e, i))
    assert port.consume_decode_s > 0
    port.close()
    ref.close()


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=2),
                                dict(stride=2, offset=1), dict(layout="nhwc")],
                         ids=["plain", "shuffle", "stride", "nhwc"])
def test_record_source_tar_matches_jax(jpeg_tar, kw):
    """Batch (epoch, index) of a plain JPEG tar (only the mapped members,
    decoded in the worker at decode_size) is the JAX source's."""
    tar_p, lm = jpeg_tar
    port = records.RecordShardSource(tar_p, 2, decode_size=(14, 15), label_map=lm, **kw)
    ref = jrec.RecordShardSource(tar_p, 2, decode_size=(14, 15), label_map=lm, **kw)
    assert port.backend == ref.backend == "tar"
    assert port.batches_per_epoch == 5
    for e, i in ADDRESSES:
        _assert_feeds_equal(port.get(e, i), ref.get(e, i))


def test_record_source_refusals(tmp_path, jpeg_tar):
    """The native ``record`` backend is detected and indexed (its batches
    the JAX source's); LevelDB, compressed tars, a tar without its label
    map or decode size, and unknown files are refused as in the JAX
    package."""
    from sparknet_tpu.data.createdb import create_db

    samples = [(im, i) for i, im in enumerate(_images(4))]
    create_db(str(tmp_path / "r.rdb"), samples, backend="record")
    create_db(str(tmp_path / "lv"), samples, backend="leveldb")
    for name, backend in (("r.rdb", "record"), ("lv", "leveldb")):
        p = str(tmp_path / name)
        assert records.probe_record_backend(p) == jrec.probe_record_backend(p) == backend
    _assert_feeds_equal(records.RecordShardSource(str(tmp_path / "r.rdb"), 2).get(0, 1),
                        jrec.RecordShardSource(str(tmp_path / "r.rdb"), 2).get(0, 1))
    with pytest.raises(ValueError, match="snappy"):
        records.RecordShardSource(str(tmp_path / "lv"), 2)
    other = tmp_path / "noise.bin"
    other.write_bytes(b"\x00" * 64)
    assert records.probe_record_backend(str(other)) == "unknown"
    with pytest.raises(ValueError, match="not a RecordDB"):
        records.RecordShardSource(str(other), 2)
    tgz = tmp_path / "s.tgz"
    tgz.write_bytes(b"")
    with pytest.raises(ValueError, match="random-access"):
        records.RecordShardSource(str(tgz), 2, label_map=jpeg_tar[1], decode_size=(4, 4))
    with pytest.raises(ValueError, match="label map"):
        records.RecordShardSource(jpeg_tar[0], 2, decode_size=(4, 4))
    with pytest.raises(ValueError, match="decode_size"):
        records.RecordShardSource(jpeg_tar[0], 2, label_map=jpeg_tar[1])


# ------------------------------------------------------------ the ring


def test_sources_and_feed_spec_match_jax():
    """``ArraySource`` (shuffled per epoch), ``SyntheticImageSource`` (both
    wire layouts), ``PrestagedSource`` and ``DataFnSource`` give the JAX
    sources' batches; ``FeedSpec`` lays out a slot as the JAX one does and
    refuses a batch of another geometry."""
    imgs, labels = _images(20), np.arange(20, dtype=np.int32)
    pairs = [
        (pipeline.ArraySource({"data": imgs, "label": labels}, 4, shuffle=True, seed=3),
         jpipe.ArraySource({"data": imgs, "label": labels}, 4, shuffle=True, seed=3)),
        (pipeline.SyntheticImageSource(3, (3, 8, 6), classes=5, seed=2),
         jpipe.SyntheticImageSource(3, (3, 8, 6), classes=5, seed=2)),
        (pipeline.SyntheticImageSource(3, (3, 8, 6), seed=2, layout="nhwc"),
         jpipe.SyntheticImageSource(3, (3, 8, 6), seed=2, layout="nhwc")),
        (pipeline.PrestagedSource({"data": imgs[:2]}), jpipe.PrestagedSource({"data": imgs[:2]})),
        (pipeline.DataFnSource(lambda it: {"x": np.full(2, it)}, 5),
         jpipe.DataFnSource(lambda it: {"x": np.full(2, it)}, 5)),
    ]
    for port, ref in pairs:
        assert port.batches_per_epoch == ref.batches_per_epoch
        for e, i in ((0, 0), (0, 3), (1, 2), (2, 4)):
            _assert_feeds_equal(port.get(e, i), ref.get(e, i))
    feeds = pipeline.SyntheticImageSource(3, (3, 8, 6)).get(0, 0)
    spec, jspec = pipeline.FeedSpec.from_arrays(feeds), jpipe.FeedSpec.from_arrays(feeds)
    assert spec.fields == jspec.fields and spec.slot_bytes == jspec.slot_bytes
    assert [o[3] for o in spec.offsets()] == [o[3] for o in jspec.offsets()]
    stage = pipeline.TransformStage(transform.TransformConfig(crop_size=5), layout="nhwc")
    jstage = jpipe.TransformStage(jtr.TransformConfig(crop_size=5), layout="nhwc")
    assert stage.out_spec(spec).fields == jstage.out_spec(jspec).fields
    with pytest.raises(ValueError, match="does not match"):
        spec.check({"data": feeds["data"][:2], "label": feeds["label"]})



def test_two_worker_ring_delivers_the_jax_batches(lmdb_path):
    """A 2-worker ``ProcessPipeline`` over the LMDB with a host
    ``TransformStage`` delivers the JAX ring's batches, in its order,
    across epochs; the stage walls are counted on the pipeline."""
    cfg = dict(crop_size=10, mirror=True, mean_value=(120.0, 110.0, 100.0), seed=4)
    src = records.RecordShardSource(lmdb_path, 8, shuffle=True, seed=2)
    jsrc = jrec.RecordShardSource(lmdb_path, 8, shuffle=True, seed=2)
    got, want = [], []
    with pipeline.ProcessPipeline(src, pipeline.TransformStage(
            transform.TransformConfig(**cfg)), num_batches=12, workers=2,
            start_index=3) as pipe:
        for b in pipe.batches():
            got.append({k: np.array(v) for k, v in b.items()})
        stats = dict(pipe.stats)
    with jpipe.ProcessPipeline(jsrc, jpipe.TransformStage(jtr.TransformConfig(**cfg)),
                               num_batches=12, workers=2, start_index=3) as jp:
        for b in jp.batches():
            want.append({k: np.array(v) for k, v in b.items()})
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        _assert_feeds_equal(a, b)
    assert stats["batches"] == 12
    assert set(pipeline.FEED_STAGES) <= set(stats)
    assert stats["decode"] > 0 and stats["put"] == 0.0


def test_ring_refusals_and_worker_death(lmdb_path):
    """A ring too small for its workers is refused; a worker that raises
    surfaces with its traceback; with a respawn budget a killed worker's
    shard resumes bit for bit."""
    src = records.RecordShardSource(lmdb_path, 8)
    with pytest.raises(ValueError, match="deadlocking"):
        pipeline.ProcessPipeline(src, num_batches=2, workers=2, slots=3)

    class Raising(pipeline.BatchSource):
        batches_per_epoch = 0

        def get(self, epoch, index):
            if index == 2:
                raise KeyError("bad record")
            return {"x": np.full((2,), index, np.int32)}

    with pipeline.ProcessPipeline(Raising(), num_batches=4, workers=1) as pipe:
        with pytest.raises(RuntimeError, match="bad record"):
            list(pipe.batches())

    class Dying(pipeline.BatchSource):
        batches_per_epoch = 0

        def get(self, epoch, index):
            if index == 3 and not os.path.exists(marker):
                open(marker, "w").close()
                os._exit(3)  # dies silently, mid-run
            return {"x": np.full((2,), index, np.int32)}

    marker = os.path.join(os.path.dirname(lmdb_path), "died")
    with pipeline.ProcessPipeline(Dying(), num_batches=8, workers=2,
                                  max_respawns=1) as pipe:
        got = [int(b["x"][0]) for b in pipe.batches()]
    assert got == list(range(8))


def test_ring_worker_modules_make_no_torch_call():
    """The ring's workers run only the host modules, which import nothing
    of torch, so a fork after CUDA is initialized leaves no CUDA call in a
    child (``data/pipeline.py``'s start-method note); ``device_feed`` takes
    torch only inside the function, through the prefetcher, and the
    consumer's journal sites reach the obs package (its ``lineage`` and
    ``schema`` are stdlib-only; the Recorder is the consumer's).  The record
    backend's decode (``createdb``), the LevelDB probe, the proto2 codec
    under ``io_utils`` and the native transform's bindings are host
    modules too."""
    worker_side = {name: os.path.join("data", f"{name}.py") for name in (
        "pipeline", "records", "lmdb_io", "io_utils", "minibatch", "archive", "transform",
        "cifar", "sampler", "createdb", "leveldb_io")}
    worker_side.update(binary=os.path.join("proto", "binary.py"),
                       native=os.path.join("native", "__init__.py"))
    for name, rel in worker_side.items():
        path = os.path.join(REPO, "sparknet_tpu_torch", rel)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert not mod.startswith("torch"), (name, mod)
                assert mod in ("", "__future__") or not mod.startswith("sparknet_tpu_torch") \
                    or mod.split(".")[-1] in tuple(worker_side) + ("prefetch", "obs",
                                                                    "lineage"), (name, mod)


def test_ring_runs_with_cuda_calls_refused(monkeypatch, lmdb_path):
    """With every way into CUDA made to raise before the fork, the ring
    (LMDB records through 2 workers with a host transform) still delivers
    the source's batches: no worker makes a CUDA call."""
    def refuse(*a, **k):
        raise AssertionError("a feed worker made a CUDA call")

    for name in ("is_available", "init", "_lazy_init", "device_count",
                 "current_device", "set_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    src = records.RecordShardSource(lmdb_path, 8)
    stage = pipeline.TransformStage(transform.TransformConfig(crop_size=10), train=False)
    with pipeline.ProcessPipeline(src, stage, num_batches=6, workers=2) as pipe:
        for g, b in enumerate(pipe.batches()):
            np.testing.assert_array_equal(b["data"], stage(src.get(*divmod(g, 5)))["data"])


# ------------------------------------------------------------ the device stage


def test_device_feed_delivers_the_source_across_a_ring_wrap(lmdb_path):
    """``device_feed`` on the CPU: every batch equals ``src.get(epoch,
    index)`` for its global id, over three passes of the LMDB and eight
    wraps of a 2-worker ring (4 slots); each delivered tensor owns its
    memory (a copy, not a view of the recycled slot); ``device_fn`` runs
    after the transfer; the put wall is counted; no thread is left."""
    src = records.RecordShardSource(lmdb_path, 8)
    before = set(threading.enumerate())
    seen = []
    with pipeline.ProcessPipeline(src, num_batches=15, workers=2) as pipe:
        assert pipe.slots == 4
        fn = lambda f, it: {**f, "it": torch.tensor(it)}  # noqa: E731
        with pipeline.device_feed(pipe, device_fn=fn, device="cpu") as feed:
            for g, b in enumerate(feed):
                seen.append(b)  # kept past several slot recycles
                assert int(b["it"]) == g
        for g, b in enumerate(seen):
            want = src.get(*divmod(g, src.batches_per_epoch))
            np.testing.assert_array_equal(b["data"].numpy(), want["data"])
            np.testing.assert_array_equal(b["label"].numpy(), want["label"])
            assert b["data"].dtype == torch.uint8
        assert len(seen) == 15 and pipe.stats["put"] > 0
    assert not feed._thread.is_alive()
    assert set(threading.enumerate()) <= before


def test_device_prefetcher_order_errors_and_close():
    """The prefetcher yields ``data_fn(it)`` in order from ``start_iter``,
    copies the host arrays, re-raises a ``data_fn`` error on the consumer,
    and ``close`` joins its thread mid-stream."""
    buf = np.zeros((2, 3), np.float32)

    def data_fn(it):
        buf[:] = it  # the same memory every call
        return {"x": buf}

    with DevicePrefetcher(data_fn, num_iters=5, start_iter=2, device="cpu") as pf:
        got = [int(f["x"][0, 0]) for f in pf]
    assert got == [2, 3, 4, 5, 6] and len(pf) == 5
    assert list(pf) == []  # single use

    def bad(it):
        raise KeyError("feed broke")

    pf = DevicePrefetcher(bad, num_iters=3, device="cpu")
    with pytest.raises(KeyError, match="feed broke"):
        list(pf)
    pf.close()
    pf = DevicePrefetcher(data_fn, num_iters=1000, depth=2, device="cpu")
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()


# ------------------------------------------------------------ DeviceAugment


def _jax_draws(key, n, h, w, crop):
    """The JAX DeviceAugment's TRAIN draws for ``key``, recomputed as it
    makes them (``device_transform.py``: split in three, randint, bernoulli)."""
    k_h, k_w, k_flip = jax.random.split(key, 3)
    hos = np.asarray(jax.random.randint(k_h, (n,), 0, h - crop + 1))
    wos = np.asarray(jax.random.randint(k_w, (n,), 0, w - crop + 1))
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (n,)))
    return (hos, wos), flips


AUGMENTS = {
    "mean_image_scale": lambda m: dict(crop_size=9, mirror=True, mean_image=m,
                                       scale=0.0039),
    "mean_value": lambda m: dict(crop_size=11, mirror=True,
                                 mean_value=(104.0, 117.0, 123.0)),
    "imagenet_recipe": lambda m: dict(crop_size=10, mirror=True, mean_image=m),
}


@pytest.mark.parametrize("case", sorted(AUGMENTS))
def test_device_augment_matches_jax_and_the_host(case):
    """TEST: bit for bit the JAX ``DeviceAugment`` and the host
    ``DataTransformer``.  TRAIN with the JAX package's draws injected: bit
    for bit the JAX augment under that key, for several keys."""
    rs = np.random.RandomState(6)
    mean = (rs.rand(3, 13, 12) * 255).astype(np.float32)
    cfg = AUGMENTS[case](mean)
    x = _images(8, (3, 13, 12), seed=7)
    port = DeviceAugment(transform.TransformConfig(**cfg), device="cpu")
    ref = JDeviceAugment(jtr.TransformConfig(**cfg), layout="nchw")
    host = jtr.DataTransformer(jtr.TransformConfig(**cfg))
    got = port(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (8, 3, cfg["crop_size"],
                                                        cfg["crop_size"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(x, jax.random.key(0),
                                                              train=False)))
    np.testing.assert_array_equal(got.numpy(), host(x, False))
    for k in (1, 2, 3):
        key = jax.random.key(k)
        offsets, flips = _jax_draws(key, 8, 13, 12, cfg["crop_size"])
        assert 0 < flips.sum() < 8 or k > 1
        got = port(torch.from_numpy(x), True, offsets=tuple(map(torch.from_numpy, offsets)),
                   flips=torch.from_numpy(flips))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref(x, key, train=True)))


def test_device_augment_draws():
    """TRAIN's own draws: in range, a fair coin, the same for the same
    ``(pid, seed, it, t)`` and apart for another; ``device_fn`` draws from
    ``generator(pid, seed, it)``; the seeds of rank-4 calls and of each slot
    differ; the nhwc arm crops the HWC batch at the same draws (the nchw
    output permuted); a double mean is refused; TRAIN without draws
    raises."""
    aug = DeviceAugment(transform.TransformConfig(crop_size=227, mirror=True),
                        device="cpu")
    (hos, wos), flips = aug.draw(2048, 256, 256, aug.generator(1, 2, 3))
    assert int(hos.min()) >= 0 and int(hos.max()) <= 29
    assert int(wos.min()) >= 0 and int(wos.max()) <= 29
    assert 0.4 <= float(flips.float().mean()) <= 0.6
    (h2, w2), f2 = aug.draw(2048, 256, 256, aug.generator(1, 2, 3))
    assert torch.equal(hos, h2) and torch.equal(wos, w2) and torch.equal(flips, f2)
    (h3, _), _ = aug.draw(2048, 256, 256, aug.generator(1, 2, 4))
    assert not torch.equal(hos, h3)
    seeds = {draw_seed(0, 0, it, t) for it in range(4) for t in (None, 0, 1, 2)}
    assert len(seeds) == 16
    assert draw_seed(1, 2, 3) == draw_seed(0, 3, 3) == (1237 << 48) | (3 << 16)
    x = torch.from_numpy(_images(4, (3, 230, 229)))
    out = aug.device_fn(pid=1, seed=2)({"data": x, "label": torch.zeros(4)}, 3)
    want = aug(x, True, generator=aug.generator(1, 2, 3))
    assert torch.equal(out["data"], want) and out["data"].shape == (4, 3, 227, 227)
    with pytest.raises(ValueError, match="generator or"):
        aug(x, True)
    hwc = DeviceAugment(transform.TransformConfig(crop_size=227, mirror=True),
                        layout="nhwc", device="cpu")
    got = hwc.device_fn(pid=1, seed=2)({"data": x.permute(0, 2, 3, 1)}, 3)["data"]
    assert got.shape == (4, 227, 227, 3) and torch.equal(got, want.permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="not both"):
        DeviceAugment(transform.TransformConfig(mean_image=np.zeros((3, 2, 2)),
                                                mean_value=(1.0,)), device="cpu")


# ------------------------------------------------------------ trainer hooks


SOLVER = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4)
B = 3


@pytest.fixture
def one_thread():
    """One intra-op thread while the trainer and its oracle step: with
    several, the CPU convolutions' sums follow the thread team, which a
    gloo collective in the middle of a step can shrink for a later call, so
    two runs of the same step may differ in last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uint8_feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randint(0, 256, (B, 3, 70, 71)).astype(np.uint8),
             "label": rs.randint(0, 10, B).astype(np.int32)} for _ in range(n)]


def _augment():
    return DeviceAugment(transform.TransformConfig(
        crop_size=67, mirror=True, mean_value=(104.0, 117.0, 123.0)), device="cpu")


def _solver():
    return Solver(SolverConfig(**SOLVER), narrow_alexnet(layers_dsl, batch=B), device="cpu")


def _assert_same_solver(a, b):
    for ln, pl in b.variables.params.items():
        for x, y in zip(a.variables.params[ln], pl):
            assert torch.equal(x, y), ln
    for ln, sl in b.slots.items():
        for hx, hy in zip(a.slots[ln], sl):
            assert all(torch.equal(x, y) for x, y in zip(hx, hy)), ln


@pytest.mark.parametrize("tau", [1, 2])
def test_parallel_trainer_feed_device_fn_matches_an_oracle(tau, one_thread):
    """A world of one with ``trainer_device_fn``: uint8 feeds stay uint8
    until the hook, which augments each slot of a rank-5 feed from its own
    generator; the rounds equal a lone Solver stepping on the same
    augmented feeds, bit for bit (loss, params, history)."""
    aug = _augment()
    feeds = _uint8_feeds(2 * tau)
    seen = []

    def hook(f, it):
        seen.append((f["data"].dtype, f["data"].dim(), it))
        return aug.trainer_device_fn(pid=0, seed=1)(f, it)

    tr = ParallelTrainer(_solver(), tau=tau)
    ref = _solver()
    losses = []
    try:
        tr.feed_device_fn = hook
        for r in range(2):
            its = range(r * tau, (r + 1) * tau)
            if tau == 1:
                loss = tr.train_round(lambda it: feeds[it])
                want = [ref.train_iteration({
                    "data": aug(torch.from_numpy(feeds[it]["data"]), True,
                                generator=aug.generator(0, 1, it)),
                    "label": feeds[it]["label"]}) for it in its]
            else:
                loss = tr.train_round(lambda it: {
                    k: np.stack([feeds[it + i][k] for i in range(tau)]) for k in feeds[0]})
                want = [ref.train_iteration({
                    "data": aug(torch.from_numpy(feeds[it]["data"]), True,
                                generator=aug.generator(0, 1, r * tau, t)),
                    "label": feeds[it]["label"]}) for t, it in enumerate(its)]
            losses.append((loss, float(torch.stack(want).mean())))
        _assert_same_solver(tr.solver, ref)
    finally:
        tr.close()
    for got, want in losses:
        assert got == want
    assert seen == [(torch.uint8, 4 if tau == 1 else 5, r * tau) for r in range(2)]


def test_elastic_trainer_feed_device_fn_matches_an_oracle(one_thread):
    """The elastic trainer's hook, a world of one at tau 2: the round's
    shards are placed, stacked [tau, B, ...] and augmented slot by slot,
    bit for bit a lone Solver on the same augmented shards."""
    aug = _augment()
    shards = _uint8_feeds(4, seed=1)
    tr = ElasticTrainer(_solver(), tau=2)
    ref = _solver()
    losses = []
    try:
        tr.feed_device_fn = aug.trainer_device_fn(pid=2)
        for r in range(2):
            loss = tr.train_round(lambda g: shards[g])
            want = [ref.train_iteration({
                "data": aug(torch.from_numpy(shards[2 * r + t]["data"]), True,
                            generator=aug.generator(2, None, 2 * r, t)),
                "label": shards[2 * r + t]["label"]}) for t in range(2)]
            losses.append((loss, float(torch.stack(want).mean())))
        _assert_same_solver(tr.solver, ref)
    finally:
        tr.close()
    for got, want in losses:
        assert got == want


def test_feed_entry_points_default_to_cuda(monkeypatch, lmdb_path):
    """``device=None`` means CUDA: without a card the augment, the
    prefetcher and the device feed raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceAugment(transform.TransformConfig(crop_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(lambda it: {}, num_iters=1)
    src = records.RecordShardSource(lmdb_path, 8)
    with pipeline.ProcessPipeline(src, num_batches=1, workers=1) as pipe:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.device_feed(pipe)
