"""The port's list-file data plane (``sparknet_tpu_torch/data/listfile.py``
and the ImageData/WindowData layers) against the JAX package's.

Fixtures are written by each test from numpy seeds: JPEGs and PNGs of mixed
sizes, ``"<path> <label>"`` lists, R-CNN window files, a record DB and a
``.binaryproto`` mean.  The same layer prototxt and seed go to both
packages' sources; every batch, across an epoch wrap and a reshuffle, is
bit for bit the JAX source's (both draw from numpy ``RandomState`` and
decode with PIL).  The layers' declared shapes match the JAX layers'.
"""

import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.data import listfile as jlf  # noqa: E402
from sparknet_tpu.proto import parse as jparse  # noqa: E402

from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.data import listfile as lf  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

SIZES = [(20, 24), (18, 18), (26, 21), (24, 24), (19, 30)]


def _save(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


@pytest.fixture
def images(tmp_path):
    """Five seeded RGB images (JPEG and PNG) of mixed sizes, a list file of
    them and a record DB of 7 CHW 20x20 images; a ``.binaryproto`` mean of
    3x24x24 for the list and of 3x20x20 for the DB."""
    from sparknet_tpu_torch.data.createdb import create_db
    from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

    rs = np.random.RandomState(0)
    names = []
    for i, (h, w) in enumerate(SIZES):
        name = f"im{i}.{'jpg' if i % 2 else 'png'}"
        _save(tmp_path / name, rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        names.append(name)
    (tmp_path / "list.txt").write_text("".join(f"{n} {i % 3}\n" for i, n in enumerate(names))
                                       + "\n")
    save_mean_binaryproto(str(tmp_path / "mean24.binaryproto"),
                          rs.uniform(0, 255, (3, 24, 24)).astype(np.float32))
    create_db(str(tmp_path / "db.sndb"),
              [(rs.randint(0, 256, (3, 20, 20)).astype(np.uint8), i % 4) for i in range(7)])
    save_mean_binaryproto(str(tmp_path / "mean20.binaryproto"),
                          rs.uniform(0, 255, (3, 20, 20)).astype(np.float32))
    return tmp_path


def _layers(text):
    return parse(text).get_all("layer")[0], jparse(text).get_all("layer")[0]


def _image_layer(d, param="", transform=""):
    return _layers(
        'layer { name: "d" type: "ImageData" top: "data" top: "label" '
        f'image_data_param {{ source: "{d}/list.txt" root_folder: "{d}/" batch_size: 3 '
        f"{param} }} transform_param {{ {transform} }} }}")


def _same_batches(ours, theirs, n):
    for it in range(n):
        a, b = ours(it), theirs(it)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {it} {k}")


def _release(*sources):
    """End the JAX sources' decode threads (tied to their lifetime)."""
    for s in sources:
        del s
    gc.collect()


@pytest.mark.parametrize("param,transform,train", [
    ("new_height: 16 new_width: 16", "", True),
    ("new_height: 22 new_width: 22 shuffle: true rand_skip: 4",
     "crop_size: 16 mirror: true mean_value: 104 mean_value: 117 mean_value: 123 "
     "scale: 0.5", True),
    ("new_height: 24 new_width: 24 shuffle: true", 'crop_size: 20 mirror: true '
     'mean_file: "%(d)s/mean24.binaryproto"', False),
    ("new_height: 18 new_width: 20 is_color: false shuffle: true", "crop_size: 16", True),
])
def test_image_data_batches_are_jax_bit_for_bit(images, param, transform, train):
    """Five images in batches of 3 for 6 batches: the epoch wraps mid-batch
    and reshuffles; random crops, mirrors and means as the JAX source."""
    ours_lp, jax_lp = _image_layer(images, param, transform % {"d": images})
    with lf.ImageDataSource(ours_lp, train=train, seed=7) as ours:
        theirs = jlf.ImageDataSource(jax_lp, train=train, seed=7)
        _same_batches(ours, theirs, 6)
    _release(theirs)


def test_image_data_decode_pool_matches_serial_and_closes(images, monkeypatch):
    """The pooled decode gives the serial decode's batches; ``close`` ends
    the ``decode_*`` threads, and a later call decodes anew."""
    ours_lp, _ = _image_layer(images, "new_height: 16 new_width: 16 shuffle: true",
                              "crop_size: 12 mirror: true")
    monkeypatch.setenv("SPARKNET_DECODE_WORKERS", "1")
    serial = lf.ImageDataSource(ours_lp, train=True, seed=3)
    monkeypatch.setenv("SPARKNET_DECODE_WORKERS", "3")
    pooled = lf.ImageDataSource(ours_lp, train=True, seed=3)
    assert (serial.workers, pooled.workers) == (1, 3)
    _same_batches(pooled, serial, 3)
    assert any(t.name.startswith("decode") for t in threading.enumerate())
    pooled.close()
    assert not any(t.name.startswith("decode") for t in threading.enumerate())
    _same_batches(pooled, serial, 1)
    pooled.close()


def test_image_data_refusals(images):
    ours_lp, _ = _image_layer(images, "new_height: 9")
    with pytest.raises(ValueError, match="new_height and new_width"):
        lf.ImageDataSource(ours_lp, train=True)
    (images / "bad.txt").write_text("im0.png\n")
    lp = parse(f'layer {{ name: "d" type: "ImageData" top: "data" top: "label" '
               f'image_data_param {{ source: "{images}/bad.txt" batch_size: 1 }} }}'
               ).get_all("layer")[0]
    with pytest.raises(ValueError, match="expected '<path> <label>'"):
        lf.ImageDataSource(lp, train=True)


@pytest.fixture
def windows(tmp_path):
    """Three seeded images of mixed sizes with fg (overlap 0.6-0.9) and bg
    (overlap 0.0-0.3) windows, some reaching past the border, and one
    window between the thresholds (dropped at bg_threshold 0.4)."""
    from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

    rs = np.random.RandomState(1)
    lines = []
    for i, (h, w) in enumerate([(40, 48), (36, 36), (44, 30)]):
        _save(tmp_path / f"w{i}.jpg", rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        wins = [f"{i + 1} 0.8 4 5 {w - 10} {h - 8}", f"{(i % 2) + 1} 0.6 0 0 {w - 1} {h - 1}",
                "0 0.1 0 0 9 9", f"0 0.3 {w - 12} {h - 14} {w - 1} {h - 1}",
                "1 0.45 2 2 20 20"]
        lines += [f"# {i}", f"w{i}.jpg", f"3 {h} {w}", str(len(wins))] + wins
    (tmp_path / "windows.txt").write_text("\n".join(lines) + "\n")
    save_mean_binaryproto(str(tmp_path / "mean.binaryproto"),
                          rs.uniform(0, 255, (3, 32, 32)).astype(np.float32))
    return tmp_path


@pytest.mark.parametrize("param,transform,train", [
    ("", "crop_size: 24 mean_value: 100", True),
    ("context_pad: 4", "crop_size: 24 mirror: true mean_value: 90 mean_value: 100 "
     "mean_value: 110 scale: 0.25", True),
    ('context_pad: 3 crop_mode: "square"', 'crop_size: 28 mirror: true '
     'mean_file: "%(d)s/mean.binaryproto"', True),
    ('crop_mode: "square"', "crop_size: 20 mirror: true", False),
])
def test_window_data_batches_are_jax_bit_for_bit(windows, param, transform, train):
    """Batches of 8 (2 fg after 6 bg) for 4 batches: the fg/bg draws, the
    context pad and ``square`` geometry, the mirror, the mean file read at
    the padding's offset and the mean values, as the JAX source."""
    text = ('layer { name: "w" type: "WindowData" top: "data" top: "label" '
            f'window_data_param {{ source: "{windows}/windows.txt" root_folder: "{windows}/" '
            f"batch_size: 8 fg_threshold: 0.5 bg_threshold: 0.4 fg_fraction: 0.25 {param} }} "
            f"transform_param {{ {transform % {'d': windows}} }} }}")
    ours_lp, jax_lp = _layers(text)
    with lf.WindowDataSource(ours_lp, train=train, seed=5) as ours:
        theirs = jlf.WindowDataSource(jax_lp, train=train, seed=5)
        assert (len(ours.fg), len(ours.bg)) == (len(theirs.fg), len(theirs.bg)) == (6, 6)
        _same_batches(ours, theirs, 4)
        b = ours(4)
        assert list(b["label"][:6]) == [0] * 6 and all(b["label"][6:] > 0)


def test_window_data_refusals(windows):
    def layer(param, crop=24):
        return parse('layer { name: "w" type: "WindowData" top: "data" top: "label" '
                     f'window_data_param {{ source: "{windows}/windows.txt" batch_size: 4 '
                     f"{param} }} transform_param {{ crop_size: {crop} }} }}"
                     ).get_all("layer")[0]

    with pytest.raises(ValueError, match="context_pad 12 must be < crop_size/2"):
        lf.WindowDataSource(layer("context_pad: 12"), train=True)
    with pytest.raises(ValueError, match="need at least one fg and one bg"):
        lf.WindowDataSource(layer("fg_threshold: 0.95"), train=True)


@pytest.mark.parametrize("param,transform,train", [
    ("", "", True),
    ("rand_skip: 9", 'crop_size: 16 mirror: true mean_file: "%(d)s/mean20.binaryproto"',
     True),
    ("", "crop_size: 14 mean_value: 120 scale: 0.125", False),
])
def test_data_db_batches_are_jax_bit_for_bit(images, param, transform, train):
    """A record DB of 7 in batches of 3 for 5 batches (the cursor rewinds
    twice), with ``rand_skip`` and the transform, as the JAX source."""
    text = ('layer { name: "d" type: "Data" top: "data" top: "label" '
            f'data_param {{ source: "{images}/db.sndb" batch_size: 3 {param} }} '
            f"transform_param {{ {transform % {'d': images}} }} }}")
    ours_lp, jax_lp = _layers(text)
    with lf.DataDbSource(ours_lp, train=train, seed=11) as ours:
        _same_batches(ours, jlf.DataDbSource(jax_lp, train=train, seed=11), 5)
    missing = parse('layer { name: "d" type: "Data" top: "data" '
                    'data_param { source: "/nonexistent.sndb" batch_size: 3 } }'
                    ).get_all("layer")[0]
    with pytest.raises(ValueError, match="not found on this host"):
        lf.DataDbSource(missing, train=True)


def _net_text(d, data_layer):
    return (f'name: "n" {data_layer} '
            'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
            "inner_product_param { num_output: 3 } } "
            'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" '
            'top: "loss" }')


@pytest.mark.parametrize("data_layer", [
    'layer { name: "d" type: "ImageData" top: "data" top: "label" image_data_param {'
    ' source: "%(d)s/list.txt" root_folder: "%(d)s/" batch_size: 3 } transform_param {'
    " crop_size: 16 } }",
    'layer { name: "d" type: "ImageData" top: "data" top: "label" image_data_param {'
    ' source: "%(d)s/list.txt" root_folder: "%(d)s/" batch_size: 2 new_height: 18'
    " new_width: 20 is_color: false } }",
    'layer { name: "d" type: "ImageData" top: "data" top: "label" image_data_param {'
    ' source: "%(d)s/list.txt" root_folder: "%(d)s/" batch_size: 4 } }',
    'layer { name: "d" type: "ImageData" top: "data" top: "label" image_data_param {'
    ' source: "/nonexistent/list.txt" batch_size: 4 } }',
    'layer { name: "w" type: "WindowData" top: "data" top: "label" window_data_param {'
    ' source: "%(d)s/windows.txt" batch_size: 8 } transform_param { crop_size: 24 } }',
])
def test_layer_blob_shapes_match_jax(images, data_layer):
    """Declared shapes: the crop, else new_height/new_width, else the first
    listed image decoded, else unknown; WindowData at its crop."""
    text = _net_text(images, data_layer % {"d": images})
    ours = Network(parse(text), Phase.TRAIN, device="cpu").feed_shapes()
    theirs = JNetwork(jparse(text), JPhase.TRAIN).feed_shapes()
    assert ours == {k: tuple(v) for k, v in theirs.items()}
    if "nonexistent" not in text:
        assert ours["data"][0] in (2, 3, 4, 8) and len(ours) == 2


def test_source_from_net_follows_the_phase(images):
    """The first self-describing layer of the net's phase: a TRAIN source
    mirrors and crops at random, a TEST one takes the center; a net with
    none raises LookupError, as the JAX probe does."""
    text = _net_text(images, "".join(
        'layer { name: "d" type: "ImageData" top: "data" top: "label" '
        f"include {{ phase: {ph} }} image_data_param {{ source: \"{images}/list.txt\" "
        f'root_folder: "{images}/" batch_size: 3 new_height: 20 new_width: 20 }} '
        "transform_param { crop_size: 16 mirror: true } } " for ph in ("TRAIN", "TEST")))
    for phase, jphase in ((Phase.TRAIN, JPhase.TRAIN), (Phase.TEST, JPhase.TEST)):
        with lf.source_from_net(Network(parse(text), phase, device="cpu"), seed=2) as ours:
            theirs = jlf.source_from_net(JNetwork(jparse(text), jphase), seed=2)
            assert ours.train == (phase == Phase.TRAIN) == theirs.train
            _same_batches(ours, theirs, 3)
        _release(theirs)
    plain = 'name: "p" input: "data" input_dim: 1 input_dim: 3 input_dim: 4 input_dim: 4'
    with pytest.raises(LookupError, match="no Data/ImageData/WindowData/HDF5Data"):
        lf.source_from_net(Network(parse(plain), Phase.TRAIN, device="cpu"))


def test_a_center_cropped_batch_feeds_the_net_dense(images):
    """A TEST-phase crop is a strided view of the transformed batch; the
    net takes it as a dense NCHW blob (the card's kernels take only
    those), with the same values."""
    text = _net_text(images, (
        'layer { name: "d" type: "ImageData" top: "data" top: "label" '
        f'image_data_param {{ source: "{images}/list.txt" root_folder: "{images}/" '
        "batch_size: 3 new_height: 20 new_width: 20 } transform_param { crop_size: 16 } }"))
    net = Network(parse(text), Phase.TEST, device="cpu")
    with lf.source_from_net(net) as src:
        feeds = src(0)
    assert not feeds["data"].flags["C_CONTIGUOUS"]
    blobs, _, _ = net.apply(net.init(), feeds, train=False)
    assert blobs["data"].is_contiguous()
    np.testing.assert_array_equal(blobs["data"].numpy(), feeds["data"])
