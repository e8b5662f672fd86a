"""The port CLI's dataset, deploy and log tools against the JAX CLI's.

Each tool runs in both CLIs through ``main(argv)`` on fixtures the test
writes from numpy seeds.  Files are byte-equal (DBs, resized images, label
files, upgraded prototxts and binaries, CSV tables, DOT graphs, PNG
charts), JSON lines equal (paths aside), arrays bit for bit
(``load_digits_dataset``); ``classify``'s labels are the JAX CLI's and its
probabilities, printed at 4 decimals, within one unit of the last decimal
(the two packages' forwards agree at atol 1e-5, which may flip a
rounding).  ``WorkerStore`` keeps the JAX store's contract.
"""

import json
import os
import struct
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

from sparknet_tpu import cli as jcli  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.net import export_caffemodel as jexport  # noqa: E402
from sparknet_tpu.proto import parse as jparse  # noqa: E402

from sparknet_tpu_torch import cli  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

MAINS = (("p", cli.main), ("j", jcli.main))


def _out(main, argv, capsys, rc=0):
    assert main(argv) == rc
    return capsys.readouterr().out


def _tree(d) -> dict:
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _contents(path):
    """A file's bytes, or a directory's ``_tree``."""
    return _tree(path) if os.path.isdir(path) else path.read_bytes()


def _jpeg_tree(d, n=6, seed=0):
    from PIL import Image

    rs = np.random.RandomState(seed)
    os.makedirs(d / "sub", exist_ok=True)
    names = []
    for i in range(n):
        rel = f"{'sub/' if i % 2 else ''}img_{i}.{'JPG' if i == 3 else 'jpg'}"
        Image.fromarray(rs.randint(0, 256, (20 + 3 * i, 28 - i, 3)).astype(np.uint8)).save(
            d / rel, format="JPEG")
        names.append(rel)
    (d / "broken.jpg").write_bytes(b"not a jpeg")
    return names


@pytest.mark.parametrize("backend", ["record", "lmdb", "leveldb"])
def test_convert_imageset_writes_the_jax_db(tmp_path, capsys, backend):
    """A list with a broken and a missing image: the same records, bytes
    and JSON."""
    names = _jpeg_tree(tmp_path)
    (tmp_path / "list.txt").write_text("".join(f"{n} {i}\n" for i, n in enumerate(names))
                                       + "broken.jpg 1\nmissing.jpg 2\n\n")
    outs = {}
    for tag, main in MAINS:
        db = str(tmp_path / f"{tag}_db")
        outs[tag] = json.loads(_out(main, [
            "convert_imageset", "--root", str(tmp_path), "--listfile",
            str(tmp_path / "list.txt"), "--db", db, "--resize", "16", "--backend", backend],
            capsys))
        assert outs[tag]["records"] == 6
    assert _contents(tmp_path / "p_db") == _contents(tmp_path / "j_db")
    assert {k: v for k, v in outs["p"].items() if k != "db"} == \
        {k: v for k, v in outs["j"].items() if k != "db"}


def test_resize_images_writes_the_jax_tree(tmp_path, capsys):
    """Shorter side to 16, center crop, the tree's structure kept; the
    broken file is an error in both (exit 1)."""
    _jpeg_tree(tmp_path / "in")
    for tag, main in MAINS:
        out = json.loads(_out(main, [
            "resize_images", "--input-folder", str(tmp_path / "in"), "--output-folder",
            str(tmp_path / tag), "--side", "16", "--workers", "1"], capsys, rc=1))
        assert out == {"resized": 6, "errors": 1}
    ours, theirs = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert ours == theirs and len(ours) == 6
    with pytest.raises(SystemExit, match="no images under"):
        cli.main(["resize_images", "--input-folder", str(tmp_path / "sub_none"),
                  "--output-folder", str(tmp_path / "x")])


def test_create_labelfile_and_pull_shards_match_jax(tmp_path, capsys):
    """Tar shards in a local store, staged by number; a label file for the
    staged files from a master list (case-normalized, some unlabeled)."""
    store = tmp_path / "store"
    store.mkdir()
    rs = np.random.RandomState(2)
    master = []
    for s in (0, 1, 2, 5):
        with tarfile.open(store / f"files-shuf-{s:03d}.tar", "w") as tf:
            for i in range(3):
                p = tmp_path / f"f{s}_{i}.jpeg"
                p.write_bytes(rs.bytes(40))
                tf.add(p, arcname=f"F{s}_{i}.JPEG" if i == 0 else f"d/f{s}_{i}.jpeg")
                if i < 2:
                    master.append(f"f{s}_{i}.JPEG {s * 10 + i}\n")
    (store / "notes.txt").write_text("x")
    (tmp_path / "master.txt").write_text("".join(master))
    for tag, main in MAINS:
        out = json.loads(_out(main, ["pull_shards", "--store", str(store), "--start", "1",
                                     "--stop", "6", "--out", str(tmp_path / tag)], capsys))
        assert out["out"] == str(tmp_path / tag / "001-006")
        assert {k: out[k] for k in ("shards", "files", "clobbered")} == \
            {"shards": 3, "files": 9, "clobbered": 0}
        out = json.loads(_out(main, ["create_labelfile", str(tmp_path / tag / "001-006"),
                                     str(tmp_path / "master.txt"),
                                     str(tmp_path / f"{tag}_train.txt")], capsys))
        assert {k: out[k] for k in ("entries", "unlabeled")} == {"entries": 6, "unlabeled": 3}
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    assert (tmp_path / "p_train.txt").read_bytes() == (tmp_path / "j_train.txt").read_bytes()
    with pytest.raises(SystemExit, match=r"no shards numbered \[7, 9\)"):
        cli.main(["pull_shards", "--store", str(store), "--start", "7", "--stop", "9",
                  "--out", str(tmp_path / "x")])
    for scheme in ("gs", "s3"):
        with pytest.raises(SystemExit, match="ROADMAP Queue A9"):
            cli.main(["pull_shards", "--store", f"{scheme}://b/s", "--start", "0",
                      "--stop", "1", "--out", str(tmp_path / "x")])


V1_NET = """
name: "v1net"
layers { name: "data" type: MEMORY_DATA top: "data" top: "label"
  memory_data_param { batch_size: 2 channels: 1 height: 8 width: 8 } }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 3 kernel_size: 3 } }
layers { name: "relu1" type: RELU bottom: "conv1" top: "conv1" }
layers { name: "ip1" type: INNER_PRODUCT bottom: "conv1" top: "ip1"
  inner_product_param { num_output: 4 } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label" top: "loss" }
"""


def _v1_binary(rs) -> bytes:
    """A V1 binary NetParameter: layers in field 2 with enum types, blobs,
    blobs_lr and weight_decay (ref: upgrade_net_proto_binary.cpp)."""
    from sparknet_tpu_torch.proto.binary import _encode_blob, _len_field, _tag, _varint

    conv_param = _tag(1, 0) + _varint(4) + _tag(4, 0) + _varint(3)
    conv = (_len_field(2, b"data") + _len_field(3, b"conv1") + _len_field(4, b"conv1")
            + _tag(5, 0) + _varint(4)
            + _len_field(6, _encode_blob(rs.randn(4, 3, 3, 3).astype(np.float32)))
            + _len_field(6, _encode_blob(rs.randn(4).astype(np.float32)))
            + _tag(7, 5) + struct.pack("<f", 1.0) + _tag(7, 5) + struct.pack("<f", 2.0)
            + _tag(8, 5) + struct.pack("<f", 1.0) + _tag(8, 5) + struct.pack("<f", 0.0)
            + _len_field(10, conv_param))
    relu = (_len_field(2, b"conv1") + _len_field(3, b"conv1") + _len_field(4, b"relu1")
            + _tag(5, 0) + _varint(18))
    return _len_field(1, b"old_net") + _len_field(2, conv) + _len_field(2, relu)


def test_upgrade_tools_write_the_jax_files(tmp_path, capsys):
    (tmp_path / "v1.prototxt").write_text(V1_NET)
    (tmp_path / "v1.caffemodel").write_bytes(_v1_binary(np.random.RandomState(5)))
    (tmp_path / "solver.prototxt").write_text("base_lr: 0.01\nsolver_type: ADAGRAD\n"
                                              "momentum: 0.9\n")
    for tag, main in MAINS:
        for cmd, src, ext in (("upgrade_net_proto_text", "v1.prototxt", ".prototxt"),
                              ("upgrade_net_proto_binary", "v1.caffemodel", ".caffemodel"),
                              ("upgrade_solver_proto_text", "solver.prototxt", ".solver")):
            out = json.loads(_out(main, [cmd, str(tmp_path / src),
                                         str(tmp_path / f"{tag}{ext}")], capsys))
            assert out.pop("out") == str(tmp_path / f"{tag}{ext}")
            assert out == {"upgrade_net_proto_text": {"layers": 5},
                           "upgrade_net_proto_binary": {"layers": 2, "upgraded_v1_records": 2,
                                                        "blobs": 2},
                           "upgrade_solver_proto_text": {"type": "AdaGrad"}}[cmd]
    for ext in (".prototxt", ".caffemodel", ".solver"):
        assert (tmp_path / f"p{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    net = Network(parse((tmp_path / "p.prototxt").read_text()), Phase.TRAIN, device="cpu")
    assert [l.type for l in net.layers][1:] == ["Convolution", "ReLU", "InnerProduct",
                                               "SoftmaxWithLoss"]


@pytest.mark.parametrize("argv", [
    ["--net", "zoo:lenet", "--batch", "4"],
    ["--net", "zoo:caffenet", "--batch", "2", "--rankdir", "TB", "--phase", "TEST"],
    ["--net", "{net}", "--phase", "TRAIN"],
])
def test_draw_writes_the_jax_dot(tmp_path, capsys, argv):
    (tmp_path / "net.prototxt").write_text(V1_NET)
    argv = [a.format(net=tmp_path / "net.prototxt") for a in argv]
    for tag, main in MAINS:
        out = json.loads(_out(main, ["draw", *argv, "--out", str(tmp_path / f"{tag}.dot")],
                              capsys))
        assert out["rankdir"] == (argv[argv.index("--rankdir") + 1]
                                  if "--rankdir" in argv else "LR")
    dot = (tmp_path / "p.dot").read_text()
    assert dot == (tmp_path / "j.dot").read_text() and dot.startswith("digraph")


@pytest.fixture
def train_log(tmp_path, capsys, monkeypatch):
    """The port CLI's own training output on LeNet (synthetic batches,
    display every iteration, a test pass): its EventLogger file, and a
    capture of its stdout (solver display lines and the echoed events)."""
    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path / "logs"))
    solver = tmp_path / "solver.prototxt"
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.proto import serialize

    net = tmp_path / "lenet.prototxt"
    net.write_text(serialize(models.lenet(4)))
    solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nlr_policy: "inv"\ngamma: 0.0001\n'
                      "power: 0.75\nmomentum: 0.9\nmax_iter: 4\ndisplay: 1\n")
    out = _out(cli.main, ["train", "--device", "cpu", "--solver", str(solver), "--data",
                          "synthetic", "--test-iters", "2", "--output",
                          str(tmp_path / "final")], capsys)
    capture = tmp_path / "capture.log"
    capture.write_text(out)
    (event_log,) = (tmp_path / "logs").iterdir()
    return event_log, capture


def test_parse_log_reads_the_ports_event_log_as_jax(train_log, tmp_path, capsys):
    """Both logs of a port run: the same .train/.test CSV bytes; the tables
    hold the 4 iterations (loss, and the learning rate from the display
    lines) and the test scores."""
    for log in train_log:
        for tag, main in MAINS:
            out = json.loads(_out(main, ["parse_log", str(log), str(tmp_path / tag)], capsys))
            assert out == {"train": str(tmp_path / tag / (log.name + ".train")),
                           "test": str(tmp_path / tag / (log.name + ".test"))}
        for ext in (".train", ".test"):
            ours = (tmp_path / "p" / (log.name + ext)).read_text()
            assert ours == (tmp_path / "j" / (log.name + ext)).read_text()
        train = (tmp_path / "p" / (log.name + ".train")).read_text().splitlines()
        test = (tmp_path / "p" / (log.name + ".test")).read_text().splitlines()
        assert len(train) == 5 and train[0].startswith("NumIters")
        assert len(test) == 2 and "accuracy" in test[0] and "loss" in test[0]
    assert "LearningRate" in (tmp_path / "p" / "capture.log.train").read_text()


@pytest.mark.parametrize("chart", [0, 6, 7])
def test_plot_training_log_draws_the_jax_chart(train_log, tmp_path, capsys, chart):
    pytest.importorskip("matplotlib")
    from PIL import Image

    event_log, _ = train_log
    for tag, main in MAINS:
        out = json.loads(_out(main, ["plot_training_log", str(chart),
                                     str(tmp_path / f"{tag}.png"), str(event_log)], capsys))
        assert out == {"chart": str(tmp_path / f"{tag}.png")}
    ours = np.asarray(Image.open(tmp_path / "p.png"))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(tmp_path / "j.png")))
    assert ours.std() > 0
    with pytest.raises(SystemExit, match="unknown chart type 9"):
        cli.main(["plot_training_log", "9", str(tmp_path / "x.png"), str(event_log)])


DEPLOY = """
name: "tiny_deploy"
input: "data"
input_dim: 4 input_dim: 3 input_dim: 8 input_dim: 8
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 stride: 1 pad: 1 } }
%(bn)s
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "ip1" type: "InnerProduct" bottom: "norm1" top: "ip1"
  inner_product_param { num_output: 7 } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""
BN = ('layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" '
      "batch_norm_param { use_global_stats: true } } "
      'layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1" '
      "scale_param { bias_term: true } }")


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    """Deploy nets (with and without BatchNorm), seeded ``.caffemodel``
    weights the JAX package writes, a label file, a mean and 3 PNGs."""
    from PIL import Image

    from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

    d = tmp_path_factory.mktemp("classify")
    rs = np.random.RandomState(7)
    for name, bn in (("plain", ""), ("bn", BN)):
        text = DEPLOY % {"bn": bn}
        (d / f"{name}.prototxt").write_text(text)
        init = Network(parse(text), Phase.TEST, device="cpu").init()
        params = {ln: [(rs.randn(*p.shape) * 0.05).astype(np.float32) for p in pl]
                  for ln, pl in init.params.items()}
        if bn:
            params["bn1"] = [rs.uniform(-0.2, 0.2, 6).astype(np.float32),
                             rs.uniform(0.5, 1.5, 6).astype(np.float32),
                             np.ones(1, np.float32)]
        jexport(JNetwork(jparse(text), JPhase.TEST), params, str(d / f"{name}.caffemodel"))
    (d / "labels.txt").write_text("\n".join(f"class_{i}" for i in range(7)) + "\n")
    save_mean_binaryproto(str(d / "mean.binaryproto"),
                          rs.uniform(100, 130, (3, 8, 8)).astype(np.float32))
    images = []
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (14 + i, 12, 3)).astype(np.uint8)).save(
            d / f"im{i}.png")
        images.append(str(d / f"im{i}.png"))
    return d, images


@pytest.mark.parametrize("net,flags", [
    ("plain", ["--mean", "{d}/mean.binaryproto", "--labels", "{d}/labels.txt", "--top", "3"]),
    ("plain", ["--oversample", "--images-dim", "12,12", "--bgr", "--top", "7"]),
    ("plain", ["--center-only", "--raw-scale", "0", "--labels", "{d}/labels.txt"]),
    ("plain", ["--int8", "--mean", "{d}/mean.binaryproto"]),
    ("bn", ["--fold-bn", "--images-dim", "10,10", "--labels", "{d}/labels.txt"]),
    ("bn", ["--fold-bn", "--int8"]),
])
def test_classify_prints_the_jax_predictions(deploy, capsys, net, flags):
    d, images = deploy
    flags = [f.format(d=d) for f in flags]
    results = {}
    for tag, main in MAINS:
        argv = ["classify", "--model", str(d / f"{net}.prototxt"), "--weights",
                str(d / f"{net}.caffemodel"), *flags, *images]
        if tag == "p":
            argv.insert(1, "--device=cpu")
        lines = _out(main, argv, capsys).strip().splitlines()
        results[tag] = [json.loads(line) for line in lines]
    ours, theirs = results["p"], results["j"]
    assert ours[:-1] == theirs[:-1]  # the fold_bn and int8 lines
    assert len(ours[-1]) == len(theirs[-1]) == 3
    for a, b in zip(ours[-1], theirs[-1]):
        assert a["image"] == b["image"]
        assert [p["label"] for p in a["predictions"]] == [p["label"] for p in b["predictions"]]
        np.testing.assert_allclose([p["prob"] for p in a["predictions"]],
                                   [p["prob"] for p in b["predictions"]], atol=1.5e-4)


def test_classify_refusals_match_jax(deploy):
    d, images = deploy
    base = ["classify", "--model", str(d / "plain.prototxt")]
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            main([*base, *extra, "--oversample", "--center-only", *images])
        with pytest.raises(SystemExit, match="smaller than the net input"):
            main([*base, *extra, "--images-dim", "4,4", *images])
        with pytest.raises(SystemExit, match='--images-dim must be "H,W"'):
            main([*base, *extra, "--images-dim", "12", *images])


def test_worker_store_keeps_the_jax_contract():
    from sparknet_tpu.worker_store import WorkerStore as JWorkerStore

    from sparknet_tpu_torch.worker_store import WorkerStore, worker_store

    assert isinstance(worker_store, WorkerStore)
    for store in (WorkerStore(), JWorkerStore()):
        store.set("net", 1)
        store.set("net", 2)
        assert store.get("net") == 2 and store.contains("net")
        store.remove("net")
        store.remove("net")  # a missing key: no error
        assert not store.contains("net")
        with pytest.raises(KeyError):
            store.get("net")
        store.set("a", [1])
        store.clear()
        assert not store.contains("a")


def test_load_digits_dataset_is_jax_bit_for_bit():
    pytest.importorskip("sklearn")
    from sparknet_tpu.data import digits as jdigits

    from sparknet_tpu_torch.data import digits

    for upscale, every in ((28, 5), (8, 3), (0, 7)):
        ours = digits.load_digits_dataset(upscale, every)
        theirs = jdigits.load_digits_dataset(upscale, every)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    xtr, ytr, _, _ = ours
    fn, jfn = digits.minibatch_fn(xtr, ytr, 64, seed=3), jdigits.minibatch_fn(xtr, ytr, 64, seed=3)
    for it in range(len(ytr) // 64 + 2):  # across an epoch's reshuffle
        a, b = fn(it), jfn(it)
        np.testing.assert_array_equal(a["data"], b["data"])
        np.testing.assert_array_equal(a["label"], b["label"])
