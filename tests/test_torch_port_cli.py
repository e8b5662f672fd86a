"""``python -m sparknet_tpu_torch.cli`` against the JAX package's ``tpunet``.

Both CLIs run in process through ``main(argv)`` on the same files: DBs
written from numpy seeds and a ``.caffemodel`` the JAX package exports.
``convert_db`` and ``compute_image_mean`` write the same files; ``test``
scores and ``extract_features`` arrays agree within atol 1e-5; ``train
--data db: --weights`` on LeNet (no dropout) gives a first-iteration loss
within rtol 1e-4 (the port's solver tests' tolerance); ``time`` lists the
JAX table's layers and types; ``train --profile`` and ``time --trace`` run;
``train`` and ``test`` under ``--layout nhwc`` give nchw's loss (rtol 1e-5)
and leave the caller's layout as it was; every JAX flag, subcommand, layer
type or store the port does not carry exits naming its ROADMAP item.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import cli as jcli  # noqa: E402
from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.data.createdb import create_db as jcreate_db  # noqa: E402
from sparknet_tpu.net import export_caffemodel as jexport  # noqa: E402

from sparknet_tpu_torch import cli, models  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402

LENET = ["--solver", "zoo:lenet", "--batch", "4", "--data-scale", "0.00390625"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A record DB of 12 MNIST-shaped images, a LevelDB of 12 CIFAR-shaped
    ones, and a ``.caffemodel`` of seeded LeNet weights written by JAX."""
    d = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(0)
    mnist = [(rs.randint(0, 256, (1, 28, 28)).astype(np.uint8), i % 10) for i in range(12)]
    jcreate_db(str(d / "mnist.sndb"), mnist)
    cifar = [(rs.randint(0, 256, (3, 8, 8)).astype(np.uint8), i % 10) for i in range(12)]
    jcreate_db(str(d / "cifar_leveldb"), cifar, backend="leveldb")
    shapes = Network(models.lenet(4), Phase.TRAIN, device="cpu").init()
    params = {ln: [(rs.randn(*p.shape) * 0.05).astype(np.float32) for p in pl]
              for ln, pl in shapes.params.items()}
    jexport(JNetwork(jm.lenet(4), JPhase.TRAIN), params, str(d / "lenet.caffemodel"))
    return d


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_convert_db_and_image_mean_match_jax(files, tmp_path, capsys):
    """LevelDB -> record -> lmdb in each CLI gives the same files and JSON;
    the ``.binaryproto`` and ``.npy`` means are the JAX CLI's bytes and
    read back equal."""
    from sparknet_tpu_torch.data.io_utils import load_mean_binaryproto

    src = str(files / "cifar_leveldb")
    for main, name in ((cli.main, "p"), (jcli.main, "j")):
        rec, lmdb = str(tmp_path / f"{name}.sndb"), str(tmp_path / f"{name}_lmdb")
        out = _run(main, ["convert_db", "--src", src, "--dst", rec], capsys)
        assert json.loads(out) == {"records": 12, "src": src, "dst": rec, "backend": "record"}
        _run(main, ["convert_db", "--src", rec, "--dst", lmdb, "--backend", "lmdb"], capsys)
        for ext in (".binaryproto", ".npy"):
            out = _run(main, ["compute_image_mean", "--db", lmdb, "--out",
                              str(tmp_path / f"{name}{ext}"), "--batch", "5"], capsys)
            assert json.loads(out)["shape"] == [3, 8, 8]
    assert (tmp_path / "p.sndb").read_bytes() == (tmp_path / "j.sndb").read_bytes()
    for n in os.listdir(tmp_path / "j_lmdb"):
        assert (tmp_path / "p_lmdb" / n).read_bytes() == (tmp_path / "j_lmdb" / n).read_bytes()
    assert (tmp_path / "p.binaryproto").read_bytes() == (tmp_path / "j.binaryproto").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))
    np.testing.assert_array_equal(load_mean_binaryproto(str(tmp_path / "p.binaryproto")),
                                  np.load(tmp_path / "j.npy"))


def test_test_scores_and_extract_features_match_jax(files, tmp_path, capsys):
    db = ["--data", f"db:{files / 'mnist.sndb'}", "--weights", str(files / "lenet.caffemodel"),
          "--iterations", "3"]
    port = json.loads(_run(cli.main, ["test", "--device", "cpu", *LENET, *db], capsys))
    jax_ = json.loads(_run(jcli.main, ["test", *LENET, *db], capsys))
    assert sorted(port) == sorted(jax_) == ["accuracy", "loss"]
    for k in port:
        np.testing.assert_allclose(port[k], jax_[k], atol=1e-5, rtol=0)
    for main, name, dev in ((cli.main, "p", ["--device", "cpu"]), (jcli.main, "j", [])):
        out = _run(main, ["extract_features", *dev, *LENET, *db, "--blob", "ip1",
                          "--out", str(tmp_path / f"{name}.npy")], capsys)
        assert json.loads(out)["shape"] == [12, 500]
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"),
                               atol=1e-5, rtol=0)
    with pytest.raises(SystemExit, match="needs --weights or --snapshot"):
        cli.main(["test", "--device", "cpu", *LENET, "--data", "synthetic"])
    with pytest.raises(SystemExit, match="blob shape"):
        cli.main(["test", "--device", "cpu", "--solver", "zoo:cifar10_quick", "--batch", "4",
                  "--data", "synthetic", "--weights", str(files / "lenet.caffemodel")])
    from sparknet_tpu_torch.proto.binary import CaffeModel, CaffeModelLayer, save_caffemodel

    ghost = str(tmp_path / "ghost.caffemodel")
    save_caffemodel(ghost, CaffeModel("g", [CaffeModelLayer("ghost", "ReLU", [np.ones(2)])]))
    with pytest.raises(SystemExit, match="no layers could be loaded"):
        cli.main(["test", "--device", "cpu", *LENET, "--data", "synthetic", "--weights", ghost])


NET_WITH_DATA_LAYER = """
name: "LeNetDB"
layer { name: "mnist" type: "Data" top: "data" top: "label"
  data_param { source: "%(db)s" batch_size: 4 }
  transform_param { crop_size: 28 mirror: true scale: 0.00390625 mean_file: "%(mean)s" } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 20 kernel_size: 5 } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 50 kernel_size: 5 } }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
  inner_product_param { num_output: 500 } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 10 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "ip2" bottom: "label" top: "accuracy"
  include { phase: TEST } }
"""


def test_data_layer_net_from_a_solver_file_matches_jax(files, tmp_path, capsys):
    """A solver prototxt whose net reads a ``Data`` layer (its geometry
    peeked from the DB, transform_param cropping 32 to 28 and subtracting
    a ``.binaryproto`` mean): ``test`` scores within atol 1e-5 of the JAX
    CLI's; ``--data auto`` on it streams data_param.source and scores as
    ``--data db:`` does."""
    from sparknet_tpu_torch.data.createdb import create_db, db_mean
    from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

    rs = np.random.RandomState(3)
    db = str(tmp_path / "m32.sndb")
    create_db(db, [(rs.randint(0, 256, (1, 32, 32)).astype(np.uint8), i % 10)
                   for i in range(8)])
    save_mean_binaryproto(str(tmp_path / "mean.binaryproto"), db_mean(db))
    (tmp_path / "net.prototxt").write_text(
        NET_WITH_DATA_LAYER % {"db": db, "mean": str(tmp_path / "mean.binaryproto")})
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{tmp_path / "net.prototxt"}"\nbase_lr: 0.01\n'
                      'lr_policy: "fixed"\nmomentum: 0.9\nmax_iter: 10\n')
    argv = ["test", "--solver", str(solver), "--data", f"db:{db}", "--iterations", "2",
            "--weights", str(files / "lenet.caffemodel")]
    port = json.loads(_run(cli.main, [*argv, "--device", "cpu"], capsys))
    jax_ = json.loads(_run(jcli.main, argv, capsys))
    assert sorted(port) == sorted(jax_) == ["accuracy", "loss"]
    for k in port:
        np.testing.assert_allclose(port[k], jax_[k], atol=1e-5, rtol=0)
    # without --data the net streams its own data_param.source, as --data db:
    auto = json.loads(_run(cli.main, ["test", "--device", "cpu", "--solver", str(solver),
                                      "--iterations", "2", "--weights",
                                      str(files / "lenet.caffemodel")], capsys))
    assert auto == port


def test_train_from_db_with_weights_matches_jax(files, tmp_path, capsys, monkeypatch):
    """One iteration of ``train --data db: --weights`` on LeNet: the same
    finetune JSON and a loss within rtol 1e-4 of the JAX CLI's; the final
    snapshot restores."""
    from sparknet_tpu.solvers.solver import Solver as JSolver

    from sparknet_tpu_torch.solvers.solver import Solver

    losses = {}
    for cls, name in ((Solver, "p"), (JSolver, "j")):
        step = cls.step

        def spy(self, *a, _step=step, _name=name, **k):
            losses[_name] = _step(self, *a, **k)
            return losses[_name]

        monkeypatch.setattr(cls, "step", spy)
    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path))
    argv = [*LENET, "--data", f"db:{files / 'mnist.sndb'}", "--weights",
            str(files / "lenet.caffemodel"), "--iterations", "1", "--test-iters", "2"]
    outs = {}
    for main, name, dev in ((cli.main, "p", ["--device", "cpu"]), (jcli.main, "j", [])):
        outs[name] = _run(main, ["train", *dev, *argv, "--output", str(tmp_path / name)],
                          capsys).strip().splitlines()[0]
    assert json.loads(outs["p"]) == json.loads(outs["j"])
    assert json.loads(outs["p"])["layers_loaded"] == ["conv1", "conv2", "ip1", "ip2"]
    np.testing.assert_allclose(losses["p"], losses["j"], rtol=1e-4)
    s = Solver(models.lenet_solver(), models.lenet(4), device="cpu")
    s.restore(str(tmp_path / "p.solverstate.npz"))
    assert s.iter == 1


@pytest.mark.parametrize("cmd", ["train", "test"])
def test_layout_nhwc_gives_nchw_loss(cmd, files, tmp_path, capsys, monkeypatch):
    """``train`` (one iteration) and ``test`` (two batches) from the DB with
    the same LeNet weights under ``--layout nhwc`` and ``--layout nchw``:
    the canonical DB batches reach the net channels-last and the loss is
    nchw's; the layout is the caller's again after each call."""
    from sparknet_tpu_torch.common import get_config
    from sparknet_tpu_torch.solvers.solver import Solver

    losses = []
    step = Solver.step

    def spy(self, *a, **k):
        losses.append(step(self, *a, **k))
        return losses[-1]

    monkeypatch.setattr(Solver, "step", spy)
    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path))
    argv = [cmd, "--device", "cpu", *LENET, "--data", f"db:{files / 'mnist.sndb'}",
            "--weights", str(files / "lenet.caffemodel"), "--iterations",
            "1" if cmd == "train" else "2"]
    got = {}
    for lay in ("nhwc", "nchw"):
        extra = ["--test-iters", "1", "--output", str(tmp_path / lay)] if cmd == "train" else []
        out = _run(cli.main, [*argv, *extra, "--layout", lay], capsys)
        assert get_config().layout == "nchw"
        got[lay] = losses[-1] if cmd == "train" else json.loads(out)["loss"]
    np.testing.assert_allclose(got["nhwc"], got["nchw"], rtol=1e-5)


def test_time_rows_match_jax(capsys):
    """``time_layers`` and the ``time`` table list the JAX table's layers
    and types in its order; ``--fused`` prints the JAX CLI's keys."""
    import jax
    from sparknet_tpu.utils.timing import time_layers as jtime_layers

    from sparknet_tpu_torch.utils.timing import Timer, time_layers

    rs = np.random.RandomState(1)
    feeds = {"data": rs.rand(4, 1, 28, 28).astype(np.float32),
             "label": rs.randint(0, 10, 4).astype(np.int32)}
    net = Network(models.lenet(4), Phase.TRAIN, device="cpu")
    rows = time_layers(net, net.init(), feeds, iterations=1)
    jnet = JNetwork(jm.lenet(4), JPhase.TRAIN)
    jrows = jtime_layers(jnet, jnet.init(jax.random.key(0)), feeds, iterations=1)
    assert [(r["layer"], r["type"]) for r in rows] == [(r["layer"], r["type"]) for r in jrows]
    assert all(r["forward_ms"] >= 0 and r["backward_ms"] is not None for r in rows)
    tables = [_run(main, ["time", *dev, "--solver", "zoo:lenet", "--batch", "4",
                          "--iterations", "1"], capsys)
              for main, dev in ((cli.main, ["--device", "cpu"]), (jcli.main, []))]
    cols = [[line.split()[:2] for line in t.splitlines()[1:-2]] for t in tables]
    assert cols[0] == cols[1] and len(cols[0]) == 8
    fused = json.loads(_run(cli.main, ["time", "--device", "cpu", "--solver", "zoo:lenet",
                                       "--batch", "4", "--iterations", "2", "--fused"], capsys))
    assert sorted(fused) == ["batch", "fused_step_ms", "img_per_sec"] and fused["batch"] == 4
    t = Timer("cpu").start()
    assert t.stop() >= 0


def test_time_layers_backward_none_only_without_a_gradient(monkeypatch):
    """A layer none of whose outputs carries a gradient (Accuracy) gets no
    backward time; a backward that fails raises instead of reading as a
    layer without one."""
    from sparknet_tpu_torch.ops.base import LayerOutput
    from sparknet_tpu_torch.proto.text_format import parse
    from sparknet_tpu_torch.utils.timing import time_layers

    net = Network(parse(
        'name: "t"\n'
        'layer { name: "data" type: "JavaData" top: "data"'
        ' java_data_param { shape { dim: 4 dim: 6 } } }\n'
        'layer { name: "label" type: "JavaData" top: "label"'
        ' java_data_param { shape { dim: 4 } } }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"'
        ' inner_product_param { num_output: 3 } }\n'
        'layer { name: "acc" type: "Accuracy" bottom: "ip" bottom: "label" top: "acc" }\n'
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"'
        ' top: "loss" }\n'), Phase.TRAIN, device="cpu")
    rs = np.random.RandomState(0)
    feeds = {"data": rs.rand(4, 6).astype(np.float32),
             "label": rs.randint(0, 3, 4).astype(np.int32)}
    rows = time_layers(net, net.init(), feeds, iterations=1)
    assert [(r["type"], r["backward_ms"] is None) for r in rows] == [
        ("InnerProduct", False), ("Accuracy", True), ("SoftmaxWithLoss", False)]

    class Broken(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("the backward kernel failed to launch")

    ip = next(layer for layer in net.layers if layer.name == "ip")
    apply = ip.apply
    monkeypatch.setattr(ip, "apply", lambda *a, **k: LayerOutput(
        [Broken.apply(o) for o in apply(*a, **k).outputs]))
    with pytest.raises(RuntimeError, match="failed to launch"):
        time_layers(net, net.init(), feeds, iterations=1)


HDF5_NET = ('name: "h" layer { name: "d" type: "HDF5Data" top: "data" top: "label" '
            'hdf5_data_param { source: "h5.txt" batch_size: 2 } } '
            'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
            "inner_product_param { num_output: 2 } }")


@pytest.mark.parametrize("argv,item", [
    (["train", "--solver", "{hdf5}", "--data", "proto"], "Queue A9"),
    (["pull_shards", "--store", "gs://bucket/shards", "--start", "0", "--stop", "1",
      "--out", "o"], "Queue A9"),
    (["pull_shards", "--store", "s3://bucket/shards", "--start", "0", "--stop", "1",
      "--out", "o"], "Queue A9"),
    (["train", "--solver", "{hdf5}"], "Queue A9"),
    (["test", "--solver", "{hdf5}", "--weights", "w.caffemodel"], "Queue A9"),
    (["train", "--weights", "w.h5"], "Queue A4"),
    (["classify", "--model", "m.prototxt", "--weights", "w.h5", "x.jpg"], "Queue A4"),
    (["train", "--scan", "4"], "Queue A5"),
    (["time", "--hlo"], "Queue A14"),
    (["bench", "--layout", "nhwc"], "Queue A6"),
    (["train", "--scan", "2"], "Queue A5"),
    (["bench", "--batch", "256"], "Queue A6"),
    (["extract_features", "--solver", "{hdf5}", "--blob", "ip", "--out", "f.npy"], "Queue A9"),
    (["bench"], "Queue A6"),
    (["pods"], "Queue A9"),
    (["pods", "create"], "Queue A9"),
])
def test_unported_flags_and_commands_name_their_item(argv, item, tmp_path):
    nets = {}
    for key, text in (("hdf5", HDF5_NET),):
        (tmp_path / f"{key}.prototxt").write_text(text)
        (tmp_path / f"{key}_solver.prototxt").write_text(
            f'net: "{tmp_path / key}.prototxt"\nbase_lr: 0.01\nlr_policy: "fixed"\n')
        nets[key] = str(tmp_path / f"{key}_solver.prototxt")
    argv = [a.format(**nets) for a in argv]
    if argv[0] in ("train", "test", "time", "extract_features", "classify"):
        argv = argv + ["--device", "cpu"]
        if "--solver" not in argv and argv[0] != "classify":
            argv += ["--solver", "zoo:lenet", "--batch", "2"]
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        cli.main(argv)


@pytest.mark.parametrize("argv", [
    ["train", "--profile", "d"],
    ["time", "--trace"],
    ["time", "--trace", "--trace-out", "t2.json"],
    ["time", "--trace-out", "t.json"],
    ["train", "--profile", "d2", "--output", "o"],
    ["train", "--profile", "d3"],
])
def test_profile_and_trace_flags_run(argv, tmp_path, monkeypatch, capsys):
    """``train --profile DIR`` writes a trace of the run; ``time --trace``
    banks its artifact (``--trace-out``, default ``tpunet_trace.json``) at
    its last stage and prints the JSON summary; ``--trace-out`` alone is
    the artifact's path and changes nothing without ``--trace`` (as in the
    JAX CLI)."""
    from sparknet_tpu_torch.utils import op_profile

    monkeypatch.chdir(tmp_path)
    out = _run(cli.main, argv + ["--device", "cpu", "--solver", "zoo:lenet", "--batch", "2",
                                 "--iterations", "1"], capsys)
    if argv[0] == "train":
        ops = op_profile.host_ops(argv[argv.index("--profile") + 1])
        assert any("|L.conv1" in name for name, _ in ops)
        assert (tmp_path / (argv[argv.index("--output") + 1] if "--output" in argv
                            else "tpunet_final")).with_suffix(".solverstate.npz").exists()
    elif "--trace" in argv:
        path = tmp_path / (argv[-1] if "--trace-out" in argv else "tpunet_trace.json")
        art = json.loads(path.read_text())
        summary = json.loads(out.strip().splitlines()[-1])
        assert art["stage"] == "final" and art["platform"] == summary["platform"] == "cpu"
        assert summary["mfu"] is None and summary["gflop_per_step"] > 0
    else:
        assert "TOTAL" in out and not (tmp_path / "t.json").exists()


def test_device_defaults_to_cuda(monkeypatch, capsys):
    """``--device`` defaults to cuda: without a card a command exits; on
    the CPU, asked for, ``device_query`` lists it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["test", "--solver", "zoo:lenet", "--batch", "2", "--data", "synthetic",
                  "--weights", "w.caffemodel"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["device_query"])
    out = _run(cli.main, ["device_query", "--device", "cpu"], capsys)
    assert json.loads(out)["platform"] == "cpu"
    with pytest.raises(SystemExit, match="Deprecated. Use tpunet train"):
        cli.main(["train_net"])
