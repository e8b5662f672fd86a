"""``python -m sparknet_tpu_torch.cli train`` over nets that stream their own
data, SparkNet's rounds and the feed flags, against the JAX CLI and the
port's own ``Solver``.

- ``train --data proto`` and ``--data auto`` on an ImageData net (the
  flickr-style fine-tuning flow: crop, mirror, a mean file, a TEST-phase
  list) and on a WindowData net (the PASCAL detection flow: fg/bg windows,
  context pad), both from one ``.caffemodel`` the JAX package exports: the
  port's snapshot holds the JAX CLI's params and history at the port
  solver tests' tolerance (rtol 1e-4, an absolute 1e-5 of each blob's
  largest |value|), after 3 iterations;
- ``--prefetch 2``, ``--feed process`` and ``--augment device`` give bit
  for bit the params of the plain run; ``--tau 2`` and ``--distributed`` in a world of one give
  bit for bit the ``Solver.step`` run's;
- two ``--num-processes 2`` processes joined over TCP on 127.0.0.1 (gloo)
  leave in rank 0's snapshot the params and history of an in-process
  oracle that steps each rank's interleaved batches and averages them,
  within the gloo drift of ROADMAP Queue C item 5 (rtol 1e-5, an absolute
  1e-6 of each blob's largest |value|);
- the refusals stay loud: HDF5Data, a lone ``--coordinator``,
  ``--num-processes`` without the trainer, ``--augment device`` and
  ``--feed process`` over list files, ``--platform tpu``.
"""

import json
import os
import socket
import subprocess
import sys

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
from sparknet_tpu_torch.data import listfile as lf  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# conv -> relu -> pool -> LRN -> ip -> loss, the CaffeNet ops at a small size
BODY = """
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 stride: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "fc8_t" type: "InnerProduct" bottom: "norm1" top: "fc8_t"
  inner_product_param { num_output: %(classes)d } }
layer { name: "accuracy" type: "Accuracy" bottom: "fc8_t" bottom: "label" top: "accuracy"
  include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8_t" bottom: "label" top: "loss" }
"""

IMAGE_DATA = """
layer { name: "data" type: "ImageData" top: "data" top: "label" include { phase: TRAIN }
  transform_param { mirror: true crop_size: 16 mean_file: "%(d)s/mean.binaryproto" }
  image_data_param { source: "%(d)s/train.txt" root_folder: "%(d)s/" batch_size: 4
    new_height: 20 new_width: 20 shuffle: true } }
layer { name: "data" type: "ImageData" top: "data" top: "label" include { phase: TEST }
  transform_param { mirror: false crop_size: 16 mean_file: "%(d)s/mean.binaryproto" }
  image_data_param { source: "%(d)s/test.txt" root_folder: "%(d)s/" batch_size: 4
    new_height: 20 new_width: 20 } }
"""

WINDOW_DATA = """
layer { name: "data" type: "WindowData" top: "data" top: "label"
  transform_param { mirror: true crop_size: 16 mean_value: 110 mean_value: 120
    mean_value: 130 }
  window_data_param { source: "%(d)s/windows.txt" root_folder: "%(d)s/" batch_size: 8
    fg_threshold: 0.5 bg_threshold: 0.5 fg_fraction: 0.25 context_pad: 2
    crop_mode: "warp" } }
"""

SOLVER = ('net: "%(net)s"\nbase_lr: 0.01\nlr_policy: "step"\ngamma: 0.1\nstepsize: 2\n'
          "momentum: 0.9\nweight_decay: 0.0005\nmax_iter: 100\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Nine seeded 24x28 JPEGs, train/test lists, a window file of fg and
    bg windows a image, a ``.binaryproto`` mean, the two nets and their
    solvers, and a ``.caffemodel`` of seeded weights for each net written
    by the JAX package."""
    from PIL import Image

    from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

    d = tmp_path_factory.mktemp("cli_train")
    rs = np.random.RandomState(0)
    lines, wins = [], []
    for i in range(9):
        Image.fromarray(rs.randint(0, 256, (24, 28, 3)).astype(np.uint8)).save(d / f"im{i}.jpg")
        lines.append(f"im{i}.jpg {i % 5}\n")
        wins += [f"# {i}", f"im{i}.jpg", "3 24 28", "3", f"{i % 3 + 1} 0.7 3 2 22 20",
                 "0 0.2 0 0 11 9", "0 0.1 14 12 27 23"]
    (d / "train.txt").write_text("".join(lines[:7]))
    (d / "test.txt").write_text("".join(lines[5:]))
    (d / "windows.txt").write_text("\n".join(wins) + "\n")
    save_mean_binaryproto(str(d / "mean.binaryproto"),
                          rs.uniform(90, 150, (3, 20, 20)).astype(np.float32))
    for name, data, classes in (("flickr", IMAGE_DATA, 5), ("pascal", WINDOW_DATA, 4)):
        text = f'name: "{name}"\n' + data % {"d": d} + BODY % {"classes": classes}
        (d / f"{name}.prototxt").write_text(text)
        (d / f"{name}_solver.prototxt").write_text(SOLVER % {"net": d / f"{name}.prototxt"})
        shapes = Network(parse(text), Phase.TRAIN, device="cpu").init()
        params = {ln: [(rs.randn(*p.shape) * 0.01).astype(np.float32) for p in pl]
                  for ln, pl in shapes.params.items()}
        jexport(JNetwork(jparse(text), JPhase.TRAIN), params, str(d / f"{name}.caffemodel"))
    return d


@pytest.fixture
def one_thread():
    """One intra-op thread while a trainer and a Solver run the same steps:
    a gloo collective can shrink the thread team of a later CPU call, whose
    sums then split another way (ROADMAP Queue C item 7)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _snapshot(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def _assert_close(ours, theirs, rtol, arel):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        ref = theirs[k]
        np.testing.assert_allclose(ours[k], ref, rtol=rtol,
                                   atol=arel * float(np.abs(ref).max()) + 1e-30, err_msg=k)


def _train(files, tmp_path, name, *extra, main=None, prefix="p"):
    """Train ``name``'s net from its ``.caffemodel`` for 3 iterations with
    2 test iterations; returns the snapshot's arrays."""
    out = str(tmp_path / prefix)
    argv = ["train", "--solver", str(files / f"{name}_solver.prototxt"), "--weights",
            str(files / f"{name}.caffemodel"), "--iterations", "3", "--test-iters", "2",
            "--output", out, *extra]
    if main is None:
        argv += ["--device", "cpu"]
    assert (main or cli.main)(argv) == 0
    return _snapshot(out + ".solverstate.npz")


@pytest.mark.parametrize("name", ["flickr", "pascal"])
@pytest.mark.parametrize("data", ["proto", "auto"])
def test_train_streams_the_nets_own_data_as_jax(files, tmp_path, monkeypatch, name, data):
    """The fine-tuning flows through ``main``: the port's snapshot against
    the JAX CLI's, both from the JAX ``.caffemodel``."""
    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path))
    ours = _train(files, tmp_path, name, "--data", data)
    theirs = _train(files, tmp_path, name, "--data", data, main=jcli.main, prefix="j")
    _assert_close(ours, theirs, rtol=1e-4, arel=1e-5)
    assert {k.split("/")[0] for k in ours} == {"__iter__", "param", "hist"}
    assert int(ours["__iter__"]) == 3


def test_feed_flags_give_the_plain_runs_params(files, tmp_path, monkeypatch):
    """``--prefetch 2`` on the ImageData net, and on a record DB ``--feed
    process`` (two ring workers) and ``--augment device`` (uint8 on the
    wire, the scale applied by ``DeviceAugment``) through the prefetcher
    and the ring: bit for bit the threaded run's snapshot."""
    from sparknet_tpu_torch.data.createdb import create_db

    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path))
    plain = _train(files, tmp_path, "flickr", prefix="plain")
    pre = _train(files, tmp_path, "flickr", "--prefetch", "2", prefix="pre")
    _assert_close(pre, plain, rtol=0, arel=0)
    rs = np.random.RandomState(4)
    db = str(tmp_path / "mnist.sndb")
    create_db(db, [(rs.randint(0, 256, (1, 28, 28)).astype(np.uint8), i % 10)
                   for i in range(24)])
    runs = {}
    for tag, extra in (("threaded", []),
                       ("process", ["--feed", "process", "--feed-workers", "2", "--prefetch",
                                    "2"]),
                       ("augment", ["--augment", "device", "--prefetch", "2"]),
                       ("augment_process", ["--augment", "device", "--feed", "process",
                                            "--feed-workers", "2"])):
        out = str(tmp_path / tag)
        assert cli.main(["train", "--device", "cpu", "--solver", "zoo:lenet", "--batch", "4",
                         "--data", f"db:{db}", "--data-scale", "0.00390625",
                         "--iterations", "5", "--output", out, *extra]) == 0
        runs[tag] = _snapshot(out + ".solverstate.npz")
    for tag in ("process", "augment", "augment_process"):
        _assert_close(runs[tag], runs["threaded"], rtol=0, arel=0)


@pytest.mark.parametrize("flags", [["--tau", "2"], ["--distributed"]])
def test_world_of_one_is_the_solvers_steps(files, tmp_path, monkeypatch, one_thread, flags):
    """``--tau 2`` (two rounds of 2) and ``--distributed`` (four rounds) in
    a world of one: the snapshot is bit for bit the ``Solver.step`` run's
    on the same stream."""
    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path))
    plain = _train(files, tmp_path, "flickr", "--iterations", "4", prefix="plain")
    rounds = _train(files, tmp_path, "flickr", "--iterations", "4", *flags, prefix="rounds")
    _assert_close(rounds, plain, rtol=0, arel=0)
    import torch.distributed as dist

    assert not dist.is_initialized()  # the trainer's world of one is gone


_RANK = r"""
import sys
import torch
torch.set_num_threads(1)
from sparknet_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def test_two_gloo_ranks_match_the_averaging_oracle(files, tmp_path, one_thread):
    """Two processes at ``--tau 2`` for 2 rounds, each taking every other
    batch of its own ImageData stream (rank r's source seeded 1234 + r):
    rank 0's snapshot holds the oracle's averaged params and history."""
    from sparknet_tpu_torch.proto.text_format import parse_file
    from sparknet_tpu_torch.solvers.solver import load_solver_net

    port = _free_port()
    env = {**os.environ, "SPARKNET_TRAIN_LOG_DIR": str(tmp_path), "PYTHONPATH": REPO,
           "SPARKNET_DECODE_WORKERS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, "train", "--device", "cpu", "--solver",
         str(files / "flickr_solver.prototxt"), "--weights", str(files / "flickr.caffemodel"),
         "--iterations", "4", "--tau", "2", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r), "--output", str(tmp_path / "ranks")],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "distributed: process 0/2" in outs[0] and "distributed: process 1/2" in outs[1]
    got = _snapshot(tmp_path / "ranks.solverstate.npz")

    solver_msg = parse_file(str(files / "flickr_solver.prototxt"))
    net_param = load_solver_net(solver_msg)
    cfg = SolverConfig.from_proto(solver_msg)
    solvers, streams = [], []
    for r in range(2):
        s = Solver(cfg, net_param, device="cpu")
        cli._load_weights_into(s, str(files / "flickr.caffemodel"), strict_shapes=False,
                               require_match=False)
        solvers.append(s)
        with lf.source_from_net(s.train_net, seed=1234 + r) as src:
            batches = [src(i) for i in range(8)]
        streams.append(batches[r::2])
    for rnd in range(2):
        for s, batches in zip(solvers, streams):
            for t in range(2):
                s.train_iteration(batches[2 * rnd + t])
        with torch.no_grad():
            for ln in solvers[0]._params:
                for a, b in zip(solvers[0]._params[ln], solvers[1]._params[ln]):
                    mean = (a + b) / 2
                    a.copy_(mean)
                    b.copy_(mean)
    with torch.no_grad():
        for ln in solvers[0]._slots:
            for ha, hb in zip(solvers[0]._slots[ln], solvers[1]._slots[ln]):
                for a, b in zip(ha, hb):
                    a.copy_((a + b) / 2)
    solvers[0].save(str(tmp_path / "oracle"))
    _assert_close(got, _snapshot(tmp_path / "oracle.solverstate.npz"), rtol=1e-5, arel=1e-6)


def test_refusals_stay_loud(files, tmp_path, monkeypatch, capsys):
    """What the port cannot do exits with a message, and never trains on
    something else."""
    monkeypatch.setenv("SPARKNET_TRAIN_LOG_DIR", str(tmp_path))
    flickr = ["train", "--device", "cpu", "--solver", str(files / "flickr_solver.prototxt"),
              "--iterations", "1"]
    cases = [
        (["--coordinator", "127.0.0.1:1"], "--coordinator requires --num-processes"),
        (["--num-processes", "2"], "--num-processes requires --coordinator"),
        (["--num-processes", "2", "--coordinator", "127.0.0.1:1"],
         "--num-processes requires --distributed, --tau > 1, or --elastic-alpha"),
        (["--augment", "device", "--prefetch", "2"],
         "--augment device is wired to the cifar: and db: sources"),
        (["--feed", "process"], "--feed process needs an index-addressable source"),
    ]
    for extra, msg in cases:
        with pytest.raises(SystemExit, match=msg.replace("+", r"\+")):
            cli.main(flickr + extra)
    with pytest.raises(SystemExit, match="--platform tpu: the port runs on cuda or the cpu"):
        cli.main(["--platform", "tpu", "device_query"])
    out = _run(cli.main, ["--platform", "cpu", "device_query"], capsys)
    assert json.loads(out)["platform"] == "cpu"
    (tmp_path / "h5.txt").write_text("x.h5\n")
    net = tmp_path / "h5.prototxt"
    net.write_text('name: "h" layer { name: "d" type: "HDF5Data" top: "data" top: "label" '
                   f'hdf5_data_param {{ source: "{tmp_path}/h5.txt" batch_size: 2 }} }}'
                   + BODY % {"classes": 3})
    solver = tmp_path / "h5_solver.prototxt"
    solver.write_text(SOLVER % {"net": net})
    for data in ("auto", "proto"):
        with pytest.raises(SystemExit, match="ROADMAP Queue A9 .HDF5"):
            cli.main(["train", "--device", "cpu", "--solver", str(solver), "--data", data])
