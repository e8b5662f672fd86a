"""The port's apps (``sparknet_tpu_torch/apps``) and their utils against the
JAX package's, on the CPU at a small size, on fixtures the tests write.

``CifarApp`` at τ 2, batch 4, in a world of one, starts from the JAX app's
initial weights (crossed through ``interop.netvars_from_numpy``): its
train and test feeds are the JAX app's bit for bit, and its first round's
loss is within rtol 1e-5 of the JAX round's (the packages sum their
convolutions in other orders; ``test_torch_port_solver``'s tolerance).
``ImageNetApp``'s mean image and ``_tau_feeds`` over one tar of JPEGs are
the JAX app's bit for bit; its round alone (AlexNet, whose dropout makes a
loss comparison meaningless without an injected mask) gives a finite loss.
``agree_action`` is a MAX all-reduce over two gloo processes.
``FeaturizerApp``'s ``ip1`` is within atol 1e-5 of the JAX app's; the DB
apps write the JAX apps' DB files byte for byte in every backend, the same
means and ``info.json``, and ``ImageNetRunDBApp`` resumes from a
JAX-written ``.caffemodel`` bit for bit, its TEST forward within atol 1e-5
of JAX's.
"""

import io
import os
import signal
import subprocess
import sys
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from sparknet_tpu.apps.cifar_app import CifarApp as JCifarApp  # noqa: E402
from sparknet_tpu.apps.imagenet_app import ImageNetApp as JImageNetApp  # noqa: E402
from sparknet_tpu.data import ImageNetLoader as JImageNetLoader  # noqa: E402
from sparknet_tpu.data import DataTransformer as JDataTransformer  # noqa: E402
from sparknet_tpu.data import TransformConfig as JTransformConfig  # noqa: E402
from sparknet_tpu.data.minibatch import compute_mean_from_minibatches as jmean  # noqa: E402
from sparknet_tpu.data.minibatch import make_minibatches_compressed as jmbc  # noqa: E402
from sparknet_tpu.parallel import data_parallel_mesh  # noqa: E402
from sparknet_tpu.utils import EventLogger as JEventLogger  # noqa: E402
from sparknet_tpu.utils import SignalHandler as JSignalHandler  # noqa: E402
from sparknet_tpu.utils import SolverAction as JSolverAction  # noqa: E402

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.apps import CifarApp, ImageNetApp  # noqa: E402
from sparknet_tpu_torch.apps import cifar_app, imagenet_app  # noqa: E402
from sparknet_tpu_torch.data.cifar import write_synthetic_cifar  # noqa: E402
from sparknet_tpu_torch.utils import (  # noqa: E402
    EventLogger,
    SignalHandler,
    SolverAction,
    agree_action,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_feeds_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar")
    write_synthetic_cifar(str(d), seed=2)
    return str(d)


def test_cifar_app_matches_jax(cifar_dir, tmp_path):
    """Same files, same seed, JAX's initial weights: the port's τ-2 feeds
    and test feeds are the JAX app's bit for bit, and the first round's
    loss is within rtol 1e-5 of the JAX round's; then ``run`` tests,
    trains, logs and snapshots."""
    assert (cifar_app.TAU, cifar_app.TEST_EVERY, cifar_app.BATCH) == (10, 10, 100)
    japp = JCifarApp(cifar_dir, mesh=data_parallel_mesh(1), tau=2, batch=4,
                     log_dir=str(tmp_path / "jax"), seed=0)
    app = CifarApp(cifar_dir, tau=2, batch=4, log_dir=str(tmp_path / "port"), seed=0,
                   device="cpu")
    try:
        assert (app.num_workers, app.global_batch) == (1, 4)
        jv = japp.trainer.solver.variables
        app.trainer.solver.variables = interop.netvars_from_numpy(
            {ln: [np.asarray(b) for b in bl] for ln, bl in jv.params.items()},
            {ln: {k: np.asarray(v) for k, v in s.items()} for ln, s in jv.state.items()},
            device="cpu")
        feeds, jfeeds = app._train_feeds(0), japp._train_feeds(0)
        _assert_feeds_equal(feeds, jfeeds)
        assert feeds["data"].shape == (2, 4, 3, 32, 32)
        _assert_feeds_equal(app._test_feeds(3), japp._test_feeds(3))
        loss = app.trainer.train_round(lambda it: feeds)
        jloss = japp.trainer.train_round(lambda it: jfeeds)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        scores = app.run(num_outer=2, num_test_batches=2)
        assert "accuracy" in scores and np.isfinite(scores["accuracy"])
        assert app.trainer.iter == 2 + 2 * 2
        content = open(app.log.path).read()
        assert "training" in content and "testing" in content
        path = app.snapshot(str(tmp_path / "snap"))
        assert os.path.exists(path)
        app.tau = 1000  # beyond the train set: the clear error
        with pytest.raises(ValueError, match="reduce tau"):
            app._train_feeds(0)
    finally:
        app.close()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def jpeg_shards(tmp_path_factory):
    """One tar shard of 8 JPEGs (64x64) and its train.txt."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imagenet")
    rs = np.random.RandomState(0)
    labels = {}
    with tarfile.open(d / "shard0.tar", "w") as tf:
        for i in range(8):
            name = f"img{i}.jpg"
            buf = io.BytesIO()
            Image.fromarray(rs.randint(0, 255, (64, 64, 3)).astype(np.uint8)).save(
                buf, format="JPEG")
            data = buf.getvalue()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            labels[name] = i % 3
    (d / "train.txt").write_text("".join(f"{n} {lab}\n" for n, lab in labels.items()))
    return str(d), str(d / "train.txt")


def test_imagenet_app_feeds_match_jax(jpeg_shards, tmp_path):
    """The port's ImageNetApp (AlexNet, 10 classes, batch 2, τ 2) computes
    the JAX app's mean image and packs its ``_tau_feeds`` bit for bit
    (decode to 256, mean, random 227 crop, mirror); its round gives a
    finite loss."""
    assert (imagenet_app.TAU, imagenet_app.RESIZE, imagenet_app.CROP) == (50, 256, 227)
    d, labels = jpeg_shards
    app = ImageNetApp(d, labels, tau=2, batch=2, model="alexnet", num_classes=10,
                      log_dir=str(tmp_path), seed=0, device="cpu")
    try:
        japp = JImageNetApp.__new__(JImageNetApp)  # its trainer is not needed
        japp.loader = JImageNetLoader(d, labels)
        japp.batch, japp.tau, japp.num_workers = 2, 2, 1
        mean = jmean(jmbc(japp.loader.shard(0, 1), 2, 256, 256), (3, 256, 256))
        np.testing.assert_array_equal(app.mean_image, mean)
        japp.transform = JDataTransformer(JTransformConfig(
            crop_size=227, mirror=True, mean_image=mean, seed=0))
        for _ in range(2):
            got = app._tau_feeds([app.minibatch_stream(0)])
            want = japp._tau_feeds([japp.minibatch_stream(0)])
            _assert_feeds_equal(got, want)
        assert got["data"].shape == (2, 2, 3, 227, 227)
        loss = app.run(num_outer=1)
        assert np.isfinite(loss) and app.trainer.iter == 2
    finally:
        app.close()


# ------------------------------------------------------------ utils


def test_event_logger_lines_match_jax(tmp_path):
    """The port's log lines are the JAX logger's after the elapsed time."""
    logs = [cls(str(tmp_path / name), prefix="t", echo=False)
            for cls, name in ((EventLogger, "port"), (JEventLogger, "jax"))]
    for log in logs:
        log("loading")
        log("loss: 1.25000", i=3)
    port, jax_ = ([line.split(": ", 1)[-1] for line in open(log.path).read().splitlines()]
                  for log in logs)
    assert port[0].startswith("start ") and jax_[0].startswith("start ")
    assert port[1:] == jax_[1:] == ["loading", "loss: 1.25000, i = 3"]


def test_signal_handler_matches_jax():
    """SIGHUP asks for a snapshot and SIGINT for a stop, one-shot, in both
    packages; the previous handlers come back on exit."""
    prev = signal.getsignal(signal.SIGHUP)
    for handler, actions in ((SignalHandler, SolverAction), (JSignalHandler, JSolverAction)):
        with handler() as sig:
            assert sig.check() is actions.NONE
            os.kill(os.getpid(), signal.SIGHUP)
            assert sig.check() is actions.SNAPSHOT
            assert sig.check() is actions.NONE
            os.kill(os.getpid(), signal.SIGINT)
            assert sig.check() is actions.STOP
        assert signal.getsignal(signal.SIGHUP) is prev
    assert [a.value for a in SolverAction] == [a.value for a in JSolverAction]


AGREE = r"""
import sys
import torch.distributed as dist
from sparknet_tpu_torch.utils import SolverAction, agree_action
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
cases = [("STOP", "SNAPSHOT"), ("NONE", "SNAPSHOT"), ("NONE", "NONE"), ("SNAPSHOT", "STOP")]
print(",".join(agree_action(SolverAction[c[rank]]).name for c in cases))
dist.destroy_process_group()
"""


def test_agree_action_is_a_max_over_the_group(tmp_path):
    """Two gloo processes: any STOP wins, else any SNAPSHOT, else NONE, on
    both ranks; with no process group the action is returned as is."""
    assert not dist.is_initialized()
    assert agree_action(SolverAction.SNAPSHOT) is SolverAction.SNAPSHOT
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", AGREE, str(r), str(tmp_path / "store")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "STOP,SNAPSHOT,NONE,STOP"


# ------------------------------------------------------------ featurizer and DB apps
# (``apps/featurizer.py`` and ``apps/db_apps.py`` against the JAX apps: DB files
# byte for byte, means and feeds bit for bit, forwards within atol 1e-5.)


def _tree_bytes(path):
    if os.path.isfile(path):
        return {"": open(path, "rb").read()}
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))}


def test_featurizer_matches_jax():
    """``ip1`` of LeNet on weights carried by ``interop``: within atol 1e-5
    of the JAX FeaturizerApp's on the same batches; a missing blob raises
    the JAX app's ``KeyError``."""
    from sparknet_tpu import models as jm
    from sparknet_tpu.apps.featurizer import FeaturizerApp as JFeaturizerApp
    from sparknet_tpu.net import TPUNet as JTPUNet

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps import FeaturizerApp
    from sparknet_tpu_torch.net import TPUNet, variables_to_collection

    jnet = JTPUNet(jm.lenet_solver(), jm.lenet(3))
    net = TPUNet(models.lenet_solver(), models.lenet(3), device="cpu")
    japp, app = JFeaturizerApp(jnet), FeaturizerApp(net)
    jv = jnet.solver.variables
    app.set_weights(variables_to_collection(
        interop.netvars_from_numpy(jv.params, jv.state, device="cpu")))
    rs = np.random.RandomState(8)
    # LeNet's feed is pixels scaled by 1/256 (lenet_train_test.prototxt)
    batches = [{"data": rs.rand(3, 1, 28, 28).astype(np.float32),
                "label": rs.randint(0, 10, 3).astype(np.int32)} for _ in range(2)]
    for got, want in zip(app.featurize(iter(batches)), japp.featurize(iter(batches))):
        assert got.shape == (3, 500) and isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(KeyError) as pe:
        next(FeaturizerApp(net, "nope").featurize(iter(batches)))
    with pytest.raises(KeyError) as je:
        next(JFeaturizerApp(jnet, "nope").featurize(iter(batches)))
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("backend", ["record", "lmdb", "leveldb"])
def test_cifar_db_app_matches_jax(backend, cifar_dir, tmp_path, monkeypatch):
    """``CifarDBApp`` at batch 10: the DB files of every backend are the JAX
    app's byte for byte, the means equal; a half-written DB (no marker) is
    cleared and rebuilt to the same bytes; then ``run`` tests and trains."""
    from sparknet_tpu.apps import db_apps as jdb

    from sparknet_tpu_torch.apps import CifarDBApp

    monkeypatch.setattr(jdb, "TPUNet", lambda *a, **k: None)  # its files only
    jdb.CifarDBApp(cifar_dir, str(tmp_path / "jax"), batch=10, log_dir=str(tmp_path),
                   backend=backend)
    app = CifarDBApp(cifar_dir, str(tmp_path / "port"), batch=10, log_dir=str(tmp_path),
                     backend=backend, device="cpu")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        if n != "mean.npy":
            assert _tree_bytes(str(tmp_path / "port" / n)) == _tree_bytes(str(tmp_path / "jax" / n)), n
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "mean.npy"),
                                  np.load(tmp_path / "jax" / "mean.npy"))
    # a crash mid-materialize: marker gone, the train DB cut short
    os.remove(tmp_path / "port" / [n for n in names if n.startswith(".materialized")][0])
    train = str(tmp_path / "port" / [n for n in names if n.startswith("cifar_train")][0])
    if os.path.isdir(train):
        for n in os.listdir(train):
            os.remove(os.path.join(train, n))
    else:
        open(train, "r+b").truncate(100)
    app = CifarDBApp(cifar_dir, str(tmp_path / "port"), batch=10, log_dir=str(tmp_path),
                     backend=backend, device="cpu")
    assert _tree_bytes(train) == _tree_bytes(train.replace("/port/", "/jax/"))
    scores = app.run(num_iters=2, test_batches=2)
    assert np.isfinite(scores["loss"]) and app.net.solver.iter == 2
    with pytest.raises(ValueError, match="unknown db backend"):
        CifarDBApp(cifar_dir, str(tmp_path / "x"), backend="hdf5", device="cpu")
    assert not os.path.exists(tmp_path / "x")  # validated before any side effect


@pytest.fixture(scope="module")
def jpeg_worker_shards(tmp_path_factory):
    """Two tar shards of 5 JPEGs (80x72) each and their train.txt."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imagenet_db")
    rs = np.random.RandomState(1)
    lines = []
    for s in range(2):
        with tarfile.open(d / f"shard{s}.tar", "w") as tf:
            for i in range(5):
                name = f"s{s}_{i}.jpg"
                buf = io.BytesIO()
                Image.fromarray(rs.randint(0, 255, (80, 72, 3)).astype(np.uint8)).save(
                    buf, format="JPEG")
                info = tarfile.TarInfo(name)
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
                lines.append(f"{name} {(s * 5 + i) % 4}\n")
    (d / "train.txt").write_text("".join(lines))
    return str(d), str(d / "train.txt")


def test_imagenet_db_apps_match_jax(jpeg_worker_shards, tmp_path):
    """``ImageNetCreateDBApp`` (2 workers, resize 72, batch 2): DBs, mean
    and ``info.json`` equal the JAX app's; ``ImageNetRunDBApp`` (CaffeNet,
    crop 67, batch 2) resumed from a JAX-written ``.caffemodel`` holds its
    weights bit for bit and its TEST forward is within atol 1e-5 of JAX's
    on the same batch; it trains two steps to a finite loss."""
    import json

    import jax
    from sparknet_tpu import models as jm
    from sparknet_tpu.apps.db_apps import ImageNetCreateDBApp as JCreate
    from sparknet_tpu.common import Phase as JPhase
    from sparknet_tpu.compiler.graph import Network as JNetwork, NetVars as JNetVars
    from sparknet_tpu.net import copy_caffemodel_params as jcopy
    from sparknet_tpu.net import export_caffemodel as jexport

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps import ImageNetCreateDBApp, ImageNetRunDBApp
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network

    d, labels = jpeg_worker_shards
    infos = {}
    for cls, name in ((JCreate, "jax"), (ImageNetCreateDBApp, "port")):
        infos[name] = cls(d, labels, str(tmp_path / name), num_workers=2, resize=72,
                          batch=2).run()
    for w in range(2):
        assert infos["port"]["workers"][w]["records"] == 4
        assert _tree_bytes(infos["port"]["workers"][w]["db"]) == \
            _tree_bytes(infos["jax"]["workers"][w]["db"])
    np.testing.assert_array_equal(np.load(infos["port"]["mean"]), np.load(infos["jax"]["mean"]))
    written = {n: json.loads((tmp_path / n / "info.json").read_text()) for n in ("port", "jax")}
    assert json.dumps(written["port"]).replace(str(tmp_path / "port"), "X") == \
        json.dumps(written["jax"]).replace(str(tmp_path / "jax"), "X")

    # a JAX-written caffemodel of seeded CaffeNet weights (crop 67 keeps every layer)
    shapes = Network(models.caffenet(2, crop=67), Phase.TRAIN, device="cpu").init()
    rs = np.random.RandomState(9)
    params = {ln: [(rs.randn(*p.shape) * (0.01 if p.dim() > 1 else 0.1)).astype(np.float32)
                   for p in pl] for ln, pl in shapes.params.items()}
    jtrain = JNetwork(jm.caffenet(2, crop=67), JPhase.TRAIN)
    path = str(tmp_path / "caffenet.caffemodel")
    jexport(jtrain, params, path)
    app = ImageNetRunDBApp(str(tmp_path / "port"), worker=1, batch=2, crop=67,
                           weights=path, log_dir=str(tmp_path), device="cpu")
    for ln, pl in params.items():
        for a, b in zip(pl, app.net.get_weights()[ln]):
            np.testing.assert_array_equal(a, b)
    from sparknet_tpu_torch.data.createdb import db_minibatches

    raw = next(db_minibatches(app.db_path, 2, dtype=np.uint8))
    feeds = {"data": app.transform(raw["data"], False), "label": raw["label"]}
    got = app.net.forward(feeds)
    jtest = JNetwork(jm.caffenet(2, crop=67), JPhase.TEST)
    jparams, _ = jcopy({ln: [np.zeros_like(p) for p in pl] for ln, pl in params.items()}, path)
    want, _, _ = jax.jit(lambda v, f: jtest.apply(v, f, rng=None, train=False))(
        JNetVars(params=jparams, state={}), feeds)
    for blob in ("fc7", "fc8"):
        np.testing.assert_allclose(got[blob].numpy(), np.asarray(want[blob]), atol=1e-5, rtol=0)
    loss = app.run(2)
    assert np.isfinite(loss) and app.net.solver.iter == 2
