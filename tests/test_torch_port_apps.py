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
