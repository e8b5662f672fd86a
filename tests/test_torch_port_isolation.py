"""The port stands alone: it never loads jax or the JAX package, and its
entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import sparknet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sparknet_tpu_torch.__path__,
                                               "sparknet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import runpy
runpy.run_path("chip_smoke.py", run_name="chip_smoke_module")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "sparknet_tpu."))
             or m == "sparknet_tpu")
training = sorted(n for n in names if n.startswith(("sparknet_tpu_torch.solvers.",
                                                    "sparknet_tpu_torch.parallel."))
                  or n == "sparknet_tpu_torch.net")
serving = sorted(n for n in names if n.startswith("sparknet_tpu_torch.serve.")
                 or n == "sparknet_tpu_torch.ops.attention")
charlm = sorted(n for n in names if n in ("sparknet_tpu_torch.data.text",
                                          "sparknet_tpu_torch.models.generate"))
feed = sorted(n for n in names if n.startswith(("sparknet_tpu_torch.data.",
                                                "sparknet_tpu_torch.apps.",
                                                "sparknet_tpu_torch.utils."))
              and n != "sparknet_tpu_torch.data.text")
zoo = sorted(n for n in names if n in ("sparknet_tpu_torch.models.deploy",
                                        "sparknet_tpu_torch.models.detector",
                                        "sparknet_tpu_torch.models.fold_bn",
                                        "sparknet_tpu_torch.models.zoo",
                                        "sparknet_tpu_torch.ops.blocks"))
files = sorted(n for n in names if n in ("sparknet_tpu_torch.cli",
                                          "sparknet_tpu_torch.native",
                                          "sparknet_tpu_torch.proto.binary",
                                          "sparknet_tpu_torch.worker_store"))
layers = sorted(n for n in names if n in ("sparknet_tpu_torch.compiler.graph",
                                          "sparknet_tpu_torch.interop",
                                          "sparknet_tpu_torch.ops.data_layers",
                                          "sparknet_tpu_torch.ops.layout",
                                          "sparknet_tpu_torch.ops.loss",
                                          "sparknet_tpu_torch.ops.moe",
                                          "sparknet_tpu_torch.ops.neuron",
                                          "sparknet_tpu_torch.ops.python_layer",
                                          "sparknet_tpu_torch.ops.vision"))
precision = sorted(n for n in names if n in ("sparknet_tpu_torch.common",
                                             "sparknet_tpu_torch.quant"))
loop = sorted(n for n in names if n.startswith(("sparknet_tpu_torch.obs",
                                                "sparknet_tpu_torch.loop")))
print(loop)
print(precision)
print(layers)
print(files)
print(training)
print(serving)
print(charlm)
print(feed)
print(zoo)
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loop, precision, layers, files, training, serving, charlm, feed, zoo, last = \
        out.stdout.strip().split("\n")[-10:]
    n, bad = last.split(" ", 1)
    assert int(n) >= 30, out.stdout
    assert bad == "[]", out.stdout
    # the training, distributed-training, token-serving, char-LM training
    # and feed slices' modules are among those imported
    assert training == str(["sparknet_tpu_torch.net"] + [
        f"sparknet_tpu_torch.parallel.{m}" for m in
        ("collectives", "elastic", "expert", "mesh", "pipeline", "ring_attention",
         "sharding", "trainer", "ulysses")] + [
        f"sparknet_tpu_torch.solvers.{m}" for m in
        ("arena", "lr_policy", "solver", "updates")]), out.stdout
    assert serving == str(["sparknet_tpu_torch.ops.attention"] + [
        f"sparknet_tpu_torch.serve.{m}" for m in
        ("batcher", "continuous", "dryrun", "engine", "graphs", "loadgen", "paged",
         "residency", "router")]), out.stdout
    assert charlm == str(["sparknet_tpu_torch.data.text",
                          "sparknet_tpu_torch.models.generate"]), out.stdout
    # the data plane, the apps and their utils (the feed slice, then the
    # DB formats, the featurizer, the DB apps and the timing utilities)
    assert feed == str(sorted(
        [f"sparknet_tpu_torch.apps.{m}" for m in
         ("cifar_app", "db_apps", "featurizer", "imagenet_app")]
        + [f"sparknet_tpu_torch.data.{m}" for m in
           ("archive", "cifar", "createdb", "device_transform", "digits", "io_utils",
            "leveldb_io", "listfile", "lmdb_io", "minibatch", "pipeline", "prefetch",
            "records", "remote", "resize_images", "sampler", "transform")]
        + [f"sparknet_tpu_torch.utils.{m}" for m in
           ("draw", "event_log", "log_parse", "op_profile", "plotting", "profiling",
            "signals", "timing")])), \
        out.stdout
    # the weights and record files' codec, the native data plane, the CLI
    # and the worker store
    assert files == str([f"sparknet_tpu_torch.{m}" for m in
                         ("cli", "native", "proto.binary", "worker_store")]), out.stdout
    # the layer library, the Python layer, DummyData, shared params, the
    # weights bridge that carries their placeholders, and the layouts
    assert layers == str(["sparknet_tpu_torch.compiler.graph", "sparknet_tpu_torch.interop"] + [
        f"sparknet_tpu_torch.ops.{m}" for m in
        ("data_layers", "layout", "loss", "moe", "neuron", "python_layer", "vision")]), \
        out.stdout
    # the production loop, its control-plane scenarios, the obs journal and
    # its readers
    assert loop == str(["sparknet_tpu_torch.loop"] + [
        f"sparknet_tpu_torch.loop.{m}" for m in
        ("autoctl", "controller", "ctl_scenarios", "deploy", "dryrun", "feed", "watcher")]
        + ["sparknet_tpu_torch.obs"] + [
        f"sparknet_tpu_torch.obs.{m}" for m in
        ("__main__", "burn", "lineage", "metrics", "recorder", "report", "schema",
         "sentinel", "slo", "train_legs")]), out.stdout
    # reduced precision: the Config's dtypes and policies, the int8 path
    assert precision == str(["sparknet_tpu_torch.common", "sparknet_tpu_torch.quant"]), \
        out.stdout
    # the ImageNet families: BatchNorm, Scale and Bias, the zoo, the fold,
    # the R-CNN detector
    assert zoo == str([f"sparknet_tpu_torch.models.{m}" for m in
                       ("deploy", "detector", "fold_bn", "zoo")]
                      + ["sparknet_tpu_torch.ops.blocks"]), out.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    """``device=None`` means CUDA; with no CUDA device every entry point
    raises instead of running on the CPU."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import Phase, resolve_device
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.models import Classifier, DeployNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deploy = models.lenet(batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Network(deploy, Phase.TEST)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeployNet(deploy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Classifier(deploy)
    from sparknet_tpu_torch.solvers.solver import Solver

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(models.lenet_solver(), deploy)
    from sparknet_tpu_torch.net import TPUNet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPUNet(models.charlm_solver(), models.charlm(batch=1, seq_len=8))
    assert resolve_device("cpu") == torch.device("cpu")


def test_weights_bridge_and_serving_default_to_cuda(monkeypatch):
    """The weights bridge, the slot arenas and the token-serving entry
    points take ``device=None`` as CUDA too, and raise without a card."""
    import numpy as np

    from sparknet_tpu_torch import interop
    from sparknet_tpu_torch.ops.base import ParamSpec
    from sparknet_tpu_torch.serve.continuous import ContinuousDecoder
    from sparknet_tpu_torch.serve.paged import PagedDecoder, TokenRouter
    from sparknet_tpu_torch.solvers import arena
    from sparknet_tpu_torch.solvers.solver import SolverConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"ip": [np.ones((2, 3), np.float32)]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.netvars_from_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.netvars_from_solverstate({"param/ip/0": params["ip"][0]})
    layout = arena.build_layout(params, {"ip": [ParamSpec()]}, SolverConfig(),
                                storage_dtype="f32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arena.init_slot_arenas(layout)
    small = dict(slots=2, seq_len=8, vocab=8, embed_dim=8, heads=2, ffn_dim=8)
    for entry in (PagedDecoder, ContinuousDecoder, TokenRouter):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(**small)
    # on the CPU, named explicitly, all of them run
    v = interop.netvars_from_numpy(params, device="cpu")
    assert v.params["ip"][0].device.type == "cpu"
    assert arena.init_slot_arenas(layout, device="cpu")[0].device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda():
    """With no CUDA device the smoke test exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_db_apps_and_cli_default_to_cuda(monkeypatch, tmp_path):
    """The DB apps, the featurizer's net and the CLI take no device as
    CUDA and raise (or exit) without a card, before any file is written."""
    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.apps import CifarDBApp, ImageNetRunDBApp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CifarDBApp(str(tmp_path / "cifar"), str(tmp_path / "db"), log_dir=str(tmp_path / "log"))
    assert not (tmp_path / "db").exists() and not (tmp_path / "log").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageNetRunDBApp(str(tmp_path / "db"), log_dir=str(tmp_path / "log"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["time", "--solver", "zoo:lenet", "--batch", "2"])
