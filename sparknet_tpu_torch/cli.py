"""``tpunet`` on the port: ``python -m sparknet_tpu_torch.cli <command>``.

Counterpart of ``sparknet_tpu/cli.py``, the equivalent of the ``caffe``
brew tool (ref: caffe/tools/caffe.cpp:153-380) and of Caffe's and
SparkNet's dataset and log tools.  Subcommands:

- ``train``: one ``Solver``, or SparkNet's rounds over ``ParallelTrainer``
  with ``--tau N`` (τ local steps, then the average), ``--distributed``
  (synchronous data parallelism) or ``--elastic-alpha`` (EASGD), in a
  world of one or across ``--num-processes`` processes that meet at
  ``--coordinator host:port``; ``--prefetch N``, ``--feed
  threaded|process``, ``--feed-workers`` and ``--augment device`` pick
  the host feed; ``--profile DIR`` writes a ``torch.profiler`` trace of
  the run into DIR (``utils/profiling.py``);
- ``test``, ``time`` (per layer; ``--fused`` over the whole ``Solver``
  step; ``--trace [--trace-out PATH]`` the whole step under
  ``torch.profiler`` with its device time attributed to layers, FLOPs and
  MFU, ``utils/op_profile.py``) and ``extract_features``;
- ``classify`` (``Classifier``: ``--oversample``, ``--images-dim``,
  ``--fold-bn``, ``--int8``);
- ``convert_imageset``, ``convert_db``, ``compute_image_mean``,
  ``resize_images``, ``create_labelfile`` and ``pull_shards`` (local and
  NFS stores);
- ``upgrade_net_proto_text``, ``upgrade_net_proto_binary`` and
  ``upgrade_solver_proto_text``; ``draw``, ``parse_log`` and
  ``plot_training_log``; ``device_query``;
- ``serve`` (the serving engine's load run, or ``--replicas K`` through
  the replica router, ``--controller`` arming the SLO controller) and
  ``loop`` (the train-to-serve production loop: elastic rounds, an atomic
  checkpoint, a candidate captured off the request path, a hot swap, a
  refused over-budget candidate and a bitwise rollback, with traffic in
  flight); each prints one JSON summary line and exits 1 unless its gates
  hold.  ``--obs PATH`` arms the obs journal (``SPARKNET_OBS``).

Flags, messages and JSON outputs are the JAX CLI's; ``--device`` (default
``cuda``) names where nets run, and a run without a card exits unless
``--device cpu`` is given (``--platform cpu|gpu|cuda`` maps onto it).
Model and solver configs are prototxt paths or zoo names
(``zoo:caffenet``).

Data sources: ``--data auto`` (the default: the net's own data layers when
they name a source, else synthetic), ``proto`` (the net's ``Data``,
``ImageData`` and ``WindowData`` layers stream their own sources on the
host, ``data/listfile.py``: the ``caffe train --solver=...`` flow),
``synthetic`` (pixel-scale random batches), ``cifar:<dir>`` (CIFAR-10
binaries) and ``db:<path>[,<test_path>]`` (a RecordDB, LMDB or LevelDB;
``{proc}`` expands to the process id; each phase's ``Data`` layer's
transform_param crops, mirrors, scales and subtracts its mean_file on the
host).  Across processes each trains on its own batches.

``--layout nhwc`` (train, test, time) runs the command channels-last
(``Config.layout``, ``ops/layout.py``) and restores the caller's layout
after; canonical-NCHW host batches are brought to the internal layout
before they reach the card, and the process feed's sources emit it
natively.

``bench`` and ``pods``, and the flags ``--scan`` and ``--hlo``, exit with a
message naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

# The JAX CLI's subcommands the port does not carry, with their ROADMAP item.
_UNPORTED_COMMANDS = {
    "bench": "Queue A6 (the single-GPU bench)",
    "pods": "Queue A9 (pods.py provisions TPU VMs; it has no one-card counterpart)",
}

# Flags of the ported subcommands that the port does not carry: (dest,
# value that means "not asked for", ROADMAP item).
_UNPORTED_FLAGS = (
    ("scan", 1, "Queue A5 (a CUDA graph of the step loop)"),
    ("hlo", False, "Queue A14 (XLA cost analysis has no counterpart yet)"),
)
# dense data-sheet FLOP/s of a card by ``torch.cuda.get_device_name()`` and
# compute dtype (PERF.md §3: float32 outside the tensor cores, which is
# what a float32 step with TF32 off runs on; bf16 on the tensor cores);
# ``time --trace`` names the cell its MFU is against, and a card missing
# here gets no MFU
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": ("h100_sxm", {"f32": 67e12, "bf16": 989e12}),
}
# traced windows of `time --trace` taken again when the profiler dropped
# records of the hand kernels (utils/op_profile.LostRecords).  This only
# works round a loss whose cause is not known (PERF.md §7): it goes once
# that loss is explained and fixed
TRACE_RETRIES = 3
# --platform of the JAX CLI, onto the port's --device
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def _refuse_unported(args) -> None:
    for dest, default, item in _UNPORTED_FLAGS:
        if getattr(args, dest, default) != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not ported to sparknet_tpu_torch yet "
                             f"(ROADMAP {item})")


def _apply_platform(args) -> None:
    """``--platform`` onto ``--device``: cpu -> cpu, gpu/cuda -> cuda."""
    if not args.platform:
        return
    plat = args.platform.lower()
    if plat not in _PLATFORMS:
        raise SystemExit(f"--platform {args.platform}: the port runs on cuda or the cpu "
                         "(--platform cpu|gpu|cuda, or --device); a TPU runs the JAX "
                         "package")
    if hasattr(args, "device"):
        args.device = _PLATFORMS[plat]


def _device(args):
    from sparknet_tpu_torch.common import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--device {args.device}: {e}") from None


def _proc() -> tuple[int, int]:
    """(this process's rank, the process count) of the default process
    group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _build_net_and_solver(args):
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.proto.text_format import parse_file
    from sparknet_tpu_torch.solvers.solver import SolverConfig, load_solver_net

    if not args.solver:
        raise SystemExit("--solver is required (prototxt path or zoo:<name>)")
    if args.solver.startswith("zoo:"):
        name = args.solver[4:]
        net_param = getattr(models, name)(args.batch or 100)
        solver_cfg = getattr(models, f"{name}_solver")()
        return net_param, solver_cfg
    solver_msg = parse_file(args.solver)
    net_param = load_solver_net(solver_msg, root=_net_root(solver_msg, args.solver))
    return net_param, SolverConfig.from_proto(solver_msg)


def _net_root(solver_msg, solver_path: str) -> str:
    """Root for the solver's relative ``net:``/``train_net:`` path: the
    CWD (Caffe's), else the first directory up from the solver file where
    the path resolves."""
    rel = next((solver_msg.get_str(f) for f in ("net", "train_net") if solver_msg.has(f)), "")
    if not rel or os.path.isabs(rel) or os.path.exists(rel):
        return ""
    d = os.path.dirname(os.path.abspath(solver_path))
    while True:
        if os.path.exists(os.path.join(d, rel)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return ""  # let load_solver_net raise the plain not-found
        d = parent


def _db_path(args, i: int = 0, pid: int = 0) -> str:
    paths = args.data[3:].split(",")
    return (paths[i] if i < len(paths) else paths[0]).replace("{proc}", str(pid))


def _db_peek_shapes(args, net) -> dict:
    """Shapes of ``Data``-layer tops peeked from ``--data db:``'s DB (Caffe:
    the geometry comes from the DB, data_layer.cpp:40-48); ``{proc}`` is
    this process's own DB."""
    if not (getattr(args, "data", "") or "").startswith("db:"):
        return {}
    known = net.feed_shapes()
    missing = [l for l in net.input_layers
               if l.TYPE == "Data" and any(t not in known for t in l.tops)]
    if not missing:
        return {}
    from sparknet_tpu_torch.data.createdb import peek_db_shape

    path = _db_path(args, pid=_proc()[0])
    try:
        chw = peek_db_shape(path)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--data db: {path}: {e}") from None
    out = {}
    for l in missing:
        shapes = l.shapes_for_chw(chw)
        if shapes:
            out.update(zip(l.tops, shapes))
    return out


def _feed_shapes(net, args=None):
    shapes = net.feed_shapes()
    if args is not None:
        shapes.update(_db_peek_shapes(args, net))
    if not shapes:
        raise SystemExit(
            "net declares no input shapes; use RDD/Input layers, keep the "
            "DB at data_param.source on disk, or stream one with --data "
            "db:<path> (a Data layer's geometry comes from its DB — ref: "
            "data_layer.cpp DataLayerSetUp)")
    return shapes


def _peeked_feed_shapes(args, net_param):
    if not (getattr(args, "data", "") or "").startswith("db:"):
        return None
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network

    return _db_peek_shapes(args, Network(net_param, Phase.TRAIN, device="cpu")) or None


@contextlib.contextmanager
def _clean_shape_errors():
    """Exit naming what to do when a net's input shapes are unknown, or
    naming the ROADMAP item of a layer type the port does not carry."""
    try:
        yield
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    except ValueError as e:
        if "no shape known" not in str(e):
            raise
        raise SystemExit(
            f"{e} — the net's data layers declare no geometry on this host (a "
            "Data layer's shape comes from its DB, ref: data_layer.cpp "
            "DataLayerSetUp); stream one with --data db:<path>, keep "
            "data_param.source on disk, or use Input/RDD layers") from None


def _make_solver(solver_cfg, net_param, args):
    from sparknet_tpu_torch.solvers.solver import Solver

    if getattr(args, "seed", None) is not None:
        solver_cfg = dataclasses.replace(solver_cfg, random_seed=args.seed)
    with _clean_shape_errors():
        return Solver(solver_cfg, net_param, feed_shapes=_peeked_feed_shapes(args, net_param),
                      device=_device(args))


def _internalize(fn):
    """``fn`` with its canonical-NCHW host batches (CIFAR readers, DB
    cursors, listfile sources all emit blob order) brought to the internal
    layout (``ops/layout.feeds_to_internal``); ``fn`` itself under nchw.
    Keeps an attached ``device_fn``/``trainer_device_fn`` (the
    ``DeviceAugment`` speaks the internal layout) and ``pipeline_factory``
    (whose sources emit the internal layout themselves, so the process
    feed pays no transpose a batch)."""
    from sparknet_tpu_torch.ops.layout import feeds_to_internal, is_nhwc

    if fn is None or not is_nhwc():
        return fn

    def wrapped(it):
        return feeds_to_internal(fn(it))

    for attr in ("device_fn", "trainer_device_fn", "pipeline_factory"):
        if hasattr(fn, attr):
            setattr(wrapped, attr, getattr(fn, attr))
    return wrapped


def _attach_device_augment(train_fn, cfg, pid, args):
    """The card-side transform as the async feed's ``device_fn`` and as the
    trainers' ``trainer_device_fn`` (``DeviceAugment``)."""
    from sparknet_tpu_torch.data import DeviceAugment

    try:
        aug = DeviceAugment(cfg, device=_device(args))
    except ValueError as e:
        raise SystemExit(f"transform_param: {e}") from None
    seed = getattr(args, "seed", None)
    train_fn.device_fn = aug.device_fn(pid, seed)
    train_fn.trainer_device_fn = aug.trainer_device_fn(pid, seed)
    return train_fn


def _process_mode(args) -> bool:
    return getattr(args, "feed", "") == "process"


def _device_augment_guards(args):
    """``--augment device`` on the step loop needs an async feed to run the
    augment on (the trainers apply it after their own feed placement)."""
    if (getattr(args, "tau", 1) > 1 or getattr(args, "distributed", False)
            or getattr(args, "elastic_alpha", 0.0) > 0):
        return
    if getattr(args, "prefetch", 0) <= 0 and not _process_mode(args):
        raise SystemExit(
            "--augment device rides the async feed: pass --prefetch N "
            "or --feed process (the DeviceAugment dispatch belongs on "
            "the feed's device stage, not the step loop)")


def _auto_data(args, net) -> str:
    """``--data auto``: a net whose own data layers name a source streams
    them (``caffe train --solver=x``), any other net gets synthetic
    batches.  A declaration check only; the proto branch opens the
    source and exits loudly if it cannot stream."""
    if args.data != "auto":
        return args.data
    from sparknet_tpu_torch.data.listfile import _SOURCES, _UNPORTED_SOURCES

    if any(l.type in _SOURCES or l.type in _UNPORTED_SOURCES for l in net.input_layers):
        return "proto"
    return "synthetic"


def _data_fns(args, net, closing: contextlib.ExitStack, test_net=None):
    """(train_fn, test_fn) from ``--data``.  ``closing`` takes the sources
    that hold threads or files, and closes them when the caller's stack
    unwinds.  ``test_net``: a distinct TEST-phase net whose own Data
    layer's transform_param drives the test stream.

    Resolves ``auto`` in place (``args.data`` holds the concrete mode
    afterwards).  Across processes each streams its own batches: batch
    indices interleave by rank, and the synthetic stream seeds by rank;
    test streams are the same on every process."""
    was_auto = args.data == "auto"
    args.data = _auto_data(args, net)
    if (getattr(args, "augment", "host") == "device"
            and not args.data.startswith(("cifar:", "db:"))):
        raise SystemExit("--augment device is wired to the cifar: and db: sources "
                         "(other sources transform on the host)")
    pid, nproc = _proc()

    if args.data == "proto":
        return tuple(map(_internalize, _proto_fns(args, net, was_auto, pid, nproc,
                                                  closing)))

    shapes = _feed_shapes(net, args)
    data_shape = shapes["data"]
    batch = data_shape[0]

    if args.data.startswith("cifar:"):
        return tuple(map(_internalize, _cifar_fns(args, batch, pid, nproc)))
    if args.data.startswith("db:"):
        return tuple(map(_internalize, _db_fns(args, net, test_net, data_shape,
                                               batch, pid, nproc)))
    if args.data == "synthetic":
        return _synthetic_fns(data_shape, batch, pid, _token_vocab(net),
                              shapes.get("label", (batch,)))
    raise SystemExit(f"unknown --data source {args.data!r}")


def _proto_fns(args, net, was_auto, pid, nproc, closing):
    """The net's own data-layer params drive the host stream, so a Caffe
    Data/ImageData/WindowData prototxt trains with no surgery (the host
    reader takes the place of the layer's prefetch thread).  A declared
    source that cannot stream exits: it is never replaced by random
    data."""
    from sparknet_tpu_torch.data.listfile import source_from_net

    anchor = getattr(args, "solver", "") or ""
    try:
        train_src = source_from_net(net, seed=1234 + pid + (getattr(args, "seed", 0) or 0),
                                    anchor=anchor)
    except (OSError, ValueError, LookupError) as e:
        mode = "auto" if was_auto else "proto"
        raise SystemExit(
            f"--data {mode}: the net's data layer declares a source that cannot stream "
            f"({e}); pass --data db:<path> / cifar:<dir> to point at the data, or "
            "--data synthetic to smoke-run on random batches") from None
    closing.callback(train_src.close)

    # the eval fallback: its own instance, built at first use with a fixed
    # seed, so every process scores the same stream and evaluation cannot
    # advance the training stream (cmd_train replaces it with the TEST
    # net's own source when there is one)
    eval_state: dict = {}

    def eval_src(b):
        if "src" not in eval_state:
            try:
                eval_state["src"] = source_from_net(net, seed=4321, anchor=anchor)
            except (OSError, ValueError, LookupError) as e:
                raise SystemExit(f"--data proto (eval): {e}") from None
        return eval_state["src"](b)

    closing.callback(lambda: eval_state.get("src") and eval_state["src"].close())
    if nproc == 1:
        return train_src, eval_src
    # an unshuffled source would stream the same lines on every process:
    # interleave batches by rank (every process decodes everything)
    inner, state = train_src, {"started": False}

    def interleaved(it):
        skip = pid if not state["started"] else nproc - 1
        state["started"] = True
        for _ in range(skip):
            inner(it)
        return inner(it)

    return interleaved, eval_src


def _cifar_fns(args, batch, pid, nproc):
    from sparknet_tpu_torch.data import CifarLoader, DataTransformer, TransformConfig

    loader = CifarLoader(args.data[6:])
    xform_cfg = TransformConfig(mean_image=loader.mean_image)
    xform = DataTransformer(xform_cfg)
    xtr, ytr = loader.train_images, loader.train_labels
    xte, yte = loader.test_images, loader.test_labels
    if batch > len(ytr) or batch > len(yte):
        raise SystemExit(f"--batch {batch} exceeds dataset size {min(len(ytr), len(yte))}")

    def raw(it, xs=xtr):
        lo = ((it * nproc + pid) * batch) % (len(ytr) - batch + 1)
        return {"data": xs[lo:lo + batch], "label": ytr[lo:lo + batch].astype(np.int32)}

    def pipeline_factory(transform_cfg):
        """The process feed's twin of the threaded stream: raw slices are a
        pure function of the index, and the host transform, if any, runs in
        the workers.  Under nhwc the images are transposed once, here, and
        the workers slice and transform them channels-last."""

        def factory(num_batches, start_index=0, workers=None):
            from sparknet_tpu_torch.data.pipeline import (
                DataFnSource,
                ProcessPipeline,
                TransformStage,
            )

            from sparknet_tpu_torch.ops.layout import active_layout

            lay = active_layout()
            xs = np.ascontiguousarray(xtr.transpose(0, 2, 3, 1)) if lay == "nhwc" else xtr
            stage = (TransformStage(transform_cfg, train=True, layout=lay)
                     if transform_cfg else None)
            return ProcessPipeline(DataFnSource(lambda it: raw(it, xs)), stage,
                                   num_batches=num_batches,
                                   start_index=start_index, workers=workers,
                                   name="feed.cifar")

        return factory

    if getattr(args, "augment", "host") == "device":
        # raw uint8 on the wire; the mean is subtracted on the card
        _device_augment_guards(args)

        def train_fn(it):
            return raw(it)

        _attach_device_augment(train_fn, xform_cfg, pid, args)
        train_fn.pipeline_factory = pipeline_factory(None)
    else:
        def train_fn(it):
            b = raw(it)
            return {"data": xform(b["data"], True), "label": b["label"]}

        train_fn.pipeline_factory = pipeline_factory(xform_cfg)

    def test_fn(b):
        lo = (b * batch) % (len(yte) - batch + 1)
        return {"data": xform(xte[lo:lo + batch], False),
                "label": yte[lo:lo + batch].astype(np.int32)}

    return train_fn, test_fn


def _token_vocab(net) -> int:
    """The vocabulary of a net whose ``data`` feeds an Embed layer (the
    char LM, the transformer), else 0."""
    for layer in net.layers:
        if layer.type == "Embed" and "data" in layer.bottoms:
            return layer.lp.get_msg("embed_param").get_int("input_dim")
    return 0


def _synthetic_fns(data_shape, batch, pid, vocab=0, label_shape=None):
    """Pixel-scale random batches, 10 classes; for a token net (``vocab``
    > 0) token ids and per-position labels in ``[0, vocab)``."""
    rs = np.random.RandomState(pid)
    num_classes = 10
    label_shape = tuple(label_shape or (batch,))

    def draw(r):
        if vocab:
            return {"data": r.randint(0, vocab, data_shape).astype(np.int32),
                    "label": r.randint(0, vocab, label_shape).astype(np.int32)}
        return {"data": (r.randn(*data_shape) * 50).astype(np.float32),
                "label": r.randint(0, num_classes, batch).astype(np.int32)}

    def synth_train(it):
        return draw(rs)

    def synth_test(b):
        return draw(np.random.RandomState(100_000 + b))

    def pipeline_factory(num_batches, start_index=0, workers=None):
        """The process feed's twin: seeded by (rank, index), since workers
        cannot share ``synth_train``'s sequential RandomState."""
        from sparknet_tpu_torch.data.pipeline import DataFnSource, ProcessPipeline

        def indexed(it):
            return draw(np.random.RandomState((pid * 1_000_003 + it) & 0x7FFFFFFF))

        return ProcessPipeline(DataFnSource(indexed), num_batches=num_batches,
                               start_index=start_index, workers=workers,
                               name="feed.synthetic")

    synth_train.pipeline_factory = pipeline_factory
    return synth_train, synth_test


def _db_fns(args, net, test_net, data_shape, batch, pid, nproc):
    """The CifarDBApp/ImageNetRunDBApp flow: lazy ``db_minibatches``
    cursors, each phase's Data layer's transform_param on the host (ref:
    data_transformer.cpp: mean -> crop [random in TRAIN, center in TEST]
    -> mirror -> scale); ``--data-scale`` overrides the scale.  One DB
    shared by several processes is interleaved by batch (process p takes
    batches p, p + n, ...); ``{proc}`` gives each its own DB."""
    from sparknet_tpu_torch.data import DataTransformer, TransformConfig
    from sparknet_tpu_torch.data.createdb import db_minibatches
    from sparknet_tpu_torch.data.transform import load_mean_file, resolve_mean_file
    from sparknet_tpu_torch.ops.layout import active_layout, canonical_shape

    train_path, test_path = _db_path(args, pid=pid), _db_path(args, 1)
    shared = "{proc}" not in args.data[3:].split(",")[0] and nproc > 1
    stride, offset = (nproc, pid) if shared else (1, 0)
    seed = 1234 + pid + (getattr(args, "seed", 0) or 0)
    mean_cache: dict = {}

    def phase_tp(n):
        return next((l.lp.get_msg("transform_param") for l in n.input_layers
                     if l.TYPE == "Data"), None)

    def tp_params(tp):
        mean_img = None
        mf = tp.get_str("mean_file") if tp else ""
        if mf:
            try:
                resolved = resolve_mean_file(mf, getattr(args, "solver", ""))
                if resolved not in mean_cache:
                    mean_cache[resolved] = load_mean_file(resolved)
                mean_img = mean_cache[resolved]
            except ValueError as e:
                raise SystemExit(str(e)) from None
        return {
            "crop": tp.get_int("crop_size", 0) if tp else 0,
            "mirror": tp.get_bool("mirror", False) if tp else False,
            "mean_vals": tuple(float(v) for v in tp.get_all("mean_value")) if tp else (),
            "mean_img": mean_img,
            "scale": args.data_scale or (tp.get_float("scale", 1.0) if tp else 1.0),
        }

    def transform_cfg(p, seed=None):
        return TransformConfig(scale=p["scale"], mirror=p["mirror"], crop_size=p["crop"],
                               mean_value=p["mean_vals"], mean_image=p["mean_img"], seed=seed)

    trainp = tp_params(phase_tp(net))
    test_has_data = test_net is not None and any(
        l.TYPE == "Data" for l in test_net.input_layers)
    testp = tp_params(phase_tp(test_net)) if test_has_data else trainp
    device_aug = getattr(args, "augment", "host") == "device"
    if device_aug:
        _device_augment_guards(args)

    def db_stream(path, train=True, stride=1, offset=0):
        """A lazy cursor: nothing opens before the first call.  With
        ``--augment device`` the TRAIN stream ships raw uint8 and the card
        transforms it."""
        state: dict = {}
        p = trainp if train else testp
        raw = device_aug and train
        xform = None
        if not raw and (p["crop"] or p["mirror"] or p["mean_img"] is not None
                        or p["mean_vals"]):
            try:
                xform = DataTransformer(transform_cfg(p, seed))
            except ValueError as e:
                raise SystemExit(f"transform_param: {e}") from None

        def fn(_):
            if "iter" not in state:
                try:
                    state["iter"] = db_minibatches(path, batch, loop=True,
                                                   dtype=np.uint8 if raw else np.float32)
                    b = next(state["iter"])
                    for _ in range(offset):
                        b = next(state["iter"])
                except (OSError, ValueError) as e:
                    raise SystemExit(f"--data db: {path}: {e}") from None
            else:
                for _ in range(stride - 1):
                    next(state["iter"])
                b = next(state["iter"])
            if xform is not None:
                try:
                    b = dict(b, data=xform(b["data"], train))
                except ValueError as e:
                    raise SystemExit(f"--data db: {path}: {e}") from None
            elif not raw and p["scale"] != 1.0:
                b = dict(b, data=b["data"] * p["scale"])
            if "checked" not in state:
                state["checked"] = True
                # the cursor's batches are canonical NCHW: compare against
                # the canonical view of the net's (internal) data blob
                got = tuple(b["data"].shape[1:])
                want = canonical_shape(data_shape)[1:]
                if not train and test_net is not None:
                    with contextlib.suppress(KeyError, SystemExit):
                        want = canonical_shape(_feed_shapes(test_net, args)["data"])[1:]
                if raw and p["crop"]:  # the card crops later
                    ok = got[0] == want[0] and got[1] >= want[1] and got[2] >= want[2]
                else:
                    ok = got == want
                if not ok:
                    raise SystemExit(f"{path}: db images {got} do not match the "
                                     f"net's data blob {want}")
            return b

        return fn

    train_fn = db_stream(train_path, stride=stride, offset=offset)
    if device_aug:
        _attach_device_augment(train_fn, transform_cfg(trainp), pid, args)

    def pipeline_factory(num_batches, start_index=0, workers=None):
        """The process feed's twin of the threaded cursor: a
        ``RecordShardSource``'s byte-offset index makes the DB addressable
        by batch, and the decode and the host transform (or, with
        ``--augment device``, nothing) run in the ring's workers."""
        from sparknet_tpu_torch.data.createdb import peek_db_shape
        from sparknet_tpu_torch.data.pipeline import ProcessPipeline, TransformStage
        from sparknet_tpu_torch.data.records import RecordShardSource

        lay = active_layout()
        try:
            src = RecordShardSource(train_path, batch, layout=lay, stride=stride,
                                    offset=offset)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--data db: {train_path}: {e}") from None
        # DB records are canonical (C, H, W)
        got, want = tuple(peek_db_shape(train_path)), canonical_shape(data_shape)[1:]
        if trainp["crop"]:
            ok = got[0] == want[0] and got[1] >= want[1] and got[2] >= want[2]
        else:
            ok = got == want
        if not ok:
            raise SystemExit(f"{train_path}: db images {got} do not match the "
                             f"net's data blob {want}")
        stage = None
        if not device_aug:
            try:
                stage = TransformStage(transform_cfg(trainp, seed), train=True,
                                       layout=lay)
            except ValueError as e:
                raise SystemExit(f"transform_param: {e}") from None
        return ProcessPipeline(src, stage, num_batches=num_batches, start_index=start_index,
                               workers=workers, name="feed.db")

    from sparknet_tpu_torch.data.records import probe_record_backend

    if probe_record_backend(train_path) in ("record", "lmdb"):
        # LevelDB keeps the threaded cursor: its snappy blocks have no
        # per-record byte offsets to index
        train_fn.pipeline_factory = pipeline_factory
    return train_fn, db_stream(test_path, train=False)


def _load_weights_into(solver, path: str, strict_shapes: bool,
                       require_match: bool) -> list[str]:
    """Copy ``.caffemodel`` weights into a solver by layer name, with clean
    CLI errors; returns the loaded layer names.  ``require_match=False``
    (finetuning) tolerates zero loadable layers, as Caffe's
    CopyTrainedLayersFrom does."""
    import struct

    from sparknet_tpu_torch.compiler.graph import NetVars
    from sparknet_tpu_torch.net import copy_caffemodel_params

    if path.endswith((".h5", ".hdf5", ".caffemodel.h5")):
        raise SystemExit(f"{path}: HDF5 weights need h5py, which the card's machine "
                         "lacks (ROADMAP Queue A4); use a .caffemodel")
    variables = solver.variables
    try:
        params, state, loaded = copy_caffemodel_params(
            variables.params, path, strict_shapes=strict_shapes, state=variables.state)
    except (OSError, ValueError, KeyError, struct.error) as e:
        raise SystemExit(f"{path}: {e}") from None
    if require_match and not loaded:
        raise SystemExit(f"{path}: no layers could be loaded (names or shapes do "
                         "not match this net)")
    solver.variables = NetVars(params=params, state=state)
    return loaded


# ---------------------------------------------------------------------------
def _process_feed(train_fn, num_batches, start_index, args, log, device, device_stage=True):
    """``--feed process``: the shared-memory ring (``data/pipeline.py``) in
    place of the threaded feed.  Returns ``(context, data_fn)``: the
    context owns the ring and (``device_stage``) the double-buffered copy
    to ``device``, and must wrap the loop.  ``device_stage=False`` keeps
    the feeds on the host (``ParallelTrainer`` packs and places them)."""
    factory = getattr(train_fn, "pipeline_factory", None)
    if factory is None:
        raise SystemExit(
            "--feed process needs an index-addressable source a worker "
            "process can re-produce deterministically: synthetic, cifar:, "
            "and db: record/LMDB files (RecordShardSource byte-offset "
            "index, data/records.py) ride the ring; the remaining "
            "stateful cursors (proto listfiles, LevelDB) keep --feed "
            "threaded — convert LevelDB via data.createdb.convert_db to "
            "join")
    stack = contextlib.ExitStack()
    pipe = stack.enter_context(factory(num_batches=num_batches, start_index=start_index,
                                       workers=getattr(args, "feed_workers", 0) or None))
    if device_stage:
        from sparknet_tpu_torch.data.pipeline import device_feed

        pf = stack.enter_context(device_feed(
            pipe, depth=max(getattr(args, "prefetch", 0), 2),
            device_fn=getattr(train_fn, "device_fn", None), device=device))
        it = iter(pf)

        def fn(_it):
            return next(it)
    else:
        # _stack_tau holds tau batches before stacking them, longer than a
        # ring view lives: stable copies
        fn = pipe.as_data_fn(copy=True)
    log(f"feed: process pipeline ({pipe.workers} worker(s), "
        f"{pipe.slots} slots x {pipe.spec.slot_bytes:,} B"
        f"{', device stage' if device_stage else ''})")
    return stack, fn


def _join_processes(args) -> None:
    """Join ``--num-processes`` processes at ``--coordinator host:port``
    (rank 0 serves the TCP store): NCCL with a card a process where the
    machine has enough of them, else gloo (several ranks on one card, or
    the CPU)."""
    import torch

    from sparknet_tpu_torch.parallel.mesh import initialize_distributed

    if not args.coordinator:
        raise SystemExit("--num-processes requires --coordinator host:port")
    if not (args.distributed or args.tau > 1 or args.elastic_alpha > 0):
        # without the trainer every process would train its own model
        raise SystemExit("--num-processes requires --distributed, --tau > 1, or "
                         "--elastic-alpha > 0")
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(f"--process-id {args.process_id} is not in "
                         f"[0, --num-processes {args.num_processes})")
    device = _device(args)
    backend = "gloo"
    if device.type == "cuda" and args.num_processes <= torch.cuda.device_count():
        torch.cuda.set_device(args.process_id)
        backend = "nccl"
    initialize_distributed(backend=backend, coordinator=args.coordinator,
                           rank=args.process_id, world_size=args.num_processes)


def cmd_train(args) -> int:
    """ref: caffe.cpp:153-218 train()."""
    import torch.distributed as dist

    if args.snapshot and args.weights:
        raise SystemExit("--snapshot and --weights are mutually exclusive")
    if args.coordinator and not args.num_processes:
        # a lone --coordinator would train unsynced models on every host
        raise SystemExit("--coordinator requires --num-processes")
    joined = False
    if args.num_processes:
        _join_processes(args)
        joined = True
    try:
        return _train(args)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _train(args) -> int:
    import tempfile

    from sparknet_tpu_torch.utils import EventLogger

    net_param, solver_cfg = _build_net_and_solver(args)
    solver = _make_solver(solver_cfg, net_param, args)
    if args.snapshot:
        solver.restore(args.snapshot)
    elif args.weights:
        loaded = _load_weights_into(solver, args.weights, strict_shapes=False,
                                    require_match=False)
        print(json.dumps({"finetune_from": args.weights, "layers_loaded": loaded}))
    log = EventLogger(os.environ.get("SPARKNET_TRAIN_LOG_DIR",
                                     os.path.join(tempfile.gettempdir(), "tpunet_logs")),
                      prefix="tpunet_train")
    with contextlib.ExitStack() as closing:
        train_fn, test_fn = _data_fns(args, solver.train_net, closing,
                                      test_net=solver.test_net)
        if args.data == "proto":
            # the TEST net's data layer names its own source; a train-only
            # prototxt (no TEST-phase data layer) keeps the eval fallback
            from sparknet_tpu_torch.data.listfile import source_from_net

            try:
                src = source_from_net(solver.test_net, seed=4321, anchor=args.solver or "")
            except LookupError:
                pass
            except (OSError, ValueError) as e:
                raise SystemExit(f"--data proto (test net): {e}") from None
            else:
                closing.callback(src.close)
                test_fn = src
        iters = args.iterations or solver_cfg.max_iter
        if args.profile:
            from sparknet_tpu_torch.utils import profiling

            closing.enter_context(profiling.trace(args.profile))
            log(f"profiling -> {args.profile}")
        if args.tau > 1 or args.distributed or args.elastic_alpha > 0:
            _train_rounds(args, solver, train_fn, iters, log)
        else:
            _train_steps(args, solver, solver_cfg, train_fn, iters, log)
        if args.test_iters:
            scores = solver.test(args.test_iters, test_fn)
            log(f"scores: {scores}", i=solver.iter)
    if _proc()[0] == 0:  # rank 0 owns the snapshot (the replicas are equal)
        out = solver.save(args.output or "tpunet_final")
        log(f"saved {out}")
    return 0


def _train_rounds(args, solver, train_fn, iters, log) -> None:
    """SparkNet's rounds over ``ParallelTrainer``: ``[tau, B, ...]`` feeds
    at ``--tau`` > 1 and under EASGD, ``[B, ...]`` at ``--distributed``
    alone; the signal checks between rounds, agreed across processes; at
    the end the solver takes the trainer's model and history."""
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    from sparknet_tpu_torch.utils import SignalHandler, SolverAction, agree_action

    rank, nproc = _proc()
    if nproc > 1:
        log(f"distributed: process {rank}/{nproc}")
    try:
        trainer = ParallelTrainer(solver, tau=args.tau, elastic_alpha=args.elastic_alpha)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    try:
        # captured before --feed process swaps train_fn for the ring's
        aug_fn = getattr(train_fn, "trainer_device_fn", None)
        if aug_fn is not None:
            trainer.feed_device_fn = aug_fn
            log("augment: device (after placement, tau wire uint8)")
        tau = max(args.tau, 1)
        outer = -(-iters // tau)  # ceil: at least the requested iterations
        feed_ctx = contextlib.nullcontext()
        if _process_mode(args):
            feed_ctx, train_fn = _process_feed(train_fn, outer * tau, 0, args, log,
                                               solver.device, device_stage=False)
        round_fn = (_stack_tau(train_fn, tau) if args.tau > 1 or args.elastic_alpha > 0
                    else train_fn)
        with feed_ctx, SignalHandler() as sig:
            for _ in range(outer):
                loss = trainer.train_round(round_fn)
                log(f"loss: {loss:.5f}", i=trainer.iter)
                action = agree_action(sig.check())
                if action is SolverAction.SNAPSHOT:
                    trainer.sync_to_solver()
                    if rank == 0:
                        solver.save(f"tpunet_iter_{trainer.iter}")
                elif action is SolverAction.STOP:
                    break
        trainer.sync_to_solver()
    finally:
        trainer.close()


def _train_steps(args, solver, solver_cfg, train_fn, iters, log) -> None:
    """One ``Solver`` stepping: the threaded feed, ``--prefetch N`` (a
    ``DevicePrefetcher``) or ``--feed process`` (the ring and its device
    stage), streaming from ``solver.iter`` so a resumed run continues the
    sequence."""
    from sparknet_tpu_torch.utils import SignalHandler, SolverAction

    pf_ctx = contextlib.nullcontext()
    if _process_mode(args):
        pf_ctx, train_fn = _process_feed(train_fn, iters, solver.iter, args, log,
                                         solver.device)
    elif args.prefetch > 0:
        from sparknet_tpu_torch.data.prefetch import DevicePrefetcher

        pf_ctx = DevicePrefetcher(train_fn, iters, depth=args.prefetch, start_iter=solver.iter,
                                  device_fn=getattr(train_fn, "device_fn", None),
                                  device=solver.device)
        pf_iter = iter(pf_ctx)

        def train_fn(it):
            return next(pf_iter)

        log(f"prefetch: depth {args.prefetch}")
    display = solver_cfg.display
    with pf_ctx, SignalHandler() as sig:
        def hook(it, loss):
            if display and it % display == 0:
                log(f"loss: {loss:.5f}", i=it)
            action = sig.check()
            if action is SolverAction.SNAPSHOT:
                solver.save(f"tpunet_iter_{it}")
            elif action is SolverAction.STOP:
                raise KeyboardInterrupt

        try:
            solver.step(iters, train_fn, callback=hook)
        except KeyboardInterrupt:
            log("stopped by signal", i=solver.iter)


def _stack_tau(train_fn, tau):
    """``[tau, B, ...]`` feeds: tau fresh batches a round, whatever the
    trainer's iteration count (one process is one worker, so a slot is one
    batch)."""
    counter = [0]

    def fn(it):
        slots = []
        for _ in range(tau):
            slots.append(train_fn(counter[0]))
            counter[0] += 1
        return {key: np.stack([s[key] for s in slots]) for key in slots[0]}

    return fn


def cmd_test(args) -> int:
    """ref: caffe.cpp:222-287 test(): score a model from --weights or
    from a --snapshot solver state."""
    if args.snapshot and args.weights:
        raise SystemExit("--snapshot and --weights are mutually exclusive")
    if not args.snapshot and not args.weights:
        raise SystemExit("test needs --weights or --snapshot to score")
    net_param, solver_cfg = _build_net_and_solver(args)
    solver = _make_solver(solver_cfg, net_param, args)
    if args.snapshot:
        solver.restore(args.snapshot)
    else:
        _load_weights_into(solver, args.weights, strict_shapes=True, require_match=True)
    with contextlib.ExitStack() as closing:
        _, test_fn = _data_fns(args, solver.test_net, closing)
        scores = solver.test(args.iterations or 10, test_fn)
    print(json.dumps(scores))
    return 0


def cmd_time(args) -> int:
    """Per-layer forward/backward table (ref: caffe.cpp:290-380); with
    ``--fused`` the whole ``Solver`` step on one fixed batch; with
    ``--trace`` the whole step under ``torch.profiler``, its device time
    attributed to layers (:func:`_time_trace`)."""
    import torch

    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.utils.timing import Timer, time_layers

    net_param, solver_cfg = _build_net_and_solver(args)
    if args.trace:
        return _time_trace(args, net_param, solver_cfg)
    iters = args.iterations or 10
    if args.fused:
        solver = _make_solver(solver_cfg, net_param, args)
        with contextlib.ExitStack() as closing:
            train_fn, _ = _data_fns(args, solver.train_net, closing)
            feeds = solver._feeds_on_device(train_fn(0))
        float(solver.train_iteration(feeds))  # warm-up + fence
        t = Timer(solver.device).start()
        for _ in range(iters):
            loss = solver.train_iteration(feeds)
        float(loss)
        dt = t.stop() / 1e3 / iters
        batch = next(iter(feeds.values())).shape[0]
        print(json.dumps({"fused_step_ms": round(dt * 1e3, 3), "batch": int(batch),
                          "img_per_sec": round(batch / dt, 1)}))
        return 0

    with _clean_shape_errors():
        net = Network(net_param, Phase.TRAIN, device=_device(args))
        variables = net.init(torch.Generator().manual_seed(0), _peeked_feed_shapes(args, net_param))
    with contextlib.ExitStack() as closing:
        train_fn, _ = _data_fns(args, net, closing)
        feeds = train_fn(0)
    rows = time_layers(net, variables, feeds, iterations=iters)
    w = max(len(r["layer"]) for r in rows) + 2
    print(f"{'layer':<{w}}{'type':<18}{'forward':>10}  {'backward':>10}")
    tot_f = tot_b = 0.0
    for r in rows:
        b = f"{r['backward_ms']:.3f}" if r["backward_ms"] is not None else "-"
        print(f"{r['layer']:<{w}}{r['type']:<18}{r['forward_ms']:>9.3f}ms {b:>9}ms")
        tot_f += r["forward_ms"]
        tot_b += r["backward_ms"] or 0.0
    print(f"{'TOTAL':<{w}}{'':<18}{tot_f:>9.3f}ms {tot_b:>9.3f}ms")
    print("(layers timed in isolation; the whole step is faster)")
    return 0


def _time_trace(args, net_param, solver_cfg) -> int:
    """``tpunet time --trace``: profiler-attributed per-layer device time
    of the whole ``Solver`` step, with FLOPs and MFU (the JAX CLI's
    ``_time_trace``).

    Staged and flushed as it goes: every stage banks its evidence to
    ``--trace-out`` (default ``tpunet_trace.json``) before the next one
    runs: ``compiled`` (FLOPs of one step by ``FlopCounterMode``, which
    also warms the step up), ``wall_timed`` (3 steps without the
    profiler), ``trace_short`` (a one-step trace) and ``final`` (an
    ``--iterations`` trace).  A float32 step runs with TF32 off, the
    condition its MFU cell assumes.  A traced window that lost records of
    a hand kernel is discarded and taken again, up to ``TRACE_RETRIES``
    times (the artifact counts them), so no table is short."""
    import time as _time

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sparknet_tpu_torch.common import f32_precision, get_config
    from sparknet_tpu_torch.utils.op_profile import LostRecords, table_from_trace, trace_step

    out_path = args.trace_out or "tpunet_trace.json"
    artifact: dict = {"stage": "init", "argv_solver": args.solver,
                      "utc": _time.strftime("%Y-%m-%d %H:%M:%SZ", _time.gmtime())}

    def bank(stage: str, **kv) -> None:
        artifact["stage"] = stage
        artifact.update(kv)
        try:
            with open(out_path + ".tmp", "w") as f:
                json.dump(artifact, f, indent=1, default=str)
            os.replace(out_path + ".tmp", out_path)
        except OSError:
            pass  # stdout remains the record

    solver = _make_solver(solver_cfg, net_param, args)
    with contextlib.ExitStack() as closing:
        train_fn, _ = _data_fns(args, solver.train_net, closing)
        feeds = solver._feeds_on_device(train_fn(0))
    iters = args.iterations or 10
    batch = int(next(iter(feeds.values())).shape[0])
    platform = solver.device.type
    kind = torch.cuda.get_device_name(solver.device) if platform == "cuda" else platform
    dtype_name = "bf16" if get_config().compute_dtype == torch.bfloat16 else "f32"
    peak = peak_label = None
    if kind in PEAK_FLOPS:
        cell, peaks = PEAK_FLOPS[kind]
        peak, peak_label = peaks[dtype_name], f"{cell}_{dtype_name}"

    def step(f):
        return solver.train_iteration(f)

    discarded = {}

    def traced(n: int, key: str) -> dict:
        for attempt in range(TRACE_RETRIES + 1):
            try:
                return trace_step(step, (feeds,), iters=n)
            except LostRecords as e:
                discarded[key] = attempt + 1
                print(f"time --trace: {e}; taking the window again", file=sys.stderr)
                if attempt == TRACE_RETRIES:
                    raise

    with f32_precision() if dtype_name == "f32" else contextlib.nullcontext():
        with FlopCounterMode(display=False) as counter:
            loss = step(feeds)  # the warm-up step, counted
        float(loss)
        flops = float(counter.get_total_flops())
        bank("compiled", batch=batch, dtype=dtype_name, platform=platform,
             device_kind=kind, iters=int(iters), gflop_per_step=round(flops / 1e9, 2),
             flop_source="torch.utils.flop_counter.FlopCounterMode over one step "
             "(aten ops; the hand kernels' own work is not counted)",
             hbm_gb_per_step=None)

        # wall timing WITHOUT the profiler, fenced on the loss value; the
        # Solver threads its own state from step to step
        t0 = _time.perf_counter()
        for _ in range(3):
            loss = step(feeds)
        float(loss)
        wall_untraced_s = (_time.perf_counter() - t0) / 3
        mfu_untraced = flops / wall_untraced_s / peak if peak else None
        bank("wall_timed",
             wall_ms_per_step_untraced=round(wall_untraced_s * 1e3, 3),
             img_per_sec_untraced=round(batch / wall_untraced_s, 1),
             mfu_untraced=round(mfu_untraced, 4) if mfu_untraced is not None else None,
             mfu_vs_peak=peak_label, fence_protocol="loss-value+threaded-args")

        layer_names = [layer.name for layer in solver.train_net.layers]
        prof = traced(1, "short")
        table = table_from_trace(prof, layer_names, iters=1)
        bank("trace_short",
             kernel_launches_short={k: n for k, n in prof["launches"].items() if n},
             rows_short=[(n, round(us, 1)) for n, us in table["rows"]],
             device_us_per_step_short=round(table["device_us_per_step"], 1),
             attributed_frac_short=round(table["attributed_frac"], 3),
             trace_dir_short=table["trace_dir"])
        if iters > 1:
            prof = traced(iters, "final")
            table = table_from_trace(prof, layer_names, iters=iters)

    wall_s = table["wall_us_per_step"] / 1e6
    mfu = flops / wall_s / peak if peak and wall_s else None
    if table["rows"]:
        # the reference's `caffe time` table: per-layer Forward and
        # Backward walls plus the total (ref: caffe/tools/caffe.cpp:
        # 290-380); here attributed from the whole step's device trace
        fb = {name: (f, b) for name, f, b in table["rows_fwd_bwd"]}
        w = max(len(r) for r, _ in table["rows"]) + 2
        print(f"{'layer':<{w}}{'fwd ms':>10}{'bwd ms':>10}{'total ms':>11}")
        for name, us in table["rows"]:
            f_us, b_us = fb.get(name, (0.0, 0.0))
            print(f"{name:<{w}}{f_us / 1e3:>10.3f}{b_us / 1e3:>10.3f}{us / 1e3:>11.3f}")
        print(f"{'DEVICE TOTAL':<{w}}{'':>10}{'':>10}"
              f"{table['device_us_per_step'] / 1e3:>11.3f}"
              f"  (attributed {table['attributed_frac'] * 100:.0f}%)")
    else:
        print("(no device-op lanes in the trace — per-layer attribution needs an "
              "accelerator backend; wall/MFU numbers below are still measured)")
    summary = {
        "wall_ms_per_step": round(wall_s * 1e3, 3),
        "img_per_sec": round(batch / wall_s, 1),
        "batch": batch,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "mfu_vs_peak": peak_label,
        "gflop_per_step": round(flops / 1e9, 2),
        "hbm_gb_per_step": None,
        "platform": platform,
        "trace_dir": table["trace_dir"],
    }
    bank("final",
         windows_discarded=discarded,
         kernel_launches={k: n for k, n in prof["launches"].items() if n},
         rows=[(n, round(us, 1)) for n, us in table["rows"]],
         rows_fwd_bwd=[(n, round(f, 1), round(b, 1)) for n, f, b in table["rows_fwd_bwd"]],
         device_us_per_step=round(table["device_us_per_step"], 1),
         attributed_frac=round(table["attributed_frac"], 3),
         **summary)
    print(json.dumps(summary))
    if platform == "cuda" and not table["rows"]:
        print(f"time --trace: the profiler window ({table['trace_dir']}) recorded no CUDA "
              "kernel", file=sys.stderr)
        return 1
    return 0


def cmd_convert_imageset(args) -> int:
    """Image list -> record DB (ref: caffe/tools/convert_imageset.cpp:
    a list file of "<relpath> <label>" lines, an optional resize)."""
    from sparknet_tpu_torch.data.createdb import create_db
    from sparknet_tpu_torch.data.minibatch import decode_jpeg

    def samples():
        with open(args.listfile) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rel, label = line.rsplit(maxsplit=1)
                try:
                    with open(os.path.join(args.root, rel), "rb") as img:
                        arr = decode_jpeg(img.read(), args.resize, args.resize)
                except OSError:
                    arr = None  # a missing file is a broken image: dropped
                if arr is None:
                    continue
                yield arr, int(label)

    n = create_db(args.db, samples(), backend=args.backend)
    if n == 0:
        raise SystemExit(f"no decodable images: check --root {args.root!r} and the "
                         "listfile paths (0 of the listed files produced records)")
    print(json.dumps({"records": n, "db": args.db, "backend": args.backend}))
    return 0


def cmd_convert_db(args) -> int:
    """LMDB / LevelDB / RecordDB conversion, source detected (the ingest
    bridge for existing Caffe datasets)."""
    from sparknet_tpu_torch.data.createdb import convert_db

    n = convert_db(args.src, args.dst, backend=args.backend)
    print(json.dumps({"records": n, "src": args.src, "dst": args.dst,
                      "backend": args.backend}))
    return 0


def cmd_compute_image_mean(args) -> int:
    """DB -> mean image ``.npy`` or ``.binaryproto`` (ref:
    caffe/tools/compute_image_mean.cpp)."""
    from sparknet_tpu_torch.data.createdb import db_mean

    try:
        mean = db_mean(args.db, args.batch or 64)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.out.endswith(".binaryproto"):
        from sparknet_tpu_torch.data.io_utils import save_mean_binaryproto

        save_mean_binaryproto(args.out, mean)
    else:
        np.save(args.out, mean)
    print(json.dumps({"out": args.out, "shape": list(mean.shape)}))
    return 0


def cmd_extract_features(args) -> int:
    """Forward a dataset and save an intermediate blob of every batch to
    one ``.npy`` (ref: caffe/tools/extract_features.cpp +
    apps/FeaturizerApp.scala)."""
    from sparknet_tpu_torch.apps.featurizer import FeaturizerApp
    from sparknet_tpu_torch.net import TPUNet

    if args.snapshot and args.weights:
        raise SystemExit("--snapshot and --weights are mutually exclusive")
    net_param, solver_cfg = _build_net_and_solver(args)
    with _clean_shape_errors():
        net = TPUNet(solver_cfg, net_param, feed_shapes=_peeked_feed_shapes(args, net_param),
                     device=_device(args))
    if args.snapshot:
        net.solver.restore(args.snapshot)
    elif args.weights:
        _load_weights_into(net.solver, args.weights, strict_shapes=True, require_match=True)
    with contextlib.ExitStack() as closing:
        _, test_fn = _data_fns(args, net.test_net, closing)
        app = FeaturizerApp(net, feature_blob=args.blob)
        out = np.concatenate(list(app.featurize(
            test_fn(b) for b in range(args.iterations or 10))))
    np.save(args.out, out)
    print(json.dumps({"out": args.out, "shape": list(out.shape)}))
    return 0


def cmd_draw(args) -> int:
    """Net prototxt -> Graphviz DOT (ref: caffe/python/draw_net.py)."""
    from sparknet_tpu_torch.utils.draw import draw_net_to_file

    if args.net.startswith("zoo:"):
        from sparknet_tpu_torch import models

        net_param = getattr(models, args.net[4:])(args.batch or 100)
    else:
        from sparknet_tpu_torch.proto_loader import load_net_prototxt

        net_param = load_net_prototxt(args.net)
    draw_net_to_file(net_param, args.out, rankdir=args.rankdir, phase=args.phase or None)
    print(json.dumps({"out": args.out, "rankdir": args.rankdir}))
    return 0


def cmd_classify(args) -> int:
    """Classify images with a deploy net: the top-N labels an image (ref:
    examples/cpp_classification/classification.cpp)."""
    from sparknet_tpu_torch.data.io_utils import load_image
    from sparknet_tpu_torch.models.classifier import Classifier

    mean = None
    if args.mean:
        from sparknet_tpu_torch.data.transform import load_mean_file

        m = load_mean_file(args.mean)
        if m.ndim == 2:  # an (H, W) grayscale mean
            m = m[None]
        # cpp_classification collapses the mean image to per-channel values
        # (classification.cpp SetMean: channel_mean)
        mean = m.reshape(m.shape[0], -1).mean(axis=1)
    labels = None
    if args.labels:
        with open(args.labels) as f:
            labels = [line.strip() for line in f if line.strip()]
    if args.oversample and args.center_only:
        raise SystemExit("--oversample and --center-only are mutually exclusive")
    image_dims = None
    if args.images_dim:
        try:
            h, w = (int(v) for v in args.images_dim.split(","))
        except ValueError:
            raise SystemExit(f'--images-dim must be "H,W" (got {args.images_dim!r})') from None
        image_dims = (h, w)
    if args.weights.endswith((".h5", ".hdf5", ".caffemodel.h5")):
        raise SystemExit(f"{args.weights}: HDF5 weights need h5py, which the card's machine "
                         "lacks (ROADMAP Queue A4); use a .caffemodel")
    clf = Classifier(args.model, args.weights or None, image_dims=image_dims, mean=mean,
                     raw_scale=args.raw_scale if args.raw_scale else None,
                     channel_swap=(2, 1, 0) if args.bgr else None, device=_device(args))
    crop_h, crop_w = clf.feed_shapes[clf.inputs[0]][2:]
    if image_dims and (image_dims[0] < crop_h or image_dims[1] < crop_w):
        raise SystemExit(f"--images-dim {image_dims} is smaller than the net input "
                         f"({crop_h}, {crop_w}); crops would be out of bounds")
    # a 1-channel net gets grayscale loads (pycaffe classify.py's --gray)
    channels = clf.feed_shapes[clf.inputs[0]][1]
    images = [load_image(p, color=channels != 1) for p in args.images]
    # one center pass by default, as cpp_classification; the preprocessing
    # runs once (calibration and prediction share the blobs)
    blobs = clf.preprocess_images(images, args.oversample)
    if args.fold_bn:
        print(json.dumps({"fold_bn": clf.fold_batchnorm()}))
    if args.int8:
        qstate = clf.calibrate_int8(blobs=blobs)
        print(json.dumps({"int8": sorted(qstate)}))
    probs = clf.predict_blobs(blobs, oversample=args.oversample)
    results = []
    for path, p in zip(args.images, probs):
        top = np.argsort(p)[::-1][:args.top]
        results.append({"image": path, "predictions": [
            {"label": labels[i] if labels and i < len(labels) else int(i),
             "prob": round(float(p[i]), 4)} for i in top]})
    print(json.dumps(results))
    return 0


def cmd_pull_shards(args) -> int:
    """Explode a contiguous range of tar shards into a staging directory,
    per-worker dataset staging (ref: ec2/pull.py, which pulled
    files-shuf-NNN.tar from S3).  ``--store`` is a local or NFS directory
    (``data/remote.py``); gs:// and s3:// are not ported."""
    import re
    import tarfile

    from sparknet_tpu_torch.data.remote import get_store

    try:
        store = get_store(args.store)
        shards = [u for u in store.list_prefix(args.store) if u.endswith(".tar")]
    except (ValueError, RuntimeError, NotImplementedError) as e:
        raise SystemExit(f"--store {args.store}: {e}") from None
    if not shards:
        raise SystemExit(f"no .tar shards under {args.store}")
    # select by the shard number in the file name (files-shuf-007.tar is
    # shard 7 even when earlier shards are missing)
    sel = []
    for path in shards:
        m = re.findall(r"(\d+)", os.path.basename(path))
        if m and args.start <= int(m[-1]) < args.stop:
            sel.append(path)
    if not sel:
        raise SystemExit(f"no shards numbered [{args.start}, {args.stop}) under {args.store}")
    outdir = os.path.join(args.out, "%03d-%03d" % (args.start, args.stop))
    os.makedirs(outdir, exist_ok=True)
    written: set[str] = set()
    clobbered = 0
    for path in sel:
        with tarfile.open(path) as tar:
            for member in tar.getmembers():
                if not member.isfile():
                    continue
                src = tar.extractfile(member)
                if src is None:
                    continue
                # keep the in-archive relative paths; refuse escapes
                rel = os.path.normpath(member.path).lstrip("/")
                if rel.startswith(".."):
                    raise SystemExit(f"shard member escapes outdir: {member.path}")
                dst = os.path.join(outdir, rel)
                os.makedirs(os.path.dirname(dst) or outdir, exist_ok=True)
                if dst in written:
                    clobbered += 1
                written.add(dst)
                with open(dst, "wb") as f:
                    f.write(src.read())
    print(json.dumps({"out": outdir, "shards": len(sel), "files": len(written),
                      "clobbered": clobbered}))
    return 0


def cmd_create_labelfile(args) -> int:
    """A train.txt of the files present in a directory, their labels looked
    up (case-normalized) in a master label file (ref:
    ec2/create_labelfile.py)."""
    labelmap = {}
    with open(args.trainfile) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                labelmap[parts[0].upper()] = parts[1]
    n, missing = 0, 0
    with open(args.outfile, "w") as out:
        for _root, _dirs, files in os.walk(args.directory):
            for fname in sorted(files):
                label = labelmap.get(fname.upper())
                if label is None:
                    missing += 1
                    continue
                out.write(f"{fname} {label}\n")
                n += 1
    print(json.dumps({"out": args.outfile, "entries": n, "unlabeled": missing}))
    return 0


def cmd_upgrade_net_proto_text(args) -> int:
    """Legacy V0/V1 net prototxt -> the current schema (ref:
    caffe/tools/upgrade_net_proto_text.cpp)."""
    from sparknet_tpu_torch.proto.text_format import parse_file, serialize
    from sparknet_tpu_torch.proto.upgrade import upgrade_net

    upgraded = upgrade_net(parse_file(args.input))
    with open(args.output, "w") as f:
        f.write(serialize(upgraded) + "\n")
    print(json.dumps({"out": args.output, "layers": len(upgraded.get_all("layer"))}))
    return 0


def cmd_upgrade_net_proto_binary(args) -> int:
    """Legacy binary NetParameter (V1LayerParameter records) -> the current
    schema (ref: caffe/tools/upgrade_net_proto_binary.cpp), remapped on
    the wire: the type enum becomes the V2 string and blobs_lr/weight_decay
    fold into ParamSpec messages; everything else passes through
    byte-identically."""
    from sparknet_tpu_torch.proto.binary import loads_caffemodel, upgrade_net_binary

    with open(args.input, "rb") as f:
        raw = f.read()
    out_bytes, upgraded = upgrade_net_binary(raw)
    model = loads_caffemodel(out_bytes)
    if not model.layers:
        raise SystemExit(f"no layers decoded from {args.input}")
    with open(args.output, "wb") as f:
        f.write(out_bytes)
    print(json.dumps({"out": args.output, "layers": len(model.layers),
                      "upgraded_v1_records": upgraded,
                      "blobs": sum(len(l.blobs) for l in model.layers)}))
    return 0


def cmd_upgrade_solver_proto_text(args) -> int:
    """The deprecated solver_type enum -> the type string (ref:
    caffe/tools/upgrade_solver_proto_text.cpp)."""
    from sparknet_tpu_torch.proto.text_format import parse_file, serialize
    from sparknet_tpu_torch.proto.upgrade import upgrade_solver

    upgraded = upgrade_solver(parse_file(args.input))
    with open(args.output, "w") as f:
        f.write(serialize(upgraded) + "\n")
    print(json.dumps({"out": args.output, "type": upgraded.get_str("type", "SGD")}))
    return 0


def cmd_parse_log(args) -> int:
    """ref: tools/extra/parse_log.py: a training log -> .train/.test CSVs."""
    from sparknet_tpu_torch.utils.log_parse import parse_log_to_csv

    train_path, test_path = parse_log_to_csv(args.logfile, args.out_dir,
                                             delimiter=args.delimiter)
    print(json.dumps({"train": train_path, "test": test_path}))
    return 0


def cmd_plot_training_log(args) -> int:
    """ref: tools/extra/plot_training_log.py.example: chart types 0-7."""
    from sparknet_tpu_torch.utils.plotting import plot_chart

    try:
        out = plot_chart(args.chart_type, args.logfile, args.out)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(str(e)) from None
    print(json.dumps({"chart": out}))
    return 0


def cmd_resize_images(args) -> int:
    """ref: tools/extra/resize_and_crop_images.py: offline dataset prep."""
    from sparknet_tpu_torch.data.resize_images import resize_tree

    try:
        ok, errors = resize_tree(args.input_folder, args.output_folder, args.side,
                                 args.workers)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    for path, msg in errors[:20]:
        print(f"{path}: {msg}", file=sys.stderr)
    print(json.dumps({"resized": ok, "errors": len(errors)}))
    return 0 if not errors else 1


_QUERY = (
    "import json, torch\n"
    "for i in range(torch.cuda.device_count()):\n"
    "    print(json.dumps({'id': i, 'platform': 'gpu', "
    "'device_kind': torch.cuda.get_device_name(i), 'process_index': 0}))\n"
)


def cmd_device_query(args) -> int:
    """ref: caffe.cpp:110-150 device_query(): one JSON line a device.  The
    CUDA query runs in a disposable subprocess bounded by ``--timeout``
    seconds (0: in this process, waiting as long as it takes)."""
    import subprocess

    if args.device == "cpu":
        print(json.dumps({"id": 0, "platform": "cpu", "device_kind": "cpu",
                          "process_index": 0}))
        return 0
    _device(args)
    if args.timeout <= 0:
        exec(_QUERY, {})
        return 0
    try:
        out = subprocess.run([sys.executable, "-c", _QUERY], capture_output=True,
                             text=True, timeout=args.timeout)
    except subprocess.TimeoutExpired:
        print(json.dumps({"error": f"the CUDA driver did not answer within "
                          f"{args.timeout:.0f}s; re-run with --timeout 0 to wait forever"}))
        return 1
    if out.returncode != 0:
        tail = (out.stderr or out.stdout).strip().splitlines()[-1:]
        print(json.dumps({"error": tail[0][:300] if tail else "no output"}))
        return 1
    print(out.stdout.strip())
    return 0


def _summary_json(summary: dict) -> str:
    """One JSON line of a run summary (numpy scalars as numbers)."""
    return json.dumps(summary, default=lambda v: v.item() if hasattr(v, "item") else str(v))


def cmd_serve(args) -> int:
    """Synthetic load through the serving engine: a primary and an aux
    model, the priced over-budget refusal, a closed-loop burst plan through
    every bucket, one summary JSON line; exits 1 unless 0 graphs were
    captured after the warm-up.  With ``--replicas K`` (K > 1) the run goes
    through the ``ReplicaRouter`` pod on K + 1 device slots of the card (a
    free one for the controller's join; open-loop arrivals, deadline
    shedding; exits 1 unless 0 captures and 0 dropped tickets).

    ref: apps/FeaturizerApp.scala:1 (the reference's batch scoring app)."""
    from sparknet_tpu_torch.serve.loadgen import load_run, pod_run

    device = _device(args)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    log = lambda m: print(f"serve: {m}", file=sys.stderr)  # noqa: E731
    if args.replicas > 1:
        summary = pod_run(
            replicas=args.replicas, family=args.family, arm=args.arm, buckets=buckets,
            max_wait_ms=args.max_wait_ms, rate=args.rate, seconds=args.seconds,
            controller=args.controller, log=log,
            devices=[str(device)] * (args.replicas + 1))
        print(_summary_json({k: v for k, v in summary.items() if k != "per_replica"}))
        return 0 if summary["compiles_post_warmup"] == 0 and summary["dropped"] == 0 else 1
    summary = load_run(requests=args.requests, family=args.family, arm=args.arm,
                       buckets=buckets, max_wait_ms=args.max_wait_ms, log=log,
                       device=device)
    print(_summary_json(summary))
    return 0 if summary["compiles_post_warmup"] == 0 else 1


def cmd_loop(args) -> int:
    """The train-to-serve production loop (``loop/dryrun.py``): elastic
    rounds -> atomic checkpoint -> candidate captured on a builder thread
    -> hot swap into the live engine -> over-budget refusal -> bitwise
    rollback, with traffic in flight.  Prints one summary JSON line; exits
    1 unless every gate holds (0 captures on the request path, 0 dropped
    tickets, scores change on the rollout and are restored on the
    rollback).  A world of one (the elastic trainer forms it: NCCL on the
    card, gloo on the CPU), on the card unless ``--device cpu``;
    ``SPARKNET_FUSED_UPDATE=1`` runs the fused update (kernel B2).

    ref: apps/FeaturizerApp.scala:1 (the reference's single Spark app
    owning both training and scoring)."""
    from sparknet_tpu_torch.loop.dryrun import loop_run

    device = _device(args)
    summary = loop_run(
        iterations=args.iterations, rounds_per_rollout=args.rounds, family=args.family,
        arm=args.arm, buckets=tuple(int(b) for b in args.buckets.split(",")),
        per_worker_batch=args.batch, width=args.width or None, tau=args.tau,
        requests=args.requests, max_wait_ms=args.max_wait_ms,
        workdir=args.workdir or None, controller=args.controller,
        log=lambda m: print(f"loop: {m}", file=sys.stderr), device=device)
    print(_summary_json(summary))
    return 0 if summary["ok"] else 1


def _cmd_unported(name: str):
    def fn(args) -> int:
        raise SystemExit(f"tpunet {name} is not ported to sparknet_tpu_torch yet "
                         f"(ROADMAP {_UNPORTED_COMMANDS[name]})")

    return fn


def _cmd_deprecated(replacement):
    def fn(args) -> int:
        raise SystemExit(f"Deprecated. Use tpunet {replacement} instead.")

    return fn


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpunet", description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default="",
                   help="the JAX CLI's platform pin, onto --device: cpu, gpu or cuda")
    p.add_argument("--obs", default="", metavar="PATH.jsonl",
                   help="arm the obs journal for this run (same as SPARKNET_OBS=PATH; "
                   "off by default)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; exits without a card) or cpu")

    def common(sp):
        device(sp)
        sp.add_argument("--solver", help="solver prototxt path or zoo:<name>")
        sp.add_argument("--data", default="auto",
                        help="auto (default: the net's own data layers when they "
                        "name a source, else synthetic) | proto (stream the net's "
                        "own Data/ImageData/WindowData layers) | cifar:<dir> | "
                        "db:<path>[,<test_path>] | synthetic")
        sp.add_argument("--data-scale", type=float, default=0.0,
                        help="multiply db feeds by this (transform_param.scale "
                        "parity, e.g. 0.00390625 for lenet)")
        sp.add_argument("--batch", type=int, default=0, help="zoo batch override")
        sp.add_argument("--iterations", type=int, default=0)
        sp.add_argument("--snapshot", help=".solverstate.npz to restore")
        sp.add_argument("--dtype", default="", choices=["", "bf16", "bfloat16", "f32"],
                        help="compute dtype (Config.compute_dtype) for this call; "
                        "params stay float32")
        sp.add_argument("--layout", default="", choices=["", "nchw", "nhwc"],
                        help="internal layout of image blobs (Config.layout) "
                        "for this call; params and snapshots do not change")

    sp = sub.add_parser("train", help="train a model")
    common(sp)
    sp.add_argument("--weights", default="",
                    help="finetune: copy params by layer name from a .caffemodel "
                    "(fresh optimizer state)")
    sp.add_argument("--tau", type=int, default=1,
                    help="model-averaging interval: tau local steps a round")
    sp.add_argument("--prefetch", type=int, default=0,
                    help="async device-feed queue depth (0 = off; the reference's "
                    "PREFETCH_COUNT is 3)")
    sp.add_argument("--feed", default="", choices=["", "threaded", "process"],
                    help="host feed: threaded (default) or process (the shared-memory "
                    "ring of data/pipeline.py; synthetic, cifar: and db: record/LMDB "
                    "sources)")
    sp.add_argument("--feed-workers", type=int, default=0,
                    help="process-feed worker count (0 = SPARKNET_FEED_WORKERS or "
                    "min(cpus, 4))")
    sp.add_argument("--augment", choices=["host", "device"], default="host",
                    help="where the data transform runs: host (DataTransformer) or "
                    "device (uint8 on the wire, DeviceAugment on the card; cifar: "
                    "and db: sources, with --prefetch or --feed process)")
    sp.add_argument("--distributed", action="store_true",
                    help="synchronous data parallelism over ParallelTrainer")
    sp.add_argument("--elastic-alpha", type=float, default=0.0,
                    help="EASGD coupling strength (~0.9/num_workers); 0 = hard averaging")
    sp.add_argument("--coordinator", default="",
                    help="multi-process: host:port where rank 0 serves the TCP store")
    sp.add_argument("--num-processes", type=int, default=0,
                    help="multi-process: the process count")
    sp.add_argument("--process-id", type=int, default=0,
                    help="multi-process: this process's rank")
    sp.add_argument("--test-iters", type=int, default=0)
    sp.add_argument("--seed", type=int, default=None,
                    help="override the solver's random_seed; also offsets the host "
                    "augmentation stream")
    sp.add_argument("--scan", type=int, default=1, help="not ported (ROADMAP Queue A5)")
    sp.add_argument("--output", help="snapshot prefix for the final model")
    sp.add_argument("--profile", metavar="DIR",
                    help="capture a torch.profiler trace of the run into DIR")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("test", help="score a model")
    common(sp)
    sp.add_argument("--weights", default="", help="score a .caffemodel")
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("time", help="per-layer timing")
    common(sp)
    sp.add_argument("--fused", action="store_true", help="time the whole Solver step instead")
    sp.add_argument("--hlo", action="store_true", help="not ported (ROADMAP Queue A14)")
    sp.add_argument("--trace", action="store_true",
                    help="profiler-attributed per-layer device time of the whole "
                    "Solver step + FLOPs + MFU")
    sp.add_argument("--trace-out", default=None, metavar="PATH",
                    help="JSON artifact for --trace, flushed after every stage "
                    "(default: ./tpunet_trace.json)")
    sp.set_defaults(fn=cmd_time)

    sp = sub.add_parser("convert_imageset", help="image list -> record DB")
    sp.add_argument("--root", required=True, help="image directory")
    sp.add_argument("--listfile", required=True, help='lines of "relpath label"')
    sp.add_argument("--db", required=True, help="output record DB path")
    sp.add_argument("--resize", type=int, default=256)
    sp.add_argument("--backend", choices=("record", "lmdb", "leveldb"), default="record",
                    help="output format (lmdb/leveldb = Caffe-compatible)")
    sp.set_defaults(fn=cmd_convert_imageset)

    sp = sub.add_parser("convert_db", help="convert between LMDB / LevelDB / native "
                        "record DB (source auto-detected)")
    sp.add_argument("--src", required=True, help="source DB (any format)")
    sp.add_argument("--dst", required=True, help="destination path")
    sp.add_argument("--backend", choices=("record", "lmdb", "leveldb"), default="record",
                    help="destination format")
    sp.set_defaults(fn=cmd_convert_db)

    sp = sub.add_parser("compute_image_mean", help="record DB -> mean .npy")
    sp.add_argument("--db", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--batch", type=int, default=0)
    sp.set_defaults(fn=cmd_compute_image_mean)

    sp = sub.add_parser("extract_features", help="dump an intermediate blob")
    common(sp)
    sp.add_argument("--blob", required=True, help="blob name, e.g. ip1")
    sp.add_argument("--out", required=True, help="output .npy")
    sp.add_argument("--weights", default="", help=".caffemodel to score with")
    sp.set_defaults(fn=cmd_extract_features)

    sp = sub.add_parser("draw", help="net prototxt -> Graphviz DOT")
    sp.add_argument("--net", required=True, help="net prototxt path or zoo:<name>")
    sp.add_argument("--out", required=True, help="output .dot path")
    sp.add_argument("--rankdir", default="LR", choices=["LR", "TB", "BT", "RL"])
    sp.add_argument("--phase", default="", help="filter by TRAIN/TEST")
    sp.add_argument("--batch", type=int, default=0, help="zoo batch override")
    sp.set_defaults(fn=cmd_draw)

    sp = sub.add_parser("classify", help="top-N labels for images (deploy net)")
    device(sp)
    sp.add_argument("--model", required=True, help="deploy prototxt")
    sp.add_argument("--weights", default="", help=".caffemodel")
    sp.add_argument("--mean", default="", help="mean .binaryproto or .npy")
    sp.add_argument("--labels", default="", help="one label per line")
    sp.add_argument("--top", type=int, default=5)
    sp.add_argument("--raw-scale", type=float, default=255.0)
    sp.add_argument("--bgr", action="store_true", help="swap channels RGB->BGR")
    sp.add_argument("--oversample", action="store_true",
                    help="average 10-crop predictions (pycaffe classify.py); pair "
                    "with --images-dim > net input for distinct crops")
    sp.add_argument("--images-dim", default="",
                    help='resize target "H,W" before cropping (pycaffe classify.py '
                    "--images_dim)")
    sp.add_argument("--center-only", action="store_true",
                    help="deprecated: single center pass is now the default")
    sp.add_argument("--int8", action="store_true",
                    help="post-training int8 inference: self-calibrates activation "
                    "scales on the input images, per-channel int8 weights")
    sp.add_argument("--fold-bn", action="store_true",
                    help="fold in-place BatchNorm/Scale chains into their "
                    "convolutions before inference (combine with --int8 to "
                    "quantize BN nets)")
    sp.add_argument("images", nargs="+")
    sp.set_defaults(fn=cmd_classify)

    sp = sub.add_parser("pull_shards", help="stage tar shards into a directory")
    sp.add_argument("--store", required=True, help="directory of .tar shards")
    sp.add_argument("--start", type=int, required=True)
    sp.add_argument("--stop", type=int, required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_pull_shards)

    sp = sub.add_parser("create_labelfile", help="train.txt for staged files")
    sp.add_argument("directory")
    sp.add_argument("trainfile")
    sp.add_argument("outfile")
    sp.set_defaults(fn=cmd_create_labelfile)

    for cmd, fn, help_ in (
        ("upgrade_net_proto_text", cmd_upgrade_net_proto_text,
         "migrate a legacy net prototxt (V0/V1 -> current)"),
        ("upgrade_net_proto_binary", cmd_upgrade_net_proto_binary,
         "migrate a legacy binary NetParameter/caffemodel (V1 -> current)"),
        ("upgrade_solver_proto_text", cmd_upgrade_solver_proto_text,
         "migrate a legacy solver prototxt (solver_type enum -> type)"),
    ):
        sp = sub.add_parser(cmd, help=help_)
        sp.add_argument("input")
        sp.add_argument("output")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("parse_log", help="training log -> .train/.test CSVs")
    sp.add_argument("logfile")
    sp.add_argument("out_dir", nargs="?", default=None,
                    help="output directory (default: next to the log)")
    sp.add_argument("--delimiter", default=",")
    sp.set_defaults(fn=cmd_parse_log)

    sp = sub.add_parser("plot_training_log", help="training log -> chart PNG (types 0-7)")
    sp.add_argument("chart_type", type=int,
                    help="0/1 test acc, 2/3 test loss, 4/5 train lr, 6/7 train loss "
                    "(vs iters/seconds)")
    sp.add_argument("out", help="output .png")
    sp.add_argument("logfile")
    sp.set_defaults(fn=cmd_plot_training_log)

    sp = sub.add_parser("resize_images", help="resize-shorter-side + center-crop a tree")
    sp.add_argument("--input-folder", required=True)
    sp.add_argument("--output-folder", required=True)
    sp.add_argument("--side", type=int, default=256)
    sp.add_argument("--workers", type=int, default=0)
    sp.set_defaults(fn=cmd_resize_images)

    sp = sub.add_parser("device_query", help="show devices")
    device(sp)
    sp.add_argument("--timeout", type=float, default=300.0,
                    help="driver query timeout in seconds (0 = in process)")
    sp.set_defaults(fn=cmd_device_query)

    sp = sub.add_parser("serve", help="serving engine load run")
    device(sp)
    sp.add_argument("--requests", type=int, default=504)
    sp.add_argument("--family", default="cifar10_quick",
                    help="cifar10_quick|lenet|mobilenet|transformer")
    sp.add_argument("--arm", default="f32", choices=["f32", "fold_bn", "int8"])
    sp.add_argument("--buckets", default="1,8,64,256",
                    help="comma-separated bucket ladder (one CUDA graph a bucket)")
    sp.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="deadline bound on any request's queue wait")
    sp.add_argument("--replicas", type=int, default=1,
                    help="K > 1 serves through the replica pod (ReplicaRouter, "
                    "open-loop arrivals)")
    sp.add_argument("--rate", type=float, default=2000.0,
                    help="pod mode: offered open-loop req/s")
    sp.add_argument("--seconds", type=float, default=1.0,
                    help="pod mode: open-loop run length")
    sp.add_argument("--controller", action="store_true",
                    help="pod mode: arm the SLO burn controller (loop/autoctl.py: "
                    "priced join/kill off the live burn stream)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("loop", help="train-to-serve production loop (hot reload)")
    device(sp)
    sp.add_argument("--iterations", type=int, default=1,
                    help="train->checkpoint->rollout cycles")
    sp.add_argument("--rounds", type=int, default=2, help="elastic rounds per rollout")
    sp.add_argument("--family", default="cifar10_quick",
                    help="cifar10_quick|lenet|mobilenet|transformer")
    sp.add_argument("--arm", default="f32", choices=["f32", "fold_bn", "int8"])
    sp.add_argument("--buckets", default="1,8", help="comma-separated bucket ladder")
    sp.add_argument("--batch", type=int, default=2, help="per-worker batch")
    sp.add_argument("--width", type=int, default=0,
                    help="elastic worker-pool width (default: the pool, a world of one)")
    sp.add_argument("--tau", type=int, default=2, help="local steps per elastic round")
    sp.add_argument("--requests", type=int, default=48,
                    help="in-flight traffic across the cycle")
    sp.add_argument("--max-wait-ms", type=float, default=5.0)
    sp.add_argument("--workdir", default="", help="checkpoint dir (default: a temp dir)")
    sp.add_argument("--controller", action="store_true",
                    help="arm the SLO burn controller (loop/autoctl.py: lend/restore "
                    "training width, canary rollback)")
    sp.set_defaults(fn=cmd_loop)

    # these take any arguments: they exit naming their item (or replacement)
    for name in _UNPORTED_COMMANDS:
        sub.add_parser(name, help=f"not ported (ROADMAP {_UNPORTED_COMMANDS[name]})"
                       ).set_defaults(fn=_cmd_unported(name))
    for cmd, repl in (
        ("train_net", "train --solver=... [--snapshot=...]"),
        ("finetune_net", "train --solver=... [--weights=...]"),
        ("test_net", "test --solver=... [--snapshot=...]"),
        ("net_speed_benchmark", "time --solver=... [--iterations=50]"),
    ):
        sub.add_parser(cmd, help=f"deprecated: use tpunet {repl.split()[0]}"
                       ).set_defaults(fn=_cmd_deprecated(repl))

    args, extra = p.parse_known_args(argv)
    if extra and args.cmd not in _UNPORTED_COMMANDS and not args.cmd.endswith(
            ("_net", "_benchmark")):
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    _refuse_unported(args)
    _apply_platform(args)
    if args.obs:
        # the environment is the one arming point the Recorder (and any
        # child process, e.g. a process feed) reads; a recorder already
        # built from it is rebuilt
        from sparknet_tpu_torch.obs.recorder import rebuild_from_env

        os.environ["SPARKNET_OBS"] = args.obs
        rebuild_from_env()
    overrides = {}
    if getattr(args, "dtype", ""):
        overrides["compute_dtype"] = "bf16" if args.dtype in ("bf16", "bfloat16") else "f32"
    if getattr(args, "layout", ""):
        overrides["layout"] = args.layout
    if not overrides:
        return args.fn(args)
    # the compute dtype and the layout are set before any net is built and
    # RESTORED after: an in-process main() (tests, interactive use) must not
    # leak them into the caller's config
    from sparknet_tpu_torch.common import get_config, set_config

    prev = {k: getattr(get_config(), k) for k in overrides}
    set_config(**overrides)
    try:
        return args.fn(args)
    finally:
        set_config(**prev)


if __name__ == "__main__":
    sys.exit(main())
