"""``tpunet`` on the port: ``python -m sparknet_tpu_torch.cli <command>``.

Counterpart of ``sparknet_tpu/cli.py``, the equivalent of the ``caffe``
brew tool (ref: caffe/tools/caffe.cpp:153-380), for the subset ``train``,
``test``, ``time`` (per layer, or ``--fused`` over the whole ``Solver``
step), ``extract_features``, ``convert_db``, ``compute_image_mean`` and
``device_query``.  Flags, messages and JSON outputs are the JAX CLI's;
``--device`` (default ``cuda``) names where nets run, and a run without a
card exits unless ``--device cpu`` is given.  Model and solver configs are
prototxt paths or zoo names (``zoo:caffenet``).

Data sources, in one process: ``--data synthetic`` (pixel-scale random
batches), ``--data cifar:<dir>`` (CIFAR-10 binaries) and ``--data
db:<path>[,<test_path>]`` (a RecordDB, LMDB or LevelDB; ``{proc}`` expands
to 0; each phase's ``Data`` layer's transform_param crops, mirrors, scales
and subtracts its mean_file on the host).

Every other subcommand, and every flag of the JAX CLI that the port does
not carry, exits with a message naming its ROADMAP item; none is ignored.
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
    "convert_imageset": "Queue A9 (listfile.py and convert_imageset)",
    "draw": "Queue A9 (utils/draw.py)",
    "classify": "Queue A9 (the CLI's remaining subcommands: classify)",
    "pull_shards": "Queue A9 (remote.py and worker_store.py)",
    "create_labelfile": "Queue A9 (the CLI's remaining subcommands: create_labelfile)",
    "upgrade_net_proto_text": "Queue A9 (the CLI's remaining subcommands: the upgrade tools)",
    "upgrade_net_proto_binary": "Queue A9 (the CLI's remaining subcommands: the upgrade tools)",
    "upgrade_solver_proto_text": "Queue A9 (the CLI's remaining subcommands: the upgrade tools)",
    "parse_log": "Queue A9 (utils/log_parse.py)",
    "plot_training_log": "Queue A9 (utils/plotting.py)",
    "resize_images": "Queue A9 (resize_images.py)",
    "bench": "Queue A6 (the single-GPU bench)",
    "serve": "Queue A7 (the engine's CLI)",
    "loop": "Queue A13 (the production loop)",
    "pods": "Queue A9 (pods.py provisions TPU VMs; it has no one-card counterpart)",
}

# Flags of the ported subcommands that the port does not carry: (dest,
# value that means "not asked for", ROADMAP item).
_UNPORTED_FLAGS = (
    ("tau", 1, "Queue A9 (the CLI's train --tau/--distributed/--elastic-alpha)"),
    ("distributed", False, "Queue A9 (the CLI's train --tau/--distributed/--elastic-alpha)"),
    ("elastic_alpha", 0.0, "Queue A9 (the CLI's train --tau/--distributed/--elastic-alpha)"),
    ("coordinator", "", "Queue A9 (the CLI's multi-host flags)"),
    ("num_processes", 0, "Queue A9 (the CLI's multi-host flags)"),
    ("process_id", 0, "Queue A9 (the CLI's multi-host flags)"),
    ("prefetch", 0, "Queue A9 (the CLI's feed flags)"),
    ("feed", "", "Queue A9 (the CLI's feed flags)"),
    ("feed_workers", 0, "Queue A9 (the CLI's feed flags)"),
    ("augment", "host", "Queue A9 (the CLI's feed flags)"),
    ("scan", 1, "Queue A5 (a CUDA graph of the step loop)"),
    ("profile", None, "Queue A13 (utils/op_profile.py over torch.profiler)"),
    ("hlo", False, "Queue A14 (XLA cost analysis has no counterpart yet)"),
    ("trace", False, "Queue A13 (utils/op_profile.py over torch.profiler)"),
    ("trace_out", None, "Queue A13 (utils/op_profile.py over torch.profiler)"),
    ("platform", "", "Queue A9 (the CLI's remaining flags; the port takes --device)"),
    ("obs", "", "Queue A13 (obs)"),
)
_LAYOUT_ITEM = "Queue A6 (channels_last)"
_PROTO_DATA_ITEM = ("Queue A9 (listfile.py with the ImageData/WindowData layers, "
                    "and HDF5)")


def _refuse_unported(args) -> None:
    for dest, default, item in _UNPORTED_FLAGS:
        if getattr(args, dest, default) != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{flag} is not ported to sparknet_tpu_torch yet "
                             f"(ROADMAP {item})")
    if getattr(args, "layout", "") == "nhwc":
        raise SystemExit(f"--layout nhwc is not ported yet (ROADMAP {_LAYOUT_ITEM})")


def _device(args):
    from sparknet_tpu_torch.common import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--device {args.device}: {e}") from None


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


def _db_path(args, i: int = 0) -> str:
    paths = args.data[3:].split(",")
    return (paths[i] if i < len(paths) else paths[0]).replace("{proc}", "0")


def _db_peek_shapes(args, net) -> dict:
    """Shapes of ``Data``-layer tops peeked from ``--data db:``'s DB (Caffe:
    the geometry comes from the DB, data_layer.cpp:40-48)."""
    if not (getattr(args, "data", "") or "").startswith("db:"):
        return {}
    known = net.feed_shapes()
    missing = [l for l in net.input_layers
               if l.TYPE == "Data" and any(t not in known for t in l.tops)]
    if not missing:
        return {}
    from sparknet_tpu_torch.data.createdb import peek_db_shape

    path = _db_path(args)
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
    try:
        yield
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


def _data_source(args, net) -> str:
    """``auto`` is synthetic for nets fed by the host (RDD/Input layers);
    a net whose own data layers name sources would stream them (the JAX
    CLI's ``proto``), which the port does not carry."""
    if args.data == "auto":
        if any(l.TYPE in ("Data", "ImageData", "WindowData", "HDF5Data")
               for l in net.input_layers):
            raise SystemExit(
                "--data auto: the net's data layers declare their own sources, "
                f"which the port does not stream yet (ROADMAP {_PROTO_DATA_ITEM}); "
                "pass --data db:<path> / cifar:<dir>, or --data synthetic")
        return "synthetic"
    if args.data == "proto":
        raise SystemExit(f"--data proto is not ported yet (ROADMAP {_PROTO_DATA_ITEM})")
    return args.data


def _data_fns(args, net, test_net=None):
    """(train_fn, test_fn) from ``--data``, in one process (the JAX
    CLI's process 0 of 1).  ``test_net``: a distinct TEST-phase net whose
    own Data layer's transform_param drives the test stream."""
    args.data = _data_source(args, net)
    shapes = _feed_shapes(net, args)
    data_shape = shapes["data"]
    batch = data_shape[0]

    if args.data.startswith("cifar:"):
        from sparknet_tpu_torch.data import CifarLoader, DataTransformer, TransformConfig

        loader = CifarLoader(args.data[6:])
        xform = DataTransformer(TransformConfig(mean_image=loader.mean_image))
        xtr, ytr = loader.train_images, loader.train_labels
        xte, yte = loader.test_images, loader.test_labels
        if batch > len(ytr) or batch > len(yte):
            raise SystemExit(
                f"--batch {batch} exceeds dataset size {min(len(ytr), len(yte))}")

        def train_fn(it):
            lo = (it * batch) % (len(ytr) - batch + 1)
            return {"data": xform(xtr[lo:lo + batch], True),
                    "label": ytr[lo:lo + batch].astype(np.int32)}

        def test_fn(b):
            lo = (b * batch) % (len(yte) - batch + 1)
            return {"data": xform(xte[lo:lo + batch], False),
                    "label": yte[lo:lo + batch].astype(np.int32)}

        return train_fn, test_fn

    if args.data.startswith("db:"):
        return _db_fns(args, net, test_net, data_shape, batch)

    if args.data == "synthetic":
        rs = np.random.RandomState(0)
        num_classes = 10

        def synth_train(it):
            return {"data": (rs.randn(*data_shape) * 50).astype(np.float32),
                    "label": rs.randint(0, num_classes, batch).astype(np.int32)}

        def synth_test(b):
            rs2 = np.random.RandomState(100_000 + b)
            return {"data": (rs2.randn(*data_shape) * 50).astype(np.float32),
                    "label": rs2.randint(0, num_classes, batch).astype(np.int32)}

        return synth_train, synth_test

    raise SystemExit(f"unknown --data source {args.data!r}")


def _db_fns(args, net, test_net, data_shape, batch):
    """The CifarDBApp/ImageNetRunDBApp flow: lazy ``db_minibatches``
    cursors, each phase's Data layer's transform_param on the host (ref:
    data_transformer.cpp: mean -> crop [random in TRAIN, center in TEST]
    -> mirror -> scale); ``--data-scale`` overrides the scale."""
    from sparknet_tpu_torch.data import DataTransformer, TransformConfig
    from sparknet_tpu_torch.data.createdb import db_minibatches
    from sparknet_tpu_torch.data.transform import load_mean_file, resolve_mean_file

    train_path, test_path = _db_path(args), _db_path(args, 1)
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

    trainp = tp_params(phase_tp(net))
    test_has_data = test_net is not None and any(
        l.TYPE == "Data" for l in test_net.input_layers)
    testp = tp_params(phase_tp(test_net)) if test_has_data else trainp

    def db_stream(path, train=True):
        """A lazy cursor: nothing opens before the first call."""
        state: dict = {}
        p = trainp if train else testp
        xform = None
        if p["crop"] or p["mirror"] or p["mean_img"] is not None or p["mean_vals"]:
            try:
                xform = DataTransformer(TransformConfig(
                    scale=p["scale"], mirror=p["mirror"], crop_size=p["crop"],
                    mean_value=p["mean_vals"], mean_image=p["mean_img"],
                    seed=1234 + (getattr(args, "seed", 0) or 0)))
            except ValueError as e:
                raise SystemExit(f"transform_param: {e}") from None

        def fn(_):
            if "iter" not in state:
                try:
                    state["iter"] = db_minibatches(path, batch, loop=True)
                    b = next(state["iter"])
                except (OSError, ValueError) as e:
                    raise SystemExit(f"--data db: {path}: {e}") from None
            else:
                b = next(state["iter"])
            if xform is not None:
                try:
                    b = dict(b, data=xform(b["data"], train))
                except ValueError as e:
                    raise SystemExit(f"--data db: {path}: {e}") from None
            elif p["scale"] != 1.0:
                b = dict(b, data=b["data"] * p["scale"])
            if "checked" not in state:
                state["checked"] = True
                got = tuple(b["data"].shape[1:])
                want = tuple(data_shape[1:])
                if not train and test_net is not None:
                    with contextlib.suppress(KeyError, SystemExit):
                        want = tuple(_feed_shapes(test_net, args)["data"][1:])
                if got != want:
                    raise SystemExit(f"{path}: db images {got} do not match the "
                                     f"net's data blob {want}")
            return b

        return fn

    return db_stream(train_path), db_stream(test_path, train=False)


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
def cmd_train(args) -> int:
    """ref: caffe.cpp:153-218 train()."""
    import tempfile

    from sparknet_tpu_torch.utils import EventLogger, SignalHandler, SolverAction

    if args.snapshot and args.weights:
        raise SystemExit("--snapshot and --weights are mutually exclusive")
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
    train_fn, test_fn = _data_fns(args, solver.train_net, test_net=solver.test_net)
    iters = args.iterations or solver_cfg.max_iter
    display = solver_cfg.display
    with SignalHandler() as sig:
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
    if args.test_iters:
        scores = solver.test(args.test_iters, test_fn)
        log(f"scores: {scores}", i=solver.iter)
    out = solver.save(args.output or "tpunet_final")
    log(f"saved {out}")
    return 0


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
    _, test_fn = _data_fns(args, solver.test_net)
    scores = solver.test(args.iterations or 10, test_fn)
    print(json.dumps(scores))
    return 0


def cmd_time(args) -> int:
    """Per-layer forward/backward table (ref: caffe.cpp:290-380), or with
    ``--fused`` the whole ``Solver`` step on one fixed batch."""
    import torch

    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.utils.timing import Timer, time_layers

    net_param, solver_cfg = _build_net_and_solver(args)
    iters = args.iterations or 10
    if args.fused:
        solver = _make_solver(solver_cfg, net_param, args)
        train_fn, _ = _data_fns(args, solver.train_net)
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
    train_fn, _ = _data_fns(args, net)
    rows = time_layers(net, variables, train_fn(0), iterations=iters)
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
    _, test_fn = _data_fns(args, net.test_net)
    app = FeaturizerApp(net, feature_blob=args.blob)
    out = np.concatenate(list(app.featurize(test_fn(b) for b in range(args.iterations or 10))))
    np.save(args.out, out)
    print(json.dumps({"out": args.out, "shape": list(out.shape)}))
    return 0


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
    p.add_argument("--platform", default="", help="the JAX CLI's platform pin; the "
                   "port takes --device (refused)")
    p.add_argument("--obs", default="", metavar="PATH.jsonl",
                   help="the obs journal (not ported: ROADMAP Queue A13)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; exits without a card) or cpu")

    def common(sp):
        device(sp)
        sp.add_argument("--solver", help="solver prototxt path or zoo:<name>")
        sp.add_argument("--data", default="auto",
                        help="auto (synthetic for host-fed nets) | cifar:<dir> | "
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
                        help="nchw only (nhwc: ROADMAP Queue A6)")

    sp = sub.add_parser("train", help="train a model")
    common(sp)
    sp.add_argument("--weights", default="",
                    help="finetune: copy params by layer name from a .caffemodel "
                    "(fresh optimizer state)")
    sp.add_argument("--tau", type=int, default=1, help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--prefetch", type=int, default=0, help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--feed", default="", choices=["", "threaded", "process"],
                    help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--feed-workers", type=int, default=0, help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--augment", choices=["host", "device"], default="host",
                    help="host only (device: ROADMAP Queue A9)")
    sp.add_argument("--distributed", action="store_true", help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--elastic-alpha", type=float, default=0.0,
                    help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--coordinator", default="", help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--num-processes", type=int, default=0, help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--process-id", type=int, default=0, help="not ported (ROADMAP Queue A9)")
    sp.add_argument("--test-iters", type=int, default=0)
    sp.add_argument("--seed", type=int, default=None,
                    help="override the solver's random_seed; also offsets the host "
                    "augmentation stream")
    sp.add_argument("--scan", type=int, default=1, help="not ported (ROADMAP Queue A5)")
    sp.add_argument("--output", help="snapshot prefix for the final model")
    sp.add_argument("--profile", help="not ported (ROADMAP Queue A13)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("test", help="score a model")
    common(sp)
    sp.add_argument("--weights", default="", help="score a .caffemodel")
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("time", help="per-layer timing")
    common(sp)
    sp.add_argument("--fused", action="store_true", help="time the whole Solver step instead")
    sp.add_argument("--hlo", action="store_true", help="not ported (ROADMAP Queue A14)")
    sp.add_argument("--trace", action="store_true", help="not ported (ROADMAP Queue A13)")
    sp.add_argument("--trace-out", default=None, metavar="PATH",
                    help="not ported (ROADMAP Queue A13)")
    sp.set_defaults(fn=cmd_time)

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

    sp = sub.add_parser("device_query", help="show devices")
    device(sp)
    sp.add_argument("--timeout", type=float, default=300.0,
                    help="driver query timeout in seconds (0 = in process)")
    sp.set_defaults(fn=cmd_device_query)

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
    if not getattr(args, "dtype", ""):
        return args.fn(args)
    # the compute dtype is set before any net is built and RESTORED after:
    # an in-process main() (tests, interactive use) must not leak bf16 into
    # the caller's config
    from sparknet_tpu_torch.common import get_config, set_config

    prev = get_config().compute_dtype
    set_config(compute_dtype="bf16" if args.dtype in ("bf16", "bfloat16") else "f32")
    try:
        return args.fn(args)
    finally:
        set_config(compute_dtype=prev)


if __name__ == "__main__":
    sys.exit(main())
