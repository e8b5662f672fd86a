"""Solver: the training loop around the net.

Counterpart of ``sparknet_tpu/solvers/solver.py`` (ref:
caffe/src/caffe/solver.cpp: Step :193-282, TestAndStoreResult :414-444,
Snapshot/Restore :447-519).  One iteration is: the forward of the TRAIN
net, the backward by ``torch.autograd``, iter_size gradient accumulation,
the lr policy, clipping, regularization and the rule, in Caffe's order.
PyTorch runs it eagerly; the Python loop feeds data and keeps the loss on
the device until a display or callback needs it.

Two update paths, chosen by ``Config.fused_update`` when the Solver is
built:

* per blob (default): ``solvers/updates.apply_update``, plain PyTorch;
* fused: the params and history live in flat arenas
  (``solvers/arena.py``), the kernel reads each blob's grad where
  autograd left it (or one packed grad arena, on the steps that
  accumulate, clip or reduce), and the whole update is one launch of the
  fused kernel, in place.

Forward and backward run in full float32 (``common.f32_precision``: TF32
off for cuDNN and cuBLAS), because the JAX reference is float32; under
``Config.compute_dtype = bfloat16`` the forward runs in bf16 with float32
sums and the masters stay in ``Config.param_dtype`` (``Network.apply``).

``remat`` (``SolverConfig.remat``, the prototxt bool, meaning ``"full"``,
or ``Config.remat``) recomputes the forward in the backward
(:func:`apply_remat`).  ``debug_info`` prints Caffe's per-layer lines each
iteration and keeps the per-blob update path, as the JAX Solver does.

Not ported yet (ROADMAP): ``jitted_scan_steps``/``scan_chunk`` (a CUDA
graph is the tool for that), orbax snapshots, the ``.caffemodel``/HDF5
model file beside the state, ``solve``, and
``batch_override``/``feed_dtypes``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from sparknet_tpu_torch.common import (
    Phase,
    f32_precision,
    get_config,
    host_array,
    tensor_from_numpy,
)
from sparknet_tpu_torch.compiler.graph import Network, NetVars
from sparknet_tpu_torch.obs import lineage as obs_lineage
from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.proto.text_format import Message, parse_file
from sparknet_tpu_torch.solvers.lr_policy import learning_rate
from sparknet_tpu_torch.solvers.updates import apply_update, init_slots

# enum (2015) and string (modern) solver types both accepted
_TYPE_ALIASES = {
    "SGD": "SGD",
    "NESTEROV": "Nesterov",
    "ADAGRAD": "AdaGrad",
    "RMSPROP": "RMSProp",
    "ADADELTA": "AdaDelta",
    "ADAM": "Adam",
    "Nesterov": "Nesterov",
    "AdaGrad": "AdaGrad",
    "RMSProp": "RMSProp",
    "AdaDelta": "AdaDelta",
    "Adam": "Adam",
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Typed view of SolverParameter (ref: caffe.proto:102-308)."""

    base_lr: float = 0.01
    lr_policy: str = "fixed"
    gamma: float = 0.1
    power: float = 0.75
    stepsize: int = 100000
    stepvalue: tuple = ()
    max_iter: int = 100000
    momentum: float = 0.0
    momentum2: float = 0.999
    rms_decay: float = 0.99
    delta: float = 1e-8
    weight_decay: float = 0.0
    regularization_type: str = "L2"
    clip_gradients: float = -1.0
    iter_size: int = 1
    solver_type: str = "SGD"
    # rematerialize the forward under the backward (torch.utils.checkpoint):
    # trades FLOPs for memory; True means the "full" policy (remat_policy)
    remat: bool = False
    random_seed: int = -1
    test_iter: tuple = ()
    # one stage-tuple per test net (ref: SolverParameter.test_state +
    # Solver::InitTestNets solver.cpp:135-190); () = one default test net
    test_states: tuple = ()
    test_levels: tuple = ()
    test_interval: int = 0
    display: int = 0
    average_loss: int = 1
    snapshot: int = 0
    snapshot_prefix: str = ""
    snapshot_after_train: bool = True
    # BINARYPROTO/HDF5 name the model file beside the state in the JAX
    # package; the port writes the state npz only (see Solver.save)
    snapshot_format: str = "BINARYPROTO"
    # per-iteration per-layer forward/param/grad abs-mean diagnostics (ref:
    # SolverParameter.debug_info + Net::ForwardDebugInfo / BackwardDebugInfo,
    # net.cpp:658-735), printed each iteration
    debug_info: bool = False

    @classmethod
    def from_proto(cls, m: Message) -> "SolverConfig":
        stype = m.get_str("type", m.get_str("solver_type", "SGD"))
        if stype not in _TYPE_ALIASES:
            raise ValueError(
                f"unknown solver type {stype!r}; expected one of "
                f"{sorted(set(_TYPE_ALIASES.values()))} "
                "(ref: SolverRegistry::CreateSolver fails on unknown types)"
            )
        return cls(
            base_lr=m.get_float("base_lr", 0.01),
            lr_policy=m.get_str("lr_policy", "fixed"),
            gamma=m.get_float("gamma", 0.1),
            power=m.get_float("power", 0.75),
            stepsize=m.get_int("stepsize", 100000),
            stepvalue=tuple(int(v) for v in m.get_all("stepvalue")),
            max_iter=m.get_int("max_iter", 100000),
            momentum=m.get_float("momentum", 0.0),
            momentum2=m.get_float("momentum2", 0.999),
            rms_decay=m.get_float("rms_decay", 0.99),
            delta=m.get_float("delta", 1e-8),
            weight_decay=m.get_float("weight_decay", 0.0),
            regularization_type=m.get_str("regularization_type", "L2"),
            clip_gradients=m.get_float("clip_gradients", -1.0),
            iter_size=m.get_int("iter_size", 1),
            solver_type=_TYPE_ALIASES[stype],
            random_seed=m.get_int("random_seed", -1),
            test_iter=tuple(int(v) for v in m.get_all("test_iter")),
            test_states=tuple(
                tuple(str(s) for s in ts.get_all("stage"))
                for ts in m.get_all("test_state")
            ),
            test_levels=tuple(
                ts.get_int("level", 0) for ts in m.get_all("test_state")
            ),
            test_interval=m.get_int("test_interval", 0),
            display=m.get_int("display", 0),
            average_loss=m.get_int("average_loss", 1),
            snapshot=m.get_int("snapshot", 0),
            snapshot_prefix=m.get_str("snapshot_prefix", ""),
            snapshot_after_train=m.get_bool("snapshot_after_train", True),
            snapshot_format=m.get_str("snapshot_format", "BINARYPROTO"),
            debug_info=m.get_bool("debug_info", False),
        )


def load_solver_net(solver_msg: Message, root: str = "") -> Message:
    """Resolve the net referenced by a solver prototxt
    (ref: Solver::InitTrainNet's net/net_param/train_net/train_net_param
    precedence, solver.cpp:66-108)."""
    for field in ("net_param", "train_net_param"):
        if solver_msg.has(field):
            return solver_msg.get_msg(field)
    for field in ("net", "train_net"):
        if solver_msg.has(field):
            path = solver_msg.get_str(field)
            if root and not os.path.isabs(path):
                path = os.path.join(root, path)
            return parse_file(path)
    raise ValueError("solver prototxt declares no net")


DataFn = Callable[[int], dict[str, Any]]  # iteration -> feed dict


def _micro_batches(feeds: dict, iter_size: int) -> list[dict]:
    """iter_size > 1: the feed arrays carry a leading [iter_size] axis."""
    if iter_size == 1:
        return [feeds]
    return [{k: v[m] for k, v in feeds.items()} for m in range(iter_size)]


def remat_policy(cfg: SolverConfig) -> str:
    """The rematerialization policy of a train step: ``"full"`` when the
    prototxt's ``remat`` bool is set, else ``Config.remat`` (``""`` is
    off)."""
    if cfg.remat:
        return "full"
    return get_config().remat


def apply_remat(net: Network, policy: str):
    """The forward of a train step under ``policy``: ``forward(variables,
    feeds, gen, debug_sink) -> (blobs, state, loss)``, ``Network.apply``
    with ``remat=policy`` (``""``, ``"full"``, ``"dots"`` or ``"blocks"``:
    ``torch.utils.checkpoint`` over the layers, which draws the forward's
    masks again in the recompute) and ``keep_blobs=False`` (each blob
    dropped after its last reader)."""
    if policy not in ("", "none", "full", "dots", "blocks"):
        raise ValueError(f"unknown remat policy {policy!r} "
                         "(want '', 'full', 'dots', or 'blocks')")
    policy = "" if policy == "none" else policy

    def forward(variables, feeds, gen, debug_sink=None):
        return net.apply(variables, feeds, gen=gen, debug_sink=debug_sink, remat=policy,
                         keep_blobs=False)

    return forward


def build_train_step(cfg: SolverConfig, net: Network, specs, reduce_grads=None,
                     debug: bool = False):
    """The per-blob train step: ``step(variables, slots, it, feeds, gen) ->
    (variables, slots, loss)`` with new params and history (nothing is
    updated in place).  iter_size > 1 accumulates the grads of the
    micro-batches in the param dtype (ref: solver.cpp:221-224).

    ``reduce_grads(grads) -> grads``, when given, takes the list of
    accumulated grads (one a param blob, in params-dict order) between the
    backward and the update: synchronous data parallelism averages them
    over the workers there (``parallel/trainer.py``).

    ``debug``: the step returns a fourth value, the ``debug_info`` stats
    (``{"forward": {(layer, top): mean |top|}, "param": {...}, "diff":
    {...}}``; of the last micro-batch's forward), as the JAX step does."""
    forward = apply_remat(net, remat_policy(cfg))

    def train_step(variables: NetVars, slots, it: int, feeds: dict, gen):
        with f32_precision():
            leaves = {ln: [p.detach().requires_grad_(True) for p in pl]
                      for ln, pl in variables.params.items()}
            flat = [p for pl in leaves.values() for p in pl]
            state = variables.state
            gsum = None
            loss_sum = None
            sink: dict | None = None
            for micro in _micro_batches(feeds, cfg.iter_size):
                sink = {} if debug else None
                _, state, loss = forward(NetVars(leaves, state), micro, gen, sink)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(flat, grads)]
                gsum = grads if gsum is None else [a + b for a, b in zip(gsum, grads)]
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            if cfg.iter_size > 1:
                loss = loss_sum / cfg.iter_size
            if reduce_grads is not None:
                gsum = reduce_grads(gsum)
            it_grads, k = {}, 0
            for ln, pl in leaves.items():
                it_grads[ln] = gsum[k:k + len(pl)]
                k += len(pl)
            rate = learning_rate(cfg, it).to(net.device)
            with torch.no_grad():
                new_params, new_slots = apply_update(
                    cfg, variables.params, it_grads, slots, specs, rate, it)
        state = {ln: {k2: v.detach() for k2, v in s.items()} for ln, s in state.items()}
        out = NetVars(params=new_params, state=state), new_slots, loss
        if not debug:
            return out
        stats = {
            "forward": sink,
            "param": {f"{ln}[{i}]": p.detach().abs().mean()
                      for ln, pl in variables.params.items()
                      for i, p in enumerate(pl) if p.numel()},
            "diff": {f"{ln}[{i}]": g.abs().mean()
                     for ln, gl in it_grads.items()
                     for i, g in enumerate(gl) if g.numel()},
        }
        return (*out, stats)

    return train_step


def build_fused_step(cfg: SolverConfig, net: Network, layout, tables,
                     reduce_grads=None):
    """The fused train step: ``step(param_arena, slot_arenas, state, it,
    feeds, gen) -> (state, loss)``, updating ``param_arena`` and
    ``slot_arenas`` IN PLACE with one launch of the fused kernel.

    The gradients reach the kernel where autograd left them: the loss is
    differentiated w.r.t. the blobs ``arena.unpack`` returns, and the
    kernel reads them through ``tables.segments``, with no grad arena and
    no copies.  Three steps take the packed grad arena instead (the loss
    differentiated w.r.t. the param arena, whose ``unpack`` backward packs
    the grads in the arena's type with zero pad zones): iter_size > 1,
    which accumulates in float32 whatever the storage type (ref:
    ``sparknet_tpu/solvers/solver.py:313-329``); ``clip_gradients``, whose
    global norm is taken over the arena; and ``reduce_grads(grad_arena) ->
    grad_arena``, when given, which takes the grad arena between the
    backward and the update (as in :func:`build_train_step`).  The two
    forms give the same update bit for bit (``reduce_grads=lambda g: g``
    takes the packed one)."""
    from sparknet_tpu_torch.solvers import arena as arena_mod

    forward = apply_remat(net, remat_policy(cfg))
    segmented = cfg.iter_size == 1 and cfg.clip_gradients <= 0 and reduce_grads is None

    def fused_step(param_arena, slot_arenas, state, it: int, feeds: dict, gen):
        with f32_precision():
            leaf = param_arena.detach().requires_grad_(True)
            gsum = None
            loss_sum = None
            for micro in _micro_batches(feeds, cfg.iter_size):
                params = arena_mod.unpack(layout, leaf)
                _, state, loss = forward(NetVars(params, state), micro, gen)
                if segmented:
                    gsum = torch.autograd.grad(
                        loss, arena_mod.segment_blobs(layout, params), allow_unused=True)
                else:
                    (g,) = torch.autograd.grad(loss, leaf)
                    if cfg.iter_size > 1:
                        gsum = g.float() if gsum is None else gsum + g.float()
                    else:
                        gsum = g
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            if cfg.iter_size > 1:
                loss = loss_sum / cfg.iter_size
                gsum = gsum.to(param_arena.dtype)
            if reduce_grads is not None:
                gsum = reduce_grads(gsum)
            rate = learning_rate(cfg, it).to(param_arena.device)
            with torch.no_grad():
                arena_mod.arena_apply_update(cfg, layout, param_arena, gsum,
                                             slot_arenas, rate, it, tables)
                if layout.mixed:
                    for a in (param_arena, *slot_arenas):
                        arena_mod.round_to_blobs(layout, a)
        state = {ln: {k: v.detach() for k, v in s.items()} for ln, s in state.items()}
        return state, loss

    return fused_step


def dropout_seed(seed: int, it: int, worker: int = 0) -> int:
    """The seed of the dropout generator at iteration ``it``: a function of
    (seed, it), so a restored run draws the masks an uninterrupted one
    would; worker ``worker`` of a distributed trainer adds ``worker << 48``
    so that the workers draw different masks (worker 0 draws a lone
    Solver's)."""
    return seed * 1_000_003 + it + (worker << 48)


def _write_npz_atomic(path: str, arrays: dict) -> None:
    """Write the archive to a temp file in the same directory, then
    ``os.replace``: a reader of the final name gets a whole archive or
    nothing.  ``np.savez`` appends ".npz" to suffix-less string paths, so
    the write goes through an open file to keep the name literal."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _feed_images(feeds: dict, iter_size: int) -> int:
    """Images per solver iteration in one feed dict (iter_size > 1 feeds
    carry a leading [iter_size] micro-batch axis)."""
    for v in feeds.values():
        shp = np.shape(v)
        if shp:
            if iter_size > 1 and len(shp) > 1:
                return int(shp[0]) * int(shp[1])
            return int(shp[0])
    return 0


def _value(loss) -> float:
    """A loss's value on the host: ``.item()`` of the step's own output
    tensor (the obs fence), or the number itself."""
    return float(loss.item() if isinstance(loss, torch.Tensor) else loss)


def _numpy(t: torch.Tensor) -> np.ndarray:
    # bf16 blobs are written as float32 (exact); restore casts back
    return host_array(t)


def _like(value, current: torch.Tensor | None) -> torch.Tensor:
    """A snapshot array as a tensor in the dtype of the blob it replaces
    (a bf16 blob is saved as float32)."""
    t = tensor_from_numpy(value)
    return t if current is None else t.to(current.dtype)


class Solver:
    """Drives training and evaluation of a prototxt-defined net.

    ``data_fn(it)`` gives the train feed dict for iteration ``it`` (with
    iter_size > 1 its arrays carry a leading [iter_size] axis, ref:
    solver.cpp:221-224).  ``device=None`` means CUDA and raises without a
    card; pass ``device="cpu"`` to train on the CPU.  Weights are drawn
    from ``random_seed`` (or ``Config.seed`` when it is negative); so is
    the dropout generator, reseeded at every iteration from (seed, iter),
    so a restored run draws the masks an uninterrupted one would.

    ``variables`` and ``slots`` are blob-wise in both update paths (views
    of the arenas on the fused path, or casts of them with bf16 storage).
    ``layout`` is the fused path's ``ArenaLayout`` (None per blob).
    ``worker`` is this replica's index in a distributed trainer (0 alone);
    it offsets the dropout seed (:func:`dropout_seed`).
    """

    def __init__(
        self,
        solver: Message | SolverConfig,
        net_param: Message,
        feed_shapes: dict[str, tuple] | None = None,
        device: str | torch.device | None = None,
    ):
        self.config = (
            solver if isinstance(solver, SolverConfig) else SolverConfig.from_proto(solver)
        )
        cfg = self.config
        if cfg.snapshot_format.upper() not in ("", "BINARYPROTO", "HDF5"):
            raise ValueError(f"unknown snapshot_format {cfg.snapshot_format!r} "
                             "(BINARYPROTO|HDF5|'')")
        self.net_param = net_param
        self.train_net = Network(net_param, Phase.TRAIN, device)
        self.device = self.train_net.device
        states = cfg.test_states or ((),)
        levels = cfg.test_levels or (0,) * len(states)
        self.test_nets = [
            Network(net_param, Phase.TEST, self.device, stages=set(st), level=lv)
            for st, lv in zip(states, levels)
        ]
        self.test_net = self.test_nets[0]
        if cfg.test_iter and len(cfg.test_iter) != len(self.test_nets):
            raise ValueError(
                f"test_iter specifies {len(cfg.test_iter)} counts "
                f"but there are {len(self.test_nets)} test nets "
                "(one test_iter per test net, ref: solver.cpp:113-118)"
            )
        self._seed = cfg.random_seed if cfg.random_seed >= 0 else get_config().seed
        variables = self.train_net.init(torch.Generator().manual_seed(self._seed),
                                        feed_shapes)
        self._specs = self.train_net.param_specs_for(variables)
        self._gen = torch.Generator(device=self.device)
        self.worker = 0
        self.iter = 0
        self.smoothed_loss = 0.0
        self._loss_window: list = []
        self._state = variables.state
        # debug_info keeps the per-blob path: its per-blob grad lines are
        # what the arena erases (the JAX Solver's rule)
        self.layout = None
        if get_config().fused_update and not cfg.debug_info:
            from sparknet_tpu_torch.solvers import arena as arena_mod

            self.layout = arena_mod.build_layout(variables.params, self._specs, cfg)
            self._tables = arena_mod.ArenaTables(self.layout, self.device)
            self._param_arena = arena_mod.pack(self.layout, variables.params, self.device)
            self._slot_arenas = arena_mod.init_slot_arenas(self.layout, self.device)
        else:
            self._params = variables.params
            self._slots = init_slots(cfg.solver_type, variables.params)
        self.set_reduce_grads(None)

    def hold(self, variables: NetVars, slots: dict) -> None:
        """Hold ``variables`` and ``slots`` whose blob shapes may differ from
        the ones held (a model-parallel ``ParallelTrainer`` keeps its rank's
        slice of each sharded blob, and gathers the whole blobs back): the
        arenas and their layout, or the blob dicts, are made anew for them,
        and the train step keeps its ``reduce_grads``."""
        if self.layout is not None:
            from sparknet_tpu_torch.solvers import arena as arena_mod

            self.layout = arena_mod.build_layout(variables.params, self._specs, self.config)
            self._tables = arena_mod.ArenaTables(self.layout, self.device)
            self._param_arena = arena_mod.pack(self.layout, variables.params, self.device)
            self._slot_arenas = arena_mod.pack_slots(self.layout, slots, self.device)
            self._state = {ln: {k: t.to(self.device) for k, t in st.items()}
                           for ln, st in variables.state.items()}
        else:
            self.variables = variables
            self.slots = slots
        self.set_reduce_grads(self._reduce_grads)

    def set_reduce_grads(self, reduce_grads) -> None:
        """(Re)build the train step with ``reduce_grads`` between the
        backward and the update (see :func:`build_fused_step`); ``None``
        is the plain step.  Synchronous data parallelism averages the grads
        over the workers there (``parallel/trainer.py``)."""
        self._reduce_grads = reduce_grads
        if self.layout is not None:
            self._fused_step = build_fused_step(self.config, self.train_net, self.layout,
                                                self._tables, reduce_grads=reduce_grads)
        else:
            self._train_step = build_train_step(self.config, self.train_net, self._specs,
                                                reduce_grads=reduce_grads,
                                                debug=self.config.debug_info)

    # -- blob-wise views of the training state ---------------------------
    @property
    def variables(self) -> NetVars:
        if self.layout is not None:
            from sparknet_tpu_torch.solvers.arena import unpack

            with torch.no_grad():
                params = unpack(self.layout, self._param_arena)
            return NetVars(params=params, state=self._state)
        return NetVars(params=self._params, state=self._state)

    @variables.setter
    def variables(self, v: NetVars) -> None:
        if self.layout is not None:
            from sparknet_tpu_torch.solvers.arena import pack

            self._param_arena.copy_(pack(self.layout, v.params, self.device))
        else:
            self._params = {ln: [p.to(self.device) for p in pl]
                            for ln, pl in v.params.items()}
        self._state = {ln: {k: t.to(self.device) for k, t in s.items()}
                       for ln, s in v.state.items()}

    @property
    def slots(self) -> dict:
        if self.layout is not None:
            from sparknet_tpu_torch.solvers.arena import unpack_slots

            with torch.no_grad():
                return unpack_slots(self.layout, self._slot_arenas)
        return self._slots

    @slots.setter
    def slots(self, slots: dict) -> None:
        if self.layout is not None:
            from sparknet_tpu_torch.solvers.arena import pack_slots

            for a, new in zip(self._slot_arenas,
                              pack_slots(self.layout, slots, self.device)):
                a.copy_(new)
        else:
            self._slots = {ln: [[h.to(self.device) for h in hl] for hl in sl]
                           for ln, sl in slots.items()}

    # ------------------------------------------------------------------
    def _feeds_on_device(self, feeds: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in feeds.items()}

    def train_iteration(self, feeds: dict) -> torch.Tensor:
        """One training iteration at ``self.iter`` on ``feeds``; advances
        ``iter`` and returns the loss, left on the device.  :meth:`step` is
        a loop of these, and so are the distributed trainer's rounds."""
        feeds = self._feeds_on_device(feeds)
        self._gen.manual_seed(dropout_seed(self._seed, self.iter, self.worker))
        if self.layout is not None:
            self._state, loss = self._fused_step(
                self._param_arena, self._slot_arenas, self._state,
                self.iter, feeds, self._gen)
        else:
            variables, self._slots, loss, *stats = self._train_step(
                NetVars(self._params, self._state), self._slots,
                self.iter, feeds, self._gen)
            self._params, self._state = variables.params, variables.state
            if stats:
                self._print_debug_info(stats[0])
        self.iter += 1
        return loss

    @staticmethod
    def _print_debug_info(stats) -> None:
        """Caffe's per-iteration diagnostic lines, the JAX Solver's (ref:
        net.cpp:658-735 ForwardDebugInfo / BackwardDebugInfo /
        UpdateDebugInfo): each top's mean |data| as its layer ran (in-place
        layers included), each param blob's mean |diff|, then its mean
        |data| before the update."""
        for (layer, top), v in stats["forward"].items():
            print(f"    [Forward] Layer {layer}, top blob {top} "
                  f"data: {float(v):.6g}")
        for name, v in stats["diff"].items():
            print(f"    [Backward] Layer {name.split('[')[0]}, "
                  f"param blob {name} diff: {float(v):.6g}")
        for name, v in stats["param"].items():
            print(f"    [Update] Layer {name.split('[')[0]}, "
                  f"param blob {name} data: {float(v):.6g}")

    def step(self, num_iters: int, data_fn: DataFn, callback=None) -> float:
        """Run ``num_iters`` training iterations (ref: Solver::Step).
        Returns the final smoothed loss; ``callback(iter, loss)`` runs
        after every iteration on the host.

        With ``SPARKNET_OBS`` armed, one ``round`` record (mode ``solo``)
        covers the call, its wall fence-stamped on the VALUE of the last
        loss (the read the smoothed loss makes anyway); with obs off it
        adds no host sync, launch or allocation to the loop."""
        rec = get_recorder() if num_iters > 0 else None
        cfg = self.config
        t0, it0, images = time.perf_counter(), self.iter, 0
        for _ in range(num_iters):
            feeds = data_fn(self.iter)
            if rec:
                images = _feed_images(feeds, cfg.iter_size)
            loss = self.train_iteration(feeds)
            # losses stay on the device (no sync per iteration); smoothing
            # window per solver.cpp:235-257
            self._loss_window.append(loss)
            if len(self._loss_window) > cfg.average_loss:
                self._loss_window.pop(0)
            if cfg.display and self.iter % cfg.display == 0:
                print(f"Iteration {self.iter}, loss = {self._smoothed():.6g}, "
                      f"lr = {float(learning_rate(cfg, self.iter)):.6g}")
            if callback:
                callback(self.iter, float(loss))
            if cfg.snapshot and self.iter % cfg.snapshot == 0 and cfg.snapshot_prefix:
                self.save(f"{cfg.snapshot_prefix}_iter_{self.iter}")
        self.smoothed_loss = self._smoothed()
        if rec:
            rec.round(
                mode="solo", tau=1, devices=1, iters=self.iter - it0, batch=images,
                wall_s=time.perf_counter() - t0, loss=_value(self._loss_window[-1]),
                fenced=True, iteration=self.iter,
                lineage=obs_lineage.round_lineage("solo", it0, it0,
                                                  max(it0, self.iter - 1)))
        return self.smoothed_loss

    def _smoothed(self) -> float:
        if not self._loss_window:
            return 0.0
        return float(sum(float(l) for l in self._loss_window) / len(self._loss_window))

    # ------------------------------------------------------------------
    def test(self, num_batches: int, data_fn: DataFn,
             test_net_id: int = 0) -> dict[str, float]:
        """Accumulate each test output over batches, then divide by the
        batch count (ref: Solver::TestAndStoreResult solver.cpp:414-444 +
        CifarApp.scala:113-115)."""
        net = self.test_nets[test_net_id]
        outputs = net.output_blobs()
        variables = self.variables
        sums: dict[str, float] = {}
        with torch.inference_mode():
            for b in range(num_batches):
                blobs, _, _ = net.apply(variables, data_fn(b), train=False)
                for name in outputs:
                    if name in blobs:
                        sums[name] = sums.get(name, 0.0) + float(torch.sum(blobs[name]))
        return {k: v / num_batches for k, v in sums.items()}

    def test_all(self, data_fns) -> list[dict[str, float]]:
        """Run every test net with its own test_iter count (ref:
        Solver::TestAll solver.cpp:323-327)."""
        data_fns = list(data_fns)
        if len(data_fns) != len(self.test_nets):
            raise ValueError(
                f"test_all needs one data_fn per test net: got "
                f"{len(data_fns)} for {len(self.test_nets)} nets")
        return [self.test(self.config.test_iter[i] if i < len(self.config.test_iter)
                          else 1, fn, test_net_id=i)
                for i, fn in enumerate(data_fns)]

    # ------------------------------------------------------------------
    # Snapshot/restore (ref: Solver::Snapshot/Restore solver.cpp:447-519 +
    # SGDSolver history snapshot sgd_solver.cpp:242+)
    def snapshot_arrays(self) -> dict[str, np.ndarray]:
        """The training state under the JAX package's ``.solverstate.npz``
        keys: ``__iter__``, ``__meta__``, ``param/<layer>/<i>``,
        ``state/<layer>/<k>``, ``hist/<layer>/<i>/<j>``.  Blob-wise and in
        the param dtype on both update paths."""
        flat: dict[str, np.ndarray] = {"__iter__": np.asarray(self.iter)}
        flat["__meta__"] = np.frombuffer(json.dumps(
            {"solver_type": self.config.solver_type, "layout": "nchw"}).encode(),
            dtype=np.uint8)
        variables = self.variables
        for lname, plist in variables.params.items():
            for i, p in enumerate(plist):
                flat[f"param/{lname}/{i}"] = _numpy(p)
        for lname, s in variables.state.items():
            for k, v in s.items():
                flat[f"state/{lname}/{k}"] = _numpy(v)
        for lname, slist in self.slots.items():
            for i, slot in enumerate(slist):
                for j, h in enumerate(slot):
                    flat[f"hist/{lname}/{i}/{j}"] = _numpy(h)
        return flat

    def save(self, prefix: str) -> str:
        """Write ``<prefix>.solverstate.npz`` (atomically) and return its
        path.  It restores into this port's Solver and into the JAX
        package's.  The port writes NO model file yet: the JAX package's
        ``.caffemodel`` (BINARYPROTO) or ``.caffemodel.h5`` companion named
        by ``snapshot_format`` is not ported (ROADMAP)."""
        path = f"{prefix}.solverstate.npz"
        _write_npz_atomic(path, self.snapshot_arrays())
        return path

    def restore(self, path: str) -> None:
        """Load a ``.solverstate.npz`` written by either package: params,
        state, history and the iteration.  Raises if it was taken with
        another solver type."""
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        meta = (json.loads(bytes(arrays["__meta__"]).decode())
                if "__meta__" in arrays else {})
        saved_type = meta.get("solver_type")
        if saved_type and saved_type != self.config.solver_type:
            raise ValueError(
                f"snapshot was taken with solver_type={saved_type!r}, "
                f"this solver is {self.config.solver_type!r}")
        current = self.variables
        params = {k: list(v) for k, v in current.params.items()}
        state = {k: dict(v) for k, v in current.state.items()}
        slots = {k: [list(s) for s in v] for k, v in self.slots.items()}
        for key, value in arrays.items():
            kind, _, rest = key.partition("/")
            if kind == "param":
                layer, _, i = rest.rpartition("/")
                params[layer][int(i)] = _like(value, params[layer][int(i)])
            elif kind == "state":
                layer, _, name = rest.rpartition("/")
                state[layer][name] = _like(value, state[layer].get(name))
            elif kind == "hist":
                layer, i, j = rest.rsplit("/", 2)
                slots[layer][int(i)][int(j)] = _like(value, slots[layer][int(i)][int(j)])
        self.iter = int(arrays["__iter__"])
        self.variables = NetVars(params=params, state=state)
        self.slots = slots
