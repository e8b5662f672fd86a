"""NetParameter -> executable network on a torch device.

Counterpart of ``sparknet_tpu/compiler/graph.py`` (ref:
caffe/src/caffe/net.cpp: Init topological wiring :40-540, ForwardFromTo
:565-583).  The executor is an eager layer loop over the phase-filtered
layers: blobs are dict entries, in-place prototxt tops (top == bottom) are
plain rebinds, and each layer's ``apply`` is a function on tensors.

Phase filtering follows NetStateRule semantics (net.cpp:287 FilterNet +
StateMeetsRule: phase / min_level / max_level / stage / not_stage).
Cross-layer weight sharing (``param { name: ... }``, the siamese example's
two towers) keeps the JAX layout: the first layer to name a param owns the
tensor, a sharer's position holds a 0-size placeholder
(:func:`is_placeholder`), and ``apply`` substitutes the owner's tensor
(:meth:`Network.layer_params`), so autograd sums every tower's gradient
into it (Caffe's shared-diff accumulation).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

import torch

from sparknet_tpu_torch.common import (
    Phase,
    act_storage_policy,
    f32_precision,
    get_config,
    resolve_device,
)
from sparknet_tpu_torch.ops import attention, create_layer
from sparknet_tpu_torch.ops.base import Layer, ParamSpec
from sparknet_tpu_torch.ops.data_layers import InputLayer
from sparknet_tpu_torch.proto.text_format import Message
from sparknet_tpu_torch.utils import profiling

Params = dict[str, list[torch.Tensor]]
State = dict[str, dict[str, torch.Tensor]]


def is_placeholder(blob: torch.Tensor) -> bool:
    """Whether ``blob`` is a shared param's 0-size placeholder: the
    position a sharer holds in ``NetVars.params``, which stores its
    owner's blob once (:meth:`Network.layer_params` resolves it)."""
    return blob.numel() == 0


def _cast(x, dtype: torch.dtype):
    """``x`` in ``dtype`` if it is a floating tensor, else ``x`` (integer
    labels and token ids keep their type)."""
    return x.to(dtype) if x.is_floating_point() else x


@contextlib.contextmanager
def _saved_as_stored(stored: list, ins: list):
    """While a layer runs on ``ins``, casts of its input blobs ``stored``,
    autograd saves the bf16 blob in place of an upcast of it that it would
    keep for the backward, and upcasts it again there (bf16 to float32 is
    exact, so the backward sees the same values).  Without this a bf16
    storage policy would save nothing (the consumer keeps its float32
    input), and a loss layer under bf16 compute would keep a float32 copy
    of its bf16 input.  JAX's compiled step saves the bf16 residual
    itself."""
    pairs = {x.data_ptr(): (s, x.numel()) for s, x in zip(stored, ins)
             if s is not x and s.dtype == torch.bfloat16}
    if not pairs or not torch.is_grad_enabled():
        yield
        return

    def pack(t):
        hit = pairs.get(t.data_ptr()) if t.dtype != torch.bfloat16 else None
        if hit is not None and t.numel() == hit[1] and t.is_contiguous():
            return (hit[0], t.dtype, t.shape)
        return t

    def unpack(packed):
        if isinstance(packed, tuple):
            src, dtype, shape = packed
            return src.to(dtype).reshape(shape)
        return packed

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


# Layers that run on sequence blocks as they would on the whole sequence,
# position by position (``Network.apply`` under sequence parallelism).
_PER_POSITION = frozenset({
    "Embed", "MultiHeadAttention", "Eltwise", "MoE", "Split", "Dropout", "ReLU",
    "Sigmoid", "TanH", "AbsVal", "BNLL", "Power", "Exp", "Log", "Threshold", "ELU"})


def _runs_on_blocks(layer: Layer, ndim: int) -> bool:
    """Whether ``layer``, its inputs split along axis 1 (the sequence) and
    of rank ``ndim``, computes on each block what it computes on those rows
    of the whole sequence: the per-position types, and InnerProduct,
    SoftmaxWithLoss and Accuracy over an axis past the sequence (the loss
    and the accuracy when their normalizer is the count of positions, so
    the mean over the seq ranks of the blocks' values is the whole's)."""
    if layer.TYPE in _PER_POSITION:
        return True
    lp = layer.lp

    def axis(msg: str) -> int:
        a = lp.get_msg(msg).get_int("axis", 1)
        return a + ndim if a < 0 else a

    if layer.TYPE == "InnerProduct":
        return axis("inner_product_param") >= 2
    if layer.TYPE == "SoftmaxWithLoss":
        loss = lp.get_msg("loss_param")
        return (axis("softmax_param") >= 2 and not loss.has("ignore_label")
                and loss.get_bool("normalize", True))
    if layer.TYPE == "Accuracy":
        return axis("accuracy_param") >= 2 and not lp.get_msg("accuracy_param").has(
            "ignore_label")
    return False


def _pool_segments(layers: list) -> list[list]:
    """``layers``, (index, layer) pairs, cut after each Pooling layer: the
    segments of the ``"blocks"`` remat policy, whose boundaries are the
    blobs the JAX package saves under ``remat="blocks"`` (its
    ``BLOCK_SAVE_NAME`` tags)."""
    segs: list[list] = [[]]
    for item in layers:
        segs[-1].append(item)
        if item[1].TYPE == "Pooling":
            segs.append([])
    return [s for s in segs if s]


def _dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (JAX's ``dots_saveable``): the outputs of the
    matrix products are saved, everything else (the convolutions) is
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(run, layers: list, blob: dict, gen, context_fn=None):
    """``run(layers, blob)`` under ``torch.utils.checkpoint``
    (``use_reentrant=False``; ``context_fn`` as it takes it): the backward
    keeps the segment's inputs, and what ``context_fn`` saves, and
    recomputes the rest.  ``blob`` is updated with the segment's outputs,
    and loses the blobs the segment dropped (``keep_blobs=False``).

    The random layers draw from ``gen``, which the checkpoint does not
    restore (it keeps the global generators only).  The forward draws and
    advances ``gen`` as it would without the checkpoint; the recompute sets
    the state the segment entered with, so it draws the forward's masks,
    and then puts the caller's state back, so a later forward (the next
    micro-batch of an ``iter_size`` step) draws on from where the forward
    left it.  The recompute runs under ``f32_precision`` as the forward
    did, wherever the backward is called from."""
    from torch.utils.checkpoint import checkpoint

    gen_state = gen.get_state() if gen is not None else None
    inputs = dict(blob)
    forward_ran = []  # the first call is the forward, a later one the recompute

    def body(inputs):
        local = dict(inputs)
        with f32_precision():
            st, loss, sink = run(layers, local)
        made = {k: v for k, v in local.items() if inputs.get(k) is not v}
        gone = [k for k in inputs if k not in local]
        return made, gone, st, loss, sink

    def segment(inputs):
        if gen_state is None or not forward_ran:
            forward_ran.append(True)
            return body(inputs)
        prev = gen.get_state()
        gen.set_state(gen_state)
        try:
            return body(inputs)
        finally:
            gen.set_state(prev)

    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    made, gone, st, loss, sink = checkpoint(segment, inputs, use_reentrant=False, **kwargs)
    for k in gone:
        del blob[k]
    blob.update(made)
    return st, loss, sink


@dataclasses.dataclass
class NetVars:
    """All network variables: learnable params (``{layer: [blob, ...]}`` in
    Caffe's ``blobs_`` order) and mutable state (``{layer: {name: tensor}}``)."""

    params: Params
    state: State


def _rule_matches(rule: Message, phase: Phase, level: int, stages: set[str]) -> bool:
    """ref: Net::StateMeetsRule (net.cpp:287+)."""
    if rule.has("phase") and rule.get_str("phase") != phase.name:
        return False
    if rule.has("min_level") and level < rule.get_int("min_level"):
        return False
    if rule.has("max_level") and level > rule.get_int("max_level"):
        return False
    for s in rule.get_all("stage"):
        if str(s) not in stages:
            return False
    for s in rule.get_all("not_stage"):
        if str(s) in stages:
            return False
    return True


def filter_phase(
    net_param: Message,
    phase: Phase,
    level: int = 0,
    stages: set[str] | None = None,
) -> list[Message]:
    """Select the layers active in ``phase`` (ref: Net::FilterNet)."""
    stages = stages or set()
    out = []
    for lp in net_param.get_all("layer") or net_param.get_all("layers"):
        includes = lp.get_all("include")
        excludes = lp.get_all("exclude")
        keep = True
        if includes:
            keep = any(_rule_matches(r, phase, level, stages) for r in includes)
        elif excludes:
            keep = not any(_rule_matches(r, phase, level, stages) for r in excludes)
        if keep:
            out.append(lp)
    return out


@dataclasses.dataclass
class BlobInfo:
    shape: tuple[int, ...]
    dtype: Any


class Network:
    """A phase-specific view of a NetParameter on one device.

    ``init(gen)`` -> NetVars on the net's device;
    ``apply(vars, feeds, gen=...)`` -> (blobs, new_state, total_loss).
    ``device=None`` means CUDA and raises without a CUDA device; pass
    ``device="cpu"`` to run on the CPU.  ``stages``/``level`` are the
    NetState the phase filter matches (ref: Net::FilterNet).
    """

    def __init__(
        self,
        net_param: Message,
        phase: Phase = Phase.TRAIN,
        device: str | torch.device | None = None,
        *,
        stages: set[str] | None = None,
        level: int = 0,
    ):
        from sparknet_tpu_torch.proto.upgrade import upgrade_net

        self.device = resolve_device(device)
        net_param = upgrade_net(net_param)
        self.net_param = net_param
        self.phase = phase
        self.name = net_param.get_str("name", "net")
        self.layers: list[Layer] = [
            create_layer(lp, phase)
            for lp in filter_phase(net_param, phase, level, stages)
        ]
        self.input_layers = [l for l in self.layers if isinstance(l, InputLayer)]
        # External feed blobs: tops of the input layers that do not feed
        # themselves.
        self.feed_blobs: list[str] = [t for l in self.input_layers
                                      if not l.SELF_FEEDING for t in l.tops]
        # net-level legacy inputs: `input: "data"` + input_shape/input_dim
        self.net_inputs = self._net_level_inputs()
        self.feed_blobs.extend(n for n, _ in self.net_inputs)
        self._blob_info: dict[str, BlobInfo] | None = None
        # Cross-layer weight sharing by name (ref: net.cpp:470+ AppendParam).
        # The first layer to name a param owns it; a later (layer, index)
        # of this phase aliases it.  Owners are elected over the UNFILTERED
        # layer list, so the TRAIN and TEST views agree on them (the phases
        # share one NetVars through the Solver).
        self.param_aliases: dict[tuple[str, int], tuple[str, int]] = {}
        self._shared_names: dict[tuple[str, int], str] = {}
        owners: dict[str, tuple[str, int]] = {}
        phase_names = {l.name for l in self.layers}
        for lp in net_param.get_all("layer") or net_param.get_all("layers"):
            lname = lp.get_str("name")
            for i, pm in enumerate(lp.get_all("param")):
                pname = pm.get_str("name", "")
                if not pname:
                    continue
                if pname not in owners:
                    owners[pname] = (lname, i)
                elif lname in phase_names and owners[pname][0] != lname:
                    self.param_aliases[(lname, i)] = owners[pname]
                    self._shared_names[(lname, i)] = pname

    # -- legacy net-level inputs (ref: net.cpp AppendTop "deprecated 4D input
    # dimensions" / input_shape) ------------------------------------------
    def _net_level_inputs(self) -> list[tuple[str, tuple[int, ...] | None]]:
        from sparknet_tpu_torch.ops.layout import internal_shape

        names = [str(s) for s in self.net_param.get_all("input")]
        shapes: list[tuple[int, ...] | None] = []
        shape_msgs = self.net_param.get_all("input_shape")
        dims_flat = [int(d) for d in self.net_param.get_all("input_dim")]
        for i, _ in enumerate(names):
            if i < len(shape_msgs):
                shapes.append(internal_shape(
                    tuple(int(d) for d in shape_msgs[i].get_all("dim"))))
            elif dims_flat:
                shapes.append(internal_shape(tuple(dims_flat[4 * i : 4 * i + 4])))
            else:
                shapes.append(None)
        return list(zip(names, shapes))

    # ------------------------------------------------------------------
    def feed_shapes(self) -> dict[str, tuple[int, ...]]:
        """Declared shapes for feed blobs (from layer params), where known."""
        out: dict[str, tuple[int, ...]] = {}
        for l in self.input_layers:
            if l.SELF_FEEDING:
                continue
            shapes = l.blob_shapes()
            if shapes:
                for top, shape in zip(l.tops, shapes):
                    out[top] = shape
        for name, shape in self.net_inputs:
            if shape:
                out[name] = shape
        return out

    # ------------------------------------------------------------------
    def init(
        self,
        gen: torch.Generator | None = None,
        feed_shapes: dict[str, tuple[int, ...]] | None = None,
    ) -> NetVars:
        """Initialize params/state on the net's device.

        Blobs are drawn on the CPU from ``gen`` (default: a generator seeded
        with ``Config.seed``) and moved to the device; shapes propagate layer
        by layer on the ``meta`` device, which computes no values."""
        if gen is None:
            gen = torch.Generator().manual_seed(get_config().seed)
        shapes = dict(self.feed_shapes())
        if feed_shapes:
            shapes.update(feed_shapes)
        blob: dict[str, torch.Tensor] = {}
        for name in self.feed_blobs:
            if name not in shapes:
                raise ValueError(
                    f"no shape known for input blob {name!r}; pass feed_shapes"
                )
            blob[name] = torch.empty(shapes[name], device="meta")
        params: Params = {}
        state: State = {}
        train = self.phase == Phase.TRAIN
        for layer in self.layers:
            if isinstance(layer, InputLayer):
                if layer.SELF_FEEDING:
                    blob.update(zip(layer.tops, layer.constant_values("meta")))
                continue
            p, s = layer.init(gen, [tuple(blob[b].shape) for b in layer.bottoms])
            p = self._alias_placeholders(layer, p, params)
            if p:
                # params are keyed by layer name (Caffe snapshot layout)
                if sum(1 for l2 in self.layers if l2.name == layer.name) > 1:
                    raise ValueError(
                        f"param-owning layer {layer.name!r} shares its name "
                        "with another layer; rename one"
                    )
                params[layer.name] = [t.to(self.device) for t in p]
            if s:
                if layer.name in state:
                    raise ValueError(
                        f"two stateful layers share the name {layer.name!r}"
                    )
                state[layer.name] = {k: v.to(self.device) for k, v in s.items()}
            outs = layer.apply(
                [t.to("meta") for t in self.layer_params(layer.name, params)],
                {k: v.to("meta") for k, v in s.items()},
                [blob[b] for b in layer.bottoms], train=train).outputs
            for top, o in zip(layer.tops, outs):
                blob[top] = o
        self._blob_info = {k: BlobInfo(tuple(v.shape), v.dtype) for k, v in blob.items()}
        return NetVars(params=params, state=state)

    def _alias_placeholders(self, layer: Layer, p: list, params: Params) -> list:
        """``layer``'s fresh blobs with each aliased position replaced by a
        0-size placeholder, after the JAX package's checks: the layer has
        the position, and the owner (initialized earlier) a blob of the
        same shape."""
        for (aname, ai), pname in self._shared_names.items():
            # an alias position the layer never makes would otherwise be
            # dropped and train unshared (Caffe CHECK-fails, net.cpp:470+)
            if aname == layer.name and ai >= len(p):
                raise ValueError(
                    f"param name {pname!r} at position {ai} of layer "
                    f"{aname!r}, which has only {len(p)} learnable "
                    "blob(s) — sharing would be silently dropped")
        out = list(p)
        for i, t in enumerate(p):
            owner = self.param_aliases.get((layer.name, i))
            if owner is None:
                continue
            pname = self._shared_names[(layer.name, i)]
            olist = params.get(owner[0])
            if olist is None or owner[1] >= len(olist):
                raise ValueError(
                    f"Cannot share param {pname!r}: owner layer {owner[0]!r} "
                    f"(position {owner[1]}) declares no such blob (is the "
                    "param{} on a param-less or later layer?)")
            if tuple(olist[owner[1]].shape) != tuple(t.shape):
                raise ValueError(
                    f"Cannot share param {pname!r}: owner {owner[0]}[{owner[1]}] "
                    f"has shape {tuple(olist[owner[1]].shape)} but "
                    f"{layer.name}[{i}] expects {tuple(t.shape)}")
            out[i] = torch.zeros((0,), dtype=t.dtype)
        return out

    def layer_params(self, name: str, params: Params) -> list:
        """The blobs layer ``name`` computes with: its list in ``params``
        with the owner's tensor at each shared position.  Every walk over
        the layers takes a layer's params from here, never from ``params``
        directly, where a sharer holds placeholders."""
        p = params.get(name, [])
        if not self.param_aliases or not p:
            return p
        out = list(p)
        for i in range(len(out)):
            owner = self.param_aliases.get((name, i))
            if owner is None:
                continue
            olist = params.get(owner[0])
            if olist is None or owner[1] >= len(olist):
                raise ValueError(
                    f"Cannot share param {self._shared_names[(name, i)]!r}: "
                    f"owner {owner[0]!r} has no params in these variables (the "
                    "owner layer may be filtered out of the phase that "
                    "initialized the net)")
            out[i] = olist[owner[1]]
        return out

    def blob_info(self) -> dict[str, BlobInfo]:
        if self._blob_info is None:
            raise RuntimeError("call init() first")
        return self._blob_info

    # ------------------------------------------------------------------
    def layer_index(self, name: str) -> int:
        for i, layer in enumerate(self.layers):
            if layer.name == name:
                return i
        raise KeyError(
            f"no layer named {name!r}; layers: {[l.name for l in self.layers]}"
        )

    def apply(
        self,
        variables: NetVars,
        feeds: dict[str, Any],
        *,
        gen: torch.Generator | None = None,
        train: bool | None = None,
        start: str | None = None,
        end: str | None = None,
        debug_sink: dict | None = None,
        remat: str = "",
        keep_blobs: bool = True,
    ) -> tuple[dict[str, torch.Tensor], State, torch.Tensor]:
        """Forward pass. Returns (all blobs, updated state, total weighted loss).

        ``gen`` is the generator the random layers (TRAIN-phase Dropout)
        draw from, on the net's device; they raise without one in train
        mode.  The forward is differentiable: gradients w.r.t. params that
        require grad come from ``torch.autograd`` (``solvers/solver.py``).

        ``feeds`` maps blob names to tensors or numpy arrays; they are moved
        to the net's device.  ``start``/``end`` name the first/last layer to
        run — the partial execution of Net::ForwardFromTo (net.cpp:565-583).
        A run that starts mid-graph takes its inputs from ``feeds`` (feed the
        start layer's bottom blobs).  Loss accumulates over the executed
        range only (layer.hpp Forward loss() * loss_weight).  Convolutions
        and matrix products run in full float32 (``common.f32_precision``).

        Mixed precision (``Config.compute_dtype``/``activation_dtype``, as the
        JAX ``apply``): floating feeds are cast to ``compute_dtype``, and a
        non-loss layer's params are cast to it inside the forward, so
        autograd carries the gradient back to the ``param_dtype`` masters;
        loss layers take float32 inputs; the activation-storage policy
        stores bf16 (the feeds at ``io``, Pooling outputs at ``blocks``,
        every non-loss output at ``full``) and the next consumer upcasts;
        returned state keeps its stored dtype; ``total_loss`` is float32.
        With float32 compute and no policy no cast is taken.

        ``debug_sink``: a dict that receives ``(layer, top) -> mean |top|``
        as each layer runs (in-place tops get their own post-op entry; ref:
        Net::ForwardDebugInfo, net.cpp:658-683).  ``remat`` (when grad is
        enabled; ``solvers/solver.apply_remat``) runs the layers under
        ``torch.utils.checkpoint``, so the backward recomputes what was not
        saved: ``"full"`` saves nothing but the run's inputs, ``"dots"``
        saves the outputs of the matrix products too (:func:`_dots_policy`),
        ``"blocks"`` runs segments that end at each Pooling layer and keeps
        only the segments' inputs (the Pooling outputs).
        ``keep_blobs=False`` drops each blob after the last layer of the run
        that reads it (the returned dict keeps the blobs no layer reads): a
        train step needs the loss and the state alone, and without this the
        forward would hold every activation to its end, whatever autograd or
        a checkpoint saves.

        Sequence parallelism (``ops.attention.sequence_parallel``, opened by
        a ``ParallelTrainer`` with a seq axis): the feeds it names hold this
        rank's block of axis 1, and ``apply`` follows the blobs computed
        from them.  A layer whose inputs are all blocks and that computes
        position by position (:func:`_runs_on_blocks`) runs on the blocks
        (MultiHeadAttention through ring or Ulysses attention) and its
        outputs are blocks; any other layer first all-gathers the blocks
        along axis 1 (the gather's backward sums the seq ranks' gradients
        and keeps this rank's rows), as GSPMD reshards in the JAX package.
        """
        train = (self.phase == Phase.TRAIN) if train is None else train
        si = 0 if start is None else self.layer_index(start)
        ei = len(self.layers) - 1 if end is None else self.layer_index(end)
        if si > ei:
            raise ValueError(
                f"start layer {start!r} (#{si}) comes after end layer "
                f"{end!r} (#{ei})"
            )
        cdt = get_config().compute_dtype
        mixed = cdt != torch.float32
        act_policy = act_storage_policy()
        store_io = act_policy in ("io", "full")

        def feed(val) -> torch.Tensor:
            # contiguous: a host transform's center crop is a strided view,
            # and the hand kernels take dense NCHW
            t = torch.as_tensor(val, device=self.device).contiguous()
            if mixed:
                t = _cast(t, cdt)
            return _cast(t, torch.bfloat16) if store_io else t

        blob: dict[str, torch.Tensor] = {}
        if si > 0:
            # mid-graph starts are primed with whatever the caller supplies
            for name, val in feeds.items():
                blob[name] = feed(val)
        else:
            for name in self.feed_blobs:
                if name not in feeds:
                    raise ValueError(f"missing feed for input blob {name!r}")
                blob[name] = feed(feeds[name])

        layers = list(enumerate(self.layers[si : ei + 1]))
        last_read = {b: i for i, layer in layers for b in layer.bottoms}
        sp = attention.active_sequence_parallel()
        # the blobs held as sequence blocks on this rank
        blocks = {b for b in blob if b in sp.feeds} if sp is not None else set()
        scoped = profiling.layer_scopes()

        def run(layers, blob):
            """The (index, layer) pairs in order on ``blob`` (updated in
            place): their new state, their weighted loss, their debug
            entries."""
            new_state: State = {}
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            sink: dict = {}
            for i, layer in layers:
                if isinstance(layer, InputLayer):
                    if layer.SELF_FEEDING:
                        blob.update(zip(layer.tops, layer.constant_values(self.device)))
                    continue
                missing = [b for b in layer.bottoms if b not in blob]
                if missing:
                    raise ValueError(
                        f"layer {layer.name!r} needs blob(s) {missing}; feed "
                        "them or start the run at an earlier layer"
                    )
                p = self.layer_params(layer.name, variables.params)
                ins = stored = [blob[b] for b in layer.bottoms]
                if mixed or act_policy:
                    if layer.IS_LOSS:
                        ins = [_cast(x, torch.float32) for x in ins]
                    else:
                        if mixed:
                            p = [_cast(x, cdt) for x in p]
                        if act_policy:
                            ins = [_cast(x, cdt) for x in ins]
                kwargs = {"gen": gen} if layer.NEEDS_GEN else {}
                split = [b in blocks for b in layer.bottoms]
                on_blocks = any(split) and all(split) and _runs_on_blocks(layer, ins[0].dim())
                if any(split) and not on_blocks:
                    from sparknet_tpu_torch.parallel.collectives import all_gather

                    ins = [all_gather(x, 1, sp.comm) if s else x
                           for x, s in zip(ins, split)]
                # the layer's range while a profiling.trace is open: the
                # counterpart of JAX's named_scope, read by utils/op_profile
                # ('/' would read as nesting there, so it is flattened)
                scope = (torch.profiler.record_function("L." + layer.name.replace("/", "."))
                         if scoped else contextlib.nullcontext())
                with scope, _saved_as_stored(stored, ins), (
                        attention.seq_blocks() if on_blocks else contextlib.nullcontext()):
                    out = layer.apply(p, variables.state.get(layer.name, {}), ins,
                                      train=train, **kwargs)
                outputs = out.outputs
                for top, o in zip(layer.tops, outputs):
                    if on_blocks and o.dim() >= 2:
                        blocks.add(top)
                    else:
                        blocks.discard(top)
                if act_policy and not layer.IS_LOSS and (
                        act_policy == "full"
                        or (act_policy == "blocks" and layer.TYPE == "Pooling")):
                    outputs = [_cast(o, torch.bfloat16) for o in outputs]
                if out.state:
                    st = out.state
                    prev = variables.state.get(layer.name)
                    if mixed and prev is not None:
                        st = {k: _cast(v, prev[k].dtype) if k in prev else v
                              for k, v in st.items()}
                    new_state[layer.name] = st
                for top, o in zip(layer.tops, outputs):
                    blob[top] = o
                    if debug_sink is not None and o.numel():
                        sink[(layer.name, top)] = o.detach().abs().mean()
                for w, o in zip(layer.loss_weights(), outputs):
                    if w != 0.0:
                        loss = loss + w * o.sum().to(torch.float32)
                if not keep_blobs:
                    for b in layer.bottoms:
                        if last_read[b] == i and b not in layer.tops:
                            blob.pop(b, None)
            return new_state, loss, sink

        with f32_precision():
            if remat and torch.is_grad_enabled():
                segments = _pool_segments(layers) if remat == "blocks" else [layers]
                context_fn = None
                if remat == "dots":
                    from torch.utils.checkpoint import create_selective_checkpoint_contexts

                    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                                   _dots_policy)
                new_state, total_loss, sink = {}, None, {}
                for seg in segments:
                    seg_state, seg_loss, seg_sink = _checkpointed(run, seg, blob, gen,
                                                                  context_fn)
                    new_state.update(seg_state)
                    sink.update(seg_sink)
                    total_loss = seg_loss if total_loss is None else total_loss + seg_loss
            else:
                new_state, total_loss, sink = run(layers, blob)
        if debug_sink is not None:
            debug_sink.update(sink)
        # carry forward unmodified state so the structure is stable
        for lname, s in variables.state.items():
            new_state.setdefault(lname, s)
        return blob, new_state, total_loss

    # ------------------------------------------------------------------
    def param_specs_for(self, variables: NetVars) -> dict[str, list[ParamSpec]]:
        """lr_mult/decay_mult per blob per layer, for the solver
        (ref: net.cpp:470+ AppendParam; params_lr_/params_weight_decay_)."""
        return {
            lname: next(l for l in self.layers if l.name == lname).param_specs(len(plist))
            for lname, plist in variables.params.items()
        }

    def output_blobs(self) -> list[str]:
        """Tops never consumed as a bottom — the net's outputs
        (ref: net.cpp AppendTop/available_blobs bookkeeping)."""
        consumed = set()
        for l in self.layers:
            for b in l.bottoms:
                if b not in l.tops:  # in-place use doesn't consume
                    consumed.add(b)
        outs: list[str] = []
        for l in self.layers:
            for t in l.tops:
                if t not in consumed and t not in outs:
                    outs.append(t)
        return outs

    def __repr__(self):
        return (f"<Network {self.name!r} phase={self.phase.name} "
                f"layers={len(self.layers)} device={self.device}>")
