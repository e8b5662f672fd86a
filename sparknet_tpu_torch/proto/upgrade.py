"""Legacy NetParameter schema migration: V0 -> V1 -> V2.

The reference carries 1,014 lines of ``upgrade_proto.cpp`` so decade-old zoo
prototxts keep loading; this is the same ladder over the schema-less
:class:`Message` representation:

- **V0** (``layers { layer { name type num_output ... } bottom: ... }``,
  ref: UpgradeV0LayerParameter upgrade_proto.cpp:179-529): per-layer scalar
  fields move into the typed ``*_param`` sub-messages, lowercase type names
  map to V2 strings (UpgradeV0LayerType :531-585).
- **V1** (``layers { type: CONVOLUTION blobs_lr: 1 ... }``,
  ref: UpgradeV1LayerParameter :785+): ``layers``->``layer``, ALL_CAPS enum
  types -> strings, repeated ``param``(names)/``blobs_lr``/``weight_decay``
  fold into ``param { name lr_mult decay_mult }`` messages.
- **Data transform** (ref: UpgradeNetDataTransformation :587-640 +
  NetNeedsDataUpgrade): scale/mean_file/crop_size/mirror move from
  data/image_data/window_data params into ``transform_param``.

- **Solver** (ref: UpgradeSolverAsNeeded): the ``solver_type`` enum folds
  into the string ``type`` field (``upgrade_solver``).

``upgrade_net`` is idempotent and returns its input unchanged for current
nets, so loaders can call it unconditionally.

The solver-side ``upgrade_solver`` of the JAX package is not carried over
here: it needs the solver, which comes with the training path.
"""

from __future__ import annotations

import warnings

from sparknet_tpu_torch.proto.text_format import Message

# ref: UpgradeV0LayerType (upgrade_proto.cpp:531-585), composed with the
# V1->V2 name map so V0 jumps straight to V2 type strings
_V0_TYPES = {
    "accuracy": "Accuracy",
    "bnll": "BNLL",
    "concat": "Concat",
    "conv": "Convolution",
    "data": "Data",
    "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss",
    "flatten": "Flatten",
    "hdf5_data": "HDF5Data",
    "hdf5_output": "HDF5Output",
    "im2col": "Im2col",
    "images": "ImageData",
    "infogain_loss": "InfogainLoss",
    "innerproduct": "InnerProduct",
    "lrn": "LRN",
    "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling",
    "relu": "ReLU",
    "sigmoid": "Sigmoid",
    "softmax": "Softmax",
    "softmax_loss": "SoftmaxWithLoss",
    "split": "Split",
    "tanh": "TanH",
    "window_data": "WindowData",
}

# V0 scalar field -> (target param message, target field, {v0 type: ...}).
# A "+" prefix on the target field means repeated add (conv kernel/stride/pad
# became repeated in V2).  ref: UpgradeV0LayerParameter:207-529.
_V0_FIELD_MOVES = [
    ("num_output", "num_output", {"conv": "convolution_param",
                                  "innerproduct": "inner_product_param"}),
    ("biasterm", "bias_term", {"conv": "convolution_param",
                               "innerproduct": "inner_product_param"}),
    ("weight_filler", "weight_filler", {"conv": "convolution_param",
                                        "innerproduct": "inner_product_param"}),
    ("bias_filler", "bias_filler", {"conv": "convolution_param",
                                    "innerproduct": "inner_product_param"}),
    ("pad", "+pad", {"conv": "convolution_param"}),
    ("pad", "pad", {"pool": "pooling_param"}),
    ("kernelsize", "+kernel_size", {"conv": "convolution_param"}),
    ("kernelsize", "kernel_size", {"pool": "pooling_param"}),
    ("group", "group", {"conv": "convolution_param"}),
    ("stride", "+stride", {"conv": "convolution_param"}),
    ("stride", "stride", {"pool": "pooling_param"}),
    ("pool", "pool", {"pool": "pooling_param"}),
    ("dropout_ratio", "dropout_ratio", {"dropout": "dropout_param"}),
    ("local_size", "local_size", {"lrn": "lrn_param"}),
    ("alpha", "alpha", {"lrn": "lrn_param"}),
    ("beta", "beta", {"lrn": "lrn_param"}),
    ("k", "k", {"lrn": "lrn_param"}),
    ("source", "source", {"data": "data_param",
                          "hdf5_data": "hdf5_data_param",
                          "images": "image_data_param",
                          "window_data": "window_data_param",
                          "infogain_loss": "infogain_loss_param"}),
    ("batchsize", "batch_size", {"data": "data_param",
                                 "hdf5_data": "hdf5_data_param",
                                 "images": "image_data_param",
                                 "window_data": "window_data_param"}),
    ("rand_skip", "rand_skip", {"data": "data_param",
                                "images": "image_data_param"}),
    ("shuffle_images", "shuffle", {"images": "image_data_param"}),
    ("new_height", "new_height", {"images": "image_data_param"}),
    ("new_width", "new_width", {"images": "image_data_param"}),
    ("concat_dim", "concat_dim", {"concat": "concat_param"}),
    ("det_fg_threshold", "fg_threshold", {"window_data": "window_data_param"}),
    ("det_bg_threshold", "bg_threshold", {"window_data": "window_data_param"}),
    ("det_fg_fraction", "fg_fraction", {"window_data": "window_data_param"}),
    ("det_context_pad", "context_pad", {"window_data": "window_data_param"}),
    ("det_crop_mode", "crop_mode", {"window_data": "window_data_param"}),
]

# V0 transform fields always land in transform_param regardless of type
# (ref: upgrade_proto.cpp:385-418)
_V0_TRANSFORM_MOVES = [
    ("scale", "scale"),
    ("meanfile", "mean_file"),
    ("cropsize", "crop_size"),
    ("mirror", "mirror"),
]

_DATA_TYPES_WITH_TRANSFORM = {
    "Data": "data_param",
    "ImageData": "image_data_param",
    "WindowData": "window_data_param",
}

_TRANSFORM_FIELDS = ("scale", "mean_file", "crop_size", "mirror")


def net_needs_v0_upgrade(net_param: Message) -> bool:
    """V0 marker: a ``layers`` entry holding a nested ``layer`` message
    (ref: NetNeedsV0ToV1Upgrade)."""
    return any(
        isinstance(lp, Message) and lp.has("layer")
        for lp in net_param.get_all("layers")
    )


def net_needs_v1_upgrade(net_param: Message) -> bool:
    """V1 marker: the ``layers`` (not ``layer``) field, non-V0
    (ref: NetNeedsV1ToV2Upgrade)."""
    return bool(net_param.get_all("layers")) and not net_needs_v0_upgrade(net_param)


def net_needs_data_upgrade(net_param: Message) -> bool:
    """Transform fields still living inside data params
    (ref: NetNeedsDataUpgrade upgrade_proto.cpp:587-612)."""
    for lp in net_param.get_all("layer"):
        pname = _DATA_TYPES_WITH_TRANSFORM.get(lp.get_str("type"))
        if pname and lp.has(pname):
            if any(lp.get_msg(pname).has(f) for f in _TRANSFORM_FIELDS):
                return True
    return False


def _upgrade_v0_layer(conn: Message) -> Message:
    """One V0 layer-connection -> V2 layer (ref: UpgradeV0LayerParameter)."""
    out = Message()
    v0 = conn.get_msg("layer")
    if v0.has("name"):
        out.set("name", v0.get_str("name"))
    v0_type = v0.get_str("type")
    if v0_type:
        if v0_type not in _V0_TYPES:
            raise ValueError(f"Unknown V0 layer type: {v0_type!r}")
        out.set("type", _V0_TYPES[v0_type])
    for b in conn.get_all("bottom"):
        out.add("bottom", str(b))
    for t in conn.get_all("top"):
        out.add("top", str(t))

    params: dict[str, Message] = {}

    def param_msg(name: str) -> Message:
        if name not in params:
            params[name] = Message()
            out.set(name, params[name])
        return params[name]

    moves_by_src: dict[str, list[tuple[str, dict]]] = {}
    for src, dst, by_type in _V0_FIELD_MOVES:
        moves_by_src.setdefault(src, []).append((dst, by_type))
    for src, rows in moves_by_src.items():
        if not v0.has(src):
            continue
        hit = next(((d, m[v0_type]) for d, m in rows if v0_type in m), None)
        if hit is None:
            # reference LOG(ERROR)s and marks not-fully-compatible but still
            # loads (upgrade_proto.cpp:215-218); match that
            warnings.warn(
                f"Unknown parameter {src!r} for V0 layer type {v0_type!r}; dropped"
            )
            continue
        dst, target = hit
        val = v0.get(src)
        if dst.startswith("+"):
            param_msg(target).add(dst[1:], val)
        else:
            param_msg(target).set(dst, val)
    for src, dst in _V0_TRANSFORM_MOVES:
        if v0.has(src):
            param_msg("transform_param").set(dst, v0.get(src))
    if v0.has("hdf5_output_param"):
        out.set("hdf5_output_param", v0.get_msg("hdf5_output_param").copy())

    # blobs_lr / weight_decay -> param {} messages (the V1->V2 fold applied
    # directly, ref: UpgradeV1LayerParameter param handling)
    _fold_param_multipliers(v0, out)
    return out


def _fold_param_multipliers(src: Message, out: Message) -> None:
    """repeated param(name str) / blobs_lr / weight_decay ->
    ``param { name lr_mult decay_mult }`` messages."""
    names = [str(n) for n in src.get_all("param")
             if not isinstance(n, Message)]
    lrs = [float(v) for v in src.get_all("blobs_lr")]
    decays = [float(v) for v in src.get_all("weight_decay")]
    n = max(len(names), len(lrs), len(decays))
    for i in range(n):
        pm = Message()
        if i < len(names) and names[i]:
            pm.set("name", names[i])
        if i < len(lrs):
            pm.set("lr_mult", lrs[i])
        if i < len(decays):
            pm.set("decay_mult", decays[i])
        out.add("param", pm)


def _upgrade_v1_layer(v1: Message) -> Message:
    """One V1 ``layers`` entry -> V2 ``layer`` (ref: UpgradeV1LayerParameter)."""
    from sparknet_tpu_torch.ops.registry import _V1_ALIASES

    out = Message()
    skip = {"param", "blobs_lr", "weight_decay"}
    for k, vals in v1.fields.items():
        if k in skip:
            continue
        for v in vals:
            if k == "type":
                tname = str(v)
                out.add("type", _V1_ALIASES.get(tname, tname))
            else:
                out.add(k, v.copy() if isinstance(v, Message) else v)
    _fold_param_multipliers(v1, out)
    return out


def upgrade_net_data_transformation(net_param: Message) -> None:
    """Move scale/mean_file/crop_size/mirror out of data params, in place
    (ref: UpgradeNetDataTransformation + CONVERT_LAYER_TRANSFORM_PARAM)."""
    for lp in net_param.get_all("layer"):
        pname = _DATA_TYPES_WITH_TRANSFORM.get(lp.get_str("type"))
        if not pname or not lp.has(pname):
            continue
        dp = lp.get_msg(pname)
        moved = {f: dp.get(f) for f in _TRANSFORM_FIELDS if dp.has(f)}
        if not moved:
            continue
        tp = lp.get_msg("transform_param") if lp.has("transform_param") else Message()
        for f, v in moved.items():
            tp.set(f, v)
            dp.fields.pop(f, None)
        lp.set("transform_param", tp)


# numeric SolverType enum values (old binary solverstates may carry these);
# string names reuse the solver module's alias map so the upgrade and the
# training path can never disagree
_SOLVER_TYPE_NUMBERS = {
    0: "SGD", 1: "Nesterov", 2: "AdaGrad", 3: "RMSProp", 4: "AdaDelta", 5: "Adam",
}


def upgrade_solver(solver_param: Message) -> Message:
    """Fold the deprecated ``solver_type`` enum into the string ``type``
    field, in place (ref: UpgradeSolverAsNeeded/UpgradeSolverType)."""
    from sparknet_tpu_torch.solvers.solver import _TYPE_ALIASES

    if solver_param.has("solver_type") and not solver_param.has("type"):
        st = solver_param.get("solver_type")
        if isinstance(st, int):
            if st not in _SOLVER_TYPE_NUMBERS:
                raise ValueError(f"Unknown solver_type {st!r}")
            resolved = _SOLVER_TYPE_NUMBERS[st]
        else:
            if str(st) not in _TYPE_ALIASES:
                raise ValueError(f"Unknown solver_type {st!r}")
            resolved = _TYPE_ALIASES[str(st)]
        solver_param.set("type", resolved)
        solver_param.fields.pop("solver_type", None)
    return solver_param


def upgrade_net(net_param: Message) -> Message:
    """Run the full upgrade ladder; current-schema nets pass through
    untouched (ref: UpgradeNetAsNeeded upgrade_proto.cpp:59-105)."""
    if net_needs_v0_upgrade(net_param):
        out = Message()
        for k, vals in net_param.fields.items():
            if k == "layers":
                continue
            for v in vals:
                out.add(k, v.copy() if isinstance(v, Message) else v)
        for conn in net_param.get_all("layers"):
            out.add("layer", _upgrade_v0_layer(conn))
        net_param = out
    elif net_needs_v1_upgrade(net_param):
        out = Message()
        for k, vals in net_param.fields.items():
            if k == "layers":
                continue
            for v in vals:
                out.add(k, v.copy() if isinstance(v, Message) else v)
        for v1 in net_param.get_all("layers"):
            out.add("layer", _upgrade_v1_layer(v1))
        net_param = out
    if net_needs_data_upgrade(net_param):
        # copy before mutating: the caller's parsed Message must not be
        # side-effected by load-time migration (the V0/V1 branches already
        # build fresh Messages)
        net_param = net_param.copy()
        upgrade_net_data_transformation(net_param)
    return net_param
