"""Prototxt loading utilities.

Equivalent of ProtoLoader (ref: src/main/scala/libs/ProtoLoader.scala:8-58),
minus the absurd round trip the reference needed (parse prototxt in C++,
serialize to bytes, re-parse in the JVM) — here parsing is native.
"""

from __future__ import annotations

from sparknet_tpu_torch.proto.text_format import Message, parse_file
from sparknet_tpu_torch.layers_dsl import RDDLayer

_DATA_LAYER_TYPES = {
    "Data",
    "ImageData",
    "HDF5Data",
    "MemoryData",
    "WindowData",
    "DummyData",
    "JavaData",
    "Input",
}


def load_net_prototxt(path: str) -> Message:
    """ref: ProtoLoader.loadNetPrototxt (:9-16); legacy V0/V1 schemas are
    migrated on load (ref: ReadNetParamsFromTextFileOrDie ->
    UpgradeNetAsNeeded, upgrade_proto.cpp:59-105)."""
    from sparknet_tpu_torch.proto.upgrade import upgrade_net

    return upgrade_net(parse_file(path))


def load_solver_prototxt_with_net(path: str, net_param: Message) -> Message:
    """Parse a solver prototxt and embed the given net as ``net_param``
    (ref: ProtoLoader.loadSolverPrototxtWithNet :31-43)."""
    solver = parse_file(path)
    solver.fields.pop("net", None)
    solver.fields.pop("train_net", None)
    solver.set("net_param", net_param)
    return solver


def replace_data_layers(
    net_param: Message,
    train_batch_size: int,
    test_batch_size: int,
    channels: int,
    height: int,
    width: int,
) -> Message:
    """Swap the net's data layers for host-fed input layers with the given
    batch geometry (ref: ProtoLoader.replaceDataLayers :50-57 — the surgery
    SparkNet applies to zoo prototxts before training from RDDs)."""
    out = Message()
    for k, vals in net_param.fields.items():
        if k in ("layer", "layers", "input", "input_shape", "input_dim"):
            continue
        for v in vals:
            out.add(k, v.copy() if isinstance(v, Message) else v)

    def _phase_tops(phase: str) -> list[str]:
        """Top names of the data layers active in ``phase`` (so surgery
        preserves nonstandard names like the siamese pair_data/sim).
        Phase selection delegates to the compiler's NetStateRule matcher so
        include/exclude/stage semantics can't diverge (ref: Net::FilterNet)."""
        from sparknet_tpu_torch.common import Phase
        from sparknet_tpu_torch.compiler.graph import filter_phase

        tops: list[str] = []
        for lp in filter_phase(net_param, Phase[phase]):
            if lp.get_str("type") not in _DATA_LAYER_TYPES:
                continue
            for t in lp.get_all("top"):
                if str(t) not in tops:
                    tops.append(str(t))
        return tops or ["data", "label"]

    def input_pair(batch: int, phase: str) -> list[Message]:
        tops = _phase_tops(phase)
        layers = []
        # first top carries the image geometry; the rest are per-sample
        # scalars (label / similarity)
        for i, top in enumerate(tops):
            shape = [batch, channels, height, width] if i == 0 else [batch]
            l = RDDLayer(top, shape)
            l.set("name", f"{top}_{phase.lower()}")
            l.add("include", Message().set("phase", phase))
            layers.append(l)
        return layers

    for l in input_pair(train_batch_size, "TRAIN") + input_pair(test_batch_size, "TEST"):
        out.add("layer", l)
    for lp in net_param.get_all("layer") or net_param.get_all("layers"):
        if lp.get_str("type") in _DATA_LAYER_TYPES:
            continue
        out.add("layer", lp.copy())
    return out
