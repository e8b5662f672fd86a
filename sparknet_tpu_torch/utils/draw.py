"""Network visualization: NetParameter -> Graphviz DOT.

Counterpart of ``sparknet_tpu/utils/draw.py``; the phase filter is the
port's ``compiler.graph.filter_phase``.

ref: caffe/python/caffe/draw.py (get_layer_label :53, choose_color_by_layertype
:108, get_pydot_graph :121, draw_net_to_file :198) and the
``python/draw_net.py`` CLI.  Emits DOT source text directly — no pydot /
graphviz dependency; render with ``dot -Tpng net.dot`` wherever graphviz
exists.  Blob (top) nodes are octagons, layer nodes are colored boxes, and
in-place layers are folded onto their blob exactly like the reference
(draw.py:143-151).
"""

from __future__ import annotations

from sparknet_tpu_torch.proto.text_format import Message

# ref draw.py:108-119
_COLORS = {
    "Convolution": "#FF5050",
    "Deconvolution": "#FF5050",
    "Pooling": "#FF9900",
    "InnerProduct": "#CC33FF",
}
_DEFAULT_COLOR = "#6495ED"


def _first_int(p: Message, name: str, default: int) -> int:
    vals = p.get_all(name)
    return int(vals[0]) if vals else default


def get_layer_label(layer: Message, rankdir: str = "LR") -> str:
    """Node label: name, type, and conv/pool geometry (ref draw.py:53-105)."""
    sep = " " if rankdir in ("TB", "BT") else "\\n"
    name = layer.get_str("name")
    ltype = layer.get_str("type")
    if ltype in ("Convolution", "Deconvolution"):
        p = layer.get_msg("convolution_param")
        return (
            f"{name}{sep}({ltype}){sep}"
            f"kernel size: {_first_int(p, 'kernel_size', 1)}{sep}"
            f"stride: {_first_int(p, 'stride', 1)}{sep}"
            f"pad: {_first_int(p, 'pad', 0)}"
        )
    if ltype == "Pooling":
        p = layer.get_msg("pooling_param")
        return (
            f"{name}{sep}({p.get_str('pool', 'MAX')} {ltype}){sep}"
            f"kernel size: {_first_int(p, 'kernel_size', 1)}{sep}"
            f"stride: {_first_int(p, 'stride', 1)}{sep}"
            f"pad: {_first_int(p, 'pad', 0)}"
        )
    return f"{name}{sep}({ltype})"


def get_edge_label(layer: Message) -> str:
    """Edge label from layer type (ref draw.py:37-50)."""
    ltype = layer.get_str("type")
    if ltype == "Data":
        return "Batch " + str(layer.get_msg("data_param").get_int("batch_size", 0))
    if ltype in ("Convolution", "Deconvolution"):
        return str(layer.get_msg("convolution_param").get_int("num_output", 0))
    if ltype == "InnerProduct":
        return str(layer.get_msg("inner_product_param").get_int("num_output", 0))
    return ""


def _q(s: str) -> str:
    return '"' + s.replace('"', r"\"") + '"'


def net_to_dot(
    net_param: Message,
    rankdir: str = "LR",
    label_edges: bool = True,
    phase: str | None = None,
) -> str:
    """Build Graphviz DOT source for a NetParameter (ref draw.py:121-177).

    ``phase``: optionally pre-filter by "TRAIN"/"TEST" include/exclude rules
    (the reference filters with the ``--phase`` flag of draw_net.py).
    """
    layers = [m for m in net_param.get_all("layer")]
    if phase is not None:
        from sparknet_tpu_torch.common import Phase
        from sparknet_tpu_torch.compiler.graph import filter_phase

        layers = filter_phase(net_param, Phase[phase.upper()])

    lines = [
        "digraph " + _q(net_param.get_str("name", "Net")) + " {",
        f"  rankdir={rankdir};",
        '  node [fontsize=10, height=0.2, width=0.2];',
    ]
    blob_nodes: set[str] = set()
    # in-place layers (top == bottom) emit no box: their name/type fold into
    # the blob's label (ref draw.py:143-151)
    blob_annotations: dict[str, list[str]] = {}
    edges: list[str] = []

    for layer in layers:
        name = layer.get_str("name")
        ltype = layer.get_str("type")
        bottoms = [str(b) for b in layer.get_all("bottom")]
        tops = [str(t) for t in layer.get_all("top")]
        if len(tops) == 1 and tops == bottoms:
            blob_nodes.add(tops[0])
            blob_annotations.setdefault(tops[0], []).append(f"{name} ({ltype})")
            continue
        node = f"layer_{name}"
        color = _COLORS.get(ltype, _DEFAULT_COLOR)
        lines.append(
            f"  {_q(node)} [label={_q(get_layer_label(layer, rankdir))}, "
            f'shape=box, style=filled, fillcolor="{color}"];'
        )
        for b in bottoms:
            blob_nodes.add(b)
            edges.append(f"  {_q('blob_' + b)} -> {_q(node)};")
        for t in tops:
            if t in bottoms:
                continue  # multi-top partial in-place: keep the box, no self-edge
            blob_nodes.add(t)
            lab = get_edge_label(layer) if label_edges else ""
            attr = f" [label={_q(lab)}]" if lab else ""
            edges.append(f"  {_q(node)} -> {_q('blob_' + t)}{attr};")

    for b in sorted(blob_nodes):
        label = "\\n".join([b] + blob_annotations.get(b, []))
        lines.append(
            f"  {_q('blob_' + b)} [label={_q(label)}, shape=octagon, "
            'style=filled, fillcolor="#E0E0E0"];'
        )
    lines.extend(edges)
    lines.append("}")
    return "\n".join(lines) + "\n"


def draw_net_to_file(
    net_param: Message,
    filename: str,
    rankdir: str = "LR",
    label_edges: bool = True,
    phase: str | None = None,
) -> None:
    """Write DOT source to ``filename`` (ref draw.py:198-211; rendering to
    png is delegated to an external ``dot`` binary, which this image lacks)."""
    with open(filename, "w") as f:
        f.write(net_to_dot(net_param, rankdir, label_edges, phase))
