"""Training-log charts — the reference's plot tooling.

Copy of ``sparknet_tpu/utils/plotting.py``; matplotlib is imported in the
call, so the module loads without it.

Equivalent of caffe/tools/extra/plot_training_log.py.example: pick a
chart type 0-7, parse the log, write a PNG.  Built on
`utils.log_parse` instead of re-grepping the log.

One metric per chart (one axis, one series — the reference's types are
already shaped that way); recessive grid; the title names the series so
no legend is needed.
"""

from __future__ import annotations

from sparknet_tpu_torch.utils.log_parse import parse_log

# (name, table, x column, y column)
CHART_TYPES: dict[int, tuple[str, str, str, str]] = {
    0: ("Test accuracy vs. Iters", "test", "NumIters", "accuracy"),
    1: ("Test accuracy vs. Seconds", "test", "Seconds", "accuracy"),
    2: ("Test loss vs. Iters", "test", "NumIters", "loss"),
    3: ("Test loss vs. Seconds", "test", "Seconds", "loss"),
    4: ("Train learning rate vs. Iters", "train", "NumIters", "LearningRate"),
    5: ("Train learning rate vs. Seconds", "train", "Seconds", "LearningRate"),
    6: ("Train loss vs. Iters", "train", "NumIters", "loss"),
    7: ("Train loss vs. Seconds", "train", "Seconds", "loss"),
}

_SERIES = "#2a78d6"  # categorical slot 1
_GRID = "#d9d8d4"
_TEXT = "#0b0b0b"
_MUTED = "#52514e"


def plot_chart(chart_type: int, log_path: str, out_path: str) -> str:
    """Render one chart type from a training log to ``out_path`` (PNG).

    Raises ValueError for unknown chart types or when the log has no
    rows for the requested table/columns (e.g. asking for test accuracy
    from a log with no eval lines).
    """
    if chart_type not in CHART_TYPES:
        known = "; ".join(f"{k}: {v[0]}" for k, v in CHART_TYPES.items())
        raise ValueError(f"unknown chart type {chart_type}; {known}")
    title, table, xcol, ycol = CHART_TYPES[chart_type]
    train_rows, test_rows = parse_log(log_path)
    rows = train_rows if table == "train" else test_rows
    pts = [
        (float(r[xcol]), float(r[ycol]))
        for r in rows
        if xcol in r and ycol in r
    ]
    if not pts:
        raise ValueError(
            f"log {log_path!r} has no ({xcol}, {ycol}) {table}-table rows "
            f"for chart {chart_type} ({title})"
        )
    pts.sort()

    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "plot_training_log needs matplotlib"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=120)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    xs, ys = zip(*pts)
    ax.plot(xs, ys, color=_SERIES, linewidth=2)
    ax.set_title(title, color=_TEXT, fontsize=12, loc="left")
    ax.set_xlabel(xcol if xcol != "NumIters" else "Iterations", color=_MUTED)
    ax.set_ylabel(ycol, color=_MUTED)
    ax.grid(True, color=_GRID, linewidth=0.6)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(_GRID)
    ax.tick_params(colors=_MUTED, labelsize=9)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
