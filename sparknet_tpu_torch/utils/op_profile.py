"""Profiler-trace aggregation: the whole step's device time attributed to
layers.

Counterpart of ``sparknet_tpu/utils/op_profile.py``.  The reference's
``caffe time`` walks the layer vector calling Forward/Backward per layer
with a cudaEvent timer (ref: caffe/tools/caffe.cpp:290-380): on the card
that times each layer alone, with its launches, not the step.  Here the
REAL step runs under ``torch.profiler`` (``utils/profiling.trace``), the
exported Chrome trace is parsed, and each kernel's time goes back to its
prototxt layer, so the per-layer table sums to the measured step.

Attribution.  The JAX package reads the ``L.<name>`` scopes the XLA
compiler writes into each device op's metadata.  A CUDA kernel record
carries no scope, so :func:`_device_events` stamps one on it (into
``args["tf_op"]``, the field the JAX parser reads) before the shared lane
policy and aggregators run:

* a kernel's ``correlation`` id leads to the host event that launched it
  (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, ...);
* a launch inside a ``record_function("L.<name>")`` range that
  ``Network.apply`` opens while a trace is on is that layer's forward:
  scope ``L.<name>``;
* a launch inside ``autograd::engine::evaluate_function: <X>Backward``
  (the autograd thread, outside every layer range) is the backward of the
  forward op with the same ``Sequence number``, which lay inside
  ``L.<name>``: scope ``transpose(jvp(L.<name>))``, the JAX autodiff
  marker, so ``aggregate_fwd_bwd`` splits forward from backward unchanged.
  The port's own ``autograd.Function``s (``LRNFunction``,
  ``FlashAttentionFunction``) are nodes like any other.

Sequence numbers are counted per forward thread; a window is expected to
run its forwards on one thread (the step's).  The lane policy and the
aggregators are the JAX module's, byte for byte, with one addition:
Kineto writes ``gpu_user_annotation`` events on the stream lanes, each
spanning the kernels of one host range; they are not device work and are
dropped (kept, the stream-lane rule would count the step twice).
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import tempfile
from collections import defaultdict

_SCOPE = re.compile(r"\bL\.([\w.\-]+)")
_BACKWARD_OP = "autograd::engine::evaluate_function: "

# the port's hand kernels by launch count (ops/kernels.py): each launch of
# a wrapper runs one kernel of every group (B3' runs three)
KERNEL_RECORDS = {
    "LRN_LAUNCHES": (("lrn_forward_kernel",),),
    "LRN_BACKWARD_LAUNCHES": (("lrn_backward_kernel",),),
    "LRN_NHWC_LAUNCHES": (("lrn_nhwc_forward_kernel",),),
    "LRN_NHWC_BACKWARD_LAUNCHES": (("lrn_nhwc_backward_kernel",),),
    "FUSED_UPDATE_LAUNCHES": (("fused_update_kernel",),),
    "FLASH_LAUNCHES": (("flash_forward_kernel", "flash_forward_wide_kernel"),),
    "FLASH_BACKWARD_LAUNCHES": (
        ("flash_backward_delta_kernel",),
        ("flash_backward_dkv_kernel", "flash_backward_dkv_wide_kernel"),
        ("flash_backward_dq_kernel", "flash_backward_dq_wide_kernel")),
    "PAGED_LAUNCHES": (("paged_attention_kernel", "paged_attention_wide_kernel"),),
}


class LostRecords(RuntimeError):
    """A profiler window holds fewer records of a hand kernel than the
    kernel was launched in it: ``short`` maps its launch count name to
    (records, launches); the window's trace stays in ``trace_dir``."""

    def __init__(self, trace_dir: str, short: dict):
        super().__init__(f"profiler window {trace_dir} lost kernel records: "
                         f"(records, launches) {short}")
        self.trace_dir = trace_dir
        self.short = short


def _kernel_group(name: str, group) -> bool:
    return any(re.search(rf"\b{k}\b", name) for k in group)


def kernel_records(events: list) -> dict[str, int]:
    """Records of each hand kernel in a window's device events (the
    ``(name|scope, us)`` pairs, or ``full=True`` dicts), by launch count
    name: the fewest records among the kernel's groups, so one record per
    launch when nothing was lost."""
    names = [e["name"] if isinstance(e, dict) else e[0].split("|", 1)[0] for e in events]
    out = {}
    for counter, groups in KERNEL_RECORDS.items():
        out[counter] = min(sum(1 for n in names if _kernel_group(n, g)) for g in groups)
    return out


def _launch_counts() -> dict[str, int]:
    from sparknet_tpu_torch.ops import kernels

    return {name: getattr(kernels, name) for name in KERNEL_RECORDS}


def _fence(out) -> None:
    """Read one value of the step's output to the host (its loss): the
    card must have run the step to hand it over."""
    import torch

    if isinstance(out, torch.Tensor):
        out.reshape(-1)[:1].cpu()
    elif isinstance(out, (tuple, list)):
        for o in reversed(out):
            if isinstance(o, (torch.Tensor, tuple, list)):
                _fence(o)
                return


def trace_step(step_fn, args, iters: int, thread_fn=None) -> dict:
    """One traced segment: run ``step_fn(*args)`` ``iters`` times under
    the profiler.  Returns {"events", "wall_step_us", "trace_dir",
    "final_args", "launches"} (``launches``: each hand kernel's launch
    count over the window, by count name).

    The caller warms the function up first (a first call's allocations and
    cuDNN's algorithm search must not land in the trace).  ``thread_fn(args,
    out) -> args`` feeds each call's output into the next call's arguments
    (a ``Solver`` threads its own state, so its step needs none).  The wall
    is fenced on the last output's value, inside the profiler.

    A window that holds fewer records of a hand kernel than its launch
    count rose by (``ops/kernels.py``) raises :class:`LostRecords`: a lost
    record would make a short table, not an error, otherwise."""
    import time

    from sparknet_tpu_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="tpunet_time_")
    before = _launch_counts()
    with profiling.trace(tmp):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = step_fn(*args)
            if thread_fn is not None:
                args = thread_fn(args, out)
        _fence(out)
        wall = (time.perf_counter() - t0) / iters
    launched = {k: n - before[k] for k, n in _launch_counts().items()}
    events = _device_events(tmp)
    if any(launched.values()):
        records = kernel_records(events)
        short = {k: (records[k], n) for k, n in launched.items() if records[k] < n}
        if short:
            raise LostRecords(tmp, short)
    return {
        "events": events,
        "wall_step_us": wall * 1e6,
        "trace_dir": tmp,
        # threaded end state, so a FOLLOW-UP traced segment can seed its
        # first call from here instead of repeating this one's
        "final_args": args,
        "launches": launched,
    }


def profile_step(step_fn, args, iters: int = 5, thread_fn=None) -> dict:
    """Warm up once (outside the trace), then one traced segment; the warm
    call's output seeds the traced segment's args through ``thread_fn``."""
    out = step_fn(*args)
    _fence(out)
    if thread_fn is not None:
        args = thread_fn(args, out)
    return trace_step(step_fn, args, iters, thread_fn=thread_fn)


class _Ranges:
    """One thread's host ranges, for "which of them holds this instant":
    sorted by start, with the running maximum of their ends so a lookup
    walks back only over ranges that can still hold it."""

    def __init__(self, ranges: list):
        ranges.sort(key=lambda r: r[0])
        self.starts = [r[0] for r in ranges]
        self.ranges = ranges
        self.reach = []
        top = float("-inf")
        for r in ranges:
            top = max(top, r[1])
            self.reach.append(top)

    def innermost(self, ts: float):
        """The latest-starting range holding ``ts`` (the innermost, ranges
        being nested), or None."""
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and self.reach[i] >= ts:
            if self.ranges[i][1] >= ts:
                return self.ranges[i]
            i -= 1
        return None


def _host_scopes(raw: list, device_pids: set) -> tuple[dict, callable]:
    """The attribution pass over one trace's host events: (correlation id
    -> scope of the host event that launched it, ``scope_at(pid, tid,
    ts)``), scopes as :func:`_device_events` stamps them."""
    layers: dict = defaultdict(list)     # (pid, tid) -> [(t0, t1, layer)]
    backward: dict = defaultdict(list)   # (pid, tid) -> [(t0, t1, seq)]
    forward_ops = []                     # (pid, tid, ts, seq)
    launches = []                        # (pid, tid, ts, correlation)
    for e in raw:
        if e.get("ph") != "X" or e.get("pid") in device_pids:
            continue
        args = e.get("args") or {}
        key = (e.get("pid"), e.get("tid"))
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur") or 0.0)
        name = e.get("name", "")
        if "correlation" in args:
            launches.append((key, ts, args["correlation"]))
        elif e.get("cat") == "user_annotation" and name.startswith("L."):
            layers[key].append((ts, end, name[2:]))
        elif name.startswith(_BACKWARD_OP) and "Sequence number" in args:
            backward[key].append((ts, end, args["Sequence number"]))
        elif "Sequence number" in args:
            forward_ops.append((key, ts, args["Sequence number"]))
    layer_ranges = {k: _Ranges(v) for k, v in layers.items()}
    backward_ranges = {k: _Ranges(v) for k, v in backward.items()}

    def layer_at(key, ts):
        r = layer_ranges[key].innermost(ts) if key in layer_ranges else None
        return r[2] if r is not None else None

    # a node's sequence number -> the layer of the forward op that made it;
    # ops that made no node peek the next number, so the LAST op to show a
    # number (the maker, or an op inside it) decides
    seq_layer: dict = {}
    for key, ts, seq in sorted(forward_ops, key=lambda f: f[1]):
        if key in backward_ranges and backward_ranges[key].innermost(ts) is not None:
            continue  # an op of a backward function, not a forward op
        seq_layer[seq] = layer_at(key, ts)

    def scope_at(key, ts) -> str:
        b = backward_ranges[key].innermost(ts) if key in backward_ranges else None
        if b is not None:
            layer = seq_layer.get(b[2]) or layer_at(key, ts)
            # a backward of ops outside every layer (the arena's unpack, the
            # loss sum) stays unattributed, in (other)'s backward column
            return f"transpose(jvp(L.{layer}))" if layer else "transpose(jvp())"
        layer = layer_at(key, ts)
        return f"L.{layer}" if layer else ""

    return {corr: scope_at(key, ts) for key, ts, corr in launches}, scope_at


def _stamp_scopes(raw: list, device_pids: set) -> None:
    """Write each correlated device event's layer scope into its
    ``args["tf_op"]`` (events that already carry one keep it)."""
    pending = [e for e in raw
               if e.get("ph") == "X" and e.get("pid") in device_pids
               and "correlation" in (e.get("args") or {})
               and "tf_op" not in e["args"]]
    if not pending:
        return
    by_corr, _ = _host_scopes(raw, device_pids)
    for e in pending:
        e["args"]["tf_op"] = by_corr.get(e["args"]["correlation"], "")


def host_ops(log_dir: str) -> list:
    """(``"<name>|<scope>"``, µs) of every host op (``cpu_op``) of the
    traces under ``log_dir``, scoped as :func:`_device_events` scopes the
    kernels they launch: what the attribution sees where there is no card
    (a CPU run launches no kernel)."""
    events = []
    for trace in _traces(log_dir):
        raw = trace.get("traceEvents", [])
        _, scope_at = _host_scopes(raw, _device_pids(raw))
        for e in raw:
            if e.get("ph") == "X" and e.get("cat") == "cpu_op" and e.get("dur"):
                scope = scope_at((e.get("pid"), e.get("tid")), float(e.get("ts", 0.0)))
                events.append((f"{e.get('name', '')}|{scope}", float(e["dur"])))
    return events


def _traces(log_dir: str):
    for path in sorted(glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                                 recursive=True)):
        with gzip.open(path, "rt") as f:
            yield json.load(f)


def _device_pids(raw: list) -> set:
    # pid -> process name; device lanes carry the op timeline.  Kineto
    # names every pid after the program and says "GPU <i>" in the pid's
    # ``process_labels``, so the labels are read too
    pnames: dict = defaultdict(str)
    for e in raw:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e.get("pid")] += e.get("args", {}).get("name", "")
        elif e.get("ph") == "M" and e.get("name") == "process_labels":
            pnames[e.get("pid")] += "|" + str(e.get("args", {}).get("labels", ""))
    return {
        pid
        for pid, name in pnames.items()
        if any(tag in name for tag in ("/device:", "TPU", "GPU", "XLA"))
        and "CUPTI" not in name
    }


def _device_events(log_dir: str, full: bool = False) -> list:
    """(op name, duration µs) complete-events from device lanes of every
    exported Chrome trace under ``log_dir``.

    ``full=True`` returns the RAW event dicts (same lane selection, scopes
    stamped), so every reader of device time (``chip_smoke.py``'s
    breakdowns among them) shares this lane policy.
    """
    events: list = []
    for trace in _traces(log_dir):
        raw = trace.get("traceEvents", [])
        device_pids = _device_pids(raw)
        _stamp_scopes(raw, device_pids)
        # A device pid exports several STACKED lanes for the same wall
        # interval — on TPU: Steps / XLA Modules / XLA Ops.  Only the
        # op-level lane carries per-op rows, so when thread names are
        # present keep just lanes that look op-level; an unnamed-lane
        # trace (CPU chrome export) passes through unfiltered.
        named_lanes: dict = {}
        for e in raw:
            if (e.get("ph") == "M" and e.get("name") == "thread_name"
                    and e.get("pid") in device_pids):
                named_lanes.setdefault(e["pid"], {})[e.get("tid")] = (
                    e.get("args", {}).get("name", "").lower())
        lane_events: dict = {}
        for e in raw:
            if e.get("ph") == "X" and e.get("pid") in named_lanes:
                key = (e["pid"], e.get("tid"))
                lane_events[key] = lane_events.get(key, 0) + 1
        # Lane policy per named device pid.  TPU xprof exports STACK
        # several views of the same wall interval (Steps / XLA Modules /
        # XLA Ops / overlays) — summing them triple-counts the step, so
        # exactly ONE lane may survive: the XLA-Ops-style lane if named,
        # else the busiest non-aggregate lane.  GPU-style exports
        # instead put CONCURRENT streams under one pid — distinct real
        # work, so dropping to one lane would undercount; there the
        # aggregate lanes are excluded by name and every stream lane
        # survives.
        AGG = ("step", "module", "overlay")
        op_tids = set()
        for pid, lanes in named_lanes.items():
            def is_ops(lname):
                return "ops" in lname and "async" not in lname
            ops_lanes = [t for t, ln in lanes.items() if is_ops(ln)]
            if ops_lanes:  # stacked-views export: ONE op lane only
                best = min(
                    ops_lanes,
                    key=lambda t: (0 if "xla" in lanes[t] else 1,
                                   -lane_events.get((pid, t), 0)))
                op_tids.add((pid, best))
                continue
            streams = [t for t, ln in lanes.items()
                       if not any(a in ln for a in AGG)
                       and "async" not in ln]
            if streams:  # stream-per-lane export: keep them all
                op_tids.update((pid, t) for t in streams)
            else:  # only aggregates named: busiest lane, counted once
                best = min(lanes,
                           key=lambda t: -lane_events.get((pid, t), 0))
                op_tids.add((pid, best))
        named_device_pids = set(named_lanes)
        for e in raw:
            if e.get("ph") != "X" or e.get("pid") not in device_pids:
                continue
            if e.get("cat") == "gpu_user_annotation":
                continue  # a host range drawn over its kernels, not device work
            if (e["pid"] in named_device_pids
                    and (e["pid"], e.get("tid")) not in op_tids):
                continue
            dur = e.get("dur")
            if not dur:
                continue
            if full:
                events.append(e)
                continue
            name = e.get("name", "")
            args = e.get("args", {})
            # both metadata fields: ``tf_op`` carries the L.<layer> scopes
            # (stamped above for a CUDA kernel), ``long_name`` whatever the
            # exporter put there
            scope = f"{args.get('tf_op', '')}|{args.get('long_name', '')}"
            events.append((f"{name}|{scope}", float(dur)))
    return events


def aggregate_by_layer(
    events: list[tuple[str, float]], iters: int
) -> tuple[dict[str, float], float]:
    """Per-layer µs/step from scoped events; unattributed time under
    '(other)'.  Returns (layer -> us, total device us/step)."""
    per_layer: dict[str, float] = defaultdict(float)
    total = 0.0
    for name, dur in events:
        total += dur
        m = _SCOPE.search(name)
        per_layer[m.group(1) if m else "(other)"] += dur
    return (
        {k: v / iters for k, v in per_layer.items()},
        total / iters,
    )


def aggregate_fwd_bwd(
    events: list[tuple[str, float]], iters: int
) -> dict[str, tuple[float, float]]:
    """Per-layer (forward µs, backward µs) per step — the reference's
    ``caffe time`` table splits each layer's Forward and Backward walls
    (ref: caffe/tools/caffe.cpp:290-380).  Backward events carry
    ``transpose(jvp(L.<name>))`` in their scope, forward events plain
    ``L.<name>``/``jvp(L.<name>)``; events spanning both count as backward
    when any transpose marker is present."""
    split: dict[str, list[float]] = defaultdict(lambda: [0.0, 0.0])
    for name, dur in events:
        m = _SCOPE.search(name)
        layer = m.group(1) if m else "(other)"
        is_bwd = "transpose(jvp(" in name
        split[layer][1 if is_bwd else 0] += dur
    return {k: (f / iters, b / iters) for k, (f, b) in split.items()}


def layer_time_table(step_fn, args, layer_names, iters: int = 5,
                     thread_fn=None) -> dict:
    """The ``tpunet time --trace`` payload: per-layer device µs/step (in
    net order, then the rest), total device time, and wall step time."""
    prof = profile_step(step_fn, args, iters, thread_fn=thread_fn)
    return table_from_trace(prof, layer_names, iters)


def table_from_trace(prof: dict, layer_names, iters: int) -> dict:
    """Aggregate one trace_step/profile_step result into the per-layer
    payload (split out so staged callers can table each segment as soon
    as it lands, before risking the next one)."""
    fwd_bwd = aggregate_fwd_bwd(prof["events"], iters)
    per_layer, device_total = aggregate_by_layer(prof["events"], iters)
    ordered: list[tuple[str, float]] = []
    for name in layer_names:
        key = name.replace("/", ".")
        if key in per_layer:
            ordered.append((name, per_layer.pop(key)))
    ordered.extend(sorted(per_layer.items(), key=lambda kv: -kv[1]))
    return {
        "rows": ordered,
        # (layer, fwd us, bwd us) in the same order — the caffe time
        # Forward/Backward split (keyed to ordered rows' names)
        "rows_fwd_bwd": [
            (name, *fwd_bwd.get(name.replace("/", "."),
                                fwd_bwd.get(name, (0.0, 0.0))))
            for name, _ in ordered
        ],
        "device_us_per_step": device_total,
        "wall_us_per_step": prof["wall_step_us"],
        "trace_dir": prof["trace_dir"],
        "attributed_frac": (
            sum(us for name, us in ordered if name != "(other)")
            / device_total
            if device_total
            else 0.0
        ),
    }
