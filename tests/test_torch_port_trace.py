"""The port's profiler (``utils/profiling.py``, ``utils/op_profile.py``)
against the JAX package's, on the CPU.

1. **Lane policy and aggregators**: on the synthetic Chrome traces of
   ``tests/test_op_profile.py`` (host-lane filter, stacked TPU lanes,
   GPU-style stream lanes) the port's ``_device_events`` and aggregators
   give the JAX results exactly.  On a Kineto-shaped trace (pids named
   after the program with ``GPU 0`` in their labels, ``stream <n>`` lanes,
   ``gpu_user_annotation`` ranges over the kernels, kernels tied to their
   launches by ``correlation``) the port's tables equal the JAX tables of
   the same kernels exported with JAX scopes: forward kernels by their
   launch's ``L.<name>`` range, backward kernels by the sequence number of
   their ``evaluate_function``, the annotations not counted.
2. **trace_step on the CPU**: over LeNet at batch 4, and over a narrow
   AlexNet whose LRNs run ``LRNFunction``'s plain path, every layer's
   forward ops land in ``L.<name>`` and its backward functions in
   ``transpose(jvp(L.<name>))``; a traced step changes no bit; a window
   whose kernel records fall short of the launch counts raises, and
   ``time --trace`` takes such a window again.
3. **profiling**: the layer scopes are on only inside ``trace``;
   ``step_span`` names a range; ``device_memory_stats`` is empty without a
   card.
"""

import contextlib
import gzip
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.utils import op_profile as jop  # noqa: E402

from sparknet_tpu_torch import layers_dsl, models  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402
from sparknet_tpu_torch.utils import op_profile, profiling  # noqa: E402

import test_op_profile as jt  # noqa: E402  (the JAX package's synthetic traces)
from test_torch_port_solver import narrow_alexnet  # noqa: E402

SYNTHETIC = {
    "host_lane_filter": lambda d: jt._write_trace(d, [
        ("fusion.1", "jit(step)/L.conv1/conv", 100.0, 7), ("python_call", "", 999.0, 1)]),
    "scopes_and_other": lambda d: jt._write_trace(d, [
        ("fusion.1", "jit(step)/L.conv1/conv_general", 100.0, 7),
        ("fusion.2", "jit(step)/L.conv1/add", 50.0, 7),
        ("fusion.3", "jit(step)/L.ip1/dot_general", 30.0, 7), ("copy.4", "", 20.0, 7)]),
    "googlenet_names": lambda d: jt._write_trace(d, [
        ("fusion.9", "jit(x)/L.inception_3a.1x1/conv", 40.0, 7)]),
    "fwd_bwd": lambda d: jt._write_trace(d, [
        ("fusion.1", "jit(step)/jvp(L.conv1)/conv_general", 100.0, 7),
        ("fusion.2", "jit(step)/transpose(jvp(L.conv1))/conv_general", 200.0, 7),
        ("fusion.3", "jit(step)/L.ip1/dot_general", 30.0, 7), ("copy.4", "", 20.0, 7)]),
    "tpu_stacked_lanes": lambda d: jt._write_tpu_style_trace(
        d, lanes={1: "Steps", 2: "XLA Modules", 3: "XLA Ops", 4: "Async XLA Ops"},
        ops=[(1, "0", "", 1000.0), (2, "jit_step(123)", "", 1000.0),
             (3, "fusion.7", "jit(step)/jvp(L.conv1)/conv_general_dilated:", 600.0),
             (3, "fusion.9", "jit(step)/transpose(jvp(L.conv1))/mul:", 300.0),
             (3, "copy.1", "", 100.0), (4, "async-copy", "", 500.0)]),
    "named_lanes_busiest": lambda d: jt._write_tpu_style_trace(
        d, lanes={1: "Steps", 2: "op timeline (v2)"},
        ops=[(1, "0", "", 1000.0), (2, "fusion.1", "jit(step)/L.fc/dot_general:", 700.0),
             (2, "fusion.2", "", 200.0), (2, "fusion.3", "", 100.0)]),
    "gpu_stream_lanes": lambda d: jt._write_tpu_style_trace(
        d, lanes={1: "Steps", 14: "Stream #14(compute)", 15: "Stream #15(memcpy)"},
        ops=[(1, "0", "", 1000.0), (14, "kern.1", "jit(step)/L.conv1/conv:", 600.0),
             (15, "memcpy.1", "", 250.0)]),
}


def _tables(events, iters=2):
    table = op_profile.table_from_trace(
        {"events": events, "wall_step_us": 1.0, "trace_dir": "t"}, ["conv1", "norm1"], iters)
    return (op_profile.aggregate_by_layer(events, iters),
            op_profile.aggregate_fwd_bwd(events, iters),
            {k: table[k] for k in ("rows", "rows_fwd_bwd", "device_us_per_step",
                                   "attributed_frac")})


def _jax_tables(events, iters=2):
    table = jop.table_from_trace(
        {"events": events, "wall_step_us": 1.0, "trace_dir": "t"}, ["conv1", "norm1"], iters)
    return (jop.aggregate_by_layer(events, iters), jop.aggregate_fwd_bwd(events, iters),
            {k: table[k] for k in ("rows", "rows_fwd_bwd", "device_us_per_step",
                                   "attributed_frac")})


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_lane_policy_and_aggregators_match_jax(case, tmp_path):
    root = SYNTHETIC[case](tmp_path)
    events = op_profile._device_events(root)
    assert events == jop._device_events(root)
    assert op_profile._device_events(root, full=True) == jop._device_events(root, full=True)
    assert _tables(events) == _jax_tables(events)


def _kineto_trace(d):
    """A trace shaped like torch.profiler's export on the card: two layers'
    forward launches on the main thread (118), their backward functions on
    the autograd thread (331), an update launched outside every op, an
    arena unpack's backward copy on a second stream, and Kineto's
    ``gpu_user_annotation`` ranges over the layers' kernels."""
    host, dev = 118, 0
    raw = [
        {"ph": "M", "name": "process_name", "pid": host, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": host, "tid": 0, "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": dev, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": dev, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": dev, "tid": 7, "args": {"name": "stream 7 "}},
        {"ph": "M", "name": "thread_name", "pid": dev, "tid": 13,
         "args": {"name": "stream 13 "}},
        {"ph": "M", "name": "thread_name", "pid": host, "tid": 331,
         "args": {"name": "thread 331 (pt_autograd_0)"}},
    ]

    def x(cat, name, pid, tid, ts, dur, **args):
        raw.append({"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
                    "dur": dur, "args": args})

    x("cpu_op", "aten::split_with_sizes", host, host, 50, 5, **{"Sequence number": 9})
    for layer, t0, op, seq, corr in (("conv1", 100, "aten::conv2d", 5, 1),
                                     ("norm1", 200, "LRNFunction", 6, 2)):
        x("user_annotation", f"L.{layer}", host, host, t0, 100)
        x("cpu_op", op, host, host, t0 + 10, 50, **{"Sequence number": seq})
        x("cuda_runtime", "cudaLaunchKernel", host, host, t0 + 20, 5, correlation=corr)
    for name, t0, seq, corr in (("LRNFunctionBackward", 500, 6, 3),
                                ("ConvolutionBackward0", 600, 5, 4),
                                ("_UnpackBackward", 700, 9, 6)):
        x("cpu_op", f"autograd::engine::evaluate_function: {name}", host, 331, t0, 50,
          **{"Sequence number": seq, "Fwd thread id": 1})
        x("cuda_runtime", "cudaMemcpyAsync" if corr == 6 else "cudaLaunchKernel", host, 331,
          t0 + 10, 5, correlation=corr)
    x("cuda_driver", "cuLaunchKernel", host, host, 900, 5, correlation=5)
    for corr, name, tid, dur in ((1, "implicit_convolve_sgemm", 7, 40.0),
                                 (2, "void lrn_forward_kernel<float, 5, true, 4>(...)", 7, 10.0),
                                 (3, "void lrn_backward_kernel<float, 5, true>(...)", 7, 15.0),
                                 (4, "dgrad_engine", 7, 80.0),
                                 (5, "void (anonymous namespace)::fused_update_kernel<float>",
                                  7, 5.0),
                                 (6, "Memcpy DtoD (Device -> Device)", 13, 7.0)):
        x("kernel" if corr != 6 else "gpu_memcpy", name, dev, tid, 1000 + corr * 100, dur,
          correlation=corr, stream=tid)
    x("gpu_user_annotation", "L.conv1", dev, 7, 1100, 45)
    x("gpu_user_annotation", "L.norm1", dev, 7, 1200, 12)
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, "runsc.118.0.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": raw}, f)
    return str(d)


def test_kineto_trace_attributes_as_the_jax_scopes(tmp_path):
    events = op_profile._device_events(_kineto_trace(tmp_path / "torch"))
    assert len(events) == 6  # the annotations are not device work
    # the same kernels as a JAX export scopes them
    root = jt._write_tpu_style_trace(
        tmp_path / "jax", lanes={7: "stream 7 ", 13: "stream 13 "},
        ops=[(7, "conv", "jit(step)/jvp(L.conv1)/conv", 40.0),
             (7, "lrn", "jit(step)/jvp(L.norm1)/lrn", 10.0),
             (7, "lrn_bwd", "jit(step)/transpose(jvp(L.norm1))/lrn", 15.0),
             (7, "dgrad", "jit(step)/transpose(jvp(L.conv1))/conv", 80.0),
             (7, "update", "", 5.0), (13, "copy", "jit(step)/transpose(jvp())", 7.0)])
    jevents = jop._device_events(root)
    assert _tables(events) == _jax_tables(jevents)
    assert _tables(events)[1] == {"conv1": (20.0, 40.0), "norm1": (5.0, 7.5),
                                  "(other)": (2.5, 3.5)}
    assert op_profile.kernel_records(events) == {
        "LRN_LAUNCHES": 1, "LRN_BACKWARD_LAUNCHES": 1, "LRN_NHWC_LAUNCHES": 0,
        "LRN_NHWC_BACKWARD_LAUNCHES": 0, "FUSED_UPDATE_LAUNCHES": 1,
        "FLASH_LAUNCHES": 0, "FLASH_BACKWARD_LAUNCHES": 0, "PAGED_LAUNCHES": 0}
    # the JAX parser reads no device lane there: Kineto names the card's pid
    # after the program
    assert jop._device_events(str(tmp_path / "torch")) == []


def _lenet_feeds(s, batch, rs, shape=(1, 28, 28)):
    return s._feeds_on_device({"data": rs.rand(batch, *shape).astype("f4") * 255,
                               "label": rs.randint(0, 10, batch).astype("f4")})


@pytest.mark.parametrize("net", ["lenet", "narrow_alexnet"])
def test_trace_step_attributes_forward_and_backward_by_layer(net):
    if net == "lenet":
        s = Solver(models.lenet_solver(), models.lenet(4), device="cpu")
        feeds = _lenet_feeds(s, 4, np.random.RandomState(0))
    else:
        s = Solver(models.lenet_solver(), narrow_alexnet(layers_dsl, batch=2), device="cpu")
        feeds = _lenet_feeds(s, 2, np.random.RandomState(0), (3, 67, 67))
    kernels.reset_launch_counts()
    prof = op_profile.profile_step(lambda f: s.train_iteration(f), (feeds,), iters=2)
    assert prof["events"] == [] and prof["wall_step_us"] > 0  # no card: no kernel
    assert not any(prof["launches"].values())
    ops = [(name.split("|", 1), us) for name, us in op_profile.host_ops(prof["trace_dir"])]
    fwd = {scope for (_, scope), _ in ops if scope.startswith("L.")}
    bwd = {scope for (op, scope), _ in ops
           if op.startswith("autograd::engine::evaluate_function: ") and scope}
    weighted = [layer.name for layer in s.train_net.layers if s.train_net.layer_params(
        layer.name, s.variables.params)]
    for name in weighted:
        assert f"L.{name}" in fwd and f"transpose(jvp(L.{name}))" in bwd, name
    by_op = {}
    for (op, scope), _ in ops:
        by_op.setdefault(op, set()).add(scope)
    if net == "narrow_alexnet":
        assert by_op["autograd::engine::evaluate_function: LRNFunctionBackward"] == {
            "transpose(jvp(L.norm1))", "transpose(jvp(L.norm2))"}
    else:
        assert by_op["autograd::engine::evaluate_function: ConvolutionBackward0"] == {
            "transpose(jvp(L.conv1))", "transpose(jvp(L.conv2))"}
    split = op_profile.aggregate_fwd_bwd([(f"{op}|{scope}", us) for (op, scope), us in ops],
                                         iters=2)
    assert all(split[name][0] > 0 and split[name][1] > 0 for name in weighted)


def test_a_traced_step_changes_no_bit():
    got = []
    for traced in (False, True):
        s = Solver(models.lenet_solver(), models.lenet(4), device="cpu")
        feeds = _lenet_feeds(s, 4, np.random.RandomState(1))
        with profiling.trace(tempfile.mkdtemp()) if traced else contextlib.nullcontext():
            assert profiling.layer_scopes() == traced
            loss = s.train_iteration(feeds)
        got.append((float(loss), {k: [p.clone() for p in v]
                                  for k, v in s.variables.params.items()}))
    assert got[0][0] == got[1][0]
    assert all(torch.equal(a, b) for k in got[0][1] for a, b in zip(got[0][1][k], got[1][1][k]))
    assert not profiling.layer_scopes()


def test_a_window_short_of_its_launches_raises(monkeypatch):
    """A launch the trace holds no record of (as when the profiler drops a
    kernel's record) is an error, not a short table."""
    def step():
        kernels._count("LRN_LAUNCHES")
        return torch.zeros(())

    with pytest.raises(op_profile.LostRecords) as e:
        op_profile.trace_step(step, (), iters=2)
    assert e.value.short == {"LRN_LAUNCHES": (0, 2)}
    assert os.path.isdir(e.value.trace_dir)


def test_time_trace_takes_a_lost_window_again(tmp_path, monkeypatch, capsys):
    """``time --trace`` discards a window that lost hand-kernel records and
    traces it again (the artifact counts it); one that keeps losing them
    is an error, never a short table."""
    from sparknet_tpu_torch import cli

    real, calls = op_profile.trace_step, []

    def flaky(*args, **kwargs):
        calls.append(kwargs["iters"])
        if len(calls) == 1:
            raise op_profile.LostRecords("w", {"LRN_LAUNCHES": (0, 2)})
        return real(*args, **kwargs)

    monkeypatch.setattr(op_profile, "trace_step", flaky)
    out = str(tmp_path / "t.json")
    argv = ["time", "--trace", "--device", "cpu", "--solver", "zoo:lenet", "--batch", "2",
            "--iterations", "2", "--trace-out", out]
    assert cli.main(argv) == 0
    art = json.load(open(out))
    assert calls == [1, 1, 2] and art["windows_discarded"] == {"short": 1}

    def lost(*args, **kwargs):
        raise op_profile.LostRecords("w", {"LRN_LAUNCHES": (0, 2)})

    monkeypatch.setattr(op_profile, "trace_step", lost)
    with pytest.raises(op_profile.LostRecords):
        cli.main(argv)
    assert "taking the window again" in capsys.readouterr().err


def test_step_span_and_memory_stats(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.step_span("round", 3):
            torch.ones(4).sum()
    (trace,) = op_profile._traces(str(tmp_path))
    assert any(e.get("name") == "round#3" and e.get("cat") == "user_annotation"
               for e in trace["traceEvents"])
    assert profiling.device_memory_stats() == {}
