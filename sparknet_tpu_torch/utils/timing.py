"""Timing utilities: a device-fenced timer and the per-layer cost table.

Counterpart of ``sparknet_tpu/utils/timing.py``: Caffe's cudaEvent
``Timer`` (ref: caffe/src/caffe/util/benchmark.cpp:18-82) and the ``caffe
time`` brew's per-layer forward/backward loop (ref:
caffe/tools/caffe.cpp:290-380).  On the card a :class:`Timer` reads CUDA
events recorded on the current stream around the timed calls; on the CPU
it reads the host clock.  Layers run one at a time, eagerly, so the table
is a diagnostic: the whole step (``tpunet time --fused``) overlaps what
the table times apart.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sparknet_tpu_torch.common import f32_precision

__all__ = ["Timer", "time_layers"]


class Timer:
    """start/stop timer of the work issued on ``device`` in between: CUDA
    events on a CUDA device (``stop`` waits for the stop event), the host
    clock on the CPU."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.elapsed_ms = 0.0
        self._t0 = None

    def start(self) -> "Timer":
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.elapsed_ms = self._t0.elapsed_time(end)
        else:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return self.elapsed_ms


def _timed_ms(fn, device, iterations: int) -> float:
    fn()  # warm-up (cuDNN's algorithm choice, first allocations)
    t = Timer(device).start()
    for _ in range(iterations):
        fn()
    return t.stop() / iterations


def time_layers(network, variables, feeds, iterations: int = 10) -> list[dict]:
    """Per-layer forward and backward timing (the ``caffe time`` table) of
    a TRAIN-phase ``Network``: [{layer, type, forward_ms, backward_ms}],
    the JAX function's layers in its order.  The backward is the gradient
    of the sum of the layer's outputs w.r.t. its params and its floating
    inputs, forward included; ``None`` where no output of the layer carries
    a gradient.  A backward that fails raises."""
    device = network.device
    gen = torch.Generator(device=device).manual_seed(0)
    blobs = {k: torch.as_tensor(v, device=device) for k, v in feeds.items()}
    rows: list[dict] = []
    for layer in network.layers:
        if not layer.bottoms and all(t in blobs for t in layer.tops):
            continue  # an input layer: its tops are the feeds
        params = network.layer_params(layer.name, variables.params)
        state = variables.state.get(layer.name, {})
        inputs = [blobs[b] for b in layer.bottoms]
        kwargs = {"gen": gen} if layer.NEEDS_GEN else {}

        def fwd():
            with torch.no_grad(), f32_precision():
                return layer.apply(params, state, inputs, train=True, **kwargs).outputs

        tops = fwd()
        fwd_ms = _timed_ms(fwd, device, iterations)

        float_idx = [i for i, x in enumerate(inputs) if x.is_floating_point()]
        bwd_ms = None
        if float_idx:
            leaves = [p.detach().requires_grad_(True) for p in params]
            full = list(inputs)
            for i in float_idx:
                full[i] = inputs[i].detach().requires_grad_(True)
            wrt = leaves + [full[i] for i in float_idx]

            def bwd():
                with f32_precision():
                    outs = layer.apply(leaves, state, full, train=True, **kwargs).outputs
                    total = sum(o.sum() for o in outs if o.requires_grad)
                    return torch.autograd.grad(total, wrt, allow_unused=True)

            with f32_precision():
                probe = layer.apply(leaves, state, full, train=True, **kwargs).outputs
            # Accuracy, ArgMax, ...: no output carries a gradient.  Any
            # other failure of the backward is the layer's and propagates.
            if any(o.requires_grad for o in probe):
                bwd_ms = _timed_ms(bwd, device, iterations)
            del probe

        for name, top in zip(layer.tops, tops):
            blobs[name] = top
        rows.append({
            "layer": layer.name,
            "type": layer.TYPE,
            "forward_ms": round(fwd_ms, 3),
            "backward_ms": None if bwd_ms is None or np.isnan(bwd_ms) else round(bwd_ms, 3),
        })
    return rows
