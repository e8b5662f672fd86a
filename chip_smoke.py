#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sparknet_tpu_torch``) on one GPU.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: every kernel of ``sparknet_tpu_torch/csrc`` with ``nvcc``;
3. kernel: the LRN kernel against its plain PyTorch version at the serving
   path's shapes (AlexNet and CaffeNet norm1/norm2 at batch 256) and at
   ragged ones, in float32 (rtol 1e-5, atol 1e-6) and bfloat16 (one bf16
   ulp of the float32 result cast to bfloat16); CUDA-event times of the
   kernel, the plain version and ``F.local_response_norm`` (a yardstick the
   port never calls) beside the least time the card could take;
4. path: the zoo AlexNet at batch 256, 227x227, TEST phase, with data and
   label feeds: 2 kernel launches per forward, a finite loss, ``fc8``
   equal to the same forward with the plain LRN, and img/s;
5. serve: a ``Classifier`` on the published CaffeNet deploy net answers 4
   image requests (10-crop each): probabilities of shape (4, 1000) whose
   rows sum to 1, 2 launches per forward, per-request latency;
6. profile: the device time of one AlexNet forward by kernel
   (``torch.profiler``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and runs nothing.  Weights are random, drawn from a fixed seed.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
F32_TOL = dict(rtol=1e-5, atol=1e-6)
REPS = 25

# The serving path's LRN calls: AlexNet and CaffeNet norm1/norm2 at b256
# (size 5, alpha 1e-4, beta 0.75, k 1), then ragged cases.
MAIN_CASES = [
    ("alexnet.norm1", (256, 96, 55, 55)),
    ("alexnet.norm2", (256, 256, 27, 27)),
    ("caffenet.norm1", (256, 96, 27, 27)),
    ("caffenet.norm2", (256, 256, 13, 13)),
]
RAGGED_CASES = [  # (label, shape, size, beta, k)
    ("c_lt_size", (4, 2, 17, 19), 5, 0.75, 1.0),
    ("c3_odd_hw", (4, 3, 31, 29), 5, 0.75, 1.0),
    ("hw1", (8, 64, 1, 1), 5, 0.75, 1.0),
    ("size3", (2, 32, 13, 13), 3, 0.75, 1.0),
    ("beta0.6_k2", (2, 32, 13, 13), 5, 0.6, 2.0),
]
ALPHA = 1e-4

# (memory bytes/s, float32 FLOP/s outside the tensor cores) by card, from
# NVIDIA's H100 data sheet; the first name that matches wins.
CARD_PEAKS = [
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
]

# bvlc_reference_caffenet/deploy.prototxt: the layers of zoo.caffenet with
# a 10x3x227x227 net input and a Softmax "prob" head.
CAFFENET_DEPLOY = """
name: "CaffeNet"
input: "data"
input_dim: 10 input_dim: 3 input_dim: 227 input_dim: 227
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 96 kernel_size: 11 stride: 4 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
  convolution_param { num_output: 256 pad: 2 kernel_size: 5 group: 2 } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm2" type: "LRN" bottom: "pool2" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "conv3" type: "Convolution" bottom: "norm2" top: "conv3"
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 } }
layer { name: "relu3" type: "ReLU" bottom: "conv3" top: "conv3" }
layer { name: "conv4" type: "Convolution" bottom: "conv3" top: "conv4"
  convolution_param { num_output: 384 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu4" type: "ReLU" bottom: "conv4" top: "conv4" }
layer { name: "conv5" type: "Convolution" bottom: "conv4" top: "conv5"
  convolution_param { num_output: 256 pad: 1 kernel_size: 3 group: 2 } }
layer { name: "relu5" type: "ReLU" bottom: "conv5" top: "conv5" }
layer { name: "pool5" type: "Pooling" bottom: "conv5" top: "pool5"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "fc6" type: "InnerProduct" bottom: "pool5" top: "fc6"
  inner_product_param { num_output: 4096 } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc7" type: "InnerProduct" bottom: "fc6" top: "fc7"
  inner_product_param { num_output: 4096 } }
layer { name: "relu7" type: "ReLU" bottom: "fc7" top: "fc7" }
layer { name: "drop7" type: "Dropout" bottom: "fc7" top: "fc7"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc8" type: "InnerProduct" bottom: "fc7" top: "fc8"
  inner_product_param { num_output: 1000 } }
layer { name: "prob" type: "Softmax" bottom: "fc8" top: "prob" }
"""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int = REPS, inner: int = 10, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: the median over ``reps`` samples, each
    CUDA events around ``inner`` back-to-back calls (so the card does not
    wait on the host between launches), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def card_peaks(name: str) -> tuple[float, float]:
    for key, bw, flops in CARD_PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peaks for card {name!r}")


def lrn_bound_ms(shape, size: int, itemsize: int, name: str) -> tuple[float, str]:
    """Least time for one LRN forward: each input byte read once and each
    output byte written once over the memory rate, or its float32
    operations (per element: 1 square, size-1 adds, 2 for the scale, 4 for
    scale^-0.75, 1 for x*scale^-beta) over the float32 rate."""
    bw, flops = card_peaks(name)
    n = int(np.prod(shape))
    t_bytes = 2 * n * itemsize / bw * 1e3
    t_ops = n * (size + 7) / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each element of ``ref`` (8 significant bits)."""
    _, exp = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)


def forward_with_plain_lrn(net, variables, feeds):
    """The net's forward with every cross-channel LRN layer run by the plain
    PyTorch version: the layers between LRNs run through ``Network.apply``'s
    partial execution (start/end), the LRNs themselves in between."""
    from sparknet_tpu_torch.ops.kernels import lrn_across_channels_torch

    names = [l.name for l in net.layers]
    blobs = dict(feeds)
    lo = 0
    for i, layer in enumerate(net.layers):
        if layer.type != "LRN":
            continue
        if i > lo:
            blobs.update(net.apply(variables, blobs, start=names[lo] if lo else None,
                                   end=names[i - 1])[0])
        p = layer.lp.get_msg("lrn_param")
        blobs[layer.tops[0]] = lrn_across_channels_torch(
            blobs[layer.bottoms[0]], p.get_int("local_size", 5),
            p.get_float("alpha", 1.0), p.get_float("beta", 0.75),
            p.get_float("k", 1.0))
        lo = i + 1
    out, _, loss = net.apply(variables, blobs, start=names[lo] if lo else None)
    blobs.update(out)
    return blobs, loss


def device_breakdown(fn, top: int = 8) -> tuple[float, list]:
    """Device time of one call of ``fn`` under ``torch.profiler``: (total
    kernel ms, [(ms, kernel name, calls)] of the ``top`` kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:top]


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    from sparknet_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    logs = kernels.build_libraries()
    print(f"build: {sorted(logs) or 'all cached'} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        print(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, {spills} bytes of spills")


def phase_kernel(card: str) -> dict:
    """Kernel vs plain at every case; times at the main shapes."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    max_err_f32 = 0.0
    cases = [(lab, shp, 5, 0.75, 1.0) for lab, shp in MAIN_CASES] + RAGGED_CASES
    for label, shape, size, beta, k in cases:
        # raw-pixel-scale activations, as after a ReLU in the zoo nets
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        ref = kernels.lrn_across_channels_torch(x, size, ALPHA, beta, k)
        y = kernels.lrn_across_channels(x, size, ALPHA, beta, k)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        ok = bool((err <= F32_TOL["atol"] + F32_TOL["rtol"] * ref.abs()).all())
        max_err_f32 = max(max_err_f32, float(err.max()))
        print(f"kernel {label} {list(shape)} size {size} beta {beta} f32: "
              f"max abs err {float(err.max()):.3e} (rtol 1e-5, atol 1e-6) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"lrn f32 {label}")
        xb = x.to(torch.bfloat16)
        refb = kernels.lrn_across_channels_torch(xb.float(), size, ALPHA, beta, k)
        refb = refb.to(torch.bfloat16).float()
        yb = kernels.lrn_across_channels(xb, size, ALPHA, beta, k).float()
        torch.cuda.synchronize()
        errb = (yb - refb).abs()
        okb = bool((errb <= bf16_ulp(refb)).all())
        print(f"kernel {label} {list(shape)} bf16: max abs err "
              f"{float(errb.max()):.3e}, max err in ulps "
              f"{float((errb / bf16_ulp(refb)).max()):.2f} (tolerance 1 bf16 ulp) "
              f"{'ok' if okb else 'FAIL'}")
        check(okb, f"lrn bf16 {label}")

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for label, shape in MAIN_CASES:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        t_k = time_ms(lambda: kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0))
        t_p = time_ms(lambda: kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0))
        t_l = time_ms(lambda: F.local_response_norm(x, 5, ALPHA, 0.75, 1.0))
        xb = x.to(torch.bfloat16)
        t_kb = time_ms(lambda: kernels.lrn_across_channels(xb, 5, ALPHA, 0.75, 1.0))
        bound, by = lrn_bound_ms(shape, 5, 4, card)
        bound_b, _ = lrn_bound_ms(shape, 5, 2, card)
        gbs = 2 * x.numel() * 4 / (t_k * 1e-3) / 1e9
        print(f"time {label} {list(shape)} f32: kernel {t_k:.4f} ms "
              f"({gbs:.0f} GB/s, {100 * bound / t_k:.1f}% of bound), plain "
              f"{t_p:.4f} ms, F.local_response_norm {t_l:.4f} ms, bound "
              f"{bound:.4f} ms ({by}); bf16 kernel {t_kb:.4f} ms (bound "
              f"{bound_b:.4f} ms) [{card}]")
        if label.startswith("alexnet"):
            totals["ms"] += t_k
            totals["plain_ms"] += t_p
            totals["library_ms"] += t_l
            totals["bound_ms"] += bound
            bound_by.add(by)
    check(len(bound_by) == 1, f"AlexNet LRN calls bound by {bound_by}")
    return dict(max_abs_err=max_err_f32, bound_by=bound_by.pop(), **totals)


def phase_path(card: str):
    """AlexNet b256 TEST forward through the port's Network.  Returns the
    LRN launches, the forward as a callable and its ms per forward."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.ops import kernels

    batch = 256
    net = Network(models.alexnet(batch), Phase.TEST)
    variables = net.init(torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feeds = {
        "data": torch.randn((batch, 3, 227, 227), generator=gen, device="cuda") * 50,
        "label": torch.randint(0, 1000, (batch,), generator=gen, device="cuda",
                               dtype=torch.int32),
    }
    forwards = 5
    with torch.inference_mode():
        net.apply(variables, feeds)  # warm-up: cuDNN/cuBLAS set-up
        torch.cuda.synchronize()
        kernels.LRN_LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(forwards):
            blobs, _, loss = net.apply(variables, feeds)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernels.LRN_LAUNCHES
        ref_blobs, ref_loss = forward_with_plain_lrn(net, variables, feeds)
    check(launches == 2 * forwards,
          f"AlexNet LRN launches {launches}, want {2 * forwards}")
    check(bool(torch.isfinite(loss)), f"AlexNet loss {float(loss)}")
    fc8, ref = blobs["fc8"], ref_blobs["fc8"]
    check(tuple(fc8.shape) == (batch, 1000), f"fc8 shape {tuple(fc8.shape)}")
    err = float((fc8 - ref).abs().max())
    check(torch.allclose(fc8, ref, rtol=1e-4, atol=1e-4),
          f"fc8 vs plain-LRN forward, max abs err {err:.3e}")
    print(f"path: AlexNet b{batch} TEST forward x{forwards}: loss "
          f"{float(loss):.6f} (plain-LRN forward {float(ref_loss):.6f}), fc8 "
          f"max abs err vs plain-LRN forward {err:.3e} (rtol/atol 1e-4), LRN "
          f"launches {launches} ({launches // forwards} per forward), "
          f"{batch * forwards / dt:.1f} img/s, {1e3 * dt / forwards:.2f} ms/forward "
          f"[{card}]")
    return launches, lambda: net.apply(variables, feeds), 1e3 * dt / forwards


def phase_profile(card: str, forward, ms_per_forward: float) -> None:
    """Where one AlexNet b256 forward's device time goes; run last, so the
    profiler cannot slow the timed phases."""
    with torch.inference_mode():
        device_ms, rows = device_breakdown(forward)
    if device_ms == 0.0:
        print("profile: torch.profiler recorded no device time")
        return
    print(f"profile: one AlexNet b256 forward under torch.profiler: "
          f"{device_ms:.3f} ms of kernels, {100 * device_ms / ms_per_forward:.1f}% "
          f"of the unprofiled {ms_per_forward:.2f} ms/forward [{card}]")
    for ms, name, calls in rows:
        print(f"  {ms:8.3f} ms  {100 * ms / device_ms:5.1f}%  x{calls}  {name[:90]}")


def phase_serve(card: str) -> int:
    """A Classifier on the CaffeNet deploy net answers 4 image requests."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.proto import parse

    clf = models.Classifier(parse(CAFFENET_DEPLOY), image_dims=(256, 256),
                            mean=np.array([104.0, 117.0, 123.0], np.float32),
                            raw_scale=255.0, channel_swap=(2, 1, 0))
    # the deploy net names no fillers: draw its weights with the published
    # train_val fillers of zoo.caffenet (same layer names and shapes)
    clf.variables = Network(models.caffenet(10), Phase.TEST).init(
        torch.Generator().manual_seed(SEED))
    rs = np.random.RandomState(SEED)
    images = [rs.rand(320, 480, 3).astype(np.float32) for _ in range(4)]
    clf.predict(images[:1])  # warm-up
    torch.cuda.synchronize()
    kernels.LRN_LAUNCHES = 0
    probs, lat, prep = [], [], []
    for im in images:
        # Classifier.predict, split at its two halves to time each
        t0 = time.perf_counter()
        blobs = clf.preprocess_images([im], oversample=True)
        t1 = time.perf_counter()
        probs.append(clf.predict_blobs(blobs, oversample=True)[0])
        lat.append(1e3 * (time.perf_counter() - t0))
        prep.append(1e3 * (t1 - t0))
    launches = kernels.LRN_LAUNCHES
    probs = np.stack(probs)
    forwards = len(images)  # 10 crops = one batch-10 forward per request
    check(launches == 2 * forwards, f"CaffeNet LRN launches {launches}, want {2 * forwards}")
    check(probs.shape == (4, 1000), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(np.allclose(probs.sum(1), 1.0, atol=1e-4)), f"row sums {probs.sum(1)}")
    with torch.inference_mode():
        blobs = clf.preprocess_images(images[:1], oversample=True)
        ref = forward_with_plain_lrn(clf.network, clf.variables,
                                     {"data": torch.from_numpy(blobs).cuda()})[0]
    ref_prob = ref["prob"].cpu().numpy().mean(axis=0)
    err = float(np.abs(probs[0] - ref_prob).max())
    check(bool(np.allclose(probs[0], ref_prob, rtol=1e-4, atol=1e-6)),
          f"request 0 vs plain-LRN forward, max abs err {err:.3e}")
    print(f"serve: CaffeNet Classifier, 4 requests x 10 crops: probs "
          f"{probs.shape}, row sums within 1e-4 of 1, top-1 "
          f"{probs.argmax(1).tolist()}, request 0 vs plain-LRN forward max abs "
          f"err {err:.3e}, LRN launches {launches} ({launches // forwards} per "
          f"forward), latency ms per request "
          f"{[round(t, 2) for t in lat]} (median {float(np.median(lat)):.2f}), of "
          f"which host preprocessing {[round(t, 2) for t in prep]} (median "
          f"{float(np.median(prep)):.2f}) [{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test runs "
              "only on a GPU", file=sys.stderr)
        return 2
    import sparknet_tpu_torch  # noqa: F401  (fails here outside a checkout)

    card = phase_card()
    phase_build()
    stats = phase_kernel(card)
    path_launches, forward, ms_per_forward = phase_path(card)
    launches = path_launches + phase_serve(card)
    phase_profile(card, forward, ms_per_forward)
    kernel_line = {
        "name": "lrn_across_channels",
        "route": "cuda",
        "source": "sparknet_tpu_torch/csrc/lrn.cu",
        "replaces": "sparknet_tpu/ops/pallas_kernels.py:40",
        "launches": launches,
        # times and bound: one AlexNet b256 forward's two calls (norm1 +
        # norm2), float32; max_abs_err: the largest over every f32 case
        "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"],
        "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"],
        "bound_by": stats["bound_by"],
        "library_ms": stats["library_ms"],
    }
    print(json.dumps({"kernels": [kernel_line]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
