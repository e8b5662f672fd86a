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
   (``torch.profiler``);
7. lrn backward kernel: against ``lrn_backward_torch`` at the four b256
   shapes and the ragged ones, f32 (rtol 1e-5, atol 1e-6) and bf16 (one
   bf16 ulp), inputs ``relu(randn*50)`` and ``g = randn``; times beside
   the bound and the autograd backward of ``F.local_response_norm``;
8. train: a port ``Solver`` with ``fused_update`` on trains the zoo AlexNet
   (``alexnet_solver``: SGD, momentum 0.9, weight decay 5e-4, step policy)
   at batch 256, 227x227, dropout on, on one fixed random batch: 1
   warm-up step and 10 timed ones, each with 2 LRN forward, 2 LRN
   backward and 1 fused-update launches and a finite loss, a non-zero
   ``conv1`` weight gradient; then one CaffeNet b256 step with the same
   checks;
9. fused update kernel: against ``fused_update_torch`` on the AlexNet
   arena geometry (the train phase's layout), all six rules x f32/bf16
   storage x L1/L2 x clip on/off x iter_size 1/2: SGD and Nesterov in f32
   bitwise, the others within one float32 ulp (``UPDATE_F32_ULPS``), bf16
   within one bf16 ulp; pad zones stay 0, w and the slots keep their
   storage (in place); times of SGD f32, Adam f32 and SGD bf16 beside the
   bound;
10. train profile: one AlexNet b256 train step by kernel;
11. fused vs per-blob: 3 AlexNet b256 steps with ``fused_update`` on and 3
    with it off, from the same weights and batch, dropout ratio 0 and
    deterministic cuDNN: params and history agree (rtol 1e-5, atol 1e-7).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and runs nothing.  Weights are random, drawn from a fixed seed.
``--phases`` runs a subset (comma-separated names: card and build always
run) and then prints no result lines; with no arguments every phase runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
        # the instances the main paths run: float32, LRN size 5 beta 0.75;
        # fused update SGD with L2
        for fn, n in re.findall(r"Compiling entry function '([^']+)'.*?Used (\d+) "
                                r"registers", log, flags=re.S):
            kernel = re.search(r"\d+((?:lrn|fused)_\w+?_kernel)I", fn)
            if kernel and ("IfLi5ELb1E" in fn or "IfLi0ELi2E" in fn):
                print(f"    {kernel.group(1)} (float32, main-path instance): "
                      f"{n} registers a thread")


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


# ---------------------------------------------------------------------------
# Training slice
# ---------------------------------------------------------------------------

# The six rules' float32 gate against the plain version: SGD and Nesterov
# must be bitwise; the sqrt/divide rules are held to one ulp.  Both sides
# run the same IEEE operations in the same order (the kernel through
# __fsqrt_rn/__fdiv_rn, the plain version through ATen's sqrt and true
# division), so 0 is expected; the one ulp allows for an ATen elementwise
# kernel built with other rounding choices than ours.
UPDATE_F32_ULPS = {"SGD": 0, "Nesterov": 0, "AdaGrad": 1, "RMSProp": 1,
                   "AdaDelta": 1, "Adam": 1}
TRAIN_STEPS = 10


def ulps_f32(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 ulps between two float32 tensors (signed
    zeros count as equal)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def phase_lrn_backward(card: str) -> dict:
    """LRN backward kernel vs plain at every case; times at the main
    shapes beside the bound and F.local_response_norm's backward."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dev = torch.device("cuda")
    max_err = 0.0
    cases = [(lab, shp, 5, 0.75, 1.0) for lab, shp in MAIN_CASES] + RAGGED_CASES
    for label, shape, size, beta, k in cases:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        g = torch.randn(shape, generator=gen, device=dev)
        ref = kernels.lrn_backward_torch(x, g, size, ALPHA, beta, k)
        dx = kernels.lrn_backward(x, g, size, ALPHA, beta, k)
        torch.cuda.synchronize()
        err = (dx - ref).abs()
        ok = bool((err <= F32_TOL["atol"] + F32_TOL["rtol"] * ref.abs()).all())
        max_err = max(max_err, float(err.max()))
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        refb = kernels.lrn_backward_torch(xb.float(), gb.float(), size, ALPHA,
                                          beta, k).to(torch.bfloat16).float()
        dxb = kernels.lrn_backward(xb, gb, size, ALPHA, beta, k).float()
        torch.cuda.synchronize()
        errb = (dxb - refb).abs()
        okb = bool((errb <= bf16_ulp(refb)).all())
        print(f"lrn_backward {label} {list(shape)} size {size} beta {beta}: f32 "
              f"max abs err {float(err.max()):.3e} (rtol 1e-5, atol 1e-6) "
              f"{'ok' if ok else 'FAIL'}, {int((dx != ref).sum())} elements not "
              f"bitwise equal; bf16 max err in ulps "
              f"{float((errb / bf16_ulp(refb)).max()):.2f} (tolerance 1) "
              f"{'ok' if okb else 'FAIL'}")
        check(ok, f"lrn_backward f32 {label}")
        check(okb, f"lrn_backward bf16 {label}")

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bw, _ = card_peaks(card)
    for label, shape in MAIN_CASES:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        g = torch.randn(shape, generator=gen, device=dev)
        t_k = time_ms(lambda: kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0))
        t_p = time_ms(lambda: kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0))
        xr = x.clone().requires_grad_(True)
        yr = F.local_response_norm(xr, 5, ALPHA, 0.75, 1.0)  # graph built once
        t_l = time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True))
        del yr, xr
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        t_kb = time_ms(lambda: kernels.lrn_backward(xb, gb, 5, ALPHA, 0.75, 1.0))
        n = x.numel()
        bound, bound_b = 3 * n * 4 / bw * 1e3, 3 * n * 2 / bw * 1e3
        print(f"time lrn_backward {label} {list(shape)} f32: kernel {t_k:.4f} ms "
              f"({100 * bound / t_k:.1f}% of bound), plain {t_p:.4f} ms, "
              f"F.local_response_norm backward {t_l:.4f} ms, bound {bound:.4f} ms "
              f"(bytes); bf16 kernel {t_kb:.4f} ms (bound {bound_b:.4f} ms) [{card}]")
        if label.startswith("alexnet"):
            totals["ms"] += t_k
            totals["plain_ms"] += t_p
            totals["library_ms"] += t_l
            totals["bound_ms"] += bound
    return dict(max_abs_err=max_err, bound_by="bytes", **totals)


def phase_fused_update(card: str, layout) -> dict:
    """The fused update kernel vs fused_update_torch on the AlexNet arena
    geometry; times of SGD f32, Adam f32 and SGD bf16."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.solvers.arena import ArenaTables
    from sparknet_tpu_torch.solvers.updates import adam_correction

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tables = ArenaTables(layout, dev)
    real = torch.zeros(layout.total, dtype=torch.bool, device=dev)
    for e in layout.entries:
        real[e.offset:e.offset + e.size] = True
    total = layout.total
    print(f"fused_update: AlexNet arena {layout.param_count():,} params in "
          f"{len(layout.entries)} blobs, {total:,} elements after padding "
          f"({layout.n_tiles} tiles of {layout.tile})")

    def arenas(rule, dtype):
        def rand(scale, positive=False):
            t = torch.randn(total, generator=gen, device=dev) * scale
            t = t.abs() if positive else t
            return torch.where(real, t, 0.0).to(dtype)
        w = rand(0.01)
        g = rand(1e-3)
        slots = [rand(1e-3, positive=True)
                 for _ in range(kernels.FUSED_RULE_SLOTS[rule])]
        return w, g, slots

    def scalars(rule, clip):
        corr = (adam_correction(0.9, 0.999, 4, dev) if rule == "Adam"
                else torch.ones((), device=dev))
        return torch.stack([torch.full((), 0.01, device=dev),
                            torch.full((), 0.7 if clip else 1.0, device=dev),
                            corr.float()])

    max_abs = 0.0
    n_cases = 0
    for rule in kernels.FUSED_RULE_SLOTS:
        for dtype in (torch.float32, torch.bfloat16):
            for reg in ("l2", "l1"):
                for clip in (False, True):
                    for iter_size in (1, 2):
                        st = kernels.UpdateStatics(
                            momentum=0.9, momentum2=0.999, rms_decay=0.98,
                            delta=1e-8, iter_size=iter_size, reg=reg, clip=clip)
                        w, g, slots = arenas(rule, dtype)
                        sc = scalars(rule, clip)
                        ref_w, ref_s = kernels.fused_update_torch(
                            rule, st, w, g, slots, tables.tile_lr,
                            tables.tile_decay, sc)
                        ptrs = [t.data_ptr() for t in (w, *slots)]
                        g0 = g.clone()
                        kernels.fused_update(rule, st, w, g, slots, tables.tile_lr,
                                             tables.tile_decay, sc)
                        torch.cuda.synchronize()
                        label = (f"{rule} {str(dtype)[6:]} {reg} clip {int(clip)} "
                                 f"iter_size {iter_size}")
                        check(ptrs == [t.data_ptr() for t in (w, *slots)],
                              f"fused_update {label}: not in place")
                        check(torch.equal(g, g0), f"fused_update {label}: wrote g")
                        for t in (w, *slots):
                            check(not bool(t[~real].any()),
                                  f"fused_update {label}: pad zone not zero")
                        pairs = list(zip((w, *slots), (ref_w, *ref_s)))
                        for out, ref in pairs:
                            max_abs = max(max_abs, float((out.float() - ref.float()).abs().max()))
                            if dtype == torch.float32:
                                u = ulps_f32(out, ref)
                                check(u <= UPDATE_F32_ULPS[rule],
                                      f"fused_update {label}: {u} ulps, allowed "
                                      f"{UPDATE_F32_ULPS[rule]}")
                            else:
                                err = (out.float() - ref.float()).abs()
                                check(bool((err <= bf16_ulp(ref.float())).all()),
                                      f"fused_update {label}: beyond one bf16 ulp")
                        n_cases += 1
                        if dtype == torch.float32 and reg == "l2" and not clip \
                                and iter_size == 1:
                            print(f"fused_update {label}: "
                                  f"{'bitwise equal' if all(torch.equal(a, b) for a, b in pairs) else 'within tolerance'}"
                                  f" to the plain version, pad zones 0, in place")
                        del w, g, slots, ref_w, ref_s, g0
    print(f"fused_update: {n_cases} cases agree (SGD/Nesterov f32 bitwise, "
          f"other f32 rules within {max(UPDATE_F32_ULPS.values())} ulp, bf16 "
          f"within one bf16 ulp), max abs err {max_abs:.3e}")

    bw, _ = card_peaks(card)
    times = {}
    for rule, dtype in (("SGD", torch.float32), ("Adam", torch.float32),
                        ("SGD", torch.bfloat16)):
        st = kernels.UpdateStatics(momentum=0.9, reg="l2")
        w, g, slots = arenas(rule, dtype)
        sc = scalars(rule, False)
        t_k = time_ms(lambda: kernels.fused_update(
            rule, st, w, g, slots, tables.tile_lr, tables.tile_decay, sc))
        t_p = time_ms(lambda: kernels.fused_update_torch(
            rule, st, w, g, slots, tables.tile_lr, tables.tile_decay, sc))
        nbytes = (2 + 2 * len(slots) + 1) * total * w.element_size()
        bound = nbytes / bw * 1e3
        times[(rule, str(dtype))] = (t_k, t_p, bound)
        print(f"time fused_update {rule} {str(dtype)[6:]} L2 on the AlexNet arena: "
              f"kernel {t_k:.4f} ms ({nbytes / 1e9:.3f} GB, "
              f"{100 * bound / t_k:.1f}% of bound), plain {t_p:.4f} ms, bound "
              f"{bound:.4f} ms (bytes) [{card}]")
        del w, g, slots
    # a same-bytes reference, not the same function: PyTorch's SGD keeps
    # the lr out of its momentum buffer, so no PyTorch call computes
    # Caffe's update (library_ms stays null)
    p = torch.zeros(total, device=dev, requires_grad=True)
    p.grad = torch.randn(total, generator=gen, device=dev)
    opt = torch.optim.SGD([p], lr=0.01, momentum=0.9, weight_decay=5e-4, fused=True)
    opt.step()
    t_ref = time_ms(opt.step)
    print(f"time torch.optim.SGD(fused=True).step() over one flat f32 tensor "
          f"of the arena's size (same bytes, not the same function): "
          f"{t_ref:.4f} ms [{card}]")
    del p, opt
    t_k, t_p, bound = times[("SGD", "torch.float32")]
    return dict(max_abs_err=max_abs, ms=t_k, plain_ms=t_p, bound_ms=bound,
                bound_by="bytes", library_ms=None)


def fixed_batch(batch: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    return {
        "data": torch.randn((batch, 3, 227, 227), generator=gen, device="cuda") * 50,
        "label": torch.randint(0, 1000, (batch,), generator=gen, device="cuda",
                               dtype=torch.int32),
    }


def conv1_grad_norm(solver, feeds) -> float:
    """Norm of conv1's weight gradient after one forward and backward of
    the train net at the solver's weights, through the LRN autograd
    Function on the card."""
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.compiler.graph import NetVars

    v = solver.variables
    params = {ln: [p.detach().clone().requires_grad_(True) for p in pl]
              for ln, pl in v.params.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with f32_precision():
        _, _, loss = solver.train_net.apply(NetVars(params, v.state), feeds, gen=gen)
        (g,) = torch.autograd.grad(loss, params["conv1"][0])
    norm = float(g.norm())
    check(np.isfinite(norm) and norm > 0, f"conv1 weight gradient norm {norm}")
    return norm


def train_solver(net_param, solver_cfg):
    from sparknet_tpu_torch.solvers.solver import Solver

    return Solver(dataclasses.replace(solver_cfg, average_loss=TRAIN_STEPS,
                                      random_seed=SEED), net_param)


def phase_train(card: str) -> dict:
    """The slice's path: a port Solver with fused_update on trains AlexNet
    b256 for 10 steps after a warm-up, then CaffeNet b256 for one."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.ops import kernels

    set_config(fused_update=True, storage_dtype="f32")
    out = {}
    for name, steps in (("alexnet", TRAIN_STEPS), ("caffenet", 1)):
        batch = 256
        solver = train_solver(getattr(models, name)(batch),
                              getattr(models, f"{name}_solver")())
        check(solver.layout is not None, "fused_update did not take")
        feeds = fixed_batch(batch)
        if name == "alexnet":
            solver.step(1, lambda it: feeds)  # warm-up: cuDNN/cuBLAS set-up
            out["layout"] = solver.layout
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        solver.step(steps, lambda it: feeds)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
                  kernels.FUSED_UPDATE_LAUNCHES)
        losses = [float(l) for l in solver._loss_window[-steps:]]
        check(counts == (2 * steps, 2 * steps, steps),
              f"{name} launches (lrn fwd, lrn bwd, fused) {counts}, want "
              f"{(2 * steps, 2 * steps, steps)}")
        check(all(np.isfinite(losses)), f"{name} losses {losses}")
        norm = conv1_grad_norm(solver, feeds)
        print(f"train: {name} b{batch} 227x227, fused_update on, f32, dropout on: "
              f"{steps} steps, losses {[round(l, 4) for l in losses]}, launches "
              f"per step: LRN forward {counts[0] // steps}, LRN backward "
              f"{counts[1] // steps}, fused update {counts[2] // steps}; conv1 "
              f"weight grad norm {norm:.4e}; {batch * steps / dt:.1f} img/s, "
              f"{1e3 * dt / steps:.2f} ms/step [{card}]")
        out[name] = dict(counts=counts, ms_per_step=1e3 * dt / steps)
        if name == "alexnet":
            out["step"] = lambda s=solver, f=feeds: s.step(1, lambda it: f)
            out["alexnet_solver"] = solver
        del solver
        gc.collect()
    set_config(fused_update=False)
    return out


def phase_fused_vs_blob(card: str) -> None:
    """Fused against per-blob on the card: 3 AlexNet b256 steps each from
    the same weights and batch, dropout ratio 0, deterministic cuDNN."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config

    net = models.alexnet(256)
    for lp in net.get_all("layer"):
        if lp.get_str("type") == "Dropout":
            lp.get_msg("dropout_param").set("dropout_ratio", 0.0)
    feeds = fixed_batch(256)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results = []
        for fused in (True, False):
            set_config(fused_update=fused)
            solver = train_solver(net, models.alexnet_solver())
            check((solver.layout is not None) == fused, "fused_update did not take")
            solver.step(3, lambda it: feeds)
            results.append((
                {ln: [p.detach().clone() for p in pl]
                 for ln, pl in solver.variables.params.items()},
                {ln: [h[0].detach().clone() for h in hl]
                 for ln, hl in solver.slots.items()},
                float(solver._loss_window[-1])))
            del solver
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = prev
        set_config(fused_update=False)
    (pf, hf, lf), (pb, hb, lb) = results
    worst, bitwise = 0.0, True
    for ln in pf:
        for a, b in list(zip(pf[ln], pb[ln])) + list(zip(hf[ln], hb[ln])):
            bitwise = bitwise and torch.equal(a, b)
            worst = max(worst, float((a - b).abs().max()))
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-7),
                  f"fused vs per-blob {ln}: max abs diff {float((a - b).abs().max()):.3e}")
    print(f"fused vs per-blob: AlexNet b256, 3 steps, dropout 0, deterministic "
          f"cuDNN: loss {lf:.6f} vs {lb:.6f}, params and history max abs diff "
          f"{worst:.3e} (rtol 1e-5, atol 1e-7), "
          f"{'bitwise equal' if bitwise else 'not bitwise equal'} [{card}]")


def phase_train_profile(card: str, step, ms_per_step: float) -> None:
    """One AlexNet b256 train step by kernel, and where the port's three
    kernels stand in it."""
    device_ms, rows = device_breakdown(step, top=1000)
    if device_ms == 0.0:
        print("train profile: torch.profiler recorded no device time")
        return
    print(f"train profile: one AlexNet b256 train step under torch.profiler: "
          f"{device_ms:.3f} ms of kernels, {100 * device_ms / ms_per_step:.1f}% "
          f"of the unprofiled {ms_per_step:.2f} ms/step [{card}]")
    for ms, name, calls in rows[:10]:
        print(f"  {ms:8.3f} ms  {100 * ms / device_ms:5.1f}%  x{calls}  {name[:90]}")
    for key in ("lrn_forward_kernel", "lrn_backward_kernel", "fused_update_kernel"):
        hits = [(i, r) for i, r in enumerate(rows) if key in r[1]]
        for i, (ms, name, calls) in hits:
            print(f"  port kernel {key}: {ms:.3f} ms, "
                  f"{100 * ms / device_ms:.1f}%, x{calls}, rank {i + 1} of {len(rows)}")
        if not hits:
            print(f"  port kernel {key}: not in the profile")


PHASES = ("kernel", "path", "serve", "profile", "lrn_backward", "train",
          "fused_update", "train_profile", "fused_vs_blob")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all)")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; known: {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test runs "
              "only on a GPU", file=sys.stderr)
        return 2
    import sparknet_tpu_torch  # noqa: F401  (fails here outside a checkout)

    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    stats = {}
    launches = {"lrn_across_channels": 0, "lrn_backward": 0, "fused_update": 0}
    if "kernel" in phases:
        stats["lrn"] = phase_kernel(card)
    if "path" in phases:
        path_launches, forward, ms_per_forward = phase_path(card)
        launches["lrn_across_channels"] += path_launches
    if "serve" in phases:
        launches["lrn_across_channels"] += phase_serve(card)
    if "profile" in phases and "path" in phases:
        phase_profile(card, forward, ms_per_forward)
    if "lrn_backward" in phases:
        stats["lrn_backward"] = phase_lrn_backward(card)
    if "train" in phases:
        train = phase_train(card)
        for name in ("alexnet", "caffenet"):
            fwd, bwd, upd = train[name]["counts"]
            launches["lrn_across_channels"] += fwd
            launches["lrn_backward"] += bwd
            launches["fused_update"] += upd
        if "fused_update" in phases:
            stats["fused_update"] = phase_fused_update(card, train["layout"])
        if "train_profile" in phases:
            phase_train_profile(card, train["step"], train["alexnet"]["ms_per_step"])
        del train
        gc.collect()
    if "fused_vs_blob" in phases:
        phase_fused_vs_blob(card)
    print(f"chip_smoke: phases {phases} done in {time.perf_counter() - t_start:.1f} s")
    if len(phases) < len(PHASES):
        return 0
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    meta = {
        "lrn_across_channels": ("sparknet_tpu_torch/csrc/lrn.cu",
                                "sparknet_tpu/ops/pallas_kernels.py:40", "lrn"),
        "lrn_backward": ("sparknet_tpu_torch/csrc/lrn.cu",
                         "sparknet_tpu/ops/pallas_kernels.py:185", "lrn_backward"),
        "fused_update": ("sparknet_tpu_torch/csrc/fused_update.cu",
                         "sparknet_tpu/ops/pallas_kernels.py:467", "fused_update"),
    }
    lines = []
    for name, (source, replaces, key) in meta.items():
        st = stats[key]
        # LRN times and bounds: one AlexNet b256 step's two calls (norm1 +
        # norm2), float32; fused_update: one SGD f32 update of the AlexNet
        # arena; max_abs_err: the largest over every f32 case (every case
        # for fused_update); launches: the main paths (the AlexNet TEST
        # forwards, the CaffeNet requests, the AlexNet and CaffeNet train
        # steps), each counted from 0
        lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"],
        })
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
