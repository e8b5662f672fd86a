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
   bf16 ulp), inputs ``relu(randn*50)`` and ``g = randn``; bit for bit at
   operands that send the kernel to its IEEE walk and over a sweep of x
   scales, k and beta across its fast path's range; times beside the
   bound and the autograd backward of ``F.local_response_norm``;
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
    deterministic cuDNN: params and history agree (rtol 1e-5, atol 1e-7);
12. flash: the flash-attention kernel against ``flash_attention_torch`` at
    the char LM's prefill shape [32,4,128,16] (causal and not), ragged
    S = 100, head dims 8, 32, 64, 128 and 256, [4,16,2048,64] causal and not,
    [2,8,1024,128] causal and a ragged [2,4,2000,64] causal (rtol 1e-5,
    atol 1e-6; atol 1e-5 at S >= 1024); batch entry 0 of the prefill shape
    bit for bit the same alone and in its batch of 32; times at the
    prefill shape and the S >= 1024 shapes beside the bound (the 3xTF32
    tensor-core rate) and ``F.scaled_dot_product_attention`` (a yardstick
    the port never calls);
13. flash backward: the backward kernel against
    ``flash_attention_backward_torch`` on the same q, k, v, o, lse and g
    at the flash phase's shapes and the padded widths 12 and 200 (rtol
    1e-5, atol 1e-6 x max|ref| at S < 1024; rtol 1e-4, atol 1e-5 x
    max|ref| above); the forward's lse against the plain one (1e-5) and
    its o bit for bit the same with and without lse; two launches bit for
    bit equal; batch entry 0 of the char LM's shape alone and in its
    batch; times of the kernel, the plain version and the autograd
    backward of ``F.scaled_dot_product_attention`` (a yardstick) beside
    the bound, and of the forward with and without lse;
14. paged: the paged-attention kernel against ``paged_attention_torch``
    (rtol 1e-5, atol 1e-6) over a sweep of every head dim (8, 16, 32, 64,
    128, 256) x block size T (1, 4, 8, 16) at 160 columns a row, positions
    at 0, block edges, both sides of every tile width and the last column,
    and pools stored in bfloat16 or float16 (read as stored) at D 8, 16,
    64 and 256;
    at the char LM's decode shape (shuffled tables, positions at 0, block
    edges and 127); and at B 64, H 16, D 64, T 16, MB 128 with random
    positions and with every position at 2047; pools hold finite garbage
    of 1e4 outside the live lines; at every case a row's output is bit for
    bit unchanged when the other rows' q, tables and positions change;
    times of the three timed shapes beside the live-bytes bound, kernel,
    plain and a gather + SDPA yardstick timed in turns;
15. token: the full-width char LM (seeded init) serves 64 seeded requests
    through a ``PagedDecoder`` (32 slots, block_tokens 8, full pool):
    tokens/s, decode-step, TTFT and inter-token percentiles; every ticket
    resolves, the pool ledger reads 0 leaked and 0 in use; 2 flash
    launches per prefill and 2 paged launches per decode step; 8 requests
    decoded alone give the same tokens; the paged logits agree with one
    full-window forward of prompt + continuation (atol 1e-4) and each token
    is that forward's argmax where its top-2 margin exceeds 1e-4; the same
    mix through the ``ContinuousDecoder`` (2 flash launches per step)
    agrees with the paged tokens up to a position of margin <= 1e-4;
    ``rope_at`` equals ``rope``'s rows bit for bit; and a prompt prefilled
    in bucket 2 and in bucket 32 is compared bit for bit;
16. token profile: one prefill + decode step and one decode step under
    ``torch.profiler``;
17. parallel (run after 11): SparkNet's rounds (``parallel.ParallelTrainer``)
    with the zoo AlexNet, ``alexnet_solver``, fused update, f32, batch 256
    a worker, seeded batches one per (rank, iteration).  A world of one
    (NCCL, formed by the trainer, cuda:0), dropout 0 and deterministic
    cuDNN: tau 1 for 3 rounds and tau 5 for 2 rounds bit for bit equal
    (params and history) to 3 and 10 ``Solver.step``s of a second Solver
    from the same weights and batches; EASGD alpha 0.9, one round of tau
    2, worker and center equal to the formula on 2 Solver steps (rtol
    1e-6); after the tau-1 check, 3 more rounds and 3 lone Solver steps
    alternate, twice, timed (what a sync round adds).  Then dropout 0.5, tau 5, 3 timed rounds after a warm-up: ms a
    round, img/s, the average's all-reduce by CUDA events over the
    arena's bytes, exactly 10 LRN forward, 10 LRN backward and 5
    fused-update launches a round, finite losses.  A world of two (gloo,
    both ranks on cuda:0, spawned, FileStore), dropout 0, deterministic
    cuDNN, tau 1 (2 rounds), tau 2 (2 rounds), EASGD alpha 0.45 (1 round of
    tau 2): both ranks' params (the center under EASGD) bit for bit equal
    after every round, exact launch counts on each rank, and the final
    arenas against an in-process oracle of the same rounds (two Solvers:
    the mean of the gradients, of the arenas, or the EASGD formula; rtol
    1e-5, atol 1e-7); ms a round and the gloo all-reduce's ms.  A failing
    rank fails the phase.  Head dims between the attention kernels'
    widths: flash at [2,4,100,12] causal and [2,4,64,48] (zero-padded in
    the wrapper) and paged at D 12, 24 and 100 on pools allocated at
    ``kernel_head_dim`` lanes (T 8, 160 columns a row), each against its
    plain version at the true width (rtol 1e-5, atol 1e-6), every call a
    counted launch; a ``PagedDecoder`` of embed_dim 48 over 4 heads (D 12)
    serves 8 seeded requests with 2 flash launches a prefill and 2 paged a
    decode step, its tokens equal to the ``ContinuousDecoder``'s up to a
    position of top-2 margin <= 1e-4;
18. charlm train: the full-width char LM (``charlm_solver``: Adam,
    base_lr 2e-3; fused update, f32, TF32 off) trained through ``TPUNet``
    on seeded ``char_lm_batches`` of this checkout's README.md and
    docs/*.md: 20 steps through the kernels against the same 20 with
    ``flash_attention_torch`` under autograd, each step from the same
    params and history (every loss rtol 1e-4; params rtol 1e-4, atol 1e-5
    x max + 1e-2 x base_lr, the one-step Adam tolerance), 3 per-blob against 3
    fused steps (rtol 1e-5, atol 1e-7), two runs of 5 steps bit for bit,
    and a world-of-one ``ParallelTrainer`` round at tau 2 bit for bit
    against 2 ``Solver`` steps (deterministic algorithms for these); then
    200 timed steps with exactly 2 flash, 2 flash backward and 1 fused
    update launches a step, ms a step, tokens/s, one step by kernel, and
    the mean loss of the last 10 steps under 3.3 nats; ``generate_chars``
    of 64 chars, greedy, through the cached path (1 flash launch a layer,
    then 1 paged a layer a step), equal to the sliding full forward up to
    a position of top-2 margin <= 1e-4, and a seeded top-k 5 sample the
    same twice; a transformer step over 2 heads of 256 lanes (finite loss,
    non-zero ``w_qkv`` gradient) and a bf16 ``flash_attention`` call bit
    for bit the float32 kernel on the upcast inputs cast to bf16.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and runs nothing.  Weights are random, drawn from a fixed seed.
``--phases`` runs a subset (comma-separated names: card and build always
run) and then prints no result lines; with no arguments every phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
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

# (memory bytes/s, float32 FLOP/s outside the tensor cores, dense TF32
# tensor-core FLOP/s) by card, from NVIDIA's H100 data sheet (its TF32
# figures are with sparsity; dense is half); the first name that matches
# wins.
CARD_PEAKS = [
    ("H100 PCIe", 2.0e12, 51e12, 378e12),
    ("H100 NVL", 3.9e12, 60e12, 417.5e12),
    ("H100", 3.35e12, 67e12, 495e12),
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


def graph_ms(fn, reps: int = REPS, inner: int = 10) -> float:
    """Device ms per call of ``fn``, host launch cost excluded: ``inner``
    calls captured in one CUDA graph, CUDA events around each replay,
    median of ``reps``.  For calls shorter than their own launch on the
    host (the char LM's attention kernels), where ``time_ms`` measures the
    host's issue rate instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    del graph
    return float(np.median(times))


def card_peaks(name: str) -> tuple[float, float, float]:
    """(memory bytes/s, float32 FLOP/s, dense TF32 FLOP/s) of the card."""
    for key, bw, flops, tf32 in CARD_PEAKS:
        if key in name:
            return bw, flops, tf32
    raise RuntimeError(f"no published peaks for card {name!r}")


def lrn_bound_ms(shape, size: int, itemsize: int, name: str) -> tuple[float, str]:
    """Least time for one LRN forward: each input byte read once and each
    output byte written once over the memory rate, or its float32
    operations (per element: 1 square, size-1 adds, 2 for the scale, 4 for
    scale^-0.75, 1 for x*scale^-beta) over the float32 rate."""
    bw, flops, _ = card_peaks(name)
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
        frames = sum(int(m) for m in re.findall(r"(\d+) bytes stack frame", log))
        print(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, {spills} bytes of spills, {frames} bytes of "
              f"stack frames")
        # the instances the main paths run: float32, LRN size 5 beta 0.75;
        # fused update SGD with L2
        for fn, n in re.findall(r"Compiling entry function '([^']+)'.*?Used (\d+) "
                                r"registers", log, flags=re.S):
            kernel = re.search(r"\d+((?:lrn|fused)_\w+?_kernel)I", fn)
            if kernel and ("IfLi5ELb1E" in fn or "IfLi0ELi2E" in fn):
                print(f"    {kernel.group(1)} (float32, main-path instance): "
                      f"{n} registers a thread")
        # every instance that spills or keeps a stack frame, by name
        for fn, frame, spill in re.findall(
                r"Compiling entry function '([^']+)'.*?(\d+) bytes stack frame, "
                r"(\d+) bytes spill stores", log, flags=re.S):
            if int(frame) or int(spill):
                print(f"    {fn}: {frame} bytes stack frame, {spill} bytes of "
                      f"spill stores")
        # the attention kernels: every head-dim instance, with its spills
        for fn, spill, n in re.findall(
                r"Compiling entry function '([^']+)'.*?(\d+) bytes spill stores.*?"
                r"Used (\d+) registers", log, flags=re.S):
            kernel = re.search(r"\d+((?:flash|paged)_\w+?_kernel)ILi(\d+)E"
                               r"(13__nv_bfloat16|6__half)?", fn)
            if kernel:
                kind = {"13__nv_bfloat16": ", bf16 pools", "6__half": ", f16 pools"}.get(
                    kernel.group(3), "")
                print(f"    {kernel.group(1)} head dim {kernel.group(2)}{kind}: {n} "
                      f"registers a thread, {spill} bytes of spill stores")


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


LRN_BWD_SEG = 32  # channels a thread of the LRN backward walks (lrn.cu)


def fast_walks(x: torch.Tensor, g: torch.Tensor, size: int, beta: float,
               k: float) -> torch.Tensor:
    """Which of the LRN backward kernel's walks (image, segment, spatial
    position) stay on its fast sqrt/division path: every channel of the
    walk's t range has its operands inside lrn.cu's ``fast_ok`` ranges,
    u = scale in [2^-20, 2^20] and a = g x p zero or of magnitude in
    [2^-96, 2^96].  Channels outside [0, C) hold zeros, as in the kernel."""
    from sparknet_tpu_torch.ops import kernels

    pad = (size - 1) // 2
    b, c = x.shape[:2]
    segs = -(-c // LRN_BWD_SEG)
    ext = segs * LRN_BWD_SEG - c + pad  # zero channels past the end
    xf = F.pad(x.float().reshape(b, c, -1), (0, 0, pad, ext))
    gf = F.pad(g.float().reshape(b, c, -1), (0, 0, pad, ext))
    u = k + (ALPHA / size) * kernels._channel_window_sum(xf * xf, size)
    a = gf * xf * kernels._pow_neg(u, beta)
    ok = ((u >= 2.0 ** -20) & (u <= 2.0 ** 20)
          & ((a == 0) | ((a.abs() >= 2.0 ** -96) & (a.abs() <= 2.0 ** 96))))
    # walk s reads t at channels [s L - pad, (s + 1) L + pad)
    return ok.unfold(1, LRN_BWD_SEG + 2 * pad, LRN_BWD_SEG).all(-1)


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
    # operands outside the kernel's fast sqrt/division ranges (x scaled by
    # 1e-35 at every other spatial position, signed zeros in g): those
    # threads walk again with the IEEE operations; every element stays exact
    shape = (4, 64, 13, 13)
    x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
    x[..., ::2] *= 1e-35
    g = torch.randn(shape, generator=gen, device=dev)
    g[:, :, 0] = -0.0
    ref = kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0)
    dx = kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0)
    torch.cuda.synchronize()
    same = torch.equal(dx, ref) and torch.equal(torch.signbit(dx), torch.signbit(ref))
    share = 100 * float(fast_walks(x, g, 5, 0.75, 1.0).float().mean())
    print(f"lrn_backward out-of-range operands {list(shape)} (x scaled by 1e-35 "
          f"at every other position, g = -0 in a row; {share:.1f}% of walks "
          f"fast): bit for bit equal to the plain version, signs of zero "
          f"included: {same}")
    check(same, "lrn_backward: the IEEE fallback walk differs from the plain version")
    # the fast walk across its accepted range: x scaled from 1e-3 to 5e4,
    # where scale nears 2^20, and 1e5, where a quarter of the walks stay
    # fast and the rest fall back in the same launch; k from 2e-6, near
    # 2^-20, to 2; beta 0.75 and 0.6.  Bit for bit, signs of zero included,
    # with the share of walks that stayed on the fast path
    shape = (4, 64, 27, 27)
    walks = fast = 0
    for x_scale in (1e-3, 1.0, 1e2, 1e4, 5e4, 1e5):
        for k in (2e-6, 1e-4, 1.0, 2.0):
            for beta in (0.75, 0.6):
                x = torch.relu(torch.randn(shape, generator=gen, device=dev)) * x_scale
                g = torch.randn(shape, generator=gen, device=dev)
                ref = kernels.lrn_backward_torch(x, g, 5, ALPHA, beta, k)
                dx = kernels.lrn_backward(x, g, 5, ALPHA, beta, k)
                torch.cuda.synchronize()
                same = (torch.equal(dx, ref)
                        and torch.equal(torch.signbit(dx), torch.signbit(ref)))
                ok_walks = fast_walks(x, g, 5, beta, k)
                walks += ok_walks.numel()
                fast += int(ok_walks.sum())
                print(f"lrn_backward fast-path sweep {list(shape)} x scale {x_scale:g} "
                      f"k {k:g} beta {beta}: bit for bit {same}, "
                      f"{100 * float(ok_walks.float().mean()):.1f}% of walks fast")
                check(same, f"lrn_backward sweep x scale {x_scale:g} k {k:g} beta {beta}")
    print(f"lrn_backward fast-path sweep: {fast} of {walks} walks on the fast path")
    check(2 * fast > walks, "lrn_backward sweep: most walks should take the fast path")

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bw, _, _ = card_peaks(card)
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

    bw, _, _ = card_peaks(card)
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


def alexnet_net(dropout: float):
    """The zoo AlexNet at batch 256 with every Dropout at ``dropout``."""
    from sparknet_tpu_torch import models

    net = models.alexnet(256)
    for lp in net.get_all("layer"):
        if lp.get_str("type") == "Dropout":
            lp.get_msg("dropout_param").set("dropout_ratio", dropout)
    return net


def phase_fused_vs_blob(card: str) -> None:
    """Fused against per-blob on the card: 3 AlexNet b256 steps each from
    the same weights and batch, dropout ratio 0, deterministic cuDNN."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config

    net = alexnet_net(0.0)
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


# ---------------------------------------------------------------------------
# Token-serving slice
# ---------------------------------------------------------------------------

# the zoo charlm at its own full width, served with charlm's default batch
# of 32 slots and the decoders' default block of 8 tokens
CHARLM = dict(slots=32, seq_len=128, vocab=128, embed_dim=64, heads=4,
              ffn_dim=128, blocks=2)
BLOCK_TOKENS = 8
N_REQUESTS = 64
MARGIN = 1e-4  # top-2 logit margin below which a greedy pick is a tie


def attention_within(out, ref, atol: float, rtol: float = 1e-5) -> tuple[bool, float]:
    err = (out - ref).abs()
    return bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def flash_bound_ms(shape, causal: bool, card: str) -> tuple[float, str]:
    """Least time of one attention forward: q, k, v read and o written once
    over the memory rate, or its 4 B H S^2 D flops (halved when causal) at
    the faster float32-accurate rate: the float32 rate, or the tensor cores'
    dense TF32 rate over 3 (a 3xTF32 split makes 3 TF32 products of each
    float32 one)."""
    bw, flops, tf32 = card_peaks(card)
    b, h, s, d = shape
    t_bytes = 4 * b * h * s * d * 4 / bw * 1e3
    work = 4 * b * h * s * s * d * (0.5 if causal else 1.0)
    t_ops = min(work / flops, 3 * work / tf32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash(card: str) -> dict:
    """The flash kernel vs flash_attention_torch at every case; a batch
    entry alone and in its batch, bit for bit; times at the char LM's
    prefill shape and at the long-context shapes."""
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [  # (label, shape, causal, atol); atol 1e-5 at S >= 1024
        ("charlm prefill", (32, 4, 128, 16), True, 1e-6),
        ("charlm prefill, not causal", (32, 4, 128, 16), False, 1e-6),
        ("ragged S=100", (2, 4, 100, 16), True, 1e-6),
        ("ragged S=100, not causal", (2, 4, 100, 16), False, 1e-6),
        ("transformer D=8", (4, 4, 128, 8), True, 1e-6),
        ("D=32 ragged", (2, 2, 77, 32), True, 1e-6),
        ("D=64", (4, 4, 200, 64), False, 1e-6),
        ("D=128", (2, 2, 130, 128), True, 1e-6),
        ("D=256", (2, 2, 130, 256), True, 1e-6),
        ("D=256, not causal", (1, 2, 77, 256), False, 1e-6),
        ("long context", (4, 16, 2048, 64), True, 1e-5),
        ("long context, not causal", (4, 16, 2048, 64), False, 1e-5),
        ("D=128 long", (2, 8, 1024, 128), True, 1e-5),
        ("ragged long", (2, 4, 2000, 64), True, 1e-5),
    ]
    max_err = 0.0
    out = {}
    with f32_precision():
        for label, shape, causal, atol in cases:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
            ref = kernels.flash_attention_torch(q, k, v, causal)
            o = kernels.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ok, err = attention_within(o, ref, atol)
            max_err = max(max_err, err)
            print(f"flash {label} {list(shape)} causal {int(causal)}: max abs err "
                  f"{err:.3e} (rtol 1e-5, atol {atol:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"flash {label}")
            if label == "charlm prefill":
                # a row's output depends only on its own fibre: batch entry 0
                # run alone gives the same bits as in the batch of 32
                alone = kernels.flash_attention(q[:1], k[:1], v[:1], causal)
                torch.cuda.synchronize()
                same = torch.equal(alone[0], o[0])
                print(f"flash {label}: batch entry 0 alone (B = 1) and in the batch "
                      f"of {shape[0]}: {'bit for bit equal' if same else 'DIFFER'}")
                check(same, "flash: batch entry 0 differs alone and in its batch")
            if label != "charlm prefill" and shape[2] < 1024:
                continue
            # the prefill shape is shorter than its launch: device time from
            # a CUDA graph; the long shapes: events over back-to-back calls
            timer = graph_ms if label == "charlm prefill" else time_ms
            how = "CUDA graph" if timer is graph_ms else "events"
            t_k = timer(lambda: kernels.flash_attention(q, k, v, causal))
            t_p = timer(lambda: kernels.flash_attention_torch(q, k, v, causal))
            t_l = timer(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
            bound, by = flash_bound_ms(shape, causal, card)
            print(f"time flash {label} {list(shape)} causal {int(causal)} ({how}): kernel "
                  f"{t_k:.4f} ms ({100 * bound / t_k:.1f}% of bound), plain {t_p:.4f} ms, "
                  f"F.scaled_dot_product_attention {t_l:.4f} ms, bound {bound:.4f} ms "
                  f"({by}) [{card}]")
            if timer is graph_ms:
                print(f"time flash {label} with the host launch (events over 10 "
                      f"back-to-back calls): kernel "
                      f"{time_ms(lambda: kernels.flash_attention(q, k, v, causal)):.4f} ms")
            out[label] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                              bound_by=by)
            del ref, o
    return dict(max_abs_err=max_err, **out["charlm prefill"], long=out["long context"])


def paged_case(gen, b, h, d, t, mb, positions, own_only: bool):
    """q, pools, tables and positions of one paged-attention case: row b
    owns ceil((pos + 1) / T) blocks of a shuffled pool (all MB of its
    table when not ``own_only``), its live lines are randn, and every
    other line (null block, unowned blocks, lines past a position) holds
    finite garbage of +-1e4."""
    dev = "cuda"
    nb = 1 + b * mb
    k_pool = (torch.rand((nb, t, h, d), generator=gen, device=dev) * 2 - 1) * 1e4
    v_pool = (torch.rand((nb, t, h, d), generator=gen, device=dev) * 2 - 1) * 1e4
    perm = torch.randperm(nb - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    for row in range(b):
        pos = int(positions[row])
        n = pos // t + 1 if own_only else mb
        blocks = perm[row * mb:row * mb + n]
        tables[row, :n] = blocks
        live = torch.randn((n * t, h, d), generator=gen, device=dev)
        live_v = torch.randn((n * t, h, d), generator=gen, device=dev)
        live[pos + 1:] = k_pool[blocks.long()].reshape(n * t, h, d)[pos + 1:]
        live_v[pos + 1:] = v_pool[blocks.long()].reshape(n * t, h, d)[pos + 1:]
        k_pool[blocks.long()] = live.reshape(n, t, h, d)
        v_pool[blocks.long()] = live_v.reshape(n, t, h, d)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    pos_t = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tables, pos_t


# The paged kernel's sweep: every head dim it takes at every block size
# in PAGED_SWEEP_T, each at MB * T = 160 columns, so that the positions
# cover block edges and both sides of every tile width (32, 64, 128).
PAGED_SWEEP_D = (8, 16, 32, 64, 128, 256)
# pools in a 16-bit type, read as stored: (head dim, storage type)
PAGED_HALF_CASES = ((8, torch.bfloat16), (16, torch.bfloat16), (64, torch.float16),
                    (256, torch.bfloat16), (256, torch.float16))
PAGED_SWEEP_T = (1, 4, 8, 16)


def paged_gate(kernels, gen, label, case) -> float:
    """The paged kernel against paged_attention_torch on one case (rtol
    1e-5, atol 1e-6), and row independence: the even rows' outputs bit for
    bit unchanged when the odd rows' q, tables and positions change.
    Returns the largest absolute error."""
    q, kp, vp, tables, pos = case
    b, mb, t = q.shape[0], tables.shape[1], kp.shape[1]
    ref = kernels.paged_attention_torch(q, kp, vp, tables, pos)
    o = kernels.paged_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    ok, err = attention_within(o, ref, 1e-6)
    odd = torch.arange(b, device="cuda") % 2 == 1
    q2 = torch.where(odd[:, None, None], torch.randn(q.shape, generator=gen,
                                                     device="cuda"), q)
    tables2 = torch.where(odd[:, None], tables.flip(0), tables)
    pos2 = torch.where(odd, torch.randint(0, mb * t, (b,), generator=gen,
                                          device="cuda").to(torch.int32), pos)
    o2 = kernels.paged_attention(q2, kp, vp, tables2, pos2)
    torch.cuda.synchronize()
    same = torch.equal(o[~odd], o2[~odd])
    print(f"paged {label}: max abs err {err:.3e} (rtol 1e-5, atol 1e-6) "
          f"{'ok' if ok else 'FAIL'}; even rows bit for bit unchanged when the "
          f"odd rows change: {same}")
    check(ok, f"paged {label}")
    check(same, f"paged {label}: a row's output depends on other rows")
    return err


def phase_paged(card: str) -> dict:
    """The paged kernel vs paged_attention_torch over a sweep of every head
    dim and block size (untimed), at the char LM's decode shape and at one
    long-context shape with random and with equal positions; row
    independence bit for bit at every case; times of the three timed
    shapes beside the live-bytes bound, kernel, plain and yardstick timed
    in turns (kernel, plain, yardstick, yardstick, plain, kernel)."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rs = np.random.RandomState(SEED + 5)
    bw, _, _ = card_peaks(card)
    max_err = 0.0
    # the sweep draws from its own generators, so the timed shapes get the
    # same positions and data as in earlier versions of this phase
    sweep_gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    sweep_rs = np.random.RandomState(SEED + 6)
    for d in PAGED_SWEEP_D:
        for t in PAGED_SWEEP_T:
            mb = -(-160 // t)
            edges = [0, t - 1, t, 31, 32, 33, 63, 64, 65, 127, 128, 129, mb * t - 1]
            positions = edges + list(sweep_rs.randint(0, mb * t, 3))
            own_only = t in (1, 8)  # else every table entry is an owned block
            case = paged_case(sweep_gen, len(positions), 2, d, t, mb, positions,
                              own_only)
            max_err = max(max_err, paged_gate(
                kernels, sweep_gen, f"sweep D {d} T {t} MB {mb} B {len(positions)}", case))
    print(f"paged sweep: {len(PAGED_SWEEP_D) * len(PAGED_SWEEP_T)} cases, every one within the gate and row "
          f"independent [{card}]")
    for d, dtype in PAGED_HALF_CASES:
        t, mb = 8, 20
        positions = [0, t - 1, t, 31, 32, 33, 63, 64, 65, 127, 128, 129, mb * t - 1]
        q, kp, vp, tables, pos = paged_case(sweep_gen, len(positions), 2, d, t, mb,
                                            positions, own_only=True)
        case = (q, kp.to(dtype), vp.to(dtype), tables, pos)
        max_err = max(max_err, paged_gate(
            kernels, sweep_gen, f"{str(dtype)[6:]} pools D {d} T {t} MB {mb}", case))

    charlm_pos = [0, 1, 7, 8, 15, 16, 63, 64, 127, 126, 120, 5] + list(
        rs.randint(0, 128, 20))
    cases = [  # (label, B, H, D, T, MB, positions, own_only)
        ("charlm decode", 32, 4, 16, 8, 16, charlm_pos, True),
        ("long context", 64, 16, 64, 16, 128, list(rs.randint(0, 2048, 64)), False),
        ("long context, equal positions", 64, 16, 64, 16, 128, [2047] * 64, False),
    ]
    out = {}
    for label, b, h, d, t, mb, positions, own_only in cases:
        q, kp, vp, tables, pos = case = paged_case(gen, b, h, d, t, mb, positions,
                                                   own_only)
        print(f"paged {label} B {b} H {h} D {d} T {t} MB {mb} (pools "
              f"{2 * kp.numel() * 4 / 1e9:.3f} GB)")
        max_err = max(max_err, paged_gate(kernels, gen, label, case))
        live = sum(int(p) + 1 for p in positions)
        nbytes = live * h * d * 4 * 2 + 2 * q.numel() * 4 + tables.numel() * 4 + b * 4
        bound = nbytes / bw * 1e3
        timer = graph_ms if label == "charlm decode" else time_ms
        how = "CUDA graph" if timer is graph_ms else "events"
        idx = tables.long()

        def kernel():
            return kernels.paged_attention(q, kp, vp, tables, pos)

        def plain():
            return kernels.paged_attention_torch(q, kp, vp, tables, pos)

        def gather_sdpa():
            kg = kp[idx].reshape(b, mb * t, h, d).transpose(1, 2)
            vg = vp[idx].reshape(b, mb * t, h, d).transpose(1, 2)
            cols = torch.arange(mb * t, device="cuda")
            mask = (cols[None, :] <= pos.long()[:, None])[:, None, None, :]
            return F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask)

        k1, p1, y1 = timer(kernel), timer(plain), timer(gather_sdpa)
        y2, p2, k2 = timer(gather_sdpa), timer(plain), timer(kernel)
        t_k, t_p, t_y = (k1 + k2) / 2, (p1 + p2) / 2, (y1 + y2) / 2
        if timer is graph_ms:
            print(f"time paged {label} with the host launch (events over 10 "
                  f"back-to-back calls): kernel {time_ms(kernel):.4f} ms")
        print(f"time paged {label} ({how}, in turns): kernel {k1:.4f} / {k2:.4f} ms, "
              f"mean {t_k:.4f} ({100 * bound / t_k:.1f}% of bound), plain {p1:.4f} / "
              f"{p2:.4f} ms, bound {bound:.4f} ms (bytes: {nbytes / 1e6:.3f} MB "
              f"live); yardstick only, not the same work: gather + "
              f"F.scaled_dot_product_attention {y1:.4f} / {y2:.4f} ms [{card}]")
        out[label] = dict(ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by="bytes",
                          library_ms=None)
        del q, kp, vp, tables, pos, case, idx
        gc.collect()
        torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **out["charlm decode"], long=out["long context"])


def request_mix(n: int, seed: int) -> list:
    """The seeded generation mix of tools/token_bench.py: prompts of 1 to
    seq_len/4 - 1 tokens, lengths between 1/8 and 1/3 of what is left of
    the window."""
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        n_p = int(rs.randint(1, max(2, CHARLM["seq_len"] // 4)))
        hi = CHARLM["seq_len"] - n_p
        m = int(rs.randint(max(1, hi // 8), max(2, hi // 3 + 1)))
        reqs.append((list(rs.randint(0, CHARLM["vocab"], n_p)), m))
    return reqs


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def window_logits(rect, seqs: list) -> list:
    """The rectangle decoder's full-window forward of each id list (right
    padded, ``slots`` rows a forward): one [len, vocab] tensor each."""
    out = []
    n = rect.slots
    for i in range(0, len(seqs), n):
        chunk = seqs[i:i + n]
        data = np.zeros((n, rect.seq_len), np.int32)
        for r, ids in enumerate(chunk):
            data[r, :len(ids)] = ids
        logits = rect.forward_logits(data)
        out += [logits[r, :len(ids)] for r, ids in enumerate(chunk)]
    return out


def phase_token(card: str) -> dict:
    """The slice's path: the full-width char LM served by a PagedDecoder,
    checked against decoding alone, the full-window forward and the
    rectangle decoder."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.continuous import ContinuousDecoder
    from sparknet_tpu_torch.serve.paged import PagedDecoder

    kw = dict(CHARLM, block_tokens=BLOCK_TOKENS, seed=SEED)
    warm = PagedDecoder(**kw)  # weights: the port's seeded init
    variables = warm.variables
    n_params = sum(t.numel() for pl in variables.params.values() for t in pl)
    for p, m in request_mix(4, SEED + 99):  # warm-up: cuBLAS set-up
        warm.submit(p, m)
    warm.run()
    del warm
    reqs = request_mix(N_REQUESTS, SEED + 6)
    d = PagedDecoder(**kw, variables=variables)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = [d.submit(p, m) for p, m in reqs]
    produced = d.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_n, paged_n = kernels.FLASH_LAUNCHES, kernels.PAGED_LAUNCHES
    st = d.stats()
    led = st["ledger"]
    check(all(t.done() for t in tickets), "a ticket did not resolve")
    check([len(t.result) for t in tickets] == [m for _, m in reqs], "wrong lengths")
    check(led["leaked"] == 0 and led["in_use"] == 0, f"pool ledger {led}")
    check(flash_n == 2 * st["prefills"] and paged_n == 2 * st["steps"],
          f"launches flash {flash_n} paged {paged_n} for {st['prefills']} prefills, "
          f"{st['steps']} steps")
    print(f"token: charlm {CHARLM} ({n_params:,} params), block_tokens "
          f"{BLOCK_TOKENS}, pool {st['blocks_total'] + 1} blocks "
          f"({st['pool_hbm_bytes'] / 1e6:.3f} MB); {len(reqs)} requests, prompts "
          f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)} tokens, "
          f"{produced} tokens generated in {wall * 1e3:.1f} ms: "
          f"{produced / wall:.1f} tokens/s; {st['prefills']} prefills, "
          f"{st['steps']} decode steps; launches flash {flash_n} (2 per prefill), "
          f"paged {paged_n} (2 per decode step); ledger {led} [{card}]")
    print(f"token: decode step ms p50 {st['decode_step_ms_p50']:.3f} p99 "
          f"{st['decode_step_ms_p99']:.3f}; prefill ms p50 {st['prefill_ms_p50']:.3f} "
          f"p99 {st['prefill_ms_p99']:.3f}; TTFT ms p50 {st['ttft_ms_p50']:.3f} p99 "
          f"{st['ttft_ms_p99']:.3f} (all {len(reqs)} submitted at once); inter-token ms p50 "
          f"{st['inter_token_ms_p50']:.3f} p99 {st['inter_token_ms_p99']:.3f} "
          f"(host clock, upload to host copy) [{card}]")

    # the same mix again, keeping every generated token's logits
    dk = PagedDecoder(**kw, variables=variables, keep_logits=True)
    kt = [dk.submit(p, m) for p, m in reqs]
    dk.run()
    check([t.result for t in kt] == [t.result for t in tickets],
          "a second run of the mix gave other tokens")

    # interleaved == alone
    alone = PagedDecoder(**kw, variables=variables)
    picked = list(range(0, N_REQUESTS, N_REQUESTS // 8))
    for i in picked:
        t = alone.submit(*reqs[i])
        alone.run()
        check(t.result == tickets[i].result,
              f"request {i}: interleaved {tickets[i].result} != alone {t.result}")
    print(f"token: interleaved == alone on token ids for requests {picked}")

    # paged vs one full-window forward of prompt + continuation
    rect = ContinuousDecoder(**CHARLM, variables=variables)
    seqs = [p + t.result for (p, _), t in zip(reqs, kt)]
    fulls = window_logits(rect, seqs)
    worst, n_ties, n_tok = 0.0, 0, 0
    for (p, m), t, full in zip(reqs, kt, fulls):
        ref = full[len(p) - 1:len(p) - 1 + m]
        got = dk.generation_logits[t.id]
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        margin = top2_margin(ref)
        picks = ref.argmax(-1).cpu().tolist()
        for j, (tok, pick, mg) in enumerate(zip(t.result, picks, margin.tolist())):
            n_tok += 1
            if mg <= MARGIN:
                n_ties += 1
            elif tok != pick:
                check(False, f"request {t.id} token {j}: paged {tok}, full-window "
                             f"argmax {pick}, margin {mg:.3e}")
        check(err <= 1e-4, f"request {t.id}: paged vs full-window logits {err:.3e}")
    print(f"token: paged vs full-window forward of prompt + continuation: logits max "
          f"abs diff {worst:.3e} (atol 1e-4) over {n_tok} tokens; every token is the "
          f"full-window argmax where the top-2 margin exceeds {MARGIN:g} "
          f"({n_ties} positions at or below it)")

    # the rectangle decoder on the same mix
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rt = [rect.submit(p, m) for p, m in reqs]
    rect.run()
    torch.cuda.synchronize()
    rwall = time.perf_counter() - t0
    rect_flash = kernels.FLASH_LAUNCHES
    check(rect_flash == 2 * rect.steps,
          f"rectangle: {rect_flash} flash launches in {rect.steps} steps")
    diverged = 0
    for (p, m), t, r, full in zip(reqs, tickets, rt, fulls):
        for j, (a, b) in enumerate(zip(t.result, r.result)):
            if a != b:
                mg = float(top2_margin(full[len(p) - 1 + j]))
                print(f"  rectangle diverges from paged at request {t.id} token {j}: "
                      f"{b} vs {a}, margin {mg:.3e}")
                check(mg <= MARGIN, f"request {t.id}: rectangle != paged at token "
                                    f"{j} with margin {mg:.3e}")
                diverged += 1
                break
    print(f"token: rectangle ContinuousDecoder on the same mix: {rect.steps} steps, "
          f"{rect_flash} flash launches (2 per step), {sum(len(r.result) for r in rt)} "
          f"tokens in {rwall * 1e3:.1f} ms ({sum(len(r.result) for r in rt) / rwall:.1f} "
          f"tokens/s); {N_REQUESTS - diverged} of {N_REQUESTS} generations equal to "
          f"the paged ones, {diverged} part at a top-2 margin <= {MARGIN:g} [{card}]")
    rope_check()
    phase_buckets(d)
    return dict(flash=flash_n + rect_flash, paged=paged_n,
                step_ms=st["decode_step_ms_p50"], prefill_ms=st["prefill_ms_p50"],
                reqs=reqs, variables=variables)


def rope_check() -> None:
    """rope_at at position t is rope's row t, bit for bit, on the card: over
    the whole window at once, and one position a row (the decode step's
    [B, H, 1, D] shape)."""
    from sparknet_tpu_torch.ops.attention import rope, rope_at

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b, s, h = CHARLM["slots"], CHARLM["seq_len"], CHARLM["heads"]
    x = torch.randn((b, h, s, CHARLM["embed_dim"] // h), generator=gen, device="cuda")
    full = rope(x)
    window = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s)
    pos = torch.randint(0, s, (b,), generator=gen, device="cuda")
    rows = torch.arange(b, device="cuda")
    at = rope_at(x[rows, :, pos][:, :, None], pos[:, None].to(torch.int32))
    same = torch.equal(rope_at(x, window), full) and torch.equal(at[:, :, 0], full[rows, :, pos])
    print(f"token: rope_at == rope bit for bit on the card over {list(x.shape)} and "
          f"at one position a row: {same}")
    check(same, "rope_at differs from rope on the card")


def phase_buckets(d) -> None:
    """One prompt prefilled in bucket 2 and in bucket 32 on zeroed pools:
    the written pool lines and the last logits, bit for bit."""
    from sparknet_tpu_torch.models import build_prefill

    prefill = build_prefill(d.network)
    s, mb = d.seq_len, d.blocks_per_slot
    prompt = request_mix(1, SEED + 7)[0][0]
    outs = []
    for bucket in (2, d.slots):
        tokens = torch.zeros((bucket, s), dtype=torch.int32, device="cuda")
        tokens[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        lengths = torch.ones(bucket, dtype=torch.int32, device="cuda")
        lengths[0] = len(prompt)
        tables = torch.zeros((bucket, mb), dtype=torch.int32, device="cuda")
        tables[0] = torch.arange(1, mb + 1, dtype=torch.int32)
        kp, vp = torch.zeros_like(d._k_pool), torch.zeros_like(d._v_pool)
        last = prefill(d.variables, tokens, lengths, kp, vp, tables)
        lines = len(prompt)
        outs.append((last[0].clone(),
                     kp[:, 1:].reshape(kp.shape[0], -1, *kp.shape[3:])[:, :lines].clone(),
                     vp[:, 1:].reshape(vp.shape[0], -1, *vp.shape[3:])[:, :lines].clone()))
    (l2, k2, v2), (l32, k32, v32) = outs
    diff = max(float((l2 - l32).abs().max()), float((k2 - k32).abs().max()),
               float((v2 - v32).abs().max()))
    same = torch.equal(l2, l32) and torch.equal(k2, k32) and torch.equal(v2, v32)
    print(f"token: bucket invariance, one {len(prompt)}-token prompt prefilled in "
          f"bucket 2 and in bucket {d.slots}: last logits and written K/V lines "
          f"{'bit for bit equal' if same else f'differ, max abs diff {diff:.3e}'}; "
          f"policy: every prefill runs at the {d.slots}-row bucket")


def phase_token_profile(card: str, token: dict) -> None:
    """Where the device time of a prefill + decode step and of a decode
    step goes."""
    from sparknet_tpu_torch.serve.paged import PagedDecoder

    d = PagedDecoder(**CHARLM, block_tokens=BLOCK_TOKENS, variables=token["variables"])
    for p, m in token["reqs"][:CHARLM["slots"]]:
        d.submit(p, max(m, 4))
    for label, unprofiled in (
            (f"prefill of {d.slots} rows + decode step",
             token["prefill_ms"] + token["step_ms"]),
            ("decode step", token["step_ms"])):
        device_ms, rows = device_breakdown(d.step, top=1000)
        if device_ms == 0.0:
            print("token profile: torch.profiler recorded no device time")
            return
        print(f"token profile: one {label} under torch.profiler: {device_ms:.4f} ms of "
              f"kernels ({sum(r[2] for r in rows)} launches of {len(rows)} kernels); "
              f"device-busy share {100 * device_ms / unprofiled:.1f}% of the unprofiled "
              f"p50 wall {unprofiled:.3f} ms (token phase) [{card}]")
        for ms, name, calls in rows[:8]:
            print(f"  {ms:8.4f} ms  {100 * ms / device_ms:5.1f}%  x{calls}  {name[:90]}")
        for key in ("flash_forward_kernel", "paged_attention_kernel"):
            for i, (ms, name, calls) in enumerate(rows):
                if key in name:
                    print(f"  port kernel {key}: {ms:.4f} ms, {100 * ms / device_ms:.1f}%, "
                          f"x{calls}, rank {i + 1} of {len(rows)}")


# ---------------------------------------------------------------------------
# Distributed training slice: SparkNet's rounds on torch.distributed
# ---------------------------------------------------------------------------

PAR_TAU = 5  # the timed rounds of the world of one
PAR_TIMED_ROUNDS = 3
# the world of two on one card (gloo): (mode, tau, rounds, elastic_alpha)
PAR2_MODES = (("tau1", 1, 2, 0.0), ("tau2", 2, 2, 0.0), ("easgd", 2, 1, 0.45))
PAR2_TOL = dict(rtol=1e-5, atol=1e-7)  # the fused-vs-per-blob gate


def parallel_batch(rank: int, it: int) -> dict:
    """Worker ``rank``'s seeded AlexNet batch of iteration ``it``: 256
    images of 227x227 at raw-pixel scale, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1000 * (rank + 1) + it)
    return {
        "data": torch.randn((256, 3, 227, 227), generator=gen, device="cuda") * 50,
        "label": torch.randint(0, 1000, (256,), generator=gen, device="cuda",
                               dtype=torch.int32),
    }


def parallel_feeds(rank: int, tau: int):
    """The trainer's ``data_fn`` for worker ``rank``: [256, ...] feeds at
    ``tau`` 0 (a Solver's and a sync round's), [tau, 256, ...] otherwise."""
    def data_fn(it):
        if not tau:
            return parallel_batch(rank, it)
        batches = [parallel_batch(rank, it + i) for i in range(tau)]
        return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}

    return data_fn


def arena_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, bool, float]:
    """(within PAR2_TOL, bit for bit, max abs diff) of two arenas."""
    return (torch.allclose(got, want, **PAR2_TOL), torch.equal(got, want),
            float((got - want).abs().max()))


def event_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event ms of single calls of ``fn`` (each synchronised)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def sync_round_cost(card: str, tr, ref, start: int) -> None:
    """What a tau-1 round adds to a step: the grad all-reduce, the loss's
    all-reduce and its read on the host.  Rounds of ``tr`` and steps of
    ``ref`` (a lone Solver) alternate on the same pre-drawn batches, timed
    by the host clock over synchronised runs of 3."""
    feeds = {it: parallel_batch(0, it) for it in range(start, start + 6)}
    ms = {"round": [], "step": []}
    for k in range(2):
        for label, run in (("round", lambda: tr.train_round(feeds.__getitem__)),
                           ("step", lambda: ref.step(1, feeds.__getitem__))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            ms[label].append(1e3 * (time.perf_counter() - t0) / 3)
    print(f"parallel: world of one (NCCL), tau 1: ms a round {[round(x, 3) for x in ms['round']]} "
          f"against a lone Solver.step {[round(x, 3) for x in ms['step']]} (dropout 0, "
          f"deterministic cuDNN, means of 3, alternating) [{card}]")


def parallel_world_one(card: str) -> dict:
    """A world of one on cuda:0 (NCCL, formed by the trainer itself): the
    rounds bit for bit against a second Solver's steps at dropout 0 with
    deterministic cuDNN, then timed tau-5 rounds at dropout 0.5."""
    import torch.distributed as dist

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.parallel import ParallelTrainer

    net0 = alexnet_net(0.0)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tau, rounds, alpha in ((1, 3, 0.0), (5, 2, 0.0), (2, 1, 0.9)):
            solver = train_solver(net0, models.alexnet_solver())
            ref = train_solver(net0, models.alexnet_solver())
            tr = ParallelTrainer(solver, tau=tau, elastic_alpha=alpha)
            check(dist.get_backend() == "nccl" and tr.num_workers == 1,
                  f"world of one: backend {dist.get_backend()}, {tr.num_workers} workers")
            c0 = solver._param_arena.clone() if alpha else None
            losses = [tr.train_round(parallel_feeds(0, tau if tau > 1 or alpha else 0))
                      for _ in range(rounds)]
            ref.step(tau * rounds, parallel_feeds(0, 0))
            check(all(np.isfinite(losses)), f"world of one losses {losses}")
            if alpha:
                with torch.no_grad():
                    d = ref._param_arena - c0
                    want_x, want_c = ref._param_arena - alpha * d, c0 + alpha * d
                ok = (torch.allclose(solver._param_arena, want_x, rtol=1e-6, atol=0)
                      and torch.allclose(tr._center[0], want_c, rtol=1e-6, atol=0))
                print(f"parallel: world of one (NCCL), EASGD alpha {alpha}, 1 round of "
                      f"tau {tau}: worker and center against the formula on {tau} "
                      f"Solver.steps (rtol 1e-6): {'ok' if ok else 'FAIL'}; max abs diff "
                      f"{float((solver._param_arena - want_x).abs().max()):.3e} / "
                      f"{float((tr._center[0] - want_c).abs().max()):.3e}")
                check(ok, "world of one: EASGD against the formula")
            else:
                same = torch.equal(solver._param_arena, ref._param_arena) and all(
                    torch.equal(a, b) for a, b in zip(solver._slot_arenas, ref._slot_arenas))
                print(f"parallel: world of one (NCCL), tau {tau}, {rounds} rounds against "
                      f"{tau * rounds} Solver.steps from the same weights and batches: "
                      f"params and history {'bit for bit equal' if same else 'DIFFER'}; "
                      f"losses {[round(x, 6) for x in losses]}")
                check(same, f"world of one: tau {tau} rounds != Solver.steps")
            if tau == 1:
                sync_round_cost(card, tr, ref, rounds)
            tr.close()
            del solver, ref, tr, c0
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = prev

    # the real recipe: dropout 0.5, tau 5, timed after a warm-up round
    solver = train_solver(alexnet_net(0.5), models.alexnet_solver())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    tr = ParallelTrainer(solver, tau=PAR_TAU)
    held = torch.cuda.memory_allocated() - held  # the trainer's own device memory
    data_fn = parallel_feeds(0, PAR_TAU)
    tr.train_round(data_fn)
    feeds = {it: data_fn(it) for it in range(tr.iter, tr.iter + PAR_TAU * PAR_TIMED_ROUNDS,
                                             PAR_TAU)}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [tr.train_round(feeds.__getitem__) for _ in range(PAR_TIMED_ROUNDS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
              kernels.FUSED_UPDATE_LAUNCHES)
    want = (2 * PAR_TAU * PAR_TIMED_ROUNDS,) * 2 + (PAR_TAU * PAR_TIMED_ROUNDS,)
    check(counts == want, f"world of one launches (lrn fwd, lrn bwd, fused) {counts}, "
                          f"want {want}")
    check(all(np.isfinite(losses)), f"world of one losses {losses}")
    buf = solver._param_arena.clone()
    ar_ms = event_ms(lambda: tr._mean_([buf]))
    nbytes = solver.layout.total_bytes
    ms_round = 1e3 * dt / PAR_TIMED_ROUNDS
    print(f"parallel: world of one (NCCL, cuda:0), AlexNet b256 a worker, dropout 0.5, "
          f"fused update, tau {PAR_TAU}: {PAR_TIMED_ROUNDS} rounds after a warm-up, "
          f"{ms_round:.2f} ms a round ({ms_round / PAR_TAU:.2f} ms a step), "
          f"{256 * PAR_TAU * PAR_TIMED_ROUNDS / dt:.1f} img/s; losses "
          f"{[round(x, 4) for x in losses]}; launches a round: LRN forward "
          f"{counts[0] // PAR_TIMED_ROUNDS}, LRN backward {counts[1] // PAR_TIMED_ROUNDS}, "
          f"fused update {counts[2] // PAR_TIMED_ROUNDS}; the average's all-reduce "
          f"(NCCL, one rank) {ar_ms:.4f} ms over the {nbytes / 1e6:.1f} MB arena "
          f"(CUDA events, median of 5), {100 * ar_ms / ms_round:.2f}% of a round; the "
          f"trainer's own device memory {held} bytes (it steps the Solver's arenas) [{card}]")
    tr.close()
    del tr, solver, buf, feeds
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, ms_round=ms_round, allreduce_ms=ar_ms)


def parallel_worker(rank: int, work: str) -> None:
    """One worker of the world of two: gloo, both ranks on cuda:0, joined
    through a FileStore in ``work``.  Runs every mode of PAR2_MODES from
    the same seeded weights on its own batches, checks after every round
    that both ranks hold the same params (the center under EASGD) bit for
    bit, and writes its arenas, times and launch counts into ``work``.
    Spawned by ``phase_parallel`` (start method spawn), so it is a
    module-level function."""
    import hashlib

    import torch.distributed as dist

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.parallel import (
        ParallelTrainer,
        data_parallel_group,
        initialize_distributed,
    )

    torch.cuda.set_device(0)
    set_config(fused_update=True, storage_dtype="f32")
    torch.backends.cudnn.deterministic = True
    initialize_distributed(backend="gloo", store_path=f"{work}/store", rank=rank,
                           world_size=2)
    try:
        net0 = alexnet_net(0.0)
        result = {}
        for mode, tau, rounds, alpha in PAR2_MODES:
            solver = train_solver(net0, models.alexnet_solver())
            tr = ParallelTrainer(solver, group=data_parallel_group(2), tau=tau,
                                 elastic_alpha=alpha)
            data_fn = parallel_feeds(rank, tau if tau > 1 or alpha else 0)
            kernels.reset_launch_counts()
            ms, losses, digests = [], [], []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(tr.train_round(data_fn))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                shared = tr._center[0] if alpha else solver._param_arena
                digests.append(hashlib.sha256(shared.cpu().numpy().tobytes()).hexdigest())
            counts = [kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
                      kernels.FUSED_UPDATE_LAUNCHES]
            both = [None, None]
            dist.all_gather_object(both, digests)
            check(both[0] == both[1], f"world of two, {mode}: the ranks differ after "
                                      f"a round")
            buf = solver._param_arena.clone()
            ar_ms = event_ms(lambda: tr._mean_([buf]), reps=3)
            if rank == 0 or alpha:
                torch.save({"arena": solver._param_arena.cpu(),
                            "center": tr._center[0].cpu() if alpha else None},
                           f"{work}/{mode}.rank{rank}.pt")
            result[mode] = dict(ms=ms, losses=losses, counts=counts, allreduce_ms=ar_ms,
                                nbytes=solver.layout.total_bytes)
            del tr, solver, buf
            gc.collect()
            torch.cuda.empty_cache()
        with open(f"{work}/rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def arena_grad(solver, feeds: dict) -> torch.Tensor:
    """The grad arena of ``solver``'s train loss on ``feeds`` at its
    current weights (dropout 0: no generator draws)."""
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.compiler.graph import NetVars
    from sparknet_tpu_torch.solvers.arena import unpack

    with f32_precision():
        leaf = solver._param_arena.detach().requires_grad_(True)
        _, _, loss = solver.train_net.apply(
            NetVars(unpack(solver.layout, leaf), solver._state), feeds,
            gen=torch.Generator(device="cuda"))
        (g,) = torch.autograd.grad(loss, leaf)
    return g


def parallel_oracle(tau: int, rounds: int, alpha: float):
    """SparkNet's rounds for two workers in this process, from the weights
    and batches the world of two used: the mean of the two workers'
    gradients applied to one replica (tau 1), or two Solvers stepping
    tau times each and then the mean of their arenas, or the EASGD
    formula.  Returns (worker 0's arena, worker 1's, the center)."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.solvers.solver import build_fused_step

    net0 = alexnet_net(0.0)
    a = train_solver(net0, models.alexnet_solver())
    if tau == 1 and not alpha:
        for it in range(rounds):
            g1 = arena_grad(a, parallel_batch(1, it))
            step = build_fused_step(a.config, a.train_net, a.layout, a._tables,
                                    reduce_grads=lambda g: g.add_(g1).div_(2))
            a._state, _ = step(a._param_arena, a._slot_arenas, a._state, it,
                               parallel_batch(0, it), torch.Generator(device="cuda"))
        return a._param_arena, None, None
    b = train_solver(net0, models.alexnet_solver())
    c = a._param_arena.clone()
    for _ in range(rounds):
        a.step(tau, parallel_feeds(0, 0))
        b.step(tau, parallel_feeds(1, 0))
        with torch.no_grad():
            if alpha:
                da, db = a._param_arena - c, b._param_arena - c
                a._param_arena.sub_(alpha * da)
                b._param_arena.sub_(alpha * db)
                c.add_(alpha * (da + db))
            else:
                mean = (a._param_arena + b._param_arena) / 2
                a._param_arena.copy_(mean)
                b._param_arena.copy_(mean)
    return a._param_arena, b._param_arena, c


def parallel_world_two(card: str) -> dict:
    """The world of two on one card: two spawned gloo ranks on cuda:0, then
    the in-process oracle of their rounds."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sparknet_parallel_") as work:
        t0 = time.perf_counter()
        mp.start_processes(parallel_worker, args=(work,), nprocs=2, join=True,
                           start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(f"{work}/rank{r}.json") as f:
                ranks.append(json.load(f))
        counts = [0, 0, 0]
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for mode, tau, rounds, alpha in PAR2_MODES:
                steps = tau * rounds
                want = [2 * steps, 2 * steps, steps]
                for r, res in enumerate(ranks):
                    got = res[mode]["counts"]
                    check(got == want, f"world of two, {mode}, rank {r}: launches "
                                       f"(lrn fwd, lrn bwd, fused) {got}, want {want}")
                    counts = [c + g for c, g in zip(counts, got)]
                    check(all(np.isfinite(res[mode]["losses"])),
                          f"world of two, {mode}, rank {r}: losses {res[mode]['losses']}")
                want_a, want_b, want_c = parallel_oracle(tau, rounds, alpha)
                saved = torch.load(f"{work}/{mode}.rank0.pt")
                gates = [("worker 0", saved["arena"], want_a)]
                if alpha:
                    saved1 = torch.load(f"{work}/{mode}.rank1.pt")
                    gates += [("worker 1", saved1["arena"], want_b),
                              ("center", saved["center"], want_c)]
                report = []
                for label, got, want_t in gates:
                    ok, same, diff = arena_diff(got.cuda(), want_t)
                    report.append(f"{label} {'bit for bit' if same else f'max abs diff {diff:.3e}'}")
                    check(ok, f"world of two, {mode}: {label} against the oracle, max abs "
                              f"diff {diff:.3e}")
                del want_a, want_b, want_c, saved
                gc.collect()
                torch.cuda.empty_cache()
                r0 = ranks[0][mode]
                print(f"parallel: world of two (gloo, both ranks on cuda:0), {mode} (tau "
                      f"{tau}, alpha {alpha}), {rounds} rounds: ranks bit for bit equal "
                      f"after every round; against the in-process oracle (rtol 1e-5, atol "
                      f"1e-7): {', '.join(report)}; ms a round (host clock, both ranks "
                      f"sharing the card) rank 0 {[round(x, 1) for x in r0['ms']]}, rank 1 "
                      f"{[round(x, 1) for x in ranks[1][mode]['ms']]}; the gloo all-reduce "
                      f"of the {r0['nbytes'] / 1e6:.1f} MB arena {r0['allreduce_ms']:.1f} / "
                      f"{ranks[1][mode]['allreduce_ms']:.1f} ms (CUDA events, median of 3); "
                      f"losses {[round(x, 4) for x in r0['losses']]}; launches a rank "
                      f"{r0['counts']} [{card}]")
        finally:
            torch.backends.cudnn.deterministic = prev
    print(f"parallel: world of two spawned, ran and joined in {spawn_s:.1f} s")
    return dict(counts=counts)


def parallel_head_dims(card: str) -> dict:
    """Head dims between the attention kernels' widths, on the kernels:
    flash zero-padded inside its wrapper, paged on pools allocated at
    ``kernel_head_dim`` lanes, each against its plain version at the true
    width; then a PagedDecoder of head dim 12 against the rectangle
    decoder, with exact launch counts."""
    import math

    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.continuous import ContinuousDecoder
    from sparknet_tpu_torch.serve.paged import PagedDecoder

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    max_err = 0.0
    kernels.reset_launch_counts()
    with f32_precision():
        for shape, causal in (((2, 4, 100, 12), True), ((2, 4, 64, 48), False)):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
            ref = kernels.flash_attention_torch(q, k, v, causal)
            o = kernels.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ok, err = attention_within(o, ref, 1e-6)
            max_err = max(max_err, err)
            print(f"parallel: flash {list(shape)} causal {int(causal)} on the kernel at "
                  f"head dim {kernels.kernel_head_dim(shape[-1])}: max abs err {err:.3e} "
                  f"(rtol 1e-5, atol 1e-6) {'ok' if ok else 'FAIL'}")
            check(ok, f"flash head dim {shape[-1]}")
        for d in (12, 24, 100):
            t, mb = 8, 20
            positions = [0, t - 1, t, 31, 32, 33, 63, 64, 65, 127, 128, 129, mb * t - 1]
            q, kp, vp, tables, pos = paged_case(gen, len(positions), 2, d, t, mb,
                                                positions, own_only=True)
            w = kernels.kernel_head_dim(d)
            pad = lambda x: F.pad(x, (0, w - d)).contiguous()  # noqa: E731
            ref = kernels.paged_attention_torch(q, kp, vp, tables, pos)
            o = kernels.paged_attention(pad(q), pad(kp), pad(vp), tables, pos,
                                        scale=1.0 / math.sqrt(d))
            torch.cuda.synchronize()
            ok, err = attention_within(o[..., :d], ref, 1e-6)
            ok = ok and not o[..., d:].any()
            max_err = max(max_err, err)
            print(f"parallel: paged D {d} on pools of {w} lanes, T {t}, MB {mb}: max abs "
                  f"err {err:.3e} (rtol 1e-5, atol 1e-6), padded lanes 0: "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"paged head dim {d}")
    check((kernels.FLASH_LAUNCHES, kernels.PAGED_LAUNCHES) == (2, 3),
          f"head-dim cases launched flash {kernels.FLASH_LAUNCHES}, paged "
          f"{kernels.PAGED_LAUNCHES} times, want 2 and 3")

    geo = dict(CHARLM, embed_dim=48)  # 4 heads of 12
    reqs = request_mix(8, SEED + 12)
    dec = PagedDecoder(**geo, block_tokens=BLOCK_TOKENS, seed=SEED)
    check(dec._k_pool.shape[-1] == 16, f"pools of {dec._k_pool.shape[-1]} lanes")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tickets = [dec.submit(p, m) for p, m in reqs]
    dec.run()
    st = dec.stats()
    flash_n, paged_n = kernels.FLASH_LAUNCHES, kernels.PAGED_LAUNCHES
    check(flash_n == 2 * st["prefills"] and paged_n == 2 * st["steps"],
          f"head dim 12: launches flash {flash_n} paged {paged_n} for "
          f"{st['prefills']} prefills, {st['steps']} steps")
    check(not dec._k_pool[..., 12:].any(), "head dim 12: a padded pool lane is not 0")
    rect = ContinuousDecoder(**geo, variables=dec.variables)
    kernels.reset_launch_counts()
    rt = [rect.submit(p, m) for p, m in reqs]
    rect.run()
    rect_flash = kernels.FLASH_LAUNCHES
    check(rect_flash == 2 * rect.steps, f"head dim 12 rectangle: {rect_flash} flash "
                                        f"launches in {rect.steps} steps")
    fulls = window_logits(rect, [p + t.result for (p, _), t in zip(reqs, tickets)])
    equal = 0
    for (p, _), t, r, full in zip(reqs, tickets, rt, fulls):
        mismatch = [j for j, (a, b) in enumerate(zip(t.result, r.result)) if a != b]
        if mismatch:
            mg = float(top2_margin(full[len(p) - 1 + mismatch[0]]))
            check(mg <= MARGIN, f"head dim 12: rectangle != paged at token "
                                f"{mismatch[0]} with margin {mg:.3e}")
        else:
            equal += 1
    print(f"parallel: PagedDecoder with embed_dim 48 over 4 heads (head dim 12, pools "
          f"at 16 lanes): {len(reqs)} requests, {st['prefills']} prefills, {st['steps']} "
          f"decode steps; launches flash {flash_n} (2 a prefill), paged {paged_n} (2 a "
          f"step); {equal} of {len(reqs)} generations equal to the rectangle "
          f"decoder's ({rect_flash} flash launches), the rest part at a top-2 margin "
          f"<= {MARGIN:g} [{card}]")
    return dict(flash=flash_n + rect_flash, paged=paged_n, max_abs_err=max_err)


def phase_parallel(card: str) -> dict:
    """The distributed slice: SparkNet's rounds with AlexNet b256 a worker,
    in a world of one (NCCL) and a world of two (gloo) on the card, then
    the head dims between the attention kernels' widths."""
    from sparknet_tpu_torch.common import set_config

    t0 = time.perf_counter()
    set_config(fused_update=True, storage_dtype="f32")
    try:
        one = parallel_world_one(card)
        two = parallel_world_two(card)
    finally:
        set_config(fused_update=False)
    heads = parallel_head_dims(card)
    print(f"parallel: phase done in {time.perf_counter() - t0:.1f} s")
    counts = [a + b for a, b in zip(one["counts"], two["counts"])]
    return dict(lrn=counts[0], lrn_backward=counts[1], fused_update=counts[2],
                flash=heads["flash"], paged=heads["paged"])


# ---------------------------------------------------------------------------
# Flash attention's backward and the char LM's training slice
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = [  # (label, shape, causal); the flash phase's shapes and D 12, 200
    ("charlm", (32, 4, 128, 16), True),
    ("charlm, not causal", (32, 4, 128, 16), False),
    ("ragged S=100", (2, 4, 100, 16), True),
    ("ragged S=100, not causal", (2, 4, 100, 16), False),
    ("D=8", (4, 4, 128, 8), True),
    ("D=12, padded to 16", (2, 4, 100, 12), True),
    ("D=32 ragged", (2, 2, 77, 32), True),
    ("D=64", (4, 4, 200, 64), False),
    ("D=128", (2, 2, 130, 128), True),
    ("D=200, padded to 256", (2, 2, 96, 200), False),
    ("D=256", (2, 2, 130, 256), True),
    ("long context", (4, 16, 2048, 64), True),
    ("long context, not causal", (4, 16, 2048, 64), False),
    ("D=128 long", (2, 8, 1024, 128), True),
    ("ragged long", (2, 4, 2000, 64), True),
]
FLASH_BWD_TIMED = ("charlm", "long context", "long context, not causal", "D=128 long")


def flash_backward_bound_ms(shape, causal: bool, card: str) -> tuple[float, str]:
    """Least time of one attention backward: q, k, v, o, dO and lse read
    and dQ, dK, dV written once over the memory rate, or its five
    [S, S, D] products (10 B H S^2 D flops, halved when causal) at the
    faster float32-accurate rate (float32, or dense TF32 over 3), as
    ``flash_bound_ms``."""
    bw, flops, tf32 = card_peaks(card)
    b, h, s, d = shape
    t_bytes = (8 * b * h * s * d + b * h * s) * 4 / bw * 1e3
    work = 10 * b * h * s * s * d * (0.5 if causal else 1.0)
    t_ops = min(work / flops, 3 * work / tf32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grads_within(got, ref, rtol: float, arel: float) -> tuple[bool, float, float]:
    """|got - ref| <= arel * max|ref| + rtol * |ref| everywhere; (ok, max
    abs err, the largest ratio of error to that tolerance: the margin a
    design change spends)."""
    atol = arel * float(ref.abs().max())
    ok, err = attention_within(got, ref, atol, rtol)
    return ok, err, float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def phase_flash_backward(card: str) -> dict:
    """The backward kernel vs flash_attention_backward_torch on the same
    q, k, v, o, lse and g at every case; the forward's lse against the
    plain one, and its o bit for bit the same with and without lse; two
    launches bit for bit equal; batch entry 0 alone and in its batch;
    times beside the bound and SDPA's autograd backward."""
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    max_err, out = 0.0, {}
    with f32_precision():
        for label, shape, causal in FLASH_BWD_CASES:
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            o, lse = kernels._flash_attention_cuda(q, k, v, causal, with_lse=True)
            o_alone = kernels._flash_attention_cuda(q, k, v, causal)
            _, lse_ref = kernels.flash_attention_forward_lse_torch(q, k, v, causal)
            ref = kernels.flash_attention_backward_torch(q, k, v, o, lse, g, causal)
            got = kernels._flash_attention_backward_cuda(q, k, v, o, lse, g, causal)
            again = kernels._flash_attention_backward_cuda(q, k, v, o, lse, g, causal)
            torch.cuda.synchronize()
            rtol, arel = (1e-5, 1e-6) if shape[2] < 1024 else (1e-4, 1e-5)
            oks, errs, shares = zip(*(grads_within(a, r, rtol, arel)
                                      for a, r in zip(got, ref)))
            lse_ok, lse_err = attention_within(lse, lse_ref, 1e-5)
            same_o = torch.equal(o, o_alone)
            twice = all(torch.equal(a, b) for a, b in zip(got, again))
            max_err = max(max_err, *errs)
            print(f"flash backward {label} {list(shape)} causal {int(causal)}: max abs err "
                  f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (rtol {rtol:g}, atol "
                  f"{arel:g} x max|ref|; at most {max(shares):.3f} of it) "
                  f"{'ok' if all(oks) else 'FAIL'}; forward lse max abs "
                  f"err {lse_err:.3e} (1e-5) {'ok' if lse_ok else 'FAIL'}, o with lse bit "
                  f"for bit o without: {same_o}; two launches bit for bit: {twice}")
            check(all(oks), f"flash backward {label}")
            check(lse_ok, f"flash forward lse {label}")
            check(same_o, f"flash forward {label}: o changes when lse is written")
            check(twice, f"flash backward {label}: two launches differ")
            if label == "charlm":
                alone = kernels._flash_attention_backward_cuda(
                    q[:1], k[:1], v[:1], o[:1], lse[:1], g[:1], causal)
                torch.cuda.synchronize()
                same = all(torch.equal(a[0], b[0]) for a, b in zip(alone, got))
                print(f"flash backward {label}: batch entry 0 alone (B = 1) and in the "
                      f"batch of {shape[0]}: {'bit for bit equal' if same else 'DIFFER'}")
                check(same, "flash backward: batch entry 0 differs alone and in its batch")
            del ref, again
            if label not in FLASH_BWD_TIMED:
                continue
            small = label == "charlm"
            timer = graph_ms if small else (lambda fn: time_ms(fn, reps=10))
            how = "CUDA graph" if small else "events"
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

            def sdpa_forward():
                return F.scaled_dot_product_attention(*leaves, is_causal=causal)

            def sdpa_both():
                return torch.autograd.grad(sdpa_forward(), leaves, g)

            t_k = timer(lambda: kernels._flash_attention_backward_cuda(
                q, k, v, o, lse, g, causal))
            t_p = timer(lambda: kernels.flash_attention_backward_torch(
                q, k, v, o, lse, g, causal))
            try:
                t_l = timer(sdpa_both) - timer(sdpa_forward)
            except RuntimeError as err:  # a backward that will not capture
                print(f"flash backward {label}: SDPA's backward not timed by "
                      f"{how} ({str(err)[:120]}); events over back-to-back calls instead")
                torch.cuda.synchronize()
                t_l = time_ms(sdpa_both) - time_ms(sdpa_forward)
            t_lse = timer(lambda: kernels._flash_attention_cuda(q, k, v, causal, True))
            t_fwd = timer(lambda: kernels._flash_attention_cuda(q, k, v, causal))
            bound, by = flash_backward_bound_ms(shape, causal, card)
            print(f"time flash backward {label} {list(shape)} causal {int(causal)} ({how}): "
                  f"kernel {t_k:.4f} ms ({100 * bound / t_k:.1f}% of bound), plain "
                  f"{t_p:.4f} ms, autograd backward of F.scaled_dot_product_attention "
                  f"{t_l:.4f} ms (forward + backward less forward), bound {bound:.4f} ms "
                  f"({by}); forward with lse {t_lse:.4f} ms, without {t_fwd:.4f} ms [{card}]")
            out[label] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                              bound_by=by)
            del leaves, o, lse, got
            gc.collect()
            torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **out["charlm"])


# the char LM trained on the repo's own documentation at the zoo's width
CHARLM_CMP_STEPS = 20  # kernel against plain
CHARLM_TIMED_STEPS = 200
CHARLM_LOSS_GATE = 3.3  # nats: the mean of the last 10 steps (ln 128 = 4.85)
CHARLM_SAMPLE = 64


def charlm_text():
    """README.md and docs/*.md of this checkout, and a vocab of their
    127 most frequent chars (id 0 is every other char): ids below the
    zoo charlm's 128."""
    import collections
    from pathlib import Path

    from sparknet_tpu_torch.data import CharVocab, load_corpus

    root = Path(__file__).resolve().parent
    text = load_corpus([str(root / "README.md")]
                       + sorted(str(p) for p in (root / "docs").glob("*.md")))
    common = collections.Counter(text).most_common(CHARLM["vocab"] - 1)
    return text, CharVocab(sorted(c for c, _ in common))


def charlm_handle(fused: bool, batch: int = CHARLM["slots"]):
    """A TPUNet over the full-width zoo charlm and ``charlm_solver`` (Adam,
    base_lr 2e-3), weights from SEED, on the card."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.net import TPUNet

    set_config(fused_update=fused, storage_dtype="f32")
    geo = {k: v for k, v in CHARLM.items() if k != "slots"}
    cfg = dataclasses.replace(models.charlm_solver(), random_seed=SEED,
                              average_loss=CHARLM_CMP_STEPS, display=0)
    return TPUNet(cfg, models.charlm(batch=batch, **geo))


@contextlib.contextmanager
def plain_attention_core():
    """Every MultiHeadAttention core through flash_attention_torch under
    autograd, in place of the kernels (as forward_with_plain_lrn swaps the
    LRN)."""
    from sparknet_tpu_torch.ops import attention, kernels

    saved = attention.flash_attention
    attention.flash_attention = kernels.flash_attention_torch
    try:
        yield
    finally:
        attention.flash_attention = saved


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic cuDNN and ATen kernels (the embedding's backward among
    them) for the bit-for-bit gates; TF32 stays off (f32_precision)."""
    prev = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])


def solver_state(solver) -> tuple[dict, dict]:
    """Copies of a Solver's params and history, blob-wise."""
    params = {ln: [p.detach().clone() for p in pl]
              for ln, pl in solver.variables.params.items()}
    slots = {ln: [[h.detach().clone() for h in hl] for hl in sl]
             for ln, sl in solver.slots.items()}
    return params, slots


def charlm_compare(card: str, batches: list) -> None:
    """Kernel against plain attention over CHARLM_CMP_STEPS Adam steps,
    per-blob against fused over 3, two runs of 5 bit for bit, and a
    world-of-one round at tau 2 against 2 Solver steps."""
    import torch.distributed as dist

    from sparknet_tpu_torch.parallel import ParallelTrainer

    def run(fused: bool, steps: int, plain: bool = False):
        net = charlm_handle(fused)
        net.set_train_data(lambda it: batches[it])
        with plain_attention_core() if plain else contextlib.nullcontext():
            net.train(steps)
        return net

    # in lockstep: before each step the plain run takes the kernel run's
    # params and history, so that each step is held to the one-step Adam
    # tolerance from the same weights (over free-running steps Adam
    # amplifies last-digit differences of near-zero gradients)
    kern, plain = charlm_handle(True), charlm_handle(True)
    kern.set_train_data(lambda it: batches[it])
    plain.set_train_data(lambda it: batches[it])
    base_lr = kern.solver.config.base_lr
    worst_loss, worst, ok_loss, ok_params = 0.0, 0.0, True, True
    for _ in range(CHARLM_CMP_STEPS):
        with torch.no_grad():
            plain.solver._param_arena.copy_(kern.solver._param_arena)
            for x, y in zip(plain.solver._slot_arenas, kern.solver._slot_arenas):
                x.copy_(y)
        kern.train(1)
        lk = float(kern.solver._loss_window[-1])
        with plain_attention_core():
            plain.train(1)
        lp = float(plain.solver._loss_window[-1])
        worst_loss = max(worst_loss, abs(lk - lp) / abs(lp))
        ok_loss = ok_loss and abs(lk - lp) <= 1e-4 * abs(lp)
        for a_list, b_list in zip(kern.solver.variables.params.values(),
                                  plain.solver.variables.params.values()):
            for x, y in zip(a_list, b_list):
                atol = 1e-5 * float(y.abs().max()) + 1e-2 * base_lr
                ok_params = ok_params and bool(torch.allclose(x, y, rtol=1e-4, atol=atol))
                worst = max(worst, float((x - y).abs().max()))
    print(f"charlm train: {CHARLM_CMP_STEPS} Adam steps through the kernels against the "
          f"same steps with flash_attention_torch under autograd, each from the same "
          f"params and history: loss max rel diff {worst_loss:.3e} (rtol 1e-4) "
          f"{'ok' if ok_loss else 'FAIL'}, last loss {lk:.6f}; params max abs diff "
          f"{worst:.3e} (rtol 1e-4, atol 1e-5 x max + 1e-2 x base_lr) "
          f"{'ok' if ok_params else 'FAIL'} [{card}]")
    check(ok_loss, "charlm: kernel and plain losses differ")
    check(ok_params, "charlm: kernel and plain params differ")
    del kern, plain

    states = [solver_state(run(fused, 3).solver) for fused in (False, True)]
    worst, ok = 0.0, True
    for part in (0, 1):
        a_side, b_side = states[0][part], states[1][part]
        for ln in a_side:
            pairs = zip(a_side[ln], b_side[ln]) if part == 0 else (
                (a, b) for ha, hb in zip(a_side[ln], b_side[ln]) for a, b in zip(ha, hb))
            for a, b in pairs:
                ok = ok and bool(torch.allclose(a, b, rtol=1e-5, atol=1e-7))
                worst = max(worst, float((a - b).abs().max()))
    print(f"charlm train: 3 steps per-blob against 3 fused: params and history max abs "
          f"diff {worst:.3e} (rtol 1e-5, atol 1e-7) {'ok' if ok else 'FAIL'}")
    check(ok, "charlm: per-blob and fused differ")

    a, b = run(True, 5).solver, run(True, 5).solver
    same = torch.equal(a._param_arena, b._param_arena) and all(
        torch.equal(x, y) for x, y in zip(a._slot_arenas, b._slot_arenas))
    print(f"charlm train: two runs of the same 5 steps: params and history "
          f"{'bit for bit equal' if same else 'DIFFER'}")
    check(same, "charlm: two runs of 5 steps differ")
    del a, b

    solver, ref = charlm_handle(True).solver, charlm_handle(True).solver
    tr = ParallelTrainer(solver, tau=2)
    check(dist.get_backend() == "nccl" and tr.num_workers == 1,
          f"world of one: backend {dist.get_backend()}, {tr.num_workers} workers")
    loss = tr.train_round(lambda it: {k: np.stack([batches[it][k], batches[it + 1][k]])
                                      for k in batches[it]})
    ref.step(2, lambda it: batches[it])
    same = torch.equal(solver._param_arena, ref._param_arena) and all(
        torch.equal(x, y) for x, y in zip(solver._slot_arenas, ref._slot_arenas))
    print(f"charlm train: a world-of-one ParallelTrainer round (NCCL) at tau 2, loss "
          f"{loss:.6f}, against 2 Solver steps: params and history "
          f"{'bit for bit equal' if same else 'DIFFER'}")
    check(same, "charlm: a tau-2 round differs from 2 Solver steps")
    tr.close()
    del solver, ref, tr
    gc.collect()


def charlm_sample(card: str, net, vocab) -> dict:
    """generate_chars from the trained weights: greedy through the cached
    path (1 flash launch a layer for the prefill, 1 paged a layer a step)
    against the sliding full forward, and a seeded top-k sample twice."""
    from sparknet_tpu_torch.models import generate_chars
    from sparknet_tpu_torch.ops import kernels

    gnet = charlm_handle(True, batch=1)
    gnet.set_weights(net.get_weights())
    prompt = "SparkNet averages the weights of "
    layers = CHARLM["blocks"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    text = generate_chars(gnet, vocab, prompt, CHARLM_SAMPLE, CHARLM["seq_len"],
                          temperature=0.0)
    dt = time.perf_counter() - t0
    counts = (kernels.FLASH_LAUNCHES, kernels.PAGED_LAUNCHES)
    want = (layers, layers * (CHARLM_SAMPLE - 1))
    check(counts == want, f"generate_chars launches (flash, paged) {counts}, want {want}")
    ids = list(vocab.encode(prompt))
    first_diff, margin = None, None
    for j in range(CHARLM_SAMPLE):
        x = np.zeros((1, CHARLM["seq_len"]), np.int32)
        x[0, :len(ids)] = ids
        logits = gnet.forward({"data": x, "label": np.zeros_like(x)})["fc"][0, len(ids) - 1]
        pick = int(logits.argmax())
        if first_diff is None and vocab.decode([pick]) != text[j]:
            first_diff, margin = j, float(top2_margin(logits))
            break
        ids.append(pick)
    check(first_diff is None or margin <= MARGIN,
          f"generate_chars: cached != sliding at char {first_diff}, margin {margin}")
    top_k = [generate_chars(gnet, vocab, prompt, CHARLM_SAMPLE, CHARLM["seq_len"],
                            temperature=1.0, top_k=5, seed=SEED + 3) for _ in range(2)]
    check(top_k[0] == top_k[1], "generate_chars: a seeded top-k sample differs")
    print(f"charlm sample: greedy {CHARLM_SAMPLE} chars after {prompt!r}: {text!r}; "
          f"launches flash {counts[0]} (prefill), paged {counts[1]} "
          f"({layers} a step); {1e3 * dt:.1f} ms; the sliding full forward "
          + ("agrees on every char" if first_diff is None else
             f"parts at char {first_diff} with top-2 margin {margin:.3e} <= {MARGIN:g}")
          + f"; top_k 5 seeded, twice the same: {top_k[0]!r} [{card}]")
    return dict(flash=counts[0], paged=counts[1])


def charlm_wide_heads_and_bf16(card: str) -> None:
    """A transformer train step over 2 heads of 256 lanes (B3 and B3' at
    their D = 256 instance), and a bf16 flash_attention call against the
    float32 kernel on the upcast inputs."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.net import TPUNet
    from sparknet_tpu_torch.ops import kernels

    set_config(fused_update=False)
    net = TPUNet(dataclasses.replace(models.transformer_solver(), random_seed=SEED),
                 models.transformer(batch=4, seq_len=64, vocab=64, embed_dim=512, heads=2,
                                    ffn_dim=512, blocks=1))
    rs = np.random.RandomState(SEED + 14)
    feeds = {"data": rs.randint(0, 64, (4, 64)).astype(np.int32),
             "label": rs.randint(0, 10, (4,)).astype(np.int32)}
    kernels.reset_launch_counts()
    w_qkv = net.backward(feeds)["attn1"][0]
    net.set_train_data(lambda it: feeds)
    loss = net.train(1)
    counts = (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES)
    norm = float(w_qkv.norm())
    check(counts == (2, 2), f"wide heads: launches (flash, backward) {counts}, want (2, 2)")
    check(np.isfinite(loss) and np.isfinite(norm) and norm > 0,
          f"wide heads: loss {loss}, w_qkv gradient norm {norm}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    q, k, v = (torch.randn((2, 4, 100, 16), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o = kernels.flash_attention(q, k, v, causal=True)
    ref = kernels.flash_attention(q.float(), k.float(), v.float(), causal=True)
    same = o.dtype == torch.bfloat16 and torch.equal(o, ref.to(torch.bfloat16))
    print(f"charlm wide heads: transformer, embed 512 over 2 heads (D 256), one train "
          f"step: loss {loss:.6f}, w_qkv gradient norm {norm:.4e}, launches flash "
          f"{counts[0]}, backward {counts[1]}; bf16 flash_attention [2,4,100,16] causal "
          f"against the float32 kernel on the upcast inputs cast to bf16: "
          f"{'bit for bit equal' if same else 'DIFFER'} [{card}]")
    check(same, "bf16 flash_attention differs from the float32 kernel")


def phase_charlm_train(card: str) -> dict:
    """The slice's path: the full-width char LM trained through TPUNet on
    char_lm_batches of the repo's documentation, f32, TF32 off,
    fused_update on; gates against plain attention, per-blob, a second run
    and a tau-2 round; 200 timed steps that must learn; sampling; wide
    heads and bf16 inputs."""
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.data import char_lm_batches
    from sparknet_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    text, vocab = charlm_text()
    batch, seq = CHARLM["slots"], CHARLM["seq_len"]
    feed = char_lm_batches(text, vocab, batch, seq, seed=SEED)
    batches = [next(feed) for _ in range(CHARLM_CMP_STEPS)]
    print(f"charlm train: corpus README.md + docs/*.md, {len(text)} chars, vocab "
          f"{vocab.size}; batch {batch} x seq_len {seq}")
    try:
        with deterministic_algorithms():
            charlm_compare(card, batches)
        net = charlm_handle(True)
        net.set_train_data(lambda it: batches[it])
        net.train(CHARLM_CMP_STEPS)  # warm-up on the compared batches
        net.set_train_data(feed)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        net.train(CHARLM_TIMED_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
                  kernels.FUSED_UPDATE_LAUNCHES)
        n = CHARLM_TIMED_STEPS
        check(counts == (2 * n, 2 * n, n), f"charlm launches (flash, backward, fused) "
                                           f"{counts}, want {(2 * n, 2 * n, n)}")
        losses = [float(x) for x in net.solver._loss_window[-10:]]
        mean10 = float(np.mean(losses))
        ms = 1e3 * dt / n
        print(f"charlm train: {n} timed steps after {CHARLM_CMP_STEPS}, "
              f"{ms:.3f} ms/step, {batch * seq / (ms / 1e3):.1f} tokens/s; launches a "
              f"step: flash {counts[0] // n}, flash backward {counts[1] // n}, fused "
              f"update {counts[2] // n}; mean loss of the last 10 steps {mean10:.4f} nats "
              f"(gate < {CHARLM_LOSS_GATE}; ln 128 = 4.852) [{card}]")
        check(mean10 < CHARLM_LOSS_GATE, f"charlm did not learn: {mean10:.4f} nats")
        device_ms, rows = device_breakdown(lambda: net.train(1), top=1000)
        if device_ms:
            bwd = sum(t for t, name, _ in rows if "flash_backward" in name)
            print(f"charlm train profile: one step under torch.profiler: {device_ms:.3f} "
                  f"ms of kernels, {100 * device_ms / ms:.1f}% of the unprofiled "
                  f"{ms:.3f} ms/step; the flash backward's three kernels {bwd:.4f} ms, "
                  f"{100 * bwd / device_ms:.2f}% of the kernels [{card}]")
            for t, name, calls in rows[:12]:
                print(f"  {t:8.3f} ms  {100 * t / device_ms:5.1f}%  x{calls}  {name[:90]}")
        else:
            print("charlm train profile: torch.profiler recorded no device time")
        sample = charlm_sample(card, net, vocab)
        charlm_wide_heads_and_bf16(card)
    finally:
        set_config(fused_update=False)
    print(f"charlm train: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(flash=counts[0] + sample["flash"], backward=counts[1],
                fused_update=counts[2], paged=sample["paged"], ms_per_step=ms)


PHASES = ("kernel", "path", "serve", "profile", "lrn_backward", "train",
          "fused_update", "train_profile", "fused_vs_blob", "parallel", "flash",
          "flash_backward", "paged", "token", "token_profile", "charlm_train")


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
    launches = {"lrn_across_channels": 0, "lrn_backward": 0, "fused_update": 0,
                "flash_attention": 0, "flash_attention_backward": 0,
                "paged_attention": 0}
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
    if "parallel" in phases:
        par = phase_parallel(card)
        launches["lrn_across_channels"] += par["lrn"]
        launches["lrn_backward"] += par["lrn_backward"]
        launches["fused_update"] += par["fused_update"]
        launches["flash_attention"] += par["flash"]
        launches["paged_attention"] += par["paged"]
    if "flash" in phases:
        stats["flash"] = phase_flash(card)
    if "flash_backward" in phases:
        stats["flash_backward"] = phase_flash_backward(card)
    if "paged" in phases:
        stats["paged"] = phase_paged(card)
    if "token" in phases:
        token = phase_token(card)
        launches["flash_attention"] += token["flash"]
        launches["paged_attention"] += token["paged"]
        if "token_profile" in phases:
            phase_token_profile(card, token)
        del token
    if "charlm_train" in phases:
        charlm = phase_charlm_train(card)
        launches["flash_attention"] += charlm["flash"]
        launches["flash_attention_backward"] += charlm["backward"]
        launches["fused_update"] += charlm["fused_update"]
        launches["paged_attention"] += charlm["paged"]
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
        "flash_attention": ("sparknet_tpu_torch/csrc/flash_attention.cu",
                            "sparknet_tpu/ops/pallas_kernels.py:239", "flash"),
        "flash_attention_backward": ("sparknet_tpu_torch/csrc/flash_attention.cu",
                                     "sparknet_tpu/ops/pallas_kernels.py:342",
                                     "flash_backward"),
        "paged_attention": ("sparknet_tpu_torch/csrc/paged_attention.cu",
                            "sparknet_tpu/ops/pallas_kernels.py:785", "paged"),
    }
    lines = []
    for name, (source, replaces, key) in meta.items():
        st = stats[key]
        # LRN times and bounds: one AlexNet b256 step's two calls (norm1 +
        # norm2), float32; fused_update: one SGD f32 update of the AlexNet
        # arena; flash: the char LM's prefill shape [32,4,128,16] causal;
        # flash_attention_backward: the char LM's training shape
        # [32,4,128,16] causal; paged: its decode shape (B 32, H 4, D 16,
        # T 8, MB 16); max_abs_err: the largest over every f32 case (every
        # case for fused_update, flash, its backward and paged); launches:
        # the main paths (the AlexNet TEST forwards, the CaffeNet
        # requests, the AlexNet and CaffeNet train steps, the trainer's
        # rounds, the paged token run and the rectangle run, the char LM's
        # timed training steps and its sampling), each counted from 0
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
