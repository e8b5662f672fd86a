#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sparknet_tpu_torch``) on one GPU.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. card: ``nvidia-smi``'s name and power limit, torch and CUDA versions;
2. build: every kernel of ``sparknet_tpu_torch/csrc`` with ``nvcc``;
3. kernel: the LRN kernel against its plain PyTorch version at every
   main-path shape (AlexNet and CaffeNet norm1/norm2 at batch 256,
   GoogLeNet's two at batch 32) and at ragged ones (16-byte loads meeting
   the channel clamp among them), in float32 (rtol 1e-5, atol 1e-6) and
   bfloat16 (one bf16 ulp of the float32 result cast to bfloat16), with
   the count of elements not bitwise equal, and bit for bit where k puts
   the window's scale out of the beta = 0.75 walk's fast range; at the main-path shapes the
   times of the kernel (CUDA events over back-to-back calls, and by
   CUDA-graph replay, which leaves out the host's launch), the plain
   version and ``F.local_response_norm`` (a yardstick the port never
   calls) beside the least time the card could take;
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
    S = 100, head dims 8, 32, 64, 128 and 256, heads of 320 (padded to
    384) and 512 lanes (the chunked kernel) at a ragged S and at S = 1024,
    [4,16,2048,64] causal and not, [2,8,1024,128] causal and a ragged
    [2,4,2000,64] causal (rtol 1e-5, atol 1e-6; atol 1e-5 at S >= 1024);
    batch entry 0 of the prefill shape and of the wide heads' cases bit for
    bit the same alone and in its batch, and two launches of them bit for
    bit; times at the prefill shape and the S >= 1024 shapes beside the
    bound (the 3xTF32 tensor-core rate) and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls);
13. flash backward: the backward kernel against
    ``flash_attention_backward_torch`` on the same q, k, v, o, lse and g
    at the flash phase's shapes and the padded widths 12, 200 and 320 and
    512 (rtol 1e-5, atol 1e-6 x max|ref| at S < 1024; rtol 1e-4, atol
    1e-5 x max|ref| above; the plain version computes in float64); the
    forward's lse against the plain one (1e-5) and its o bit for bit the
    same with and without lse; two launches bit for bit equal; batch entry
    0 of the char LM's shape and of the wide heads alone and in its batch;
    times of the kernel, the plain version and the autograd
    backward of ``F.scaled_dot_product_attention`` (a yardstick) beside
    the bound, and of the forward with and without lse beside the forward's
    plain version with lse and
    ``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp`` (a yardstick);
14. paged: the paged-attention kernel against ``paged_attention_torch``
    (rtol 1e-5, atol 1e-6) over a sweep of every head dim (8, 16, 32, 64,
    128, 256 and 512, the chunked kernel) x block size T (1, 4, 8, 16) at
    160 columns a row, positions at 0, block edges, both sides of every
    tile width and the last column, pools stored in bfloat16 or float16
    (read as stored) at D 8, 16, 64, 256 and 512, and a head of 320 lanes
    on pools of 384 at 160 and 1024 columns;
    at the char LM's decode shape (shuffled tables, positions at 0, block
    edges and 127); and at B 64, H 16, D 64, T 16, MB 128 with random
    positions and with every position at 2047; pools hold finite garbage
    of 1e4 outside the live lines; at every case a row's output is bit for
    bit unchanged when the other rows' q, tables and positions change;
    and at B 16, H 4, D 512, T 16, MB 64 (random positions below 1024);
    times of the four timed shapes beside the live-bytes bound, kernel,
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
18. elastic (run after 17): SparkNet's elastic rounds
    (``parallel.ElasticTrainer``) in a pool of three gloo ranks on cuda:0
    (spawned, FileStore), the zoo AlexNet at full width, ``alexnet_solver``,
    fused update, f32, dropout 0, deterministic cuDNN, batch 256 a worker
    from seeded shards (``data_fn(g)``), tau 2: with no plan, 2 width-3
    rounds bit for bit equal to 2 ``ParallelTrainer`` rounds of the same
    shards (params and history); then 5 rounds of the plan (round 1 delays
    worker 2 by 2 steps, so it misses one round and rejoins at round 2 with
    weight 0.5; round 3 kills worker 0; round 4 joins a fresh worker): the
    active ranks' params bit for bit equal after every round, every round
    within rtol 1e-5 / atol 1e-7 of an in-process oracle (one Solver a
    worker, the weighted mean, in lockstep with the pool's consensus), the
    shard ids consumed ``range(cursor)`` once each, and 4 LRN forward, 4
    LRN backward and 2 fused-update launches a round on each active rank
    (0 on an idle one); ms a round by width, the boundary's ms and the
    weighted all-reduce's ms;
19. charlm train: the full-width char LM (``charlm_solver``: Adam,
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
    same twice; transformer steps over 2 heads of 256, 320 (padded to 384)
    and 512 lanes (every gradient against plain attention from the same
    weights, rtol 1e-4, atol 1e-5 x max|ref|; the loss rtol 1e-4; exactly
    2 flash and 2 backward launches) and a bf16 ``flash_attention`` call
    bit for bit the float32 kernel on the upcast inputs cast to bf16;
20. feed (run after 18): SparkNet's ImageNet recipe from records.  An LMDB
    of 2,048 seeded 256x256x3 uint8 ``Datum``s (1000 classes) and its mean
    image in a temp dir; ``RecordShardSource`` -> the ``ProcessPipeline``
    ring (forked workers) -> ``device_feed`` (pinned staging, a copy
    stream, events) -> ``DeviceAugment`` (mean, random 227 crop, mirror)
    on the card -> AlexNet b256, 1000 classes, fused update, f32: 36
    ``Solver`` steps, then 2 ``ParallelTrainer`` rounds at tau 4 (a world
    of one, NCCL) through ``trainer_device_fn``.  Gates: DeviceAugment TEST
    at [256,3,256,256] bit for bit the host ``DataTransformer``; TRAIN with
    injected draws bit for bit the host formula; its own draws in range, a
    flip share in [0.4, 0.6] over 2,048 samples, the same twice for one
    (pid, seed, it, t); every batch of the first 16 steps (two passes of
    the ring) and of the rounds bit for bit ``src.get(epoch, index)``; the
    first fed step bit for bit (loss and params) a ``Solver`` step on the
    batch augmented on the host with the same draws (deterministic cuDNN,
    TF32 off); exactly 2 LRN forward, 2 LRN backward and 1 fused-update
    launches a step; uint8 until the hook.  Prints the fed step's img/s
    beside the same solver's fixed-batch step, the ring's stage walls a
    batch and the device's idle share between fed steps;
21. cifar_app: ``apps.CifarApp`` (cifar10_full, tau 10, batch 100, a world
    of one, NCCL) on synthetic CIFAR binaries of 1,000 records a file, 2
    outer rounds and its test passes (round 0 and the end); its first
    round's loss bit for bit the mean of 10 ``Solver`` steps on the same
    host-transformed batches from the same weights (deterministic cuDNN);
22. engine: the CNN serving engine (``serve.ServeEngine``) loads
    cifar10_quick, lenet and transformer (seeded weights) at buckets 1, 8,
    64 and 256, one CUDA graph captured a bucket; resident and reserved
    bytes and capture seconds a load; every bucket's replay bit for bit
    its eager forward at the same rows (TF32 off); the transformer's
    replay within B3's gate (rtol 1e-5, atol 1e-6) of a plain-attention
    forward, and as many B3 launches a replay (the most of 25 one-replay
    ``torch.profiler`` windows, by kernel name) as the capture recorded and
    as MultiHeadAttention layers; B3's count on the main path (the loads,
    the traffic and swaps) takes the capture's calls off and adds each
    replay's, and is held against the engine's batches and warm-ups; the
    same requests across the buckets within 1e-5 of max|score| (bits not promised); replay and
    eager ms (CUDA events) and host ms a batch; through the engine, a
    padded batch bit for bit the full one in every bucket; two captures
    (``build_candidate``), two swaps and a rollback while a pump thread
    (``serve_forever``) and a client thread serve: every ticket resolves,
    0 captures on the request path, the rollback's scores bit for bit the
    first generation's; then ``loadgen.load_run``: 504 requests over every
    bucket on cifar10_quick and a lenet beside it, one load refused
    through an injected fit table, 0 captures after the warm-up, p50/p99
    and requests/s;
23. replica: ``dryrun.replica_run`` with 2 transformer replicas on 3
    device slots of the one card (buckets 1, 8, 64; 2,000 requests/s
    offered for 1.5 s a leg): a kill with a known backlog (every rerouted
    ticket resolves), a steady open-loop leg whose queue p99 stays within
    max_wait_ms + one pump tick, a live join, kill and rollout with 0
    dropped and 0 captures on the request path, and the continuous
    decoder's interleaved-equals-alone gate; B3's launches counted as in
    22, the continuous decoder's eager forwards added;
24. zoo: the ImageNet families at published width and default batch,
    f32, TF32 off, weights from seed 0, the published recipes, fused
    update: GoogLeNet b32 224, ResNet-50 b32 224, VGG-16 b64 224,
    SqueezeNet b32 227 and MobileNet b32 224 on one fixed batch (noise x40
    plus a +-80 pattern a class, 10 classes): ms/step and img/s over timed
    steps after a warm-up, the device's busy share over 2 profiled steps,
    finite losses, the mean of the last 5 of 20 steps below the first 5's
    and each of the last 5 below the first (SqueezeNet's on the batch at
    unit scale, ``ZOO_UNIT_SCALE``; ResNet-50's in 20 more steps at
    ``ZOO_FALL_LR``, the published base_lr's losses printed),
    BatchNorm scale_factor moved, exact launches (2 LRN forward, 2 LRN
    backward and 1 fused update a GoogLeNet step, 1 fused update a step of
    the others, 2 LRN forward a GoogLeNet TEST forward), the TEST forward
    with global statistics finite and timed; a ResNet-50 and
    a MobileNet step by kind of kernel, and their BatchNorm+Scale pairs
    timed alone; B1 and B1' against their plain versions at GoogLeNet's
    LRN shapes [32,64,56,56] and [32,192,56,56] (rtol 1e-5, atol 1e-6),
    timed beside the bound and ``F.local_response_norm``; GoogLeNet's
    logits against the plain-LRN forward (1e-4); the ResNet-50 trained at
    ``ZOO_FALL_LR`` folded through ``DeployNet.fold_batchnorm`` (53 chains,
    fc1000 within rtol/atol 2e-4 of the unfolded forward, both timed); one
    ResNet-50 and one VGG-16 step fused against per-blob (rtol 1e-5, atol
    1e-7), B2 bitwise its plain version on their arenas and timed beside
    its bound; ResNet-50 and GoogLeNet at crop 64, batch 4, the card
    against the CPU: every layer alone on the CPU forward's inputs
    (outputs, state, VJP; rtol 1e-4 + 1e-5 x max), the ReLU signs and
    MAX-pool argmaxes that the two whole forwards decide otherwise, and
    one whole step (loss rtol 1e-4, history ``ZOO_CPU_HISTORY``, state
    ``ZOO_CPU_STATE``); the engine serving ``mobilenet`` (trained 5 steps)
    at buckets 1/8/64/256 in the ``f32`` and ``fold_bn`` arms (replay bit
    for bit eager, padded bit for bit full, across buckets within
    ``ZOO_ACROSS_BUCKETS`` of max|score|, fold_bn within 2e-4 of f32, 0
    request-path captures, 0 dropped) and ``cifar10_quick``'s fold_bn arm
    bit for bit its f32 arm.

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
import math
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
GOOGLENET_LRN = ((32, 64, 56, 56), (32, 192, 56, 56))  # pool1/norm1, conv2/norm2 at b32
# every shape a main path gives the LRN forward: the serving path's, then
# GoogLeNet's
LRN_PATH_CASES = MAIN_CASES + [
    (f"googlenet.{name}", shape) for name, shape in zip(("norm1", "norm2"), GOOGLENET_LRN)]
RAGGED_CASES = [  # (label, shape, size, beta, k)
    ("c_lt_size", (4, 2, 17, 19), 5, 0.75, 1.0),
    ("c3_odd_hw", (4, 3, 31, 29), 5, 0.75, 1.0),
    ("hw1", (8, 64, 1, 1), 5, 0.75, 1.0),
    ("size3", (2, 32, 13, 13), 3, 0.75, 1.0),
    ("beta0.6_k2", (2, 32, 13, 13), 5, 0.6, 2.0),
    # 16-byte loads (H*W a multiple of 8) meeting the channel clamp: C odd
    # and below the window, C below the window, a last segment cut short
    ("vec_c3", (4, 3, 8, 8), 5, 0.75, 1.0),
    ("vec_c_lt_size", (2, 2, 16, 16), 5, 0.75, 1.0),
    ("vec_c40_size7", (2, 40, 12, 12), 7, 0.75, 1.0),
    # beta = 0.75 operands out of the forward walk's fast range [2^-20, 2^20]:
    # k = 1e-7 gives u = k at every window of zeros, so walks fall back part
    # way down (16-byte bf16 rows, then scalar rows); k = 2e6 sends every
    # walk back at its first channel.  Held bit for bit (LRN_EXACT_CASES)
    ("range_k1e-7_vec", (4, 32, 16, 16), 5, 0.75, 1e-7),
    ("range_k1e-7", (4, 32, 13, 13), 5, 0.75, 1e-7),
    ("range_k2e6", (2, 32, 16, 16), 5, 0.75, 2e6),
]
LRN_EXACT_CASES = ("range_k1e-7_vec", "range_k1e-7", "range_k2e6")
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
            if (kernel and "lrn_forward" not in fn
                    and ("IfLi5ELb1E" in fn or "IfLi0ELi2E" in fn)):
                print(f"    {kernel.group(1)} (float32, main-path instance): "
                      f"{n} registers a thread")
        print_lrn_forward_registers(log)
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
            wide = re.search(r"\d+((?:flash|paged)_\w+?_wide_kernel)"
                             r"(?:I(13__nv_bfloat16|6__half|f)E)?", fn)
            if wide:
                kind = {"13__nv_bfloat16": ", bf16 pools", "6__half": ", f16 pools",
                        "f": ", f32 pools"}.get(wide.group(2), "")
                print(f"    {wide.group(1)} (heads above 256 lanes{kind}): {n} "
                      f"registers a thread, {spill} bytes of spill stores")


def print_lrn_forward_registers(log: str) -> None:
    """ptxas's registers for the LRN forward's walks in a build log of
    ``csrc/lrn.cu``: each (storage type, load width) over its sizes and
    beta forms."""
    fwd = {}
    for fn, n in re.findall(r"Compiling entry function '([^']+)'.*?Used (\d+) "
                            r"registers", log, flags=re.S):
        walk = re.search(r"lrn_forward_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E"
                         r"Li(\d+)E", fn)
        if walk:
            kind, size, b34, vec = walk.groups()
            key = ("f32" if kind == "f" else "bf16", int(vec))
            fwd.setdefault(key, {})[(int(size), b34 == "1")] = int(n)
    for (kind, vec), regs in sorted(fwd.items()):
        print(f"    lrn_forward_kernel {kind}, {vec} a load: "
              f"{min(regs.values())}-{max(regs.values())} registers a thread over "
              f"sizes 1-11 and both beta forms (size 5, beta 0.75: "
              f"{regs.get((5, True))})")


def phase_kernel(card: str) -> dict:
    """Kernel vs plain at every case; times at the main-path shapes."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    max_err_f32 = 0.0
    cases = [(lab, shp, 5, 0.75, 1.0) for lab, shp in LRN_PATH_CASES] + RAGGED_CASES
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
              f"max abs err {float(err.max()):.3e} (rtol 1e-5, atol 1e-6), "
              f"{int((y != ref).sum())} elements not bitwise equal "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"lrn f32 {label}")
        if label in LRN_EXACT_CASES:
            check(torch.equal(y, ref), f"lrn f32 {label}: not bit for bit the plain version")
        xb = x.to(torch.bfloat16)
        refb = kernels.lrn_across_channels_torch(xb.float(), size, ALPHA, beta, k)
        refb = refb.to(torch.bfloat16).float()
        yb = kernels.lrn_across_channels(xb, size, ALPHA, beta, k).float()
        torch.cuda.synchronize()
        errb = (yb - refb).abs()
        okb = bool((errb <= bf16_ulp(refb)).all())
        print(f"kernel {label} {list(shape)} bf16: max abs err "
              f"{float(errb.max()):.3e}, max err in ulps "
              f"{float((errb / bf16_ulp(refb)).max()):.2f} (tolerance 1 bf16 ulp), "
              f"{int((yb != refb).sum())} elements not bitwise equal "
              f"{'ok' if okb else 'FAIL'}")
        check(okb, f"lrn bf16 {label}")
        if label in LRN_EXACT_CASES:
            check(torch.equal(yb, refb), f"lrn bf16 {label}: not bit for bit the plain version")

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    for label, shape in LRN_PATH_CASES:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev) * 50)
        xb = x.to(torch.bfloat16)
        # events over back-to-back calls, then the same calls replayed from a
        # CUDA graph: at GoogLeNet's shapes the host's launch takes about as
        # long as the kernel, and the events measure the host's issue rate
        t_k = time_ms(lambda: kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0))
        t_kg = graph_ms(lambda: kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0))
        t_p = time_ms(lambda: kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0))
        t_l = time_ms(lambda: F.local_response_norm(x, 5, ALPHA, 0.75, 1.0))
        t_kb = time_ms(lambda: kernels.lrn_across_channels(xb, 5, ALPHA, 0.75, 1.0))
        t_kbg = graph_ms(lambda: kernels.lrn_across_channels(xb, 5, ALPHA, 0.75, 1.0))
        bound, by = lrn_bound_ms(shape, 5, 4, card)
        bound_b, _ = lrn_bound_ms(shape, 5, 2, card)
        gbs = 2 * x.numel() * 4 / (t_k * 1e-3) / 1e9
        print(f"time {label} {list(shape)} f32: kernel {t_k:.4f} ms "
              f"({gbs:.0f} GB/s, {100 * bound / t_k:.1f}% of bound), by graph replay "
              f"{t_kg:.4f} ms ({100 * bound / t_kg:.1f}%), plain "
              f"{t_p:.4f} ms, F.local_response_norm {t_l:.4f} ms, bound "
              f"{bound:.4f} ms ({by}); bf16 kernel {t_kb:.4f} ms ({100 * bound_b / t_kb:.1f}%), "
              f"by graph replay {t_kbg:.4f} ms ({100 * bound_b / t_kbg:.1f}%), bound "
              f"{bound_b:.4f} ms [{card}]")
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
        ("D=320 ragged, padded to 384", (2, 2, 130, 320), True, 1e-6),
        ("D=512 ragged", (2, 2, 77, 512), False, 1e-6),
        ("long context", (4, 16, 2048, 64), True, 1e-5),
        ("long context, not causal", (4, 16, 2048, 64), False, 1e-5),
        ("D=128 long", (2, 8, 1024, 128), True, 1e-5),
        ("ragged long", (2, 4, 2000, 64), True, 1e-5),
        ("D=320 long, padded to 384", (1, 4, 1024, 320), True, 1e-5),
        ("D=512 long", (1, 4, 1024, 512), True, 1e-5),
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
            if label == "charlm prefill" or shape[-1] > 256:
                # a row's output depends only on its own fibre: batch entry 0
                # run alone gives the same bits as in its batch, and a
                # second launch the same bits as the first
                alone = kernels.flash_attention(q[:1], k[:1], v[:1], causal)
                again = kernels.flash_attention(q, k, v, causal)
                torch.cuda.synchronize()
                same = torch.equal(alone[0], o[0])
                twice = torch.equal(again, o)
                print(f"flash {label}: batch entry 0 alone (B = 1) and in the batch "
                      f"of {shape[0]}: {'bit for bit equal' if same else 'DIFFER'}; two "
                      f"launches bit for bit: {twice}")
                check(same, f"flash {label}: batch entry 0 differs alone and in its batch")
                check(twice, f"flash {label}: two launches differ")
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
    return dict(max_abs_err=max_err, **out["charlm prefill"], long=out["long context"],
                wide=out["D=512 long"])


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
PAGED_SWEEP_D = (8, 16, 32, 64, 128, 256, 512)
# pools in a 16-bit type, read as stored: (head dim, storage type)
PAGED_HALF_CASES = ((8, torch.bfloat16), (16, torch.bfloat16), (64, torch.float16),
                    (256, torch.bfloat16), (256, torch.float16), (512, torch.bfloat16))
# heads between the chunked kernel's widths, on pools of kernel_head_dim
# lanes: (head dim, T, MB), at 160 and at 1024 columns a row
PAGED_PADDED_CASES = ((320, 8, 20), (320, 16, 64))
PAGED_SWEEP_T = (1, 4, 8, 16)


def paged_gate(kernels, gen, label, case, scale=None) -> float:
    """The paged kernel against paged_attention_torch on one case (rtol
    1e-5, atol 1e-6), and row independence: the even rows' outputs bit for
    bit unchanged when the odd rows' q, tables and positions change.
    ``scale``: a padded head's (1/sqrt of its true width).  Returns the
    largest absolute error."""
    q, kp, vp, tables, pos = case
    b, mb, t = q.shape[0], tables.shape[1], kp.shape[1]
    ref = kernels.paged_attention_torch(q, kp, vp, tables, pos, scale)
    o = kernels.paged_attention(q, kp, vp, tables, pos, scale)
    torch.cuda.synchronize()
    ok, err = attention_within(o, ref, 1e-6)
    odd = torch.arange(b, device="cuda") % 2 == 1
    q2 = torch.where(odd[:, None, None], torch.randn(q.shape, generator=gen,
                                                     device="cuda"), q)
    tables2 = torch.where(odd[:, None], tables.flip(0), tables)
    pos2 = torch.where(odd, torch.randint(0, mb * t, (b,), generator=gen,
                                          device="cuda").to(torch.int32), pos)
    o2 = kernels.paged_attention(q2, kp, vp, tables2, pos2, scale)
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
    for d, t, mb in PAGED_PADDED_CASES:
        positions = [0, t - 1, t, 31, 32, 33, 127, 128, 129, mb * t - 1] + list(
            sweep_rs.randint(0, mb * t, 6))
        q, kp, vp, tables, pos = paged_case(sweep_gen, len(positions), 2, d, t, mb,
                                            positions, own_only=True)
        w = kernels.kernel_head_dim(d)
        pad = lambda x: F.pad(x, (0, w - d)).contiguous()  # noqa: E731
        max_err = max(max_err, paged_gate(
            kernels, sweep_gen, f"D {d} on pools of {w} lanes, T {t} MB {mb}",
            (pad(q), pad(kp), pad(vp), tables, pos), scale=1.0 / math.sqrt(d)))

    charlm_pos = [0, 1, 7, 8, 15, 16, 63, 64, 127, 126, 120, 5] + list(
        rs.randint(0, 128, 20))
    cases = [  # (label, B, H, D, T, MB, positions, own_only)
        ("charlm decode", 32, 4, 16, 8, 16, charlm_pos, True),
        ("long context", 64, 16, 64, 16, 128, list(rs.randint(0, 2048, 64)), False),
        ("long context, equal positions", 64, 16, 64, 16, 128, [2047] * 64, False),
        ("D=512, S 1024", 16, 4, 512, 16, 64, list(rs.randint(0, 1024, 16)), False),
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
    return dict(max_abs_err=max_err, **out["charlm decode"], long=out["long context"],
                wide=out["D=512, S 1024"])


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
# SparkNet's elastic rounds: a pool of three gloo ranks on the one card
# ---------------------------------------------------------------------------

ELASTIC_POOL = 3
ELASTIC_TAU = 2
ELASTIC_ROUNDS = 5
ELASTIC_NO_PLAN_ROUNDS = 2
# (kind, round, worker, steps): round 1 delays worker 2 by 2 steps (it
# misses one round and rejoins at round 2 with weight 0.5), round 3 kills
# worker 0, round 4 joins a fresh worker
ELASTIC_PLAN = (("delay", 1, 2, 2), ("kill", 3, 0, 0), ("join", 4, -1, 0))
ELASTIC_DECAY = 0.5


def elastic_shard(g: int) -> dict:
    """Shard ``g``'s seeded AlexNet batch, one worker's: 256 images of
    227x227 at raw-pixel scale, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5000 + g)
    return {
        "data": torch.randn((256, 3, 227, 227), generator=gen, device="cuda") * 50,
        "label": torch.randint(0, 1000, (256,), generator=gen, device="cuda",
                               dtype=torch.int32),
    }


def elastic_plan():
    from sparknet_tpu_torch.parallel import FaultPlan, delay, join, kill

    make = {"delay": lambda r, w, s: delay(w, at_round=r, steps=s),
            "kill": lambda r, w, s: kill(w, at_round=r),
            "join": lambda r, w, s: join(at_round=r)}
    return FaultPlan([make[kind](r, w, s) for kind, r, w, s in ELASTIC_PLAN])


def elastic_worker(rank: int, work: str) -> None:
    """One rank of the elastic pool: gloo, every rank on cuda:0, joined
    through a FileStore in ``work``.  With no plan, two width-3 rounds
    against two ParallelTrainer rounds of the same shards (its own arena
    and history, bit for bit); then the plan's rounds, each timed with its
    boundary (the re-formation) apart, with the rank's launch counts, the
    shards it consumed and its arena's digest; the lowest active rank
    saves the round's arena.  Writes its results into ``work``.  Spawned
    by ``phase_elastic`` (start method spawn), so module level."""
    import hashlib

    import torch.distributed as dist

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.parallel import (
        ElasticTrainer,
        ParallelTrainer,
        initialize_distributed,
        round_shards,
    )
    from sparknet_tpu_torch.parallel.trainer import all_reduce_mean_

    class TimedBoundary(ElasticTrainer):
        """The trainer with its boundary (membership, the joiners'
        consensus, the round's process group) timed apart."""

        def _apply_boundary(self, rnd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._apply_boundary(rnd)
            self._group()
            torch.cuda.synchronize()
            self.boundary_ms = 1e3 * (time.perf_counter() - t0)

    torch.cuda.set_device(0)
    set_config(fused_update=True, storage_dtype="f32")
    torch.backends.cudnn.deterministic = True
    initialize_distributed(backend="gloo", store_path=f"{work}/store", rank=rank,
                           world_size=ELASTIC_POOL)
    clock = {"joined": time.time()}  # wall clock: the parent spawned us at its own
    try:
        net0 = alexnet_net(0.0)
        el = ElasticTrainer(train_solver(net0, models.alexnet_solver()), tau=ELASTIC_TAU)
        pt = ParallelTrainer(train_solver(net0, models.alexnet_solver()), tau=ELASTIC_TAU)

        def stacked(it):
            cols = round_shards(it * ELASTIC_POOL, ELASTIC_TAU, ELASTIC_POOL)[:, rank]
            fs = [elastic_shard(int(g)) for g in cols]
            return {k: torch.stack([f[k] for f in fs]) for k in fs[0]}

        plain = [(el.train_round(elastic_shard), pt.train_round(stacked))
                 for _ in range(ELASTIC_NO_PLAN_ROUNDS)]
        a, b = el.solver, pt.solver
        plain_equal = torch.equal(a._param_arena, b._param_arena) and all(
            torch.equal(x, y) for x, y in zip(a._slot_arenas, b._slot_arenas))
        clock["no plan"] = time.time()
        del el, pt, a, b
        gc.collect()
        torch.cuda.empty_cache()

        tr = TimedBoundary(train_solver(net0, models.alexnet_solver()), tau=ELASTIC_TAU,
                           staleness_decay=ELASTIC_DECAY, plan=elastic_plan())
        used = []

        def data_fn(g):
            used.append(g)
            return elastic_shard(g)

        rounds = []
        for r in range(ELASTIC_ROUNDS):
            dist.barrier()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.train_round(data_fn)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = [kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
                      kernels.FUSED_UPDATE_LAUNCHES]
            arena = tr.solver._param_arena
            digest = (hashlib.sha256(arena.cpu().numpy().tobytes()).hexdigest()
                      if tr.active else None)
            if tr.active and rank == min(tr._ranks()):
                torch.save(arena.cpu(), f"{work}/round{r}.pt")
            rounds.append(dict(ms=ms, boundary_ms=tr.boundary_ms, width=tr.width,
                               wids=tr.worker_ids, weights=tr.round_weights,
                               active=tr.active, loss=loss, counts=counts,
                               digest=digest))
        clock["plan"] = time.time()
        # the weighted all-reduce alone, over the last round's set
        ar_ms = None
        if tr.active:
            buf = tr.solver._param_arena.clone()
            pos = tr._ranks().index(rank)
            group, total = tr._group(), sum(tr.round_weights)
            ar_ms = event_ms(lambda: all_reduce_mean_([buf], group, total,
                                                      tr.round_weights[pos]), reps=3)
        with open(f"{work}/rank{rank}.json", "w") as f:
            json.dump(dict(plain_equal=plain_equal, plain_losses=plain, rounds=rounds,
                           used=used, cursor=tr.cursor, allreduce_ms=ar_ms,
                           nbytes=tr.solver.layout.total_bytes,
                           clock=dict(clock, done=time.time())), f)
    finally:
        dist.destroy_process_group()


def elastic_oracle(pool_arena, solvers: dict):
    """The plan replayed in this process with one Solver a worker, from the
    pool's weights and shards: tau Solver.steps a worker on its shards,
    then the weighted mean of the arenas, a joiner adopting the mean of the
    entry pool's arenas and histories, a straggler rejoining at decay**s.
    In lockstep with the pool: each round starts from the pool's consensus
    of the round before (``pool_arena(r)``), so that each round is held to
    one round's tolerance (over free-running rounds, sums over three
    workers taken in gloo's order and in this one's drift apart by a few
    ulps a round).  ``solvers``: a fresh Solver for every worker id the plan
    makes, from SEED.  Yields each round's consensus arena."""
    wids, parked, next_wid, it, cursor = list(range(ELASTIC_POOL)), {}, ELASTIC_POOL, 0, 0
    for r in range(ELASTIC_ROUNDS):
        if r:
            with torch.no_grad():
                prev = pool_arena(r - 1)
                for w in wids:
                    solvers[w]._param_arena.copy_(prev)
                del prev
        entry = list(wids)
        weights = {w: 1.0 for w in wids}
        for kind, at, w, steps in ELASTIC_PLAN:
            if at != r:
                continue
            if kind == "kill":  # its replica still counts in a join's entry mean
                wids.remove(w)
            elif kind == "delay":
                wids.remove(w)
                parked[w] = (r, r + -(-steps // ELASTIC_TAU))
            else:
                s = solvers[next_wid]
                with torch.no_grad():
                    s._param_arena.copy_(sum(solvers[e]._param_arena for e in entry)
                                         / len(entry))
                    for i, h in enumerate(s._slot_arenas):
                        h.copy_(sum(solvers[e]._slot_arenas[i] for e in entry) / len(entry))
                wids.append(next_wid)
                weights[next_wid] = 1.0
                next_wid += 1
        for w, (since, back) in list(parked.items()):
            if back <= r:
                del parked[w]
                wids.append(w)
                weights[w] = ELASTIC_DECAY ** (r - since)
        width = len(wids)
        ids = range(cursor, cursor + ELASTIC_TAU * width)  # position p owns g % width == p
        for p, w in enumerate(wids):
            solvers[w].iter = it
            for g in (g for g in ids if g % width == p):
                solvers[w].train_iteration(elastic_shard(g))
        with torch.no_grad():
            total = sum(weights[w] for w in wids)
            mean = sum(solvers[w]._param_arena * weights[w] for w in wids) / total
            for w in wids:
                solvers[w]._param_arena.copy_(mean)
        it += ELASTIC_TAU
        cursor += ELASTIC_TAU * width
        yield r, wids, mean


def phase_elastic(card: str) -> dict:
    """SparkNet's elastic rounds (``parallel.ElasticTrainer``) with the zoo
    AlexNet at full width a worker: three spawned gloo ranks on cuda:0 run
    the plan, then the in-process oracle holds every round."""
    import tempfile

    import torch.multiprocessing as mp

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config

    t_phase = time.perf_counter()
    counts = [0, 0, 0]
    set_config(fused_update=True, storage_dtype="f32")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="sparknet_elastic_") as work:
            t0, wall0 = time.perf_counter(), time.time()
            pool = mp.start_processes(elastic_worker, args=(work,), nprocs=ELASTIC_POOL,
                                      join=False, start_method="spawn")
            # the oracle's Solvers, one a worker id of the plan, made while the
            # pool runs
            net0 = alexnet_net(0.0)
            solvers = {w: train_solver(net0, models.alexnet_solver())
                       for w in range(ELASTIC_POOL + sum(e[0] == "join" for e in ELASTIC_PLAN))}
            while not pool.join():
                pass
            spawn_s = time.perf_counter() - t0
            ranks = []
            for r in range(ELASTIC_POOL):
                with open(f"{work}/rank{r}.json") as f:
                    ranks.append(json.load(f))
            same = all(res["plain_equal"] for res in ranks)
            print(f"elastic: no plan, {ELASTIC_NO_PLAN_ROUNDS} width-{ELASTIC_POOL} rounds "
                  f"of tau {ELASTIC_TAU} against ParallelTrainer's on the same shards: "
                  f"every rank's params and history "
                  f"{'bit for bit equal' if same else 'DIFFER'}; losses (elastic, "
                  f"ParallelTrainer) {[[round(x, 6) for x in p] for p in ranks[0]['plain_losses']]}")
            check(same, "elastic: weight-1 rounds differ from ParallelTrainer's")
            used = sorted(g for res in ranks for g in res["used"])
            cursor = ranks[0]["cursor"]
            check(used == list(range(cursor)), f"elastic: the shards consumed are not "
                                               f"range({cursor}) once each")
            def pool_arena(r):
                return torch.load(f"{work}/round{r}.pt").cuda()

            for (r, wids, mean), *rows in zip(elastic_oracle(pool_arena, solvers),
                                              *(res["rounds"] for res in ranks)):
                act = [row for row in rows if row["active"]]
                check(wids == act[0]["wids"], f"elastic round {r}: workers "
                                              f"{act[0]['wids']}, the oracle's {wids}")
                check(len({row["digest"] for row in act}) == 1,
                      f"elastic round {r}: the active ranks' params differ")
                want = [2 * ELASTIC_TAU, 2 * ELASTIC_TAU, ELASTIC_TAU]
                for k, row in enumerate(rows):
                    check(row["counts"] == (want if row["active"] else [0, 0, 0]),
                          f"elastic round {r}, rank {k}: launches (lrn fwd, lrn bwd, "
                          f"fused) {row['counts']}")
                    counts = [c + n for c, n in zip(counts, row["counts"])]
                ok, bitwise, diff = arena_diff(pool_arena(r), mean)
                row0 = act[0]
                print(f"elastic round {r}: width {row0['width']}, workers {row0['wids']}, "
                      f"weights {row0['weights']}; ms a round (host clock, every rank "
                      f"sharing the card) {[round(row['ms'], 1) for row in rows]} (idle "
                      f"ranks wait in the boundary's collectives), of it the boundary "
                      f"{[round(row['boundary_ms'], 1) for row in rows]}; loss "
                      f"{row0['loss']:.6f}; active ranks bit for bit equal; against the "
                      f"in-process oracle from the pool's last consensus (rtol 1e-5, atol "
                      f"1e-7): "
                      f"{'bit for bit' if bitwise else f'max abs diff {diff:.3e}'} "
                      f"{'ok' if ok else 'FAIL'}; launches a rank {[row['counts'] for row in rows]} "
                      f"[{card}]")
                check(ok, f"elastic round {r}: the pool differs from the oracle by {diff:.3e}")
                del mean
            del solvers
            ar = [res["allreduce_ms"] for res in ranks if res["allreduce_ms"] is not None]
            c = ranks[0]["clock"]
            print(f"elastic: the weighted all-reduce of the {ranks[0]['nbytes'] / 1e6:.1f} MB "
                  f"arena over the last round's {len(ar)} ranks (gloo, CUDA events, median "
                  f"of 3): {[round(x, 1) for x in ar]} ms; pool spawned, ran and joined in "
                  f"{spawn_s:.1f} s (rank 0: in the process group after "
                  f"{c['joined'] - wall0:.1f} s, the no-plan check {c['no plan'] - c['joined']:.1f} "
                  f"s, the plan's rounds {c['plan'] - c['no plan']:.1f} s, the rest "
                  f"{c['done'] - c['plan']:.1f} s) [{card}]")
    finally:
        torch.backends.cudnn.deterministic = prev
        set_config(fused_update=False)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"elastic: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=counts[0], lrn_backward=counts[1], fused_update=counts[2])


# ---------------------------------------------------------------------------
# The data plane: LMDB records through the process ring, the device feed and
# on-card augmentation into the τ trainers; CifarApp
# ---------------------------------------------------------------------------

FEED_RECORDS = 2048  # 256x256x3 uint8 Datums, 1000 classes: 8 batches a pass
FEED_BATCH = 256
FEED_CROP = 227
FEED_CHECKED = 16  # fed steps whose batch is held against the source: 2 passes
FEED_TIMED = 16  # fed steps timed by the host clock
FEED_PROFILED = 4  # fed steps under torch.profiler (the device's idle share)
FEED_TAU = 4  # the trainer's rounds: ParallelTrainer, world of one (NCCL)
FEED_ROUNDS = 2
FEED_FIXED = 8  # fixed-batch steps of the same solver, timed beside the fed ones


def feed_lmdb(d: str) -> tuple[str, np.ndarray]:
    """An LMDB of FEED_RECORDS seeded 3x256x256 uint8 ``Datum``s (labels in
    0..999) under ``d``, and its mean image (float64 sums, as
    ``compute_mean_from_minibatches``), saved beside it as ``mean.npy``."""
    import os

    from sparknet_tpu_torch.data import compute_mean_from_minibatches
    from sparknet_tpu_torch.data.io_utils import array_to_datum
    from sparknet_tpu_torch.data.lmdb_io import LmdbWriter

    rs = np.random.RandomState(SEED + 11)
    path = os.path.join(d, "train_lmdb")
    chunks = []
    with LmdbWriter(path) as w:
        for lo in range(0, FEED_RECORDS, FEED_BATCH):
            imgs = rs.randint(0, 256, (FEED_BATCH, 3, 256, 256), dtype=np.uint8)
            labels = rs.randint(0, 1000, FEED_BATCH)
            for i in range(FEED_BATCH):
                w.put(f"{lo + i:08d}".encode(), array_to_datum(imgs[i], int(labels[i])))
            chunks.append((imgs, labels))
    mean = compute_mean_from_minibatches(iter(chunks), (3, 256, 256))
    np.save(os.path.join(d, "mean.npy"), mean)
    return path, mean


def host_augment(x: np.ndarray, mean: np.ndarray, hos, wos, flips, crop: int) -> np.ndarray:
    """The host ``DataTransformer``'s TRAIN arithmetic with the given draws:
    float32 mean subtraction, the windows gathered by index arithmetic, then
    the mirror (the recipe has no scale)."""
    x = x.astype(np.float32) - mean[None]
    n, ch = x.shape[:2]
    rows = np.asarray(hos)[:, None] + np.arange(crop)[None]
    cols = np.asarray(wos)[:, None] + np.arange(crop)[None]
    x = x[np.arange(n)[:, None, None, None], np.arange(ch)[None, :, None, None],
          rows[:, None, :, None], cols[:, None, None, :]]
    flips = np.asarray(flips, bool)
    x[flips] = x[flips, :, :, ::-1]
    return x


def feed_augment_gates(card: str, src, aug, host, mean) -> None:
    """DeviceAugment on the card against the host: TEST at [256,3,256,256]
    bit for bit the host DataTransformer; TRAIN with injected draws bit for
    bit the host formula; its own draws in range, a fair coin over 2,048
    samples, and the same for the same (pid, seed, it, t)."""
    raw = src.get(0, 0)["data"]
    x = torch.from_numpy(raw).cuda()
    got = aug(x, False)
    check(torch.equal(got.cpu(), torch.from_numpy(host(raw, False))),
          "DeviceAugment TEST differs from the host DataTransformer")
    (hos, wos), flips = aug.draw(FEED_BATCH, 256, 256, aug.generator(0, SEED, 0))
    got = aug(x, True, offsets=(hos, wos), flips=flips)
    want = host_augment(raw, mean, hos.cpu().numpy(), wos.cpu().numpy(),
                        flips.cpu().numpy(), FEED_CROP)
    check(torch.equal(got.cpu(), torch.from_numpy(want)),
          "DeviceAugment TRAIN with injected draws differs from the host formula")
    (h1, w1), f1 = aug.draw(FEED_RECORDS, 256, 256, aug.generator(3, SEED, 7, 1))
    (h2, w2), f2 = aug.draw(FEED_RECORDS, 256, 256, aug.generator(3, SEED, 7, 1))
    lim = 256 - FEED_CROP
    share = float(f1.float().mean())
    check(0 <= int(h1.min()) and int(h1.max()) <= lim and 0 <= int(w1.min())
          and int(w1.max()) <= lim, "TRAIN's crop offsets out of range")
    check(0.4 <= share <= 0.6, f"TRAIN's flip share {share} outside [0.4, 0.6]")
    check(torch.equal(h1, h2) and torch.equal(w1, w2) and torch.equal(f1, f2),
          "the same (pid, seed, it, t) drew other windows")
    print(f"feed: DeviceAugment TEST at [256,3,256,256] bit for bit the host "
          f"DataTransformer; TRAIN with injected draws bit for bit the host formula; "
          f"{FEED_RECORDS} own draws: offsets in [0, {lim}], flip share {share:.4f}, "
          f"the same twice for one (pid, seed, it, t) [{card}]")


def phase_feed(card: str) -> dict:
    """SparkNet's ImageNet recipe at full width from records: an LMDB of
    256x256 Datums -> RecordShardSource -> the ProcessPipeline ring ->
    device_feed (pinned staging, a copy stream) -> DeviceAugment (mean,
    random 227 crop, mirror) on the card -> AlexNet b256 with 1000 classes
    (fused update, f32): Solver steps, then ParallelTrainer rounds (a world
    of one, NCCL, tau 4) through trainer_device_fn."""
    import tempfile

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.data import (
        DataTransformer,
        DeviceAugment,
        ProcessPipeline,
        RecordShardSource,
        TransformConfig,
        device_feed,
    )
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.parallel import ParallelTrainer

    t_phase = time.perf_counter()
    set_config(fused_update=True, storage_dtype="f32")
    prev = torch.backends.cudnn.deterministic
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            path, mean = feed_lmdb(d)
            write_s = time.perf_counter() - t0
            src = RecordShardSource(path, FEED_BATCH)
            bpe = src.batches_per_epoch
            check(src.backend == "lmdb" and bpe == FEED_RECORDS // FEED_BATCH,
                  f"record source: {src.backend}, {bpe} batches a pass")
            cfg = TransformConfig(crop_size=FEED_CROP, mirror=True, mean_image=mean)
            aug, host = DeviceAugment(cfg), DataTransformer(cfg)
            feed_augment_gates(card, src, aug, host, mean)

            def expect(g: int) -> dict:
                return src.get(*divmod(g, bpe))

            # The oracle of the first fed step: a second Solver's step on batch
            # 0 augmented on the host with the draws the fed step will take.
            torch.backends.cudnn.deterministic = True
            ref = train_solver(models.alexnet(FEED_BATCH), models.alexnet_solver())
            (hos, wos), flips = aug.draw(FEED_BATCH, 256, 256, aug.generator(0, SEED, 0))
            b0 = expect(0)
            ref_loss = float(ref.train_iteration({
                "data": host_augment(b0["data"], mean, hos.cpu().numpy(), wos.cpu().numpy(),
                                     flips.cpu().numpy(), FEED_CROP),
                "label": b0["label"]}))
            ref_arena = ref._param_arena.clone()
            del ref
            gc.collect()
            solver = train_solver(models.alexnet(FEED_BATCH), models.alexnet_solver())

            def keep_raw(feeds, it):
                return {**aug.device_fn(pid=0, seed=SEED)(feeds, it), "raw": feeds["data"]}

            def step(f):
                return solver.train_iteration({"data": f["data"], "label": f["label"]})

            n_fed = FEED_CHECKED + FEED_TIMED + FEED_PROFILED
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t_main = time.perf_counter()
            with ProcessPipeline(src, num_batches=n_fed, name="feed") as pipe, \
                    device_feed(pipe, device_fn=keep_raw) as feed:
                it = iter(feed)
                losses = []
                for g in range(FEED_CHECKED):
                    f = next(it)
                    want = expect(g)
                    check(f["raw"].dtype == torch.uint8 and torch.equal(
                        f["raw"].cpu(), torch.from_numpy(want["data"])) and torch.equal(
                        f["label"].cpu(), torch.from_numpy(want["label"])),
                        f"fed batch {g} is not the source's batch {divmod(g, bpe)}")
                    losses.append(step(f))
                    if g == 0:
                        check(float(losses[0]) == ref_loss and torch.equal(
                            solver._param_arena, ref_arena),
                            f"the fed step differs from the host-augmented step: loss "
                            f"{float(losses[0])} vs {ref_loss}")
                        torch.backends.cudnn.deterministic = prev
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FEED_TIMED):
                    losses.append(step(next(it)))
                torch.cuda.synchronize()
                fed_ms = 1e3 * (time.perf_counter() - t0) / FEED_TIMED
                busy_ms, _ = device_breakdown(
                    lambda: [step(next(it)) for _ in range(FEED_PROFILED)], top=1)
                busy_ms /= FEED_PROFILED
                stats = dict(pipe.stats)
                workers = pipe.workers
            # the rounds: the ring's batches stacked [tau, B, ...] on the host,
            # augmented slot by slot on the card by the trainer's hook
            tr = ParallelTrainer(solver, tau=FEED_TAU)
            check(tr.iter == n_fed, f"the rounds start at iteration {tr.iter}")
            n_round = FEED_TAU * FEED_ROUNDS
            with ProcessPipeline(src, num_batches=n_round, start_index=n_fed,
                                 name="feed.tau") as pipe:
                pull = pipe.as_data_fn(copy=True)
                hook = aug.trainer_device_fn(pid=0, seed=SEED)
                placed = []

                def checked_hook(feeds, it_):
                    placed.append(feeds["data"].dtype)
                    for t in range(FEED_TAU):
                        want = expect(it_ + t)  # the rounds start at iteration n_fed
                        check(torch.equal(feeds["data"][t].cpu(),
                                          torch.from_numpy(want["data"])),
                              f"round batch {it_ + t} is not the source's")
                    return hook(feeds, it_)

                tr.feed_device_fn = checked_hook

                def data_fn(_it):
                    bs = [pull(0) for _ in range(FEED_TAU)]
                    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}

                round_losses = [tr.train_round(data_fn) for _ in range(FEED_ROUNDS)]
            tr.close()
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t_main
            counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
                      kernels.FUSED_UPDATE_LAUNCHES)
            n_steps = n_fed + n_round
            check(counts == (2 * n_steps, 2 * n_steps, n_steps),
                  f"feed launches (lrn fwd, lrn bwd, fused) {counts}, want "
                  f"{(2 * n_steps, 2 * n_steps, n_steps)}")
            check(placed == [torch.uint8] * FEED_ROUNDS, f"the hook saw {placed}")
            values = [float(x) for x in losses] + round_losses
            check(all(np.isfinite(values)), f"feed losses {values}")
            # the same solver on one fixed batch already on the card
            fixed = {"data": aug(torch.from_numpy(expect(0)["data"]).cuda(), True,
                                 generator=aug.generator(0, SEED, 10 ** 6)),
                     "label": torch.from_numpy(expect(0)["label"]).cuda()}
            step(fixed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FEED_FIXED):
                step(fixed)
            torch.cuda.synchronize()
            fixed_ms = 1e3 * (time.perf_counter() - t0) / FEED_FIXED
    finally:
        torch.backends.cudnn.deterministic = prev
        set_config(fused_update=False)
        gc.collect()
        torch.cuda.empty_cache()
    nb = stats["batches"]
    per = {k: 1e3 * stats[k] / nb for k in ("slot_wait", "source", "decode", "transform",
                                           "write", "put")}
    idle = max(0.0, 1.0 - busy_ms / fed_ms)
    print(f"feed: {FEED_RECORDS} Datums (256x256x3 uint8, 1000 classes) written to an "
          f"LMDB in {write_s:.1f} s; {n_fed} AlexNet b{FEED_BATCH} steps fed through "
          f"{workers} ring workers and device_feed, the first {FEED_CHECKED} (2 passes) "
          f"each bit for bit the source's batch, the first bit for bit (loss and params) "
          f"a Solver step on the host-augmented batch (deterministic cuDNN, TF32 off); "
          f"{FEED_ROUNDS} ParallelTrainer rounds at tau {FEED_TAU} (NCCL, world of one) "
          f"through trainer_device_fn, every slot the source's batch, uint8 until the "
          f"hook; launches a step: LRN forward 2, LRN backward 2, fused update 1 "
          f"({counts}); round losses {[round(x, 4) for x in round_losses]} [{card}]")
    print(f"feed: fed step {fed_ms:.2f} ms, {FEED_BATCH * 1e3 / fed_ms:.1f} img/s "
          f"(mean of {FEED_TIMED}); the fixed-batch step of the same solver {fixed_ms:.2f} "
          f"ms, {FEED_BATCH * 1e3 / fixed_ms:.1f} img/s (mean of {FEED_FIXED}) [{card}]")
    print(f"feed: stage walls a batch (ms, over {nb} batches, {workers} workers): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
          + f"; the ring and the device feed, first step to the last round, "
          f"{main_s:.1f} s [{card}]")
    print(f"feed: device kernels {busy_ms:.2f} ms a fed step (torch.profiler, "
          f"{FEED_PROFILED} steps, every stream) against {fed_ms:.2f} ms unprofiled: "
          f"idle share {100 * idle:.1f} % [{card}]")
    print(f"feed: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=counts[0], lrn_backward=counts[1], fused_update=counts[2],
                fed_ms=fed_ms, fixed_ms=fixed_ms, idle=idle)


CIFAR_TAU = 10  # CifarApp's own TAU and BATCH
CIFAR_BATCH = 100
CIFAR_ROUNDS = 2
CIFAR_RECORDS = 1000  # a synthetic file's records: 5,000 to train on


def phase_cifar_app(card: str) -> dict:
    """CifarApp (cifar10_full, tau 10, batch 100) on synthetic CIFAR binaries
    for 2 outer rounds and its test passes; its first round's loss bit for
    bit the mean of 10 Solver steps on the same host-transformed batches
    (deterministic cuDNN, TF32 off)."""
    import tempfile

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps import CifarApp
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.data.cifar import write_synthetic_cifar
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.solvers.solver import Solver

    t_phase = time.perf_counter()
    set_config(fused_update=False)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as d:
            write_synthetic_cifar(d, seed=SEED, records=CIFAR_RECORDS)
            app = CifarApp(d, tau=CIFAR_TAU, batch=CIFAR_BATCH, log_dir=d, seed=SEED)
            try:
                init = app.trainer.solver.variables
                init = ({ln: [p.clone() for p in pl] for ln, pl in init.params.items()},
                        {ln: {k: v.clone() for k, v in s.items()} for ln, s in init.state.items()})
                feeds, losses = [], []
                make, train_round = app._train_feeds, app.trainer.train_round
                app._train_feeds = lambda it: feeds.append(make(it)) or feeds[-1]
                app.trainer.train_round = lambda fn: losses.append(train_round(fn)) or losses[-1]
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scores = app.run(num_outer=CIFAR_ROUNDS, num_test_batches=1)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
                          kernels.FUSED_UPDATE_LAUNCHES)
                check(app.trainer.iter == CIFAR_TAU * CIFAR_ROUNDS and
                      len(losses) == CIFAR_ROUNDS, f"CifarApp ran {app.trainer.iter} steps")
            finally:
                app.close()
            from sparknet_tpu_torch.compiler.graph import NetVars

            ref = Solver(models.cifar10_full_solver(), models.cifar10_full(CIFAR_BATCH))
            ref.variables = NetVars(params=init[0], state=init[1])
            ref_losses = [ref.train_iteration({k: v[t] for k, v in feeds[0].items()})
                          for t in range(CIFAR_TAU)]
            want = float(torch.stack(ref_losses).mean())
            check(losses[0] == want, f"CifarApp's first round loss {losses[0]} vs "
                  f"{want} from {CIFAR_TAU} Solver steps")
            acc = scores.get("accuracy", float("nan"))
            check(np.isfinite(acc) and all(np.isfinite(losses)),
                  f"CifarApp scores {scores}, losses {losses}")
    finally:
        torch.backends.cudnn.deterministic = prev
    print(f"cifar_app: CifarApp, cifar10_full, tau {CIFAR_TAU}, batch {CIFAR_BATCH}, "
          f"{5 * CIFAR_RECORDS} synthetic training records: {CIFAR_ROUNDS} rounds and its "
          f"test passes in {run_s:.2f} s, round losses {[round(x, 6) for x in losses]}, "
          f"the first bit for bit {CIFAR_TAU} Solver steps on the same host-transformed "
          f"batches; final accuracy {acc:.4f}; launches (lrn fwd, lrn bwd, fused) "
          f"{counts} [{card}]")
    print(f"cifar_app: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=counts[0], lrn_backward=counts[1], fused_update=counts[2])


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
    ("D=320 ragged, padded to 384", (2, 2, 100, 320), True),
    ("D=512", (2, 2, 130, 512), False),
    ("long context", (4, 16, 2048, 64), True),
    ("long context, not causal", (4, 16, 2048, 64), False),
    ("D=128 long", (2, 8, 1024, 128), True),
    ("ragged long", (2, 4, 2000, 64), True),
    ("D=320 long, padded to 384", (1, 4, 1024, 320), False),
    ("D=512 long", (1, 4, 1024, 512), True),
]
FLASH_BWD_TIMED = ("charlm", "long context", "long context, not causal", "D=128 long",
                   "D=512 long")
# batch entry 0 alone and in its batch, bit for bit
FLASH_BWD_ALONE = ("charlm", "D=320 ragged, padded to 384", "D=512")


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
            if label in FLASH_BWD_ALONE:
                alone = kernels._flash_attention_backward_cuda(
                    q[:1], k[:1], v[:1], o[:1], lse[:1], g[:1], causal)
                torch.cuda.synchronize()
                same = all(torch.equal(a[0], b[0]) for a, b in zip(alone, got))
                print(f"flash backward {label}: batch entry 0 alone (B = 1) and in the "
                      f"batch of {shape[0]}: {'bit for bit equal' if same else 'DIFFER'}")
                check(same, f"flash backward {label}: batch entry 0 differs alone and in "
                            f"its batch")
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
            # B3 with its lse output beside its plain version and the one
            # PyTorch call that returns o and a float32 log-sum-exp too
            t_lse_p = timer(lambda: kernels.flash_attention_forward_lse_torch(
                q, k, v, causal))

            def efficient_lse():
                return torch.ops.aten._scaled_dot_product_efficient_attention(
                    q, k, v, None, compute_log_sumexp=True, is_causal=causal)

            try:
                t_lse_l = timer(efficient_lse)
            except RuntimeError as err:  # a call that will not capture
                print(f"flash forward {label}: the efficient attention call not timed by "
                      f"{how} ({str(err)[:120]}); events over back-to-back calls instead")
                torch.cuda.synchronize()
                t_lse_l = time_ms(efficient_lse)
            bound, by = flash_backward_bound_ms(shape, causal, card)
            print(f"time flash backward {label} {list(shape)} causal {int(causal)} ({how}): "
                  f"kernel {t_k:.4f} ms ({100 * bound / t_k:.1f}% of bound), plain "
                  f"{t_p:.4f} ms, autograd backward of F.scaled_dot_product_attention "
                  f"{t_l:.4f} ms (forward + backward less forward), bound {bound:.4f} ms "
                  f"({by}); forward with lse {t_lse:.4f} ms, without {t_fwd:.4f} ms; "
                  f"with lse: plain flash_attention_forward_lse_torch {t_lse_p:.4f} ms, "
                  f"aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True) "
                  f"{t_lse_l:.4f} ms [{card}]")
            out[label] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                              bound_by=by)
            del leaves, o, lse, got
            gc.collect()
            torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **out["charlm"], wide=out["D=512 long"])


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


# transformer steps over 2 heads: (embed_dim, the kernels' width); 256 is
# the widest narrow instance, 320 (padded) and 512 the chunked kernels'
WIDE_HEAD_STEPS = ((512, 256), (640, 384), (1024, 512))


def wide_head_step(card: str, embed_dim: int, width: int) -> None:
    """A transformer train step over 2 heads of embed_dim / 2 lanes (B3 and
    B3' at ``width``): the gradient of every param and the loss through
    the kernels against the same with flash_attention_torch under autograd,
    from the same weights and batch (rtol 1e-4, atol 1e-5 x max|ref|); then
    one SGD step through the kernels, with exact launch counts."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.net import TPUNet
    from sparknet_tpu_torch.ops import kernels

    def handle():
        cfg = dataclasses.replace(models.transformer_solver(), random_seed=SEED, display=0)
        return TPUNet(cfg, models.transformer(batch=4, seq_len=64, vocab=64,
                                              embed_dim=embed_dim, heads=2,
                                              ffn_dim=512, blocks=1))

    rs = np.random.RandomState(SEED + 14)
    feeds = {"data": rs.randint(0, 64, (4, 64)).astype(np.int32),
             "label": rs.randint(0, 10, (4,)).astype(np.int32)}
    net, plain = handle(), handle()
    kernels.reset_launch_counts()
    grads = net.backward(feeds)
    with plain_attention_core():
        ref = plain.backward(feeds)
    ok, worst = True, 0.0
    for ln, gl in ref.items():
        for got, want in zip(grads[ln], gl):
            got, want = torch.as_tensor(got), torch.as_tensor(want)
            atol = 1e-5 * float(want.abs().max())
            ok = ok and bool(torch.allclose(got, want, rtol=1e-4, atol=atol))
            worst = max(worst, float((got - want).abs().max()))
    net.set_train_data(lambda it: feeds)
    plain.set_train_data(lambda it: feeds)
    loss = net.train(1)
    counts = (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES)
    with plain_attention_core():
        loss_ref = plain.train(1)
    norm = float(torch.as_tensor(grads["attn1"][0]).norm())
    print(f"charlm wide heads: transformer, embed {embed_dim} over 2 heads (D "
          f"{embed_dim // 2} on the kernels at {width}), one train step: every "
          f"gradient against plain attention from the same weights, max abs diff "
          f"{worst:.3e} (rtol 1e-4, atol 1e-5 x max|ref|) {'ok' if ok else 'FAIL'}; "
          f"loss {loss:.6f} (plain {loss_ref:.6f}), w_qkv gradient norm {norm:.4e}, "
          f"launches flash {counts[0]}, backward {counts[1]} [{card}]")
    check(counts == (2, 2), f"wide heads D {embed_dim // 2}: launches (flash, backward) "
                            f"{counts}, want (2, 2)")
    check(ok, f"wide heads D {embed_dim // 2}: gradients differ from plain attention")
    check(np.isfinite(loss) and abs(loss - loss_ref) <= 1e-4 * abs(loss_ref)
          and np.isfinite(norm) and norm > 0,
          f"wide heads D {embed_dim // 2}: loss {loss} (plain {loss_ref}), w_qkv "
          f"gradient norm {norm}")


def charlm_wide_heads_and_bf16(card: str) -> None:
    """Transformer train steps over 2 heads of 256, 320 and 512 lanes (B3
    and B3' at their D = 256 instance and the chunked kernels) against
    plain attention, and a bf16 flash_attention call against the float32
    kernel on the upcast inputs."""
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.ops import kernels

    set_config(fused_update=False)
    for embed_dim, width in WIDE_HEAD_STEPS:
        wide_head_step(card, embed_dim, width)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    q, k, v = (torch.randn((2, 4, 100, 16), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o = kernels.flash_attention(q, k, v, causal=True)
    ref = kernels.flash_attention(q.float(), k.float(), v.float(), causal=True)
    same = o.dtype == torch.bfloat16 and torch.equal(o, ref.to(torch.bfloat16))
    print(f"charlm wide heads: bf16 flash_attention [2,4,100,16] causal against the "
          f"float32 kernel on the upcast inputs cast to bf16: "
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


ENGINE_FAMILIES = ("cifar10_quick", "lenet", "transformer")
ENGINE_TIMED_INNER = 5  # calls between a timing sample's two events


def mha_layers(model) -> int:
    """MultiHeadAttention layers in a served model's forward."""
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.ops.attention import MultiHeadAttentionLayer

    net = Network(model.family.net(2), Phase.TEST, device="cuda")
    return sum(isinstance(layer, MultiHeadAttentionLayer) for layer in net.layers)


def continuous_mha_layers() -> int:
    """MultiHeadAttention layers in a forward of ``replica_run``'s
    continuous decoder (its defaults, as the run builds it)."""
    from sparknet_tpu_torch.ops.attention import MultiHeadAttentionLayer
    from sparknet_tpu_torch.serve.continuous import ContinuousDecoder

    dec = ContinuousDecoder(slots=4, seq_len=16, vocab=32, device="cuda")
    return sum(isinstance(layer, MultiHeadAttentionLayer) for layer in dec.network.layers)


PROFILED_REPLAYS = 25  # one-replay torch.profiler windows a transformer bucket


def flash_per_replay(program) -> int:
    """B3 kernels one replay of a bucket's CUDA graph ran on the card,
    counted by kernel name under torch.profiler: the most that any of
    ``PROFILED_REPLAYS`` one-replay windows saw.  A profiler window on the
    card now and then loses most of a replay's kernel records, and a lost
    record can only lower a count, so the most is the count; the windows
    short of the most kernel records seen are printed."""
    from torch.profiler import ProfilerActivity, profile

    flash, kernels_seen = [], []
    for _ in range(PROFILED_REPLAYS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            program.graph.replay()
            torch.cuda.synchronize()
        events = prof.key_averages()
        flash.append(sum(e.count for e in events if "flash_forward" in e.key))
        kernels_seen.append(sum(e.count for e in events))
    short = sorted(n for n in kernels_seen if n < max(kernels_seen))
    print(f"  {PROFILED_REPLAYS} one-replay profiler windows: B3 seen {sorted(set(flash))} "
          f"time(s) a window; {len(short)} window(s) short of the most records "
          f"({max(kernels_seen)}), holding {short}")
    return max(flash)


def flash_accounted(label: str, launches: int, replays: int, captures: int,
                    per_replay: int, eager: int = 0) -> int:
    """B3's launch count over a window of the main path, held against the
    engine's own books: the graph replays (its batches) and the warm-up
    forwards before each capture, ``per_replay`` launches each, plus
    ``eager`` other forwards' launches."""
    from sparknet_tpu_torch.serve.graphs import WARMUP_FORWARDS

    want = (replays + WARMUP_FORWARDS * captures) * per_replay + eager
    print(f"{label}: B3 launched {launches} times (its count, replays included); "
          f"{replays} replays and {WARMUP_FORWARDS} x {captures} warm-up forwards at "
          f"{per_replay} a forward, plus {eager} others, give {want}")
    check(launches == want, f"{label}: B3 launched {launches} times, the books give {want}")
    return launches


def host_ms(fn, reps: int = REPS) -> float:
    """Median host-clock ms of ``fn`` (which ends in a synchronisation)."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def run_locked(model, program, rows) -> np.ndarray:
    """One direct call of a bucket's program on ``rows`` (a comparison,
    not engine traffic: no ticket, no ledger)."""
    with model.lock:
        program.host_input[:] = rows
        return program.run()


def engine_gates(card: str, engine, rs) -> int:
    """Per family and bucket: replay against eager bit for bit, the timings,
    the transformer against plain attention; across buckets, the largest
    difference against the policy's tolerance.  Returns the B3 launches a
    transformer replay."""
    from sparknet_tpu_torch.serve import loadgen

    per_replay = None
    for fam in ENGINE_FAMILIES:
        m = engine._models[fam]
        items = np.stack(loadgen.synthetic_items(m, 256, rs))
        first = {}
        for b, prog in m.programs.items():
            rows = items[:prog.batch]
            out = run_locked(m, prog, rows)
            data = torch.from_numpy(rows).cuda()
            eager = prog.eager(data).cpu().numpy()
            same = np.array_equal(out, eager)
            print(f"engine {fam} bucket {b} (exec {prog.batch} rows): replay and eager "
                  f"{'bit for bit equal' if same else 'DIFFER'}")
            check(same, f"engine {fam} bucket {b}: replay differs from eager")
            first[b] = out[:2]
            if fam == "transformer":
                with plain_attention_core():
                    plain = prog.eager(data).cpu().numpy()
                err = float(np.abs(out - plain).max())
                ok = bool(np.allclose(out, plain, rtol=1e-5, atol=1e-6))
                print(f"engine transformer bucket {b}: replay against plain attention "
                      f"max abs err {err:.3e} (rtol 1e-5, atol 1e-6) {'ok' if ok else 'FAIL'}")
                check(ok, f"engine transformer bucket {b}: off plain attention")
                n, want = flash_per_replay(prog), mha_layers(m)
                counted = prog.launches.get("FLASH_LAUNCHES", 0)
                print(f"engine transformer bucket {b}: {n} B3 launch(es) a replay on the "
                      f"card, {counted} recorded by the capture (MultiHeadAttention "
                      f"layers: {want})")
                check(n == counted == want,
                      f"engine transformer bucket {b}: {n} B3 launches a replay")
                per_replay = n
            t_replay = time_ms(prog.graph.replay, inner=ENGINE_TIMED_INNER)
            t_eager = time_ms(lambda: prog.eager(data), inner=ENGINE_TIMED_INNER)
            t_host = host_ms(lambda: run_locked(m, prog, rows))
            print(f"time engine {fam} bucket {b}: replay {t_replay:.4f} ms, eager "
                  f"{t_eager:.4f} ms (CUDA events, median of {REPS}); host {t_host:.4f} ms "
                  f"a batch (copy in, replay, copy out), {t_host / b:.4f} ms a request "
                  f"at a full bucket [{card}]")
        ref = first[min(first)]
        scale = float(np.abs(ref).max())
        for b, got in first.items():
            diff = float(np.abs(got - ref).max())
            print(f"engine {fam}: the same 2 requests in bucket {b} against bucket "
                  f"{min(first)}: max abs diff {diff:.3e} ({diff / scale:.2e} of max|score| "
                  f"{scale:.3e}; {'bit for bit' if diff == 0 else 'not bit for bit'})")
            check(diff <= 1e-5 * scale, f"engine {fam} bucket {b}: across-bucket "
                  "difference over 1e-5 of max|score|")
    return per_replay


def phase_engine(card: str) -> dict:
    """The CNN serving engine on the card: three families at the full
    bucket ladder, the gates, the load run and a hot swap and rollback
    under live traffic."""
    import threading

    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve import graphs, loadgen
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS, ServeEngine, percentile

    rs = np.random.RandomState(SEED + 12)
    engine = ServeEngine(SERVE_BUCKETS, max_wait_ms=5.0, device="cuda")
    print(f"engine: budget {engine.policy.budget_bytes:,} B (90% of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory:,} B), buckets "
          f"{SERVE_BUCKETS}")
    transformers = []
    # B3 on the main path: the loads, then the traffic and swaps, each
    # counted from 0 (the gates between them do not count)
    kernels.reset_launch_counts()
    for fam in ENGINE_FAMILIES:
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        m = engine.load_model(fam, family=fam, seed=SEED)
        torch.cuda.synchronize()
        caps = ", ".join(f"b{b} {p.capture_s:.3f}" for b, p in m.programs.items())
        print(f"engine load {fam}: {m.measured_bytes:,} B allocated, "
              f"{torch.cuda.memory_reserved() - reserved0:,} B more reserved (the "
              f"graph pool's intermediates), {len(m.programs)} graphs captured in "
              f"{m.compile_wall_s:.3f} s ({caps} s) [{card}]")
        if fam == "transformer":
            transformers.append(m)
    flash_main = flash_accounted("engine loads", kernels.FLASH_LAUNCHES, 0,
                                 len(transformers[0].programs), mha_layers(transformers[0]))
    per_replay = engine_gates(card, engine, rs)
    kernels.reset_launch_counts()
    # within a bucket, through the engine: a padded batch equals the full one
    for fam in ENGINE_FAMILIES:
        m = engine._models[fam]
        items = loadgen.synthetic_items(m, 256, rs)
        for b in SERVE_BUCKETS[1:]:
            full = [engine.submit(fam, it) for it in items[:b]]
            engine.pump(force=True)
            k = b // 2 + 1
            padded = [engine.submit(fam, it) for it in items[:k]]
            engine.pump(force=True)
            check({t.bucket for t in full + padded} == {b}, f"engine {fam}: bucket {b}")
            same = all(np.array_equal(p.result, f.result) for p, f in zip(padded, full))
            print(f"engine {fam} bucket {b}: {k} requests padded to {b} and {b} requests, "
                  f"each real row {'bit for bit equal' if same else 'DIFFERS'}")
            check(same, f"engine {fam} bucket {b}: padded rows changed a real row")

    # hot swap and rollback under live serve_forever traffic (transformer)
    m0 = engine._models["transformer"]
    items = loadgen.synthetic_items(m0, 64, rs)
    before = [engine.infer("transformer", it) for it in items[:8]]
    stop = threading.Event()
    tickets = []

    def client():
        i = 0
        while not stop.is_set():
            tickets.append(engine.submit("transformer", items[i % len(items)]))
            i += 1
            time.sleep(2e-4)

    pump = threading.Thread(target=engine.serve_forever,
                            kwargs={"until": stop.is_set, "poll_s": 0.005})
    feeder = threading.Thread(target=client)
    pump.start()
    feeder.start()
    t0 = time.perf_counter()
    try:
        time.sleep(0.2)
        cand = engine.build_candidate("transformer", family="transformer",
                                      seed=SEED + 1)
        transformers.append(cand)
        swap1 = engine.swap_model("transformer", cand)
        time.sleep(0.2)
        # through the pump thread: infer's forced pump would chase the
        # client's arrivals and never finish
        swapped = [t.wait(timeout=60.0)
                   for t in [engine.submit("transformer", it) for it in items[:8]]]
        engine.rollback("transformer")
        time.sleep(0.2)
        cand = engine.build_candidate("transformer", family="transformer", seed=SEED + 2)
        transformers.append(cand)
        swap2 = engine.swap_model("transformer", cand)
        time.sleep(0.2)
    finally:
        stop.set()
        feeder.join(timeout=30.0)
        pump.join(timeout=30.0)
    engine.pump(force=True)  # what the feeder queued after the pump's last sweep
    for t in tickets:
        t.wait(timeout=60.0)
    live_s = time.perf_counter() - t0
    check(not pump.is_alive() and not feeder.is_alive(), "engine: a thread did not stop")
    errors = sum(t.error is not None for t in tickets)
    engine.rollback("transformer")
    rolled = [engine.infer("transformer", it) for it in items[:8]]
    torch.cuda.synchronize()
    replays = sum(m.batches for m in transformers)
    flash_main += flash_accounted("engine traffic and swaps", kernels.FLASH_LAUNCHES,
                                  replays, sum(len(m.programs) for m in transformers[1:]),
                                  per_replay)
    bitwise = all(np.array_equal(a, b) for a, b in zip(rolled, before))
    moved = not all(np.array_equal(a, b) for a, b in zip(swapped, before))
    print(f"engine swap under live traffic: {len(tickets)} tickets in {live_s:.2f} s, "
          f"{sum(t.done() for t in tickets)} resolved, {errors} errors, dropped "
          f"{sum(not t.done() for t in tickets)}; swaps drained {swap1['drained']} and "
          f"{swap2['drained']} tickets in {swap1['swap_wall_s'] * 1e3:.2f} / "
          f"{swap2['swap_wall_s'] * 1e3:.2f} ms; request-path captures "
          f"{engine.serve_path_compiles}; new weights moved the scores: {moved}; "
          f"rollback scores bit for bit the first generation's: {bitwise}")
    check(all(t.done() for t in tickets) and errors == 0, "engine: a ticket dropped")
    check(engine.serve_path_compiles == 0, "engine: a capture on the request path")
    check(bitwise and moved, "engine: rollback scores differ")
    total = [x for m in transformers for x in m.lat_total_ms]
    queue = [x for m in transformers for x in m.lat_queue_ms]
    print(f"engine transformer, every generation's requests ({len(total)}): p50 "
          f"{percentile(total, 50):.3f} ms, p99 {percentile(total, 99):.3f} ms, queue p50 "
          f"{percentile(queue, 50):.3f} ms, p99 {percentile(queue, 99):.3f} ms; the live "
          f"leg {len(tickets) / live_s:.1f} requests/s through two captures, two swaps and "
          f"a rollback [{card}]")
    engine.shutdown()
    del engine, transformers, m0, cand
    gc.collect()

    # the 504-request load run: every bucket, two resident models, one
    # refusal through an injected table, no capture after the warm-up
    captures0 = graphs.capture_count()
    s = loadgen.load_run(device="cuda", log=lambda msg: print(f"load_run: {msg}"))
    print(f"load_run: {s['requests']} requests, {s['resolved']} resolved, {s['batches']} "
          f"batches, buckets {s['buckets_exercised']}, captures after the warm-up "
          f"{s['compiles_post_warmup']} (request path {s['serve_path_compiles']}), "
          f"refused {s['refused']}; p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
          f"{s['rps']:.1f} requests/s over {s['wall_s']:.3f} s [{card}]")
    for name, ms in s["stats"].items():
        print(f"load_run {name} ({ms['family']}): {ms['requests']} requests in "
              f"{ms['batches']} batches, p50 {ms['p50_ms']:.3f} ms, p99 "
              f"{ms['p99_ms']:.3f} ms, queue p50 {ms['queue_p50_ms']:.3f} ms, p99 "
              f"{ms['queue_p99_ms']:.3f} ms, device p50 {ms['device_p50_ms']:.3f} ms, "
              f"{ms['measured_bytes']:,} B resident [{card}]")
    check(s["requests"] == s["resolved"] == 504, "load_run: a request did not resolve")
    check(s["compiles_post_warmup"] == s["serve_path_compiles"] == 0,
          "load_run: a capture after the warm-up")
    check(s["refused"], "load_run: the over-budget load was admitted")
    check(s["buckets_exercised"] == list(SERVE_BUCKETS), "load_run: a bucket not used")
    check(graphs.capture_count() - captures0 == 8, "load_run: not 8 captures at load")
    return {"flash": flash_main, "per_replay": per_replay}


def phase_replica(card: str, per_replay: int) -> dict:
    """``replica_run`` on three device slots of the one card."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve import graphs
    from sparknet_tpu_torch.serve.dryrun import replica_run

    kernels.reset_launch_counts()
    captures0 = graphs.capture_count()
    s = replica_run(replicas=2, family="transformer", buckets=(1, 8, 64),
                    max_wait_ms=25.0, rate=2000.0, seconds=1.5, backlog=40,
                    seed=SEED, devices=["cuda:0"] * 3,
                    log=lambda msg: print(f"replica: {msg}"))
    torch.cuda.synchronize()
    flash = kernels.FLASH_LAUNCHES
    print(f"replica: faults {s['faults_fired']}, width {s['replicas_start']} -> "
          f"{s['replicas_end']}; {s['requests']} requests in {s['batches']} batches, "
          f"{s['shed']} shed; rerouted {s['rerouted']} ({s['rerouted_deterministic']} "
          f"at the known-backlog kill, all resolved: {s['kill_resolved']}); dropped "
          f"{s['dropped']} (pod ledger {s['pod_dropped']}); request-path captures "
          f"{s['serve_path_compiles']}; steady queue p99 {s['queue_p99_ms']:.3f} ms "
          f"against a bound of {s['queue_bound_ms']:.1f} ms; total p99 "
          f"{s['p99_ms']:.3f} ms; continuous decoder interleaved == alone: "
          f"{s['continuous_exact']}, slots reused: {s['slot_churn']}; "
          f"{s['wall_s']:.2f} s [{card}]")
    check(s["ok"], f"replica_run: a gate failed ({s['gates']})")
    # the continuous decoder's leg runs one char LM forward a step, eagerly
    return {"flash": flash_accounted(
        "replica", flash, s["batches"], graphs.capture_count() - captures0, per_replay,
        eager=s["continuous_steps"] * continuous_mha_layers())}


# ---------------------------------------------------------------------------
# The ImageNet zoo families: BatchNorm, Scale and Bias; GoogLeNet, ResNet-50,
# VGG-16, SqueezeNet and MobileNet training at published width; BN folding;
# the engine's mobilenet family and fold_bn arm
# ---------------------------------------------------------------------------

ZOO = (  # (family, default batch, published crop, timed steps)
    ("googlenet", 32, 224, 3),
    ("resnet50", 32, 224, 3),
    ("vgg16", 64, 224, 2),
    ("squeezenet", 32, 227, 3),
    ("mobilenet", 32, 224, 3),
)
ZOO_SIZES = {name: (batch, crop) for name, batch, crop, _ in ZOO}
ZOO_STEPS = 20  # steps on the fixed batch for the falling-loss check
ZOO_PROFILED = 2  # steps under torch.profiler (the busy share)
ZOO_CLASSES = 10  # the fixed batch's labels: 10 of the 1000 classes
# SqueezeNet's published recipe (xavier fillers, base_lr 0.04) diverges on the
# pixel-scale batch within a few steps (the phase prints those steps); its
# steps take the same batch divided by its standard deviation
ZOO_UNIT_SCALE = ("squeezenet",)
ZOO_TEST_FORWARDS = 5  # timed TEST forwards a family, after a check and a warm-up
# the card against the CPU at crop 64, batch 4 (``zoo_card_vs_cpu``): each
# layer alone on the CPU forward's own inputs, its outputs, state and VJP
# at rtol 1e-4 + 1e-5 x max|ref|; the whole step's loss at rtol 1e-4
ZOO_CPU_GATE = (1e-4, 1e-5)
ZOO_CPU_FAMILIES = ("googlenet", "resnet50")
# the whole step: each blob's history (the step's update) as a relative L2
# error, and the BatchNorm state as a share of max|ref|.  A rounding that
# decides a ReLU or a max otherwise moves every gradient below it (the
# phase lists those decisions); tests/test_torch_port_zoo_bn.py measures
# 0.077 and 3.3e-4 for ResNet-50 between the port and JAX on the CPU, and
# tests/test_torch_port_zoo_conditioning.py 3.1e-2 (ResNet-50) and 7.3e-3
# (GoogLeNet, this check's batch) between the port's float32 and float64
ZOO_CPU_HISTORY = {"googlenet": 0.05, "resnet50": 0.15}
ZOO_CPU_STATE = 1e-3
# ResNet-50's published base_lr (0.1) spikes on the fixed batch: its losses
# are printed, and the falling-loss check and the fold take the JAX fold
# test's base_lr (tests/test_fold_bn.py)
ZOO_FALL_LR = {"resnet50": 1e-3}
ZOO_ACROSS_BUCKETS = 1e-4  # of max|score|: the engine's mobilenet across buckets


def zoo_batch(batch: int, crop: int, classes: int = ZOO_CLASSES, seed: int = SEED + 13) -> dict:
    """One fixed pixel-scale batch on the card: noise x40 plus a +-80
    pattern a class, labels cycling over ``classes``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    label = torch.arange(batch, device="cuda") % classes
    pattern = torch.randn((classes, 3, crop, crop), generator=gen, device="cuda").sign()
    data = torch.randn((batch, 3, crop, crop), generator=gen, device="cuda") * 40
    return {"data": data + 80 * pattern[label], "label": label.to(torch.int32)}


def zoo_solver(net_param, name: str, fused: bool = True, device=None, cfg=None):
    """A Solver of ``name``'s published recipe (or ``cfg``), weights from
    ``SEED``."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.solvers.solver import Solver

    set_config(fused_update=fused, storage_dtype="f32")
    try:
        cfg = dataclasses.replace(cfg or getattr(models, f"{name}_solver")(),
                                  random_seed=SEED)
        solver = Solver(cfg, net_param, device=device)
    finally:
        set_config(fused_update=False)
    check((solver.layout is not None) == fused, f"{name}: fused_update did not take")
    return solver


def zoo_net(name: str, batch: int, crop: int, dropout=None):
    from sparknet_tpu_torch import models

    net = getattr(models, name)(batch=batch, crop=crop)
    if dropout is not None:
        for lp in net.get_all("layer"):
            if lp.get_str("type") == "Dropout":
                lp.get_msg("dropout_param").set("dropout_ratio", dropout)
    return net


def zoo_steps(solver, feeds, n: int) -> list:
    """``n`` train iterations; the losses stay on the card."""
    return [solver.train_iteration(feeds) for _ in range(n)]


def zoo_kinds(rows) -> dict:
    """Device ms of a profile's kernels by kind: the convolutions and GEMMs
    (cuDNN, cuBLAS, ATen's depthwise convolution), ATen's elementwise and
    reduction kernels (BatchNorm, Scale, ReLU, Eltwise, pooling's glue),
    the port's kernels and the rest."""
    kinds = {"conv/gemm": 0.0, "aten elementwise/reduce": 0.0, "port": 0.0, "other": 0.0}
    for ms, name, _ in rows:
        n = name.lower()
        if any(k in n for k in ("lrn_", "fused_update")):
            kinds["port"] += ms
        elif any(k in n for k in ("cudnn", "xmma", "gemm", "conv", "cutlass", "dgrad",
                                  "wgrad", "implicit", "winograd", "fft")):
            kinds["conv/gemm"] += ms
        elif any(k in n for k in ("elementwise", "reduce", "unrolled", "vectorized")):
            kinds["aten elementwise/reduce"] += ms
        else:
            kinds["other"] += ms
    return kinds


def zoo_bn_scale_ms(solver) -> tuple[float, int]:
    """Device ms of the train step's BatchNorm and Scale work alone: each
    BatchNorm -> Scale pair's forward (batch statistics, the state update)
    and backward at its shape in the step, on random activations, the
    kernels' time under torch.profiler."""
    from sparknet_tpu_torch.common import f32_precision

    net = solver.train_net
    info = net.blob_info()
    v = solver.variables
    pairs = [(l, net.layers[i + 1]) for i, l in enumerate(net.layers)
             if l.type == "BatchNorm" and net.layers[i + 1].type == "Scale"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.randn(info[bn.bottoms[0]].shape, generator=gen, device="cuda")
          .requires_grad_(True) for bn, _ in pairs]
    gs = [torch.randn_like(x) for x in xs]
    params = [[p.detach().requires_grad_(True) for p in v.params[sc.name]] for _, sc in pairs]

    def run():
        with f32_precision():
            for (bn, sc), x, g, p in zip(pairs, xs, gs, params):
                y = bn.apply([], v.state[bn.name], [x], train=True).outputs[0]
                y = sc.apply(p, {}, [y], train=True).outputs[0]
                torch.autograd.grad(y, [x, *p], g)

    run()  # warm-up
    return device_breakdown(run, top=1)[0], len(pairs)


def zoo_train(card: str) -> dict:
    """Each family at its published width and default batch, fused update,
    f32: warm-up, timed steps, the busy share, the falling loss over
    ``ZOO_STEPS`` steps on the fixed batch (ResNet-50's at
    ``ZOO_FALL_LR``), the TEST forward with global statistics.  Returns the
    launches of these steps (the main path) and the GoogLeNet and ResNet-50
    solvers."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.ops import kernels

    out = {"steps": 0, "googlenet_steps": 0, "test_forwards": 0}
    kernels.reset_launch_counts()
    for name, batch, crop, timed in ZOO:
        feeds = zoo_batch(batch, crop)
        if name in ZOO_UNIT_SCALE:
            solver = zoo_solver(zoo_net(name, batch, crop), name)
            pixel = [round(float(l), 4) for l in zoo_steps(solver, feeds, 5)]
            print(f"zoo {name} on the pixel-scale batch (std "
                  f"{float(feeds['data'].std()):.1f}), not gated: losses {pixel}")
            out["steps"] += 5
            feeds = {"data": feeds["data"] / feeds["data"].std(), "label": feeds["label"]}
        solver = zoo_solver(zoo_net(name, batch, crop), name)
        params = solver.layout.param_count()
        losses = zoo_steps(solver, feeds, 1)  # warm-up: cuDNN/cuBLAS set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += zoo_steps(solver, feeds, timed)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / timed
        busy_ms, rows = device_breakdown(lambda: losses.extend(
            zoo_steps(solver, feeds, ZOO_PROFILED)), top=1000)
        busy_ms /= ZOO_PROFILED
        losses += zoo_steps(solver, feeds, ZOO_STEPS - len(losses))
        tl = [float(l) for l in losses]
        check(all(np.isfinite(tl)), f"{name}: losses {tl}")
        out["steps"] += ZOO_STEPS
        fall = ""
        if name in ZOO_FALL_LR:
            published = [round(x, 4) for x in tl]
            del solver
            gc.collect()
            cfg = dataclasses.replace(getattr(models, f"{name}_solver")(),
                                      base_lr=ZOO_FALL_LR[name])
            solver = zoo_solver(zoo_net(name, batch, crop), name, cfg=cfg)
            tl = [float(l) for l in zoo_steps(solver, feeds, ZOO_STEPS)]
            check(all(np.isfinite(tl)), f"{name} at base_lr {cfg.base_lr:g}: losses {tl}")
            out["steps"] += ZOO_STEPS
            fall = (f"; the published base_lr's losses (not gated to fall) {published}; "
                    f"{ZOO_STEPS} more steps from seed 0 at base_lr {cfg.base_lr:g}")
        first, last = float(np.mean(tl[:5])), float(np.mean(tl[-5:]))
        check(last < first and max(tl[-5:]) < tl[0],
              f"{name}: the loss did not fall over {ZOO_STEPS} steps: {tl}")
        if name == "googlenet":
            out["googlenet_steps"] += ZOO_STEPS
        bn = ""
        state = solver.variables.state
        if state:
            sf = [float(s["scale_factor"][0]) for s in state.values()]
            check(min(sf) > 0, f"{name}: a BatchNorm scale_factor did not move")
            bn = (f"; {len(sf)} BatchNorm layers, scale_factor {min(sf):.4f}-"
                  f"{max(sf):.4f} after {ZOO_STEPS} steps")
        print(f"zoo {name} b{batch} {crop}x{crop} ({params:,} params, fused update, f32, "
              f"TF32 off{', unit-scale batch' if name in ZOO_UNIT_SCALE else ''}): "
              f"{timed} timed steps {ms:.2f} ms/step, {batch * 1e3 / ms:.1f} img/s; busy "
              f"{busy_ms:.2f} ms a step ({ZOO_PROFILED} profiled steps, every stream), "
              f"{100 * busy_ms / ms:.1f}% of the unprofiled step{fall}; losses over "
              f"{ZOO_STEPS} steps {[round(x, 4) for x in tl]}: first 5 mean {first:.4f}, "
              f"last 5 mean {last:.4f}, each of the last 5 below the first{bn} [{card}]")
        if name in ("resnet50", "mobilenet"):
            device_ms = sum(r[0] for r in rows) / ZOO_PROFILED
            kinds = zoo_kinds(rows)
            bn_ms, pairs = zoo_bn_scale_ms(solver)
            print(f"zoo {name} step by kind of kernel (torch.profiler, {device_ms:.2f} ms "
                  f"of kernels a step): " + ", ".join(
                      f"{k} {v / ZOO_PROFILED:.2f} ms ({100 * v / ZOO_PROFILED / device_ms:.1f}%)"
                      for k, v in kinds.items())
                  + f"; the {pairs} BatchNorm+Scale pairs alone (forward and backward at "
                  f"the step's shapes, their kernels under torch.profiler) {bn_ms:.2f} ms, "
                  f"{100 * bn_ms / device_ms:.1f}% of the step's kernel time [{card}]")
            for dms, kname, calls in rows[:8]:
                print(f"  {dms / ZOO_PROFILED:8.3f} ms  {100 * dms / ZOO_PROFILED / device_ms:5.1f}%"
                      f"  x{calls // ZOO_PROFILED}  {kname[:90]}")
        test_net = Network(solver.net_param, Phase.TEST)
        v = solver.variables
        # the main head's scores: the last label reader's other bottom
        head = [layer for layer in test_net.layers if "label" in layer.bottoms][-1]
        score = next(b for b in head.bottoms if b != "label")
        with torch.inference_mode():
            scores = test_net.apply(v, feeds, train=False)[0][score]
            check(tuple(scores.shape) == (batch, 1000) and bool(torch.isfinite(scores).all()),
                  f"{name}: TEST scores {tuple(scores.shape)}")
            test_net.apply(v, feeds, train=False)  # warm-up
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ZOO_TEST_FORWARDS):
                test_net.apply(v, feeds, train=False)
            stop.record()
            stop.synchronize()
            t_test = start.elapsed_time(stop) / ZOO_TEST_FORWARDS
        out["test_forwards"] += 2 + ZOO_TEST_FORWARDS if name == "googlenet" else 0
        print(f"zoo {name} TEST forward (global statistics) b{batch}: {t_test:.2f} "
              f"ms/forward, {batch * 1e3 / t_test:.1f} img/s (CUDA events over "
              f"{ZOO_TEST_FORWARDS} forwards), scores finite [{card}]")
        if name in ("googlenet", "resnet50"):
            out[name] = solver
        del solver, feeds, v, test_net, scores
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
              kernels.FUSED_UPDATE_LAUNCHES)
    g, f = out["googlenet_steps"], out["test_forwards"]
    want = (2 * (g + f), 2 * g, out["steps"])
    print(f"zoo: {out['steps']} train steps, {g} of them GoogLeNet's, and {f} GoogLeNet "
          f"TEST forwards; launches (LRN forward, LRN backward, fused update) {counts}, "
          f"want {want}")
    check(counts == want, f"zoo launches {counts}, want {want}")
    out["counts"] = counts
    return out


def zoo_lrn(card: str) -> None:
    """B1 and B1' against their plain versions at GoogLeNet's two LRN
    shapes, and their times beside the bound and the library call."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    bw, _, _ = card_peaks(card)
    for shape in GOOGLENET_LRN:
        x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 50)
        g = torch.randn(shape, generator=gen, device="cuda")
        for what, got, ref in (
                ("forward", kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0),
                 kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0)),
                ("backward", kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0),
                 kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0))):
            err = (got - ref).abs()
            ok = bool((err <= F32_TOL["atol"] + F32_TOL["rtol"] * ref.abs()).all())
            print(f"zoo googlenet LRN {what} {list(shape)}: max abs err "
                  f"{float(err.max()):.3e} (rtol 1e-5, atol 1e-6) {'ok' if ok else 'FAIL'}, "
                  f"{int((got != ref).sum())} elements not bitwise equal")
            check(ok, f"googlenet LRN {what} {shape}")
        t_k = time_ms(lambda: kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0))
        t_p = time_ms(lambda: kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0))
        t_l = time_ms(lambda: F.local_response_norm(x, 5, ALPHA, 0.75, 1.0))
        bound, by = lrn_bound_ms(shape, 5, 4, card)
        print(f"time zoo googlenet LRN forward {list(shape)} f32: kernel {t_k:.4f} ms "
              f"({100 * bound / t_k:.1f}% of bound), plain {t_p:.4f} ms, "
              f"F.local_response_norm {t_l:.4f} ms, bound {bound:.4f} ms ({by}) [{card}]")
        t_k = time_ms(lambda: kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0))
        t_p = time_ms(lambda: kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0))
        xr = x.clone().requires_grad_(True)
        yr = F.local_response_norm(xr, 5, ALPHA, 0.75, 1.0)
        t_l = time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True))
        del yr, xr
        bound = 3 * x.numel() * 4 / bw * 1e3
        print(f"time zoo googlenet LRN backward {list(shape)} f32: kernel {t_k:.4f} ms "
              f"({100 * bound / t_k:.1f}% of bound), plain {t_p:.4f} ms, "
              f"F.local_response_norm backward {t_l:.4f} ms, bound {bound:.4f} ms "
              f"(bytes) [{card}]")


def zoo_googlenet_plain_lrn(card: str, solver) -> None:
    """GoogLeNet's logits through B1 against the same forward with the
    plain LRN, at the AlexNet path phase's gate (rtol/atol 1e-4)."""
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network

    net = Network(solver.net_param, Phase.TEST)
    feeds = zoo_batch(*ZOO_SIZES["googlenet"], seed=SEED + 15)
    with torch.inference_mode():
        blobs = net.apply(solver.variables, feeds, train=False)[0]
        ref, _ = forward_with_plain_lrn(net, solver.variables, feeds)
    got, want = blobs["loss3/classifier"], ref["loss3/classifier"]
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
    print(f"zoo googlenet b{feeds['label'].numel()} loss3/classifier through B1 against the plain-LRN forward: "
          f"max abs err {err:.3e} (rtol/atol 1e-4) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "googlenet logits vs the plain-LRN forward")


def zoo_fused_vs_blob(card: str) -> None:
    """One step, fused against per-blob, from the same weights and batch
    (dropout 0, deterministic cuDNN), for ResNet-50 and VGG-16; then B2
    against its plain version on their arenas, timed beside its bound."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.solvers.arena import ArenaTables

    bw, _, _ = card_peaks(card)
    for name in ("resnet50", "vgg16"):
        batch, crop = ZOO_SIZES[name]
        net = zoo_net(name, batch, crop, dropout=0.0)
        feeds = zoo_batch(batch, crop)
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            res = []
            for fused in (True, False):
                s = zoo_solver(net, name, fused=fused)
                loss = float(s.train_iteration(feeds))
                v = s.variables
                res.append((loss, {ln: [p.detach().clone() for p in pl]
                                   for ln, pl in v.params.items()},
                            {ln: [h[0].detach().clone() for h in hl]
                             for ln, hl in s.slots.items()},
                            {ln: {k: t.clone() for k, t in st.items()}
                             for ln, st in v.state.items()}))
                if fused:
                    layout = s.layout
                del s, v
                gc.collect()
        finally:
            torch.backends.cudnn.deterministic = prev
        (lf, pf, hf, sf), (lb, pb, hb, sb) = res
        worst, bitwise = 0.0, True
        pairs = [(a, b) for ln in pf for a, b in zip(pf[ln] + hf[ln], pb[ln] + hb[ln])]
        pairs += [(sf[ln][k], sb[ln][k]) for ln in sf for k in sf[ln]]
        for a, b in pairs:
            bitwise = bitwise and torch.equal(a, b)
            worst = max(worst, float((a - b).abs().max()))
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-7),
                  f"{name} fused vs per-blob: max abs diff {float((a - b).abs().max()):.3e}")
        print(f"zoo {name} fused vs per-blob, 1 step b{batch}, dropout 0, deterministic "
              f"cuDNN: loss {lf:.6f} vs {lb:.6f}, params, history and state max abs diff "
              f"{worst:.3e} (rtol 1e-5, atol 1e-7), "
              f"{'bitwise equal' if bitwise else 'not bitwise equal'} [{card}]")
        del res, pairs, pf, pb, hf, hb, sf, sb
        gc.collect()
        torch.cuda.empty_cache()
        # B2 on this arena: against its plain version, then timed
        tables = ArenaTables(layout, torch.device("cuda"))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        real = torch.zeros(layout.total, dtype=torch.bool, device="cuda")
        for e in layout.entries:
            real[e.offset:e.offset + e.size] = True
        w = torch.where(real, torch.randn(layout.total, generator=gen, device="cuda") * 0.01, 0.0)
        g = torch.where(real, torch.randn(layout.total, generator=gen, device="cuda") * 1e-3, 0.0)
        h = torch.where(real, torch.randn(layout.total, generator=gen, device="cuda") * 1e-3, 0.0)
        st = kernels.UpdateStatics(momentum=0.9, reg="l2")
        sc = torch.tensor([0.01, 1.0, 1.0], device="cuda")
        ref_w, ref_s = kernels.fused_update_torch("SGD", st, w, g, [h], tables.tile_lr,
                                                  tables.tile_decay, sc)
        kernels.fused_update("SGD", st, w, g, [h], tables.tile_lr, tables.tile_decay, sc)
        same = torch.equal(w, ref_w) and torch.equal(h, ref_s[0])
        del ref_w, ref_s
        t_k = time_ms(lambda: kernels.fused_update("SGD", st, w, g, [h], tables.tile_lr,
                                                   tables.tile_decay, sc), reps=10)
        t_p = time_ms(lambda: kernels.fused_update_torch("SGD", st, w, g, [h], tables.tile_lr,
                                                         tables.tile_decay, sc), reps=10)
        nbytes = 5 * layout.total * 4
        bound = nbytes / bw * 1e3
        print(f"time zoo fused_update SGD f32 L2 on the {name} arena ({layout.param_count():,} "
              f"params, {layout.total:,} after padding): kernel {t_k:.4f} ms "
              f"({nbytes / 1e9:.3f} GB, {100 * bound / t_k:.1f}% of bound), plain "
              f"{t_p:.4f} ms, bound {bound:.4f} ms (bytes); kernel against plain "
              f"{'bitwise equal' if same else 'NOT bitwise equal'} [{card}]")
        check(same, f"fused_update on the {name} arena differs from its plain version")
        del w, g, h, tables, real
        gc.collect()
        torch.cuda.empty_cache()


def zoo_walk(net, variables, feeds, device) -> dict:
    """The TRAIN forward of ``net`` layer by layer on ``device``, without
    grad: each layer's inputs by layer name."""
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops.data_layers import InputLayer

    gen = torch.Generator(device=device).manual_seed(SEED)
    blob = {k: torch.as_tensor(v).to(device) for k, v in feeds.items()}
    ins = {}
    with torch.no_grad(), f32_precision():
        for layer in net.layers:
            if isinstance(layer, InputLayer):
                continue
            ins[layer.name] = [blob[b] for b in layer.bottoms]
            out = layer.apply([p.to(device) for p in variables.params.get(layer.name, [])],
                              {k: t.to(device) for k, t in
                               variables.state.get(layer.name, {}).items()},
                              ins[layer.name], train=True,
                              **({"gen": gen} if layer.NEEDS_GEN else {}))
            blob.update(zip(layer.tops, out.outputs))
    return ins


def zoo_in_context(net, variables, ins) -> tuple[int, float, str]:
    """Each layer of ``net`` alone, on the CPU forward's own inputs ``ins``:
    the card's outputs, state, and VJP (seeded cotangents) against the
    CPU's.  Returns the layers held, the worst excess over rtol 1e-4 as a
    share of max|ref|, and where."""
    from sparknet_tpu_torch.common import f32_precision

    rtol = ZOO_CPU_GATE[0]
    rs = np.random.RandomState(SEED + 20)
    worst, where = 0.0, "-"
    for layer in net.layers:
        if layer.name not in ins:
            continue
        res, cots = [], None
        for dev in ("cpu", "cuda"):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            p = [t.detach().to(dev).requires_grad_(True)
                 for t in variables.params.get(layer.name, [])]
            st = {k: t.to(dev) for k, t in variables.state.get(layer.name, {}).items()}
            xs = [x.detach().to(dev).requires_grad_(x.is_floating_point())
                  for x in ins[layer.name]]
            with f32_precision():
                out = layer.apply(p, st, xs, train=True,
                                  **({"gen": gen} if layer.NEEDS_GEN else {}))
                if cots is None:
                    cots = [torch.from_numpy(np.asarray(rs.randn(*o.shape), np.float32))
                            for o in out.outputs]
                live = [(o, c.to(dev)) for o, c in zip(out.outputs, cots) if o.requires_grad]
                wrt = p + [x for x in xs if x.requires_grad]
                grads = torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                            allow_unused=True) if live and wrt else []
            res.append([o.detach() for o in out.outputs] + list(out.state.values())
                       + [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)])
        for i, (got, ref) in enumerate(zip(res[1], res[0], strict=True)):
            got, ref = got.detach().double().cpu(), ref.detach().double()
            scale = float(ref.abs().max()) or 1.0
            excess = float(((got - ref).abs() - rtol * ref.abs()).clamp(min=0).max()) / scale
            if excess > worst:
                worst, where = excess, f"{layer.name} #{i}"
    return len(ins), worst, where


def zoo_card_vs_cpu(card: str) -> None:
    """ResNet-50 and GoogLeNet at crop 64, batch 4, dropout 0, from the same
    weights and batch on the card and on this machine's CPU: each layer
    alone on the CPU forward's inputs (``zoo_in_context``, at
    ``ZOO_CPU_GATE``); the ReLU signs and MAX-pool argmaxes that differ
    between the two devices' whole forwards; one whole step (loss, each
    blob's history, BatchNorm state)."""
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.ops.vision import _pool_pads

    rtol, arel = ZOO_CPU_GATE
    rs = np.random.RandomState(SEED + 17)
    for name in ZOO_CPU_FAMILIES:
        feeds = {"data": (rs.randn(4, 3, 64, 64) * 40).astype(np.float32),
                 "label": rs.randint(0, ZOO_CLASSES, 4).astype(np.int32)}
        net_param = zoo_net(name, 4, 64, dropout=0.0)
        solvers = [zoo_solver(net_param, name, device=d) for d in ("cuda", "cpu")]
        v0 = solvers[1].variables
        v0 = type(v0)({ln: [p.detach().clone() for p in pl] for ln, pl in v0.params.items()},
                      {ln: {k: t.clone() for k, t in st.items()} for ln, st in v0.state.items()})
        # each layer alone, and the ReLU decisions of the two whole forwards
        net = Network(net_param, Phase.TRAIN, device="cpu")
        cpu_ins = zoo_walk(net, v0, feeds, "cpu")
        card_ins = zoo_walk(net, v0, feeds, "cuda")
        layers, worst_layer, where_layer = zoo_in_context(net, v0, cpu_ins)
        flips = []
        for layer in net.layers:
            if layer.type not in ("ReLU", "Pooling"):
                continue
            a, c = card_ins[layer.name][0].cpu(), cpu_ins[layer.name][0]
            if layer.type == "ReLU":
                diff = (a > 0) != (c > 0)
            elif layer.type == "Pooling" and layer._conf(c.shape)[0] == "MAX":
                # the window's argmax, each device's input through the same
                # CPU pooling
                _, kernel, stride, pad = layer._conf(c.shape)
                pads = _pool_pads(c, kernel, stride, pad)
                diff = torch.ne(*[F.max_pool2d(F.pad(x, pads, value=float("-inf")), kernel,
                                               stride, return_indices=True)[1] for x in (a, c)])
            else:
                continue
            if bool(diff.any()):
                flips.append(f"{layer.name} x{int(diff.sum())}")
        del cpu_ins, card_ins
        # the whole step
        losses = [float(s.train_iteration(feeds)) for s in solvers]
        (gv, cv), (gs, cs) = [s.variables for s in solvers], [s.slots for s in solvers]
        upd, state = (0.0, "-"), (0.0, "-")
        for ln, pl in cv.params.items():
            for i, p in enumerate(pl):
                # SGD's first step: the history is the update, w <- w - history
                check(torch.equal(p.detach(), v0.params[ln][i] - cs[ln][i][0])
                      and torch.equal(gv.params[ln][i].detach(),
                                      v0.params[ln][i].cuda() - gs[ln][i][0]),
                      f"{name} {ln}[{i}]: the params did not move by the history")
                ref, got = cs[ln][i][0].double(), gs[ln][i][0].cpu().double()
                err = float((got - ref).norm()) / max(float(ref.norm()), 1e-30)
                upd = max(upd, (err, f"{ln}[{i}]"))
        for ln, st in cv.state.items():
            for k, t in st.items():
                got, ref = gv.state[ln][k].cpu().double(), t.double()
                excess = float(((got - ref).abs() - rtol * ref.abs()).clamp(min=0).max())
                state = max(state, (excess / (float(ref.abs().max()) or 1.0), f"{ln}/{k}"))
        loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
        ok = (worst_layer <= arel and loss_rel <= rtol and upd[0] <= ZOO_CPU_HISTORY[name]
              and state[0] <= ZOO_CPU_STATE)
        print(f"zoo {name} crop 64 b4 dropout 0, the card against the CPU: {layers} layers "
              f"alone on the CPU's inputs (outputs, state, VJP), worst {worst_layer:.2e} of "
              f"max|ref| beyond rtol {rtol:g} ({where_layer}; gate {arel:g}); ReLU signs and "
              f"MAX-pool argmaxes deciding otherwise in the two whole forwards: {flips}; "
              f"one whole step: "
              f"loss {losses[0]:.6f} vs {losses[1]:.6f} (rel {loss_rel:.2e}, gate {rtol:g}), "
              f"worst history (the update) relative L2 error {upd[0]:.2e} ({upd[1]}; gate "
              f"{ZOO_CPU_HISTORY[name]:g}), state {state[0]:.2e} of max|ref| beyond rtol "
              f"({state[1]}; gate {ZOO_CPU_STATE:g}) {'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"{name}: the card's step is off the CPU's")
        del solvers, gv, cv, v0, net
        gc.collect()


def deploy_of(net_param):
    """``net_param`` without its label input and the layers that read it."""
    from sparknet_tpu_torch.proto.text_format import Message

    out = Message()
    for lp in net_param.get_all("layer"):
        if "label" not in [str(b) for b in lp.get_all("bottom")] + [lp.get_str("name")]:
            out.add("layer", lp)
    return out


def zoo_fold(card: str, solver) -> None:
    """The ResNet-50 b32 trained at ``ZOO_FALL_LR`` folded through
    DeployNet.fold_batchnorm: 53 chains, no BatchNorm or Scale left, fc1000
    within the JAX test's gate (rtol/atol 2e-4) of the unfolded TEST
    forward."""
    from sparknet_tpu_torch.compiler.graph import NetVars
    from sparknet_tpu_torch.models import DeployNet

    d = DeployNet(deploy_of(solver.net_param))
    v = solver.variables
    d.variables = NetVars({ln: [p.detach().clone() for p in pl] for ln, pl in v.params.items()},
                          {ln: {k: t.clone() for k, t in s.items()} for ln, s in v.state.items()})
    batch, crop = ZOO_SIZES["resnet50"]
    x = {"data": zoo_batch(batch, crop, seed=SEED + 18)["data"]}

    def forward():
        return d.network.apply(d.variables, x, train=False)[0]["fc1000"]

    with torch.inference_mode():
        ref = forward().clone()
        t_ref = time_ms(forward, reps=5, inner=2)
        folded = d.fold_batchnorm()
        got = forward()
        t_fold = time_ms(forward, reps=5, inner=2)
    types = {layer.type for layer in d.network.layers}
    err = float((got - ref).abs().max())
    ok = (len(folded) == 53 and not types & {"BatchNorm", "Scale"}
          and bool(torch.isfinite(ref).all())
          and bool(torch.allclose(got, ref, rtol=2e-4, atol=2e-4)))
    print(f"zoo resnet50 fold (the weights of the base_lr {solver.config.base_lr:g} run): "
          f"{len(folded)} chains folded, BatchNorm/Scale left: "
          f"{sorted(types & {'BatchNorm', 'Scale'})}; fc1000 max abs err {err:.3e} "
          f"(max|fc1000| {float(ref.abs().max()):.3e}; rtol 2e-4, atol 2e-4) "
          f"{'ok' if ok else 'FAIL'}; TEST forward b{batch} {t_ref:.2f} ms unfolded, "
          f"{t_fold:.2f} ms folded [{card}]")
    check(ok, "resnet50 fold")


def zoo_serve(card: str) -> None:
    """The engine serves the mobilenet family (trained a few steps) at the
    full bucket ladder in the f32 and fold_bn arms; cifar10_quick's fold_bn
    arm gives its f32 arm's bits."""
    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS, ServeEngine

    fam = GRAPH_SWEEP_FAMILIES["mobilenet"]
    solver = zoo_solver(fam.net(32), "mobilenet", cfg=fam.solver())
    feeds = zoo_batch(32, 64, classes=fam.num_classes)
    losses = [float(l) for l in zoo_steps(solver, feeds, 5)]
    check(all(np.isfinite(losses)), f"engine mobilenet training losses {losses}")
    engine = ServeEngine(SERVE_BUCKETS, max_wait_ms=5.0, device="cuda")
    rs = np.random.RandomState(SEED + 19)
    items = (rs.randn(256, *fam.image_shape) * 40).astype(np.float32)
    firsts, tickets = {}, []
    try:
        for arm in ("f32", "fold_bn"):
            m = engine.load_model(f"mobilenet_{arm}", family="mobilenet", arm=arm,
                                  variables=solver.variables)
            first = {}
            for b, prog in m.programs.items():
                rows = items[:prog.batch]
                out = run_locked(m, prog, rows)
                eager = prog.eager(torch.from_numpy(rows).cuda()).cpu().numpy()
                same = np.array_equal(out, eager)
                t_replay = time_ms(prog.graph.replay, inner=ENGINE_TIMED_INNER)
                t_eager = time_ms(lambda: prog.eager(torch.from_numpy(rows).cuda()),
                                  inner=ENGINE_TIMED_INNER)
                print(f"zoo engine mobilenet {arm} bucket {b} (exec {prog.batch} rows): "
                      f"replay and eager {'bit for bit equal' if same else 'DIFFER'}; "
                      f"replay {t_replay:.4f} ms, eager {t_eager:.4f} ms [{card}]")
                check(same and np.isfinite(out).all(), f"mobilenet {arm} bucket {b}: replay")
                first[b] = out[:2]
            ref = first[min(first)]
            scale = float(np.abs(ref).max())
            worst = max(float(np.abs(got - ref).max()) for got in first.values())
            print(f"zoo engine mobilenet {arm}: {len(m.folded)} chains folded; the same 2 "
                  f"requests across buckets {sorted(first)}: worst max abs diff {worst:.3e}, "
                  f"{worst / scale:.2e} of max|score| {scale:.3e} (adopted tolerance "
                  f"{ZOO_ACROSS_BUCKETS:g})")
            check(worst <= ZOO_ACROSS_BUCKETS * scale, f"mobilenet {arm}: across buckets")
            for b in SERVE_BUCKETS[1:]:
                full = [engine.submit(m.name, it) for it in items[:b]]
                engine.pump(force=True)
                padded = [engine.submit(m.name, it) for it in items[:b // 2 + 1]]
                engine.pump(force=True)
                tickets += full + padded
                same = all(np.array_equal(p.result, f.result) for p, f in zip(padded, full))
                check(same and {t.bucket for t in full + padded} == {b},
                      f"mobilenet {arm} bucket {b}: padded rows changed a real row")
            print(f"zoo engine mobilenet {arm}: padded batches bit for bit the full ones "
                  f"in buckets {list(SERVE_BUCKETS[1:])}")
            firsts[arm] = first
        for b in firsts["f32"]:
            err = float(np.abs(firsts["fold_bn"][b] - firsts["f32"][b]).max())
            check(np.allclose(firsts["fold_bn"][b], firsts["f32"][b], rtol=2e-4, atol=2e-4),
                  f"mobilenet fold_bn bucket {b} off the f32 arm by {err:.3e}")
        # a BN-free family: the fold_bn arm is the f32 arm, bit for bit
        ms = [engine.load_model(f"cifar_{arm}", family="cifar10_quick", arm=arm)
              for arm in ("f32", "fold_bn")]
        citems = (rs.randn(256, 3, 32, 32) * 10).astype(np.float32)
        for b in SERVE_BUCKETS:
            outs = [run_locked(m, m.programs[b], citems[:m.programs[b].batch]) for m in ms]
            check(np.array_equal(*outs), f"cifar10_quick fold_bn bucket {b} is not f32's")
        dropped = sum(not t.done() or t.error is not None for t in tickets)
        print(f"zoo engine: fold_bn within rtol/atol 2e-4 of f32 for mobilenet in every "
              f"bucket; cifar10_quick fold_bn bit for bit its f32 arm in every bucket; "
              f"request-path captures {engine.serve_path_compiles}, dropped {dropped} [{card}]")
        check(engine.serve_path_compiles == 0, "zoo engine: a capture on the request path")
        check(dropped == 0, f"zoo engine: {dropped} tickets dropped")
    finally:
        engine.shutdown()
    del solver
    gc.collect()


def phase_zoo(card: str) -> dict:
    """The ImageNet families on the card: training, the kernels at
    GoogLeNet's shapes, fused against per-blob, card against CPU, the
    fold and the engine.  Returns the main path's launches."""
    walls = [time.perf_counter()]
    train = zoo_train(card)
    walls.append(time.perf_counter())
    zoo_lrn(card)
    zoo_googlenet_plain_lrn(card, train.pop("googlenet"))
    zoo_fold(card, train.pop("resnet50"))
    gc.collect()
    torch.cuda.empty_cache()
    walls.append(time.perf_counter())
    zoo_fused_vs_blob(card)
    walls.append(time.perf_counter())
    zoo_card_vs_cpu(card)
    walls.append(time.perf_counter())
    zoo_serve(card)
    walls.append(time.perf_counter())
    print("zoo: seconds by part: " + ", ".join(
        f"{part} {b - a:.1f}" for part, a, b in zip(
            ("training", "LRN and fold", "fused against per-blob", "card against CPU",
             "engine"), walls, walls[1:])))
    lrn, bwd, upd = train["counts"]
    return dict(lrn=lrn, lrn_backward=bwd, fused_update=upd)


PHASES = ("kernel", "path", "serve", "profile", "lrn_backward", "train",
          "fused_update", "train_profile", "fused_vs_blob", "parallel", "elastic", "feed",
          "cifar_app", "flash", "flash_backward", "paged", "token", "token_profile",
          "charlm_train", "engine", "replica", "zoo")


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
    laps = [t_start]  # the clock after each step, for the seconds by phase

    def lap(name: str) -> None:
        laps.append(time.perf_counter())
        print(f"chip_smoke: {name} took {laps[-1] - laps[-2]:.1f} s")

    card = phase_card()
    phase_build()
    lap("build")
    stats = {}
    launches = {"lrn_across_channels": 0, "lrn_backward": 0, "fused_update": 0,
                "flash_attention": 0, "flash_attention_backward": 0,
                "paged_attention": 0}
    if "kernel" in phases:
        stats["lrn"] = phase_kernel(card)
        lap("kernel")
    if "path" in phases:
        path_launches, forward, ms_per_forward = phase_path(card)
        launches["lrn_across_channels"] += path_launches
        lap("path")
    if "serve" in phases:
        launches["lrn_across_channels"] += phase_serve(card)
        lap("serve")
    if "profile" in phases and "path" in phases:
        phase_profile(card, forward, ms_per_forward)
        lap("profile")
    if "lrn_backward" in phases:
        stats["lrn_backward"] = phase_lrn_backward(card)
        lap("lrn_backward")
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
        lap("train, fused_update and train_profile")
    if "fused_vs_blob" in phases:
        phase_fused_vs_blob(card)
        lap("fused_vs_blob")
    if "parallel" in phases:
        par = phase_parallel(card)
        launches["lrn_across_channels"] += par["lrn"]
        launches["lrn_backward"] += par["lrn_backward"]
        launches["fused_update"] += par["fused_update"]
        launches["flash_attention"] += par["flash"]
        launches["paged_attention"] += par["paged"]
        lap("parallel")
    if "elastic" in phases:
        el = phase_elastic(card)
        launches["lrn_across_channels"] += el["lrn"]
        launches["lrn_backward"] += el["lrn_backward"]
        launches["fused_update"] += el["fused_update"]
        lap("elastic")
    for name, run in (("feed", phase_feed), ("cifar_app", phase_cifar_app)):
        if name in phases:
            fed = run(card)
            launches["lrn_across_channels"] += fed["lrn"]
            launches["lrn_backward"] += fed["lrn_backward"]
            launches["fused_update"] += fed["fused_update"]
            lap(name)
    if "flash" in phases:
        stats["flash"] = phase_flash(card)
        lap("flash")
    if "flash_backward" in phases:
        stats["flash_backward"] = phase_flash_backward(card)
        lap("flash_backward")
    if "paged" in phases:
        stats["paged"] = phase_paged(card)
        lap("paged")
    if "token" in phases:
        token = phase_token(card)
        launches["flash_attention"] += token["flash"]
        launches["paged_attention"] += token["paged"]
        if "token_profile" in phases:
            phase_token_profile(card, token)
        del token
        lap("token and token_profile")
    if "charlm_train" in phases:
        charlm = phase_charlm_train(card)
        launches["flash_attention"] += charlm["flash"]
        launches["flash_attention_backward"] += charlm["backward"]
        launches["fused_update"] += charlm["fused_update"]
        launches["paged_attention"] += charlm["paged"]
        lap("charlm_train")
    per_replay = 1  # the transformer family's one MultiHeadAttention layer
    if "engine" in phases:
        eng = phase_engine(card)
        launches["flash_attention"] += eng["flash"]
        per_replay = eng["per_replay"]
        lap("engine")
    if "replica" in phases:
        launches["flash_attention"] += phase_replica(card, per_replay)["flash"]
        lap("replica")
    if "zoo" in phases:
        zoo = phase_zoo(card)
        launches["lrn_across_channels"] += zoo["lrn"]
        launches["lrn_backward"] += zoo["lrn_backward"]
        launches["fused_update"] += zoo["fused_update"]
        lap("zoo")
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
        # rounds, the elastic rounds, the fed AlexNet steps and rounds, the
        # CifarApp run, the paged token run and the rectangle run, the char
        # LM's timed training steps and its sampling, the serving engine's
        # loads, traffic and swaps and the replica run: there, each graph
        # replay adds the launches its capture recorded, and a capture
        # adds none; the ImageNet families' training steps), each counted
        # from 0
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
