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
   storage (in place); then fed by gradient segments (each blob's
   gradient where autograd leaves it), bit for bit the packed path and
   within the same gates of the plain version at SGD f32, Adam f32, SGD
   bf16 and a mixed bf16-in-f32 arena, a blob without a gradient among
   them; the kernel on segments and on the packed arena, and the update
   path (pack + B2 against B2 on segments), timed beside the bound in
   turns, by events and by CUDA-graph replay, and counted from each
   path's capture record (B2's recorded launch and the graph's kernel,
   memset and memcpy nodes); the same gate on every other arena the
   script trains (the ImageNet families, MNIST, flickr, the loop's
   cifar10_quick and transformer, the char LM with the empty kernel's
   graph-replay floor beside the small arenas), and each trained net's
   step on the packed arena against its step on segments in turns
   (AlexNet f32 and bf16 compute, the char LM, cifar10_quick);
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
    bit for bit its f32 arm;
25. db_apps: Caffe's weight and record files, the DB apps and the CLI
    (fused update, f32, TF32 off, deterministic cuDNN): ``.caffemodel``
    round trips through ``TPUNet.save_caffemodel``/``load_caffemodel``
    bit for bit (CaffeNet at full width, GoogLeNet at published width with
    ``/`` in its layer names, ResNet-50 with BatchNorm state moved by two
    steps), sizes and seconds printed; ``ImageNetCreateDBApp`` over two tar
    shards of 600 seeded 320x320 JPEGs: two record DBs of 512 records, bit
    for bit the PIL-decoded, resized images, the mean the float64
    accumulation of them, ``info.json`` as the JAX app writes it;
    ``ImageNetRunDBApp`` (CaffeNet b256, crop 227) resumed from the
    CaffeNet file: its weights bit for bit, its first step bit for bit a
    ``Solver`` step on the captured batch, 12 steps with 24/24/12
    launches, ms/step, img/s and the host's share (``db_minibatches`` and
    ``DataTransformer`` timed apart) beside the same solver's fixed-batch
    step; ``FeaturizerApp`` ``fc7`` of 2 TEST batches of worker 1's DB with
    the trained weights through ``save_weights_to_file``, within 1e-4 of
    the plain-LRN forward, 4 launches; ``CifarDBApp`` on LevelDB
    (cifar10_full b100, 2,500 + 500 synthetic records, 20 iterations, 5
    test batches): every record bit for bit the loader's, the accuracy
    before and after; the CLI in
    process: ``convert_db`` LevelDB -> record -> lmdb bit for bit,
    ``compute_image_mean`` to ``.binaryproto`` read back equal and within
    rtol 1e-6 of the app's mean, ``test --weights`` on a ``Data``-layer
    CaffeNet equal to ``Solver.test``, ``extract_features`` bit for bit
    the featurizer's, ``time`` per layer and ``--fused``, ``train`` from
    worker 0's DB with launches, ``device_query`` naming the card.
26. layers: Caffe's remaining layer library and weight sharing by name
    (f32, TF32 off).  Every newly ported layer type (the neuron layers,
    the losses, Slice, Reshape, Tile, ArgMax, BatchReindex, Reduction,
    MVN, Silence, Filter, Deconvolution, Im2col, SPP, STOCHASTIC pooling)
    forward and backward on the card against the same layer on the CPU
    (``LAYERS_GATE`` of each array's largest |value|), beside the CPU's
    own float32 against float64 error; BatchReindex's backward twice on the
    card and replayed from a CUDA graph, bit for bit; STOCHASTIC pooling in TRAIN on injected
    uniforms; DummyData's values; the Python layer in its Caffe-compat and
    torch-native styles, and the Caffe-compat style refusing a CUDA graph
    capture; FCN-32s's upsampling Deconvolution ([1,21,16,16] to 544x544,
    kernel 64, stride 32) against the CPU and timed by CUDA events beside
    its bound; ``mnist_siamese`` at batch 64 and ``mnist_autoencoder`` at
    batch 100 each train 20 steps through ``Solver`` with the fused update
    on seeded synthetic batches: each step's loss within
    ``LAYERS_LOSS_RTOL`` of the CPU port's run of the same steps from the
    same init, one B2 launch a step, the siamese net's 10 shared blobs
    held once (0-size placeholders of 0 arena tiles), ms a step by CUDA
    events; then one more step of each under ``torch.profiler`` (the
    device's busy share), and B2 against ``fused_update_torch`` bit for bit
    on each family's arena with its recipe's constants and multipliers,
    timed beside its bound.

27. precision: reduced precision (TF32 off, bf16 products summed in
    float32).  B1 and B1' in bf16 at the AlexNet and CaffeNet b256 shapes
    against their plain versions (one bf16 ulp), timed beside the bound,
    the plain versions and ``F.local_response_norm`` (its autograd
    backward for B1'); the zoo AlexNet b256 at ``compute_dtype`` bf16 on
    float32 masters (fused update, B1/B1' on bf16 blobs, B2 in float32):
    its first loss within ``PREC_LOSS_RTOL`` of the f32 step's from the
    same seed, exact launches, 20 steps timed in turns against the f32
    step; each remat policy (``full``, ``dots``, ``blocks``) and
    ``activation_dtype`` ``blocks`` (bf16 and f32 steps): one step from the
    same state (remat: its loss bit for bit the policy-free step's; every
    update within ``PREC_UPDATE_RTOL`` relative L2), the peak memory and
    ms/step; the full-width char LM at bf16 through ``TPUNet`` (B3/B3' on
    bf16 q, k, v cast to float32 in the wrappers), 40 steps in turns
    against f32, exact launches, the loss falling; the CaffeNet
    ``Classifier`` (10 crops) calibrated with ``calibrate_int8`` and
    predicting in int8: exact launches (8 int8 products and 2 LRN a
    forward), top-1 agreement with f32; CaffeNet conv1-3's int32 sums bit
    for bit the float64 convolution of the same int8 values, and
    ``torch._int_mm`` and the int8 path timed at conv1-5 beside cuDNN's
    float32 convolution and the int8 bound; the engine's ``int8`` arm for
    ``cifar10_quick``, ``lenet`` and ``mobilenet`` (trained 5 steps) at
    buckets 1/8/64/256: replay bit for bit eager, the int8 products each
    replay launches, padded bit for bit full, scores beside the f32
    arm's, 0 request-path captures, 0 dropped.
28. listfile: the list-file data layers and the rest of the CLI (fused
    update, f32, TF32 off, deterministic cuDNN) on 300 seeded 320x240
    JPEGs, their lists, an R-CNN window file and a mean computed by the
    CLI's ``convert_imageset`` and ``compute_image_mean``: BVLC Caffe's
    finetune_flickr_style net (CaffeNet, ImageData b50, fc8_flickr 20)
    through ``cli train --data auto`` for 4 steps and 2 test iterations,
    its first step's gradient and update within ``LF_GRAD_RTOL`` of the
    CPU port's from the same weights, batch and dropout masks, ms a step
    and the share waiting on the host's decode and transform beside the
    fixed-batch step; the same run at ``--tau 2`` in a world of one, bit
    for bit its params and history; the PASCAL detection net (WindowData
    b128, fc8_pascal 21) through ``--data proto`` for 3 steps; the R-CNN
    ``Detector`` (fc-rcnn 200, context_pad 16) over 2 images x 16 windows
    within ``LF_DET_TOL`` of the CPU Detector; ``classify`` on 4 images,
    top-5 equal to ``Classifier.predict``; B1 and B1' against their plain
    versions at the phase's shapes and B2 on the flickr arena bit for bit;
    exact launches on every path.
29. seq_parallel: sequence parallelism, MoE and the GPipe schedule.
    gloo's answer on CUDA tensors (``all_to_all_single`` with its values;
    ``batch_isend_irecv`` in a 2-rank probe, which aborts: the ring's hops
    go through pinned host buffers, ``collectives.GLOO_CUDA_HOST_STAGED``);
    then four gloo ranks on cuda:0 (spawned, FileStore) train the
    full-width char LM (b32 x 128, Adam, fused update, f32) through
    ``ParallelTrainer`` over ``auto_mesh(seq_parallel=4)``, 3 checked and 5
    timed steps under ring attention and under Ulysses: each checked step
    from the pool's params and history against a lone ``Solver`` step
    (loss rtol 1e-4; params rtol 1e-4, atol 1e-5 x max + 1e-2 x base_lr),
    exact launches (ring: rank i 2(i + 1) B3 and 2(i + 1) B3' a step;
    Ulysses 2 and 2; one B2 a rank), the host-staged hops counted; ms a
    step and tokens/s beside the lone step; the all-to-all and a ring hop
    timed alone; the MoE layer with one expert a rank over a model axis of
    4 at [4096, 64] tokens, E 4, H 256 against the dense layer, and
    ``expert_parallel_moe`` at capacity E and 1.0 (kept rows) against it
    (``SP_MOE_TOL`` of max|dense|); ``pipeline_blocks`` S 4, D 64 against
    ``sequential_blocks``; B3 (with lse) and B3' at the ring's blocks
    [32,4,32,16] (causal and not) and Ulysses' [32,1,128,16] against their
    plain versions (rtol 1e-5, atol 1e-6; backward atol 1e-6 x max|ref|),
    timed by CUDA graph beside the plain versions, SDPA and the bound.
30. loop: the train-to-serve production loop (``loop.dryrun.loop_run``)
    with its obs journal, fused update, f32, deterministic cuDNN.
    cifar10_quick at its published batch of 100 in a world of one (NCCL):
    two iterations of two elastic rounds at tau 2, each checkpointed
    atomically, its candidate captured on a builder thread at buckets
    1/8/64/256 and swapped into the live engine with tickets in flight,
    then a refused over-budget ``resnet50`` candidate and a bitwise
    rollback: every gate holds (0 captures on the request path and on the
    serving thread, 0 dropped, scores changed then restored bit for bit,
    the refusal, the incumbent intact), 8 B2 launches for 8 steps, the
    journal valid with no dangling lineage, its round, save, build and
    swap walls printed; the same run with obs off gives the same launches
    and bit for bit the same last checkpoint.  Then the serving latency
    (p50/p99 by phase: before, during training, during the rollout, after)
    of a client thread served by a pump thread while the main thread
    trains two rounds and rolls out.  The transformer family (batch 32 a
    worker, one iteration): the gates, and B3 launched once a layer for
    each replay, each capture's warm-up forwards and each training
    forward, B3' once a layer a step.  A pool of two gloo ranks on cuda:0
    (spawned, FileStore), rank 0 serving and journaling, the plan killing
    worker 1 at round 1: the gates, ``worker_lost`` and ``mesh_resize`` in
    rank 0's journal, the rounds at widths 2 and 1, B2 launches by rank.
    Last, B2 against ``fused_update_torch`` bit for bit on the loop's arena
    (timed beside its bound), B3 (with lse) and B3' at the transformer's
    [32,4,32,4] and [256,4,32,4] causal against their plain versions (rtol
    1e-5, atol 1e-6).

31. trace (run first, right after the build: late in a long process
    about half of all profiler windows lose device records, see 32): the
    port's profiler (fused update, f32, TF32 off).  ``tpunet time --trace
    --iterations 5`` on the zoo AlexNet b256 and on the full-width char LM
    (b32 x 128), through the CLI's ``main``: the per-layer table with
    norm1/norm2's B1 time in ``fwd`` and their B1' time in ``bwd`` (every
    B1 record scoped ``L.norm<i>``, every B1' record
    ``transpose(jvp(L.norm<i>))``), every B3' record in an attention layer's
    ``bwd``, the records of B1, B1', B2, B3 and B3' in both traced windows
    equal to the launch counts of those windows, ``(other)``'s kernels
    printed by name (the update and what runs outside ``Network.apply``,
    no layer's hand kernel), the device time a step at most the wall, the
    MFU below 1 against ``h100_sxm_f32``; an AlexNet b256 step traced and
    untraced bit for bit (loss, params, history) with the same launches;
    ``tpunet train --profile`` (AlexNet b64, 2 steps) writing a trace that
    holds every launch.  ``time --trace`` takes a window that lost
    hand-kernel records again (up to 3 times; the count is printed).
    Prints each command's seconds and the phase's.
32. obs_cli (last): what a journal line costs the emitting thread on the
    journals' filesystem (the Recorder's one handle against reopening the
    file a line, fault C18 in ROADMAP Queue C; printed); the 64-request
    token mix through a ``PagedDecoder`` with a Recorder armed (one
    ``request`` event a ticket, one ``prefill`` event a prefill, a summary
    with 0 leaked); ``obs dryrun --replica --replicas 2`` in a process of
    its own, as a user starts it, with its host-clock queue gate; ``obs
    dryrun --serve --family transformer``, ``--replica --replicas 2``, the dp/tau
    legs with ``--elastic`` at ``--devices 2`` (two spawned gloo ranks on
    the card) and ``--ctl`` exiting 0; ``obs validate`` and ``obs report
    --lineage`` on every journal, ``obs top --once`` on one; then 100
    one-replay ``trace_step`` windows of a transformer bucket and 50 bare
    ``torch.profiler`` windows around the same replay: how many lose B3's
    record, the kinds of record they lose and how far before its launch
    the device's first record was stamped (printed, not gated).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and runs nothing.  Weights are random, drawn from a fixed seed.
``--phases`` runs a subset (comma-separated names: card and build always
run) and then prints no result lines; with no arguments every phase runs.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import signal
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
    """Device time of one call of ``fn`` under ``torch.profiler``
    (``utils/profiling.trace``), read by ``utils/op_profile``'s lane
    policy, the one ``tpunet time --trace`` reads: (total device ms,
    [(ms, kernel name, calls)] of the ``top`` kernels)."""
    import tempfile

    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.utils import op_profile, profiling

    torch.cuda.synchronize()
    before = {k: getattr(kernels, k) for k in op_profile.KERNEL_RECORDS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        with profiling.trace(d):
            fn()
        events = op_profile._device_events(d)
    records = op_profile.kernel_records(events)
    short = {k: (records[k], getattr(kernels, k) - n) for k, n in before.items()
             if records[k] < getattr(kernels, k) - n}
    if short:
        print(f"  (this profiler window lost hand-kernel records (records, launches) {short}: "
              "its device time reads low and is left out of PERF.md's comparisons, §7)")
    by_name: dict = {}
    for name, us in events:
        key = name.split("|", 1)[0]
        ms, n = by_name.get(key, (0.0, 0))
        by_name[key] = (ms + us / 1e3, n + 1)
    rows = sorted(((ms, key, n) for key, (ms, n) in by_name.items()), reverse=True)
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


# a kernel that does nothing, in blocks of the fused update's 256 threads:
# its graph-replay time is the floor any launch pays on the card, the
# yardstick of B2 on the small arenas.  The smoke builds it itself; no path
# of the program launches it.
EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int smoke_empty_kernel(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
_EMPTY_LIB = []


def empty_kernel_library():
    """Path of the empty kernel's shared library, and the ``nvcc`` that
    builds it (None when built), started now."""
    import hashlib

    from sparknet_tpu_torch.ops import kernels

    digest = hashlib.sha256(EMPTY_KERNEL_CU.encode()
                            + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()[:16]
    path = kernels.BUILD_DIR / f"libsmoke_empty-{digest}.so"
    if path.exists():
        return path, None
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = path.with_suffix(".cu")
    src.write_text(EMPTY_KERNEL_CU)
    return path, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(path), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def empty_kernel(blocks: int) -> None:
    """Launch ``blocks`` blocks of the empty kernel on the current stream
    (built in the build phase)."""
    import ctypes

    if not _EMPTY_LIB:
        path, proc = empty_kernel_library()
        check(proc is None, "the empty kernel was not built in the build phase")
        lib = ctypes.CDLL(str(path))
        lib.smoke_empty_kernel.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.smoke_empty_kernel.restype = ctypes.c_int
        _EMPTY_LIB.append(lib)
    err = _EMPTY_LIB[0].smoke_empty_kernel(int(blocks), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel: CUDA error {err}")


def phase_build() -> None:
    from sparknet_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    _, empty_proc = empty_kernel_library()  # built beside the kernels
    logs = kernels.build_libraries()
    if empty_proc is not None:
        log = empty_proc.communicate()[0]
        check(empty_proc.returncode == 0, f"nvcc failed for the empty kernel:\n{log}")
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
TURN_STEPS = 5  # steps a turn when the packed and the segment steps are timed in turns
STEP_TURNS = 8  # pairs of turns, alternating which step runs first


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


def arena_mask(layout) -> torch.Tensor:
    """True on the arena's real elements, False in the pad zones."""
    real = torch.zeros(layout.total, dtype=torch.bool, device="cuda")
    for e in layout.entries:
        real[e.offset:e.offset + e.size] = True
    return real


def seeded_blob_grads(layout, gen, none_at=None) -> list:
    """One seeded gradient a layout entry on the card, in its blob's type
    (a bf16 blob's is bf16), as autograd leaves it; None for a shared
    blob's placeholder (no span) and for entry ``none_at`` (a blob that
    got no gradient)."""
    return [None if not e.span or i == none_at else
            (torch.randn(e.shape, generator=gen, device="cuda") * 1e-3).to(getattr(torch, e.dtype))
            for i, e in enumerate(layout.entries)]


def capture_record(fn) -> tuple[dict, dict]:
    """One call of ``fn`` captured into a CUDA graph: the launches the
    port's wrappers recorded in it, and the graph's own nodes by kind
    (KERNEL, MEMSET, MEMCPY, from its debug dump), so a path's kernels are
    counted from the capture and not from a profiler window."""
    import tempfile

    from sparknet_tpu_torch.ops import kernels

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # the graph, not only its executable
    graph.enable_debug_mode()
    with kernels.recording_launches() as recorded:
        with torch.cuda.graph(graph):
            fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del graph
    return dict(recorded), {k: len(re.findall(rf"\b{k}\b", dot))
                            for k in ("KERNEL", "MEMSET", "MEMCPY")}


def b2_gate(card: str, what: str, layout, rule: str, st, sc: torch.Tensor,
            none_blob: bool = True, timed: bool = True) -> dict:
    """B2 on ``layout``'s arena fed by gradient segments (each blob's
    gradient where autograd would leave it, ``ArenaTables.segments``)
    against the same kernel on the packed grad arena (``pack_grads``, what
    ``unpack``'s backward makes): params and history bit for bit; and
    against the plain version at the fused_update phase's gates (SGD and
    Nesterov f32 bitwise, the others ``UPDATE_F32_ULPS``, bf16 one bf16
    ulp).  Seeded weights and history on the blobs' spans (0 in the pad
    zones), one gradient a blob in its own type, the last blob with a span
    given none when ``none_blob``.  Pad zones stay 0, the gradients are
    not written, nothing is copied.  When ``timed``: the kernel on
    segments and on the packed arena by CUDA events and by graph replay,
    the update path (pack + B2 against B2 on segments) by graph replay,
    all in turns, each path's capture record, and on a small arena the
    empty kernel's floor.  Returns the numbers."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.solvers import arena as arena_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    tables = arena_mod.ArenaTables(layout, dev)
    real = arena_mask(layout)

    def rand(scale, positive=False):
        t = torch.randn(layout.total, generator=gen, device=dev) * scale
        return torch.where(real, t.abs() if positive else t, 0.0).to(layout.storage)

    w0 = rand(0.01)
    slots0 = [rand(1e-3, positive=True) for _ in range(kernels.FUSED_RULE_SLOTS[rule])]
    spans = [i for i, e in enumerate(layout.entries) if e.span]
    none_at = spans[-1] if none_blob and len(spans) > 1 else None
    grads = seeded_blob_grads(layout, gen, none_at)
    seg = [g for e, g in zip(layout.entries, grads) if e.span]
    before = [None if g is None else g.clone() for g in seg]
    packed = arena_mod.pack_grads(layout, grads)
    args = (tables.tile_lr, tables.tile_decay, sc)
    ref_w, ref_s = kernels.fused_update_torch(rule, st, w0, seg, slots0, *args,
                                              tables.segments)
    pw, ps = kernels.fused_update_torch(rule, st, w0, packed, slots0, *args)
    plain_same = torch.equal(ref_w, pw) and all(torch.equal(a, b) for a, b in zip(ref_s, ps))
    del pw, ps
    wp, sp = w0.clone(), [t.clone() for t in slots0]
    kernels.fused_update(rule, st, wp, packed, sp, *args)
    ws, ss = w0.clone(), [t.clone() for t in slots0]
    copies = kernels.FUSED_GRAD_COPIES
    kernels.fused_update(rule, st, ws, seg, ss, *args, tables.segments)
    torch.cuda.synchronize()
    bitwise = torch.equal(ws, wp) and all(torch.equal(a, b) for a, b in zip(ss, sp))
    max_abs, worst = 0.0, 0
    for out, ref in zip((ws, *ss), (ref_w, *ref_s)):
        max_abs = max(max_abs, float((out.float() - ref.float()).abs().max()))
        if out.dtype == torch.float32:
            worst = max(worst, ulps_f32(out, ref))
            check(worst <= UPDATE_F32_ULPS[rule],
                  f"B2 on segments, {what} {rule}: {worst} ulps off the plain version")
        else:
            err = (out.float() - ref.float()).abs()
            check(bool((err <= bf16_ulp(ref.float())).all()),
                  f"B2 on segments, {what} {rule}: beyond one bf16 ulp of the plain version")
        check(not bool(out[~real].any()), f"B2 on segments, {what} {rule}: pad zone not zero")
    untouched = all(a is None or torch.equal(a, b) for a, b in zip(seg, before))
    mixed = sum(g is not None and g.dtype != layout.storage for g in seg)
    print(f"B2 on segments, {what} {rule} {str(layout.storage)[6:]} arena ({layout.param_count():,} "
          f"params, {len(seg)} segments, {mixed} of another type, "
          f"{sum(e.span == 0 for e in layout.entries)} placeholders, "
          f"{'one blob without a gradient' if none_at is not None else 'every blob a gradient'}): "
          f"{'bit for bit' if bitwise else 'NOT bit for bit'} the packed path, "
          f"{worst} ulps / max abs err {max_abs:.3e} off the plain version; plain on segments "
          f"{'bit for bit' if plain_same else 'NOT bit for bit'} plain on the packed arena; "
          f"gradients {'untouched' if untouched else 'WRITTEN'}, "
          f"{kernels.FUSED_GRAD_COPIES - copies} copies [{card}]")
    check(bitwise and plain_same, f"B2 on segments, {what} {rule}: not the packed path")
    check(untouched, f"B2 on segments, {what} {rule}: wrote a gradient")
    check(kernels.FUSED_GRAD_COPIES == copies, f"B2 on segments, {what}: copied a gradient")
    del ref_w, ref_s, before
    out = dict(max_abs_err=max_abs)
    if not timed:
        return out
    bw, _, _ = card_peaks(card)
    # timed on the steps' case: every blob a gradient (the one left without
    # is given zeros; the same update)
    seg_all = list(seg)
    if none_at is not None:
        e = layout.entries[none_at]
        seg_all[spans.index(none_at)] = torch.zeros(e.shape, device=dev,
                                                    dtype=getattr(torch, e.dtype))
    # each arena read and written once, each gradient read once (its own
    # type)
    nbytes = ((1 + len(slots0)) * 2 * layout.total * w0.element_size()
              + sum(g.numel() * g.element_size() for g in seg_all))
    bound = nbytes / bw * 1e3

    def k_seg():
        kernels.fused_update(rule, st, ws, seg_all, ss, *args, tables.segments)

    def k_seg_none():
        kernels.fused_update(rule, st, ws, seg, ss, *args, tables.segments)

    def k_packed():
        kernels.fused_update(rule, st, wp, packed, sp, *args)

    def path_packed():
        kernels.fused_update(rule, st, wp, arena_mod.pack_grads(layout, grads), sp, *args)

    reps = 10
    ev = {"segments": [], "packed": []}
    gr = {"segments": [], "packed": [], "path": []}
    for turn in (0, 1):
        order = (("path", path_packed), ("segments", k_seg), ("packed", k_packed))
        for name, fn in (order if turn == 0 else order[::-1]):
            gr[name].append(graph_ms(fn, reps=reps))
            if name != "path":
                ev[name].append(time_ms(fn, reps=reps))
    t_plain = time_ms(lambda: kernels.fused_update_torch(rule, st, ws, seg, ss, *args,
                                                         tables.segments), reps=reps)
    host = {}
    calls = [("segments", k_seg), ("packed", k_packed)]
    for name, fn in calls + ([("none", k_seg_none)] if none_at is not None else []):
        # the wrapper's host time: 10 calls queued back to back (the queue
        # does not fill), host clock, median of ``reps``
        torch.cuda.synchronize()
        laps = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            laps.append((time.perf_counter() - t0) / 10 * 1e3)
            torch.cuda.synchronize()
        host[name] = float(np.median(laps))
    med = {k: float(np.median(v)) for k, v in gr.items()}
    evm = {k: float(np.median(v)) for k, v in ev.items()}
    rec_p, nodes_p = capture_record(path_packed)
    rec_s, nodes_s = capture_record(k_seg)
    floor = ""
    if layout.total < (1 << 22):
        blocks = -(-layout.total // (4 if layout.storage == torch.float32 else 8) // 256)
        f1 = graph_ms(lambda: empty_kernel(1), reps=reps)
        fb = graph_ms(lambda: empty_kernel(blocks), reps=reps)
        out.update(floor_ms=f1, floor_blocks_ms=fb)
        floor = (f"; the empty kernel by graph replay {f1:.4f} ms at 1 block, {fb:.4f} ms "
                 f"at the update's {blocks} blocks")
    print(f"time B2 {what} {rule} {str(layout.storage)[6:]}: kernel on segments {evm['segments']:.4f} "
          f"ms by events ({100 * bound / evm['segments']:.1f}% of bound), {med['segments']:.4f} "
          f"ms by graph replay ({100 * bound / med['segments']:.1f}%); on the packed arena "
          f"{evm['packed']:.4f} / {med['packed']:.4f} ms; the wrapper's host time a call "
          f"{host['segments']:.4f} ms on segments"
          f"{'' if none_at is None else ' (%.4f with a blob without one)' % host['none']}, "
          f"{host['packed']:.4f} ms packed; the update path by graph replay: pack + B2 {med['path']:.4f} ms, segments {med['segments']:.4f} ms "
          f"({med['path'] / med['segments']:.2f}x); plain {t_plain:.4f} ms; bound "
          f"{bound:.4f} ms ({nbytes / 1e9:.4f} GB, bytes){floor} [{card}]")
    print(f"  capture record {what}: pack + B2 recorded {rec_p}, graph nodes {nodes_p}; "
          f"segments recorded {rec_s}, graph nodes {nodes_s}")
    check(rec_s == {"FUSED_UPDATE_LAUNCHES": 1} and rec_p == {"FUSED_UPDATE_LAUNCHES": 1},
          f"B2 {what}: one launch a path, recorded {rec_s} / {rec_p}")
    check(nodes_s == {"KERNEL": 1, "MEMSET": 0, "MEMCPY": 0} and nodes_p["KERNEL"] >= 2,
          f"B2 {what}: the segment path's graph holds {nodes_s}, want one kernel; the "
          f"packed path's {nodes_p}")
    out.update(ms=evm["segments"], ms_graph=med["segments"], packed_ms=evm["packed"],
               packed_graph_ms=med["packed"], path_packed_ms=med["path"],
               plain_ms=t_plain, bound_ms=bound, host_ms=host["segments"],
               packed_host_ms=host["packed"])
    del ws, ss, wp, sp, packed, seg, seg_all, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_turns(card: str, what: str, solver, data_fn, steps: int,
               profile: bool = False) -> dict:
    """``solver``'s fused step on the packed grad arena against its step on
    segments, in STEP_TURNS pairs of turns, alternating which runs first
    (``steps`` steps a turn, host clock around synchronised steps): the
    median ms a step of each and the pairs the segments won; B2 once a
    step on both, ``unpack``'s backward once a step on the packed path and
    never on segments, no gradient copied.  ``profile``: one step of each
    under torch.profiler too, its device ms and its memcpy and fill
    records."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.solvers import arena as arena_mod
    from sparknet_tpu_torch.solvers.solver import build_fused_step

    steps_of = {"segments": solver._fused_step,
                "packed": build_fused_step(solver.config, solver.train_net, solver.layout,
                                           solver._tables, reduce_grads=lambda g: g)}
    ms = {"packed": [], "segments": []}
    saved = _arena_state(solver)  # the caller's solver goes on from here
    try:
        for pair in range(STEP_TURNS):
            for kind in (("packed", "segments") if pair % 2 == 0 else ("segments", "packed")):
                solver._fused_step = steps_of[kind]
                torch.cuda.synchronize()
                u0, b0 = arena_mod.UNPACK_BACKWARDS, kernels.FUSED_UPDATE_LAUNCHES
                c0 = kernels.FUSED_GRAD_COPIES
                t0 = time.perf_counter()
                solver.step(steps, data_fn)
                torch.cuda.synchronize()
                ms[kind].append(1e3 * (time.perf_counter() - t0) / steps)
                packs = arena_mod.UNPACK_BACKWARDS - u0
                b2 = kernels.FUSED_UPDATE_LAUNCHES - b0
                check(b2 == steps and packs == (steps if kind == "packed" else 0)
                      and kernels.FUSED_GRAD_COPIES == c0,
                      f"{what} {kind} steps: B2 {b2}, packs {packs}, copies "
                      f"{kernels.FUSED_GRAD_COPIES - c0} in {steps} steps")
        prof = ""
        if profile:
            for kind in ("packed", "segments"):
                solver._fused_step = steps_of[kind]
                dev_ms, rows = device_breakdown(lambda: solver.step(1, data_fn), top=1000)
                copies = sum(n for _, name, n in rows if name.startswith("Memcpy DtoD"))
                fills = sum(n for _, name, n in rows if "FillFunctor" in name)
                prof += (f"; one {kind} step under torch.profiler {dev_ms:.3f} ms of device "
                         f"time, {copies} DtoD memcpys, {fills} fill kernels")
    finally:
        solver._fused_step = steps_of["segments"]
        _arena_restore(solver, saved)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    wins = sum(s < p for s, p in zip(ms["segments"], ms["packed"]))
    print(f"step turns {what}: packed {med['packed']:.3f} ms/step, segments "
          f"{med['segments']:.3f} ms/step (medians of {STEP_TURNS} turns of {steps} steps, "
          f"{med['packed'] - med['segments']:+.3f} ms; segments faster in {wins} of "
          f"{STEP_TURNS} pairs; turns packed {[round(x, 3) for x in ms['packed']]}, segments "
          f"{[round(x, 3) for x in ms['segments']]}); B2 1 a step on both, unpack's backward "
          f"1 a step packed and 0 on segments, 0 gradient copies{prof} [{card}]")
    return med


def phase_fused_update(card: str, layout) -> dict:
    """The fused update kernel vs fused_update_torch on the AlexNet arena
    geometry, every case on the packed grad arena; then, fed by gradient
    segments, against its packed path (bit for bit) and the plain version
    at SGD f32, Adam f32, SGD bf16 and a mixed arena (every other blob
    bf16 in the float32 arena), with the update path timed."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.solvers.arena import ArenaTables
    from sparknet_tpu_torch.solvers.updates import adam_correction

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tables = ArenaTables(layout, dev)
    real = arena_mask(layout)
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

    times = {}
    for rule, storage in (("SGD", "f32"), ("Adam", "f32"), ("SGD", "bf16")):
        lay = dataclasses.replace(layout, storage_dtype=storage)
        st = kernels.UpdateStatics(momentum=0.9, reg="l2")
        times[(rule, storage)] = b2_gate(card, "AlexNet", lay, rule, st, scalars(rule, False),
                                         none_blob=False)
    mixed = dataclasses.replace(layout, entries=tuple(
        dataclasses.replace(e, dtype="bfloat16") if k % 2 else e
        for k, e in enumerate(layout.entries)))
    check(mixed.mixed, "the mixed arena is not mixed")
    b2_gate(card, "AlexNet geometry, mixed bf16 in f32", mixed, "SGD",
            kernels.UpdateStatics(momentum=0.9, reg="l2"), scalars("SGD", False),
            timed=False)
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
    t = times[("SGD", "f32")]
    return dict(max_abs_err=max(max_abs, *(v["max_abs_err"] for v in times.values())),
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
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
            out["turns"] = step_turns(card, "AlexNet b256 f32", solver, lambda it: feeds,
                                      TURN_STEPS, profile=True)
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
    from sparknet_tpu_torch.solvers.arena import update_statics

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
        solver = net.solver
        b2_gate(card, "char LM", solver.layout, "Adam", update_statics(solver.config),
                torch.tensor([2e-3, 1.0, 0.9], device="cuda"))
        step_turns(card, f"char LM b{batch} x {seq}", solver,
                   lambda it: batches[it % len(batches)], 4 * TURN_STEPS)
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


def b2_against_plain(card: str, what: str, layout, cfg, it: int) -> dict:
    """B2 on ``layout``'s arena (``b2_gate``): fed by segments, bit for bit
    its packed path and its plain version; ``cfg``'s SGD constants, each
    blob's lr and decay multipliers and the rate of iteration ``it``; then
    timed beside the bound, the update path against pack + B2."""
    from sparknet_tpu_torch.solvers.arena import update_statics
    from sparknet_tpu_torch.solvers.lr_policy import learning_rate

    check(cfg.solver_type == "SGD", f"{what}: B2 check takes SGD, not {cfg.solver_type}")
    one = torch.ones((), device="cuda")
    sc = torch.stack([learning_rate(cfg, it).to("cuda", torch.float32), one, one])
    return b2_gate(card, what, layout, "SGD", update_statics(cfg), sc)


def zoo_fused_vs_blob(card: str) -> None:
    """One step, fused against per-blob, from the same weights and batch
    (dropout 0, deterministic cuDNN), for ResNet-50 and VGG-16; then B2
    against its plain version on their arenas, timed beside its bound."""
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
                    layout, cfg = s.layout, s.config
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
        b2_against_plain(card, f"zoo {name}", layout, cfg, 0)


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
    for name in ("googlenet", "resnet50"):  # 128 and 161 gradient segments
        batch, crop = ZOO_SIZES[name]
        feeds = zoo_batch(batch, crop)
        step_turns(card, f"zoo {name} b{batch}", train[name], lambda it, f=feeds: f, 2)
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


# ---------------------------------------------------------------------------
# Caffe's weight and record files, the DB apps and the CLI
# ---------------------------------------------------------------------------

DB_WORKERS = 2  # tar shards, one a worker, and worker DBs
DB_SHARD_JPEGS = 600  # seeded 320x320 JPEGs a shard: 2 batches of 256 a worker
DB_CLASSES = 10
DB_BATCH = 256
DB_RESIZE = 256
DB_CROP = 227
DB_STEPS = 12  # ImageNetRunDBApp steps from worker 0's DB, the first held alone
DB_FIXED = 4  # fixed-batch steps of the same solver, timed beside them
DB_FEATURIZE = 2  # TEST batches of worker 1's DB through FeaturizerApp
# a synthetic CIFAR file's records: cifar_app's 1,000 halved, since LevelDB's
# pure-Python CRC32C reads about 6 MB/s on the card's host
DB_CIFAR_RECORDS = 500
DB_CIFAR_ITERS = 20
DB_CIFAR_TEST = 5
DB_CLI_BATCHES = 2  # batches the CLI's test and extract_features read
DB_CLI_TRAIN = 4
DB_FEATURE_TOL = 1e-4  # fc7 against the plain-LRN forward (the path phase's gate)


def take_counts() -> tuple[int, int, int]:
    """(LRN forward, LRN backward, fused update) launches since the last
    call; sets the counts to 0."""
    from sparknet_tpu_torch.ops import kernels

    c = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES, kernels.FUSED_UPDATE_LAUNCHES)
    kernels.reset_launch_counts()
    return c


def db_jpeg_shards(d: str):
    """DB_WORKERS plain tar shards of DB_SHARD_JPEGS seeded 320x320 JPEGs
    (128 + noise x40 + a +-80 pattern a class, clipped: the zoo phase's
    batch in pixels) and their label file; returns (label file, each
    shard's [(jpeg bytes, label)] in tar order)."""
    import io
    import os
    import tarfile
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    pattern = 80 * np.sign(np.random.default_rng(SEED + 17).standard_normal(
        (DB_CLASSES, 320, 320, 3), dtype=np.float32))

    def jpeg(s: int, i: int, label: int) -> bytes:
        """Image i of shard s, drawn from its own seed, as a JPEG."""
        noise = np.random.default_rng([SEED + 17, s, i]).standard_normal(
            (320, 320, 3), dtype=np.float32)
        buf = io.BytesIO()
        Image.fromarray(np.clip(128 + 40 * noise + pattern[label], 0, 255).astype(np.uint8)
                        ).save(buf, format="JPEG")
        return buf.getvalue()

    shards, lines = [], []
    for s in range(DB_WORKERS):
        samples = []
        labels = [(s * DB_SHARD_JPEGS + i) % DB_CLASSES for i in range(DB_SHARD_JPEGS)]
        with ThreadPoolExecutor(8) as pool:  # numpy's and PIL's loops leave the GIL
            jpegs = list(pool.map(jpeg, [s] * len(labels), range(len(labels)), labels))
        with tarfile.open(os.path.join(d, f"shard{s}.tar"), "w") as tf:
            for i, (data, label) in enumerate(zip(jpegs, labels)):
                info = tarfile.TarInfo(f"s{s}_{i:04d}.JPEG")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                samples.append((data, label))
                lines.append(f"{info.name} {label}\n")
        shards.append(samples)
    label_file = os.path.join(d, "train.txt")
    with open(label_file, "w") as f:
        f.writelines(lines)
    return label_file, shards


def db_decoded(data: bytes) -> np.ndarray:
    """A JPEG decoded to RGB and resized to DB_RESIZE square with PIL, as
    uint8 CHW: what a worker DB must hold."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB").resize((DB_RESIZE, DB_RESIZE))
    return np.asarray(img, np.uint8).transpose(2, 0, 1)


def same_vars(a, b) -> bool:
    """Every param and state tensor of two NetVars bit for bit equal."""
    return (a.params.keys() == b.params.keys() and a.state.keys() == b.state.keys()
            and all(torch.equal(x, y) for ln in a.params
                    for x, y in zip(a.params[ln], b.params[ln]))
            and all(torch.equal(a.state[ln][k], b.state[ln][k])
                    for ln in a.state for k in a.state[ln]))


def db_caffemodel_round_trips(card: str, d: str):
    """``TPUNet.save_caffemodel`` then ``load_caffemodel`` into a fresh
    TPUNet of another seed, bit for bit: CaffeNet at full width (seed 0),
    GoogLeNet at published width (layer names with ``/``), ResNet-50 with
    BatchNorm state moved by two steps at crop 64, batch 4.  Returns the
    CaffeNet file and its weights."""
    import os

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.net import TPUNet

    def handle(name, net_param, seed):
        cfg = getattr(models, f"{name}_solver")()
        if name == "resnet50":
            cfg = dataclasses.replace(cfg, base_lr=ZOO_FALL_LR[name])
        return TPUNet(dataclasses.replace(cfg, random_seed=seed), net_param)

    kept = None
    for name, net_param, steps in (
            ("caffenet", models.caffenet(DB_BATCH), 0),
            ("googlenet", models.googlenet(batch=1), 0),
            ("resnet50", models.resnet50(batch=4, crop=64), 2)):
        net = handle(name, net_param, SEED)
        if steps:
            feeds = zoo_batch(4, 64)
            net.solver.step(steps, lambda it: feeds)
            state = net.solver.variables.state
            check(state and all(bool(torch.isfinite(v).all()) and bool(v.abs().sum() > 0)
                                for s in state.values() for v in s.values()),
                  f"{name}: BatchNorm state after {steps} steps is zero or not finite")
        path = os.path.join(d, f"{name}.caffemodel")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.save_caffemodel(path)
        save_s = time.perf_counter() - t0
        fresh = handle(name, net_param, SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = fresh.load_caffemodel(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want, got = net.solver.variables, fresh.solver.variables
        check(set(loaded) == set(want.params) | set(want.state),
              f"{name}: loaded {len(loaded)} layers")
        check(same_vars(want, got), f"{name}: the .caffemodel round trip is not bit for bit")
        if name == "googlenet":
            check(any("/" in ln for ln in loaded), "googlenet: no layer name with '/'")
        n_blobs = sum(len(p) for p in want.params.values()) + sum(
            len(s) for s in want.state.values())
        print(f"db_apps: .caffemodel round trip {name}: {len(loaded)} layers, {n_blobs} blobs, "
              f"{os.path.getsize(path)} bytes; save {save_s:.3f} s, load {load_s:.3f} s; "
              f"bit for bit [{card}]")
        if name == "caffenet":
            kept = (path, clone_vars(want))
        del net, fresh
        gc.collect()
    torch.cuda.empty_cache()
    return kept


def clone_vars(v):
    from sparknet_tpu_torch.compiler.graph import NetVars

    return NetVars(params={ln: [p.clone() for p in pl] for ln, pl in v.params.items()},
                   state={ln: {k: t.clone() for k, t in s.items()} for ln, s in v.state.items()})


def db_create(card: str, d: str):
    """ImageNetCreateDBApp over the tar shards: DB_WORKERS record DBs of
    decoded, resized images; their records, mean and info.json gated."""
    import json
    import os

    from sparknet_tpu_torch.apps import ImageNetCreateDBApp
    from sparknet_tpu_torch.data.createdb import db_minibatches

    shard_dir = os.path.join(d, "shards")
    os.makedirs(shard_dir)
    t0 = time.perf_counter()
    label_file, shards = db_jpeg_shards(shard_dir)
    jpeg_s = time.perf_counter() - t0
    out = os.path.join(d, "imagenet_db")
    t0 = time.perf_counter()
    info = ImageNetCreateDBApp(shard_dir, label_file, out, num_workers=DB_WORKERS,
                               resize=DB_RESIZE, batch=DB_BATCH, backend="record").run()
    create_s = time.perf_counter() - t0
    per_worker = (DB_SHARD_JPEGS // DB_BATCH) * DB_BATCH
    acc = np.zeros((3, DB_RESIZE, DB_RESIZE), np.float64)
    from concurrent.futures import ThreadPoolExecutor

    for w, samples in enumerate(shards):
        with ThreadPoolExecutor(8) as pool:  # PIL decodes without the GIL
            want = np.stack(list(pool.map(db_decoded, [x for x, _ in samples[:per_worker]])))
        acc += want.astype(np.float64).sum(axis=0)
        rec = info["workers"][w]
        check(rec["records"] == per_worker and rec["batches"] == per_worker // DB_BATCH,
              f"worker {w} DB: {rec}")
        got = next(db_minibatches(rec["db"], per_worker, dtype=np.uint8))
        check(np.array_equal(got["data"], want), f"worker {w} DB: records are not the "
              "decoded, resized images bit for bit")
        check(np.array_equal(got["label"], [lab for _, lab in samples[:per_worker]]),
              f"worker {w} DB: labels")
    mean = np.load(info["mean"])
    check(np.array_equal(mean, (acc / (DB_WORKERS * per_worker)).astype(np.float32)),
          "the DB mean is not the float64 accumulation of the records")
    with open(os.path.join(out, "info.json")) as f:
        written = json.load(f)
    check(written == {"workers": [
        {"db": os.path.join(out, f"imagenet_w{w}.sndb"), "records": per_worker,
         "batches": per_worker // DB_BATCH} for w in range(DB_WORKERS)],
        "mean": os.path.join(out, "mean.npy")}, f"info.json {written}")
    print(f"db_apps: ImageNetCreateDBApp: {DB_WORKERS} tar shards of {DB_SHARD_JPEGS} "
          f"320x320 JPEGs ({jpeg_s:.1f} s to write) -> {DB_WORKERS} record DBs of "
          f"{per_worker} 3x{DB_RESIZE}x{DB_RESIZE} records in {create_s:.1f} s; records, "
          "mean and info.json exact")
    return out, info


def db_run(card: str, d: str, db_dir: str, weights: str, saved) -> dict:
    """ImageNetRunDBApp (CaffeNet b256, crop 227, fused update) resumed
    from ``weights`` trains DB_STEPS steps from worker 0's DB; the first
    held bit for bit against a Solver step on the captured batch."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps import ImageNetRunDBApp
    from sparknet_tpu_torch.apps import db_apps as db_mod
    from sparknet_tpu_torch.solvers.solver import Solver

    walls = {"db": 0.0, "transform": 0.0}
    reader = db_mod.db_minibatches

    def timed_reader(*args, **kwargs):  # the cursor's wall, batch by batch
        it = reader(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            walls["db"] += time.perf_counter() - t0
            if b is None:
                return
            yield b

    db_mod.db_minibatches = timed_reader
    try:
        app = ImageNetRunDBApp(db_dir, worker=0, batch=DB_BATCH, crop=DB_CROP,
                               model="caffenet", weights=weights, log_dir=d)
        solver = app.net.solver
        check(solver.layout is not None, "ImageNetRunDBApp: fused_update did not take")
        check(same_vars(solver.variables, saved),
              "ImageNetRunDBApp: the loaded weights are not the saved ones bit for bit")
        transform, step = app.transform, solver.train_iteration
        first = {}

        def timed_transform(x, train):
            t0 = time.perf_counter()
            y = transform(x, train)
            walls["transform"] += time.perf_counter() - t0
            return y

        def capture(feeds):  # the first step's host-transformed batch
            first["feeds"] = {k: np.array(v) for k, v in feeds.items()}
            solver.train_iteration = step
            return step(feeds)

        app.transform = timed_transform
        solver.train_iteration = capture
        ref = Solver(models.caffenet_solver(), models.caffenet(DB_BATCH, crop=DB_CROP))
        ref.variables = saved
        take_counts()
        first_loss = app.run(1)
        first_counts = take_counts()
        ref_loss = float(ref.train_iteration(first["feeds"]))
        take_counts()  # the oracle's launches are not the path's
        check(first_loss == ref_loss and torch.equal(solver._param_arena, ref._param_arena)
              and all(torch.equal(a, b) for a, b in zip(solver._slot_arenas, ref._slot_arenas)),
              f"ImageNetRunDBApp's first step (loss {first_loss}) is not a Solver step's "
              f"(loss {ref_loss}) bit for bit")
        del ref
        gc.collect()
        walls.update(db=0.0, transform=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = app.run(DB_STEPS - 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = tuple(a + b for a, b in zip(first_counts, take_counts()))
        n = DB_STEPS - 1
        check(np.isfinite(loss), f"ImageNetRunDBApp loss {loss}")
        check(counts == (2 * DB_STEPS, 2 * DB_STEPS, DB_STEPS),
              f"ImageNetRunDBApp launches (lrn fwd, lrn bwd, fused) {counts}, want "
              f"{(2 * DB_STEPS, 2 * DB_STEPS, DB_STEPS)}")
        feeds = solver._feeds_on_device(first["feeds"])
        solver.step(1, lambda it: feeds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        solver.step(DB_FIXED, lambda it: feeds)
        torch.cuda.synchronize()
        fixed_ms = 1e3 * (time.perf_counter() - t1) / DB_FIXED
        extra = take_counts()
        ms = 1e3 * dt / n
        host = walls["db"] + walls["transform"]
        print(f"db_apps: ImageNetRunDBApp, CaffeNet b{DB_BATCH} {DB_CROP}x{DB_CROP}, fused "
              f"update, f32, TF32 off, resumed from {weights.rsplit('/', 1)[-1]}: first step "
              f"bit for bit a Solver step (loss {first_loss:.6f}); {n} DB-fed steps "
              f"{ms:.2f} ms/step, {DB_BATCH / ms * 1e3:.1f} img/s, loss {loss:.6f}; host "
              f"share {host / dt:.3f} (db_minibatches {1e3 * walls['db'] / n:.2f} ms/step, "
              f"DataTransformer {1e3 * walls['transform'] / n:.2f} ms/step); the same "
              f"solver on a fixed batch {fixed_ms:.2f} ms/step, "
              f"{DB_BATCH / fixed_ms * 1e3:.1f} img/s; launches (lrn fwd, lrn bwd, fused) "
              f"{counts} [{card}]")
        return dict(app=app, counts=tuple(a + b for a, b in zip(counts, extra)),
                    ms=ms, fixed_ms=fixed_ms)
    finally:
        db_mod.db_minibatches = reader


def db_worker_batches(db: str, mean: np.ndarray, n: int) -> list:
    """The first ``n`` TEST-transformed batches of a worker DB (center
    crop, mean subtracted)."""
    from sparknet_tpu_torch.data import DataTransformer, TransformConfig
    from sparknet_tpu_torch.data.createdb import db_minibatches

    xf = DataTransformer(TransformConfig(crop_size=DB_CROP, mean_image=mean))
    stream = db_minibatches(db, DB_BATCH, dtype=np.uint8)
    return [{"data": xf(b["data"], False), "label": b["label"]}
            for b, _ in zip(stream, range(n))]


def db_featurize(card: str, d: str, app, info) -> tuple:
    """The trained weights through ``save_weights_to_file`` into a
    TEST-phase CaffeNet b256 TPUNet; ``fc7`` of worker 1's batches by
    FeaturizerApp against the plain-LRN forward."""
    import os

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps import FeaturizerApp
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.data.transform import load_mean_file
    from sparknet_tpu_torch.net import TPUNet

    trained = os.path.join(d, "trained.caffemodel")
    app.net.save_weights_to_file(trained)
    set_config(fused_update=False)
    net = TPUNet(models.caffenet_solver(), models.caffenet(DB_BATCH))
    set_config(fused_update=True, storage_dtype="f32")
    net.load_weights_from_file(trained)
    check(same_vars(net.solver.variables, app.net.solver.variables),
          "the trained .caffemodel did not load bit for bit")
    batches = db_worker_batches(info["workers"][1]["db"], load_mean_file(info["mean"]),
                                DB_FEATURIZE)
    take_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = list(FeaturizerApp(net, "fc7").featurize(batches))
    dt = time.perf_counter() - t0
    counts = take_counts()
    check(counts[0] == 2 * DB_FEATURIZE, f"FeaturizerApp: {counts[0]} LRN launches, want "
          f"{2 * DB_FEATURIZE}")
    worst = 0.0
    with torch.no_grad():
        for f, feeds in zip(feats, batches):
            check(f.shape == (DB_BATCH, 4096) and np.isfinite(f).all(), f"fc7 {f.shape}")
            ref = forward_with_plain_lrn(net.test_net, net.solver.variables, feeds)[0]["fc7"]
            worst = max(worst, float(np.abs(f - ref.cpu().numpy()).max()))
    check(worst <= DB_FEATURE_TOL, f"FeaturizerApp fc7 off the plain-LRN forward by {worst}")
    print(f"db_apps: FeaturizerApp fc7, CaffeNet b{DB_BATCH} TEST, trained weights through "
          f"{os.path.basename(trained)}: {DB_FEATURIZE} batches of worker 1's DB, "
          f"{1e3 * dt / DB_FEATURIZE:.2f} ms a batch (forward + copy to the host), max |fc7 "
          f"- plain-LRN fc7| {worst:.3e} (gate {DB_FEATURE_TOL}); {counts[0]} LRN launches "
          f"[{card}]")
    del net
    gc.collect()
    return trained, np.concatenate(feats), counts


def db_cifar(card: str, d: str):
    """CifarDBApp on LevelDB over synthetic CIFAR binaries: cifar10_full
    b100, DB_CIFAR_ITERS iterations, DB_CIFAR_TEST test batches."""
    import os

    from sparknet_tpu_torch.apps import CifarDBApp
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.data.cifar import write_synthetic_cifar
    from sparknet_tpu_torch.data.createdb import db_minibatches

    cifar_dir = os.path.join(d, "cifar")
    write_synthetic_cifar(cifar_dir, seed=SEED, records=DB_CIFAR_RECORDS)
    t0 = time.perf_counter()
    app = CifarDBApp(cifar_dir, os.path.join(d, "cifar_db"), batch=CIFAR_BATCH, log_dir=d,
                     backend="leveldb")
    write_s = time.perf_counter() - t0
    loader = CifarLoader(cifar_dir)
    t0 = time.perf_counter()
    for db, imgs, labels in ((app.train_db, loader.train_images, loader.train_labels),
                             (app.test_db, loader.test_images, loader.test_labels)):
        got = next(db_minibatches(db, len(labels), dtype=np.uint8))
        check(np.array_equal(got["data"], imgs) and np.array_equal(got["label"], labels),
              f"{db}: LevelDB records are not the loader's images bit for bit")
    read_s = time.perf_counter() - t0
    scores, test = [], app.net.test
    app.net.test = lambda: scores.append(test()) or scores[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app.run(num_iters=DB_CIFAR_ITERS, test_batches=DB_CIFAR_TEST)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check(len(scores) == 2 and all(np.isfinite(s["loss"]) for s in scores),
          f"CifarDBApp scores {scores}")
    print(f"db_apps: CifarDBApp, cifar10_full b{CIFAR_BATCH}, LevelDB ({len(loader.train_labels)}"
          f" + {len(loader.test_labels)} records, written in {write_s:.1f} s, read back bit for "
          f"bit in {read_s:.1f} s): {DB_CIFAR_ITERS} iterations and {DB_CIFAR_TEST} test "
          f"batches before and after in {run_s:.1f} s; accuracy {scores[0]['accuracy']:.4f} "
          f"-> {scores[1]['accuracy']:.4f}, loss {scores[0]['loss']:.4f} -> "
          f"{scores[1]['loss']:.4f} [{card}]")
    return app, loader


def db_solver_file(d: str, source: str, mean_file: str) -> str:
    """A solver prototxt of the CaffeNet recipe whose net reads a ``Data``
    layer (crop 227, mirror, the mean file) instead of the RDD inputs."""
    import os

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.proto import serialize

    layers = [lp for lp in models.caffenet(DB_BATCH).get_all("layer")
              if lp.get_str("type") != "JavaData"]
    net = (f'name: "CaffeNetDB"\nlayer {{ name: "data" type: "Data" top: "data" top: "label"\n'
           f'  data_param {{ source: "{source}" batch_size: {DB_BATCH} }}\n'
           f'  transform_param {{ crop_size: {DB_CROP} mirror: true mean_file: "{mean_file}" }} }}\n'
           + "\n".join("layer {\n" + serialize(lp, 1) + "\n}" for lp in layers) + "\n")
    net_path, solver_path = os.path.join(d, "caffenet_db.prototxt"), os.path.join(d, "solver.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    with open(solver_path, "w") as f:
        f.write(f'net: "{net_path}"\nbase_lr: 0.01\nlr_policy: "step"\ngamma: 0.1\n'
                'stepsize: 100000\nmomentum: 0.9\nweight_decay: 0.0005\nmax_iter: 450000\n')
    return solver_path


def db_cli(card: str, d: str, cifar_app, loader, info, weights: str, trained: str,
           feats: np.ndarray) -> tuple:
    """The CLI in process: convert_db, compute_image_mean, test, extract_features,
    time (per layer and --fused), train and device_query."""
    import io
    import os

    from sparknet_tpu_torch import cli, models
    from sparknet_tpu_torch.data.createdb import db_mean, db_minibatches
    from sparknet_tpu_torch.data.io_utils import load_mean_binaryproto
    from sparknet_tpu_torch.net import copy_caffemodel_params
    from sparknet_tpu_torch.compiler.graph import NetVars
    from sparknet_tpu_torch.data.transform import load_mean_file
    from sparknet_tpu_torch.solvers.solver import Solver

    def run(*argv) -> str:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        check(rc == 0, f"cli {argv[0]} exited {rc}")
        walls.append((argv[0] + (" --fused" if "--fused" in argv else ""),
                      time.perf_counter() - t0))
        return buf.getvalue()

    walls = []
    os.environ["SPARKNET_TRAIN_LOG_DIR"] = d  # the train command's event log
    rec, lmdb = os.path.join(d, "cifar_train.sndb"), os.path.join(d, "cifar_train_lmdb")
    n = len(loader.train_labels)
    run("convert_db", "--src", cifar_app.train_db, "--dst", rec)
    run("convert_db", "--src", rec, "--dst", lmdb, "--backend", "lmdb")
    for p in (rec, lmdb):
        got = next(db_minibatches(p, n, dtype=np.uint8))
        check(np.array_equal(got["data"], loader.train_images)
              and np.array_equal(got["label"], loader.train_labels),
              f"convert_db {p}: records are not the LevelDB's bit for bit")
    mean_path = os.path.join(d, "cifar_mean.binaryproto")
    run("compute_image_mean", "--db", cifar_app.train_db, "--out", mean_path)
    mean = load_mean_binaryproto(mean_path)
    check(np.array_equal(mean, db_mean(rec)), "compute_image_mean: .binaryproto read back")
    check(np.allclose(mean, cifar_app.mean_image, rtol=1e-6, atol=0),
          "compute_image_mean against CifarDBApp's mean (rtol 1e-6): "
          f"{np.abs(mean - cifar_app.mean_image).max()}")

    w0, w1 = (info["workers"][w]["db"] for w in (0, 1))
    solver_file = db_solver_file(d, w1, info["mean"])
    scores = json.loads(run("test", "--solver", solver_file, "--data", f"db:{w1}",
                            "--weights", weights, "--iterations", str(DB_CLI_BATCHES)))
    tested = take_counts()  # the CLI's test alone
    check(tested == (2 * DB_CLI_BATCHES, 0, 0),
          f"cli test launches (lrn fwd, lrn bwd, fused) {tested}")
    ref = Solver(models.caffenet_solver(), models.caffenet(DB_BATCH))
    v = ref.variables
    params, state, _ = copy_caffemodel_params(v.params, weights, state=v.state)
    ref.variables = NetVars(params=params, state=state)
    batches = db_worker_batches(w1, load_mean_file(info["mean"]), DB_CLI_BATCHES)
    want = ref.test(DB_CLI_BATCHES, lambda b: batches[b])
    check(scores == want, f"cli test scores {scores} against Solver.test's {want}")
    del ref, params, state, v
    gc.collect()
    take_counts()  # the reference's launches are not the CLI's path
    out = os.path.join(d, "fc7.npy")
    run("extract_features", "--solver", solver_file, "--data", f"db:{w1}", "--weights",
        trained, "--blob", "fc7", "--out", out, "--iterations", str(DB_CLI_BATCHES))
    check(np.array_equal(np.load(out), feats), "cli extract_features fc7 is not "
          "FeaturizerApp's bit for bit")
    table = run("time", "--solver", "zoo:caffenet", "--batch", str(DB_BATCH),
                "--iterations", "1")
    rows = [line.split() for line in table.splitlines()[1:-2]]
    check(len(rows) > 20 and all(r[3] != "-ms" for r in rows),
          f"cli time: a CaffeNet layer without a backward:\n{table}")
    fused = json.loads(run("time", "--solver", "zoo:caffenet", "--batch", str(DB_BATCH),
                           "--iterations", "3", "--fused"))
    from sparknet_tpu_torch.solvers import solver as solver_mod

    losses, step = [], solver_mod.Solver.step

    def spy(self, *args, **kwargs):
        losses.append(step(self, *args, **kwargs))
        return losses[-1]

    timed = take_counts()  # extract_features and time
    solver_mod.Solver.step = spy
    try:
        run("train", "--solver", solver_file, "--data", f"db:{w0}", "--weights", weights,
            "--iterations", str(DB_CLI_TRAIN), "--output", os.path.join(d, "cli_final"))
    finally:
        solver_mod.Solver.step = step
    counts = take_counts()
    check(len(losses) == 1 and np.isfinite(losses[0]), f"cli train losses {losses}")
    check(counts == (2 * DB_CLI_TRAIN, 2 * DB_CLI_TRAIN, DB_CLI_TRAIN),
          f"cli train launches (lrn fwd, lrn bwd, fused) {counts}")
    query = json.loads(run("device_query", "--timeout", "0").splitlines()[0])
    check(query["device_kind"] == torch.cuda.get_device_name(0), f"device_query {query}")
    del os.environ["SPARKNET_TRAIN_LOG_DIR"]
    print("db_apps: cli time, CaffeNet b256 (synthetic feeds), each layer alone:")
    print(table.rstrip())
    print(f"db_apps: cli: convert_db LevelDB -> record -> lmdb ({n} records bit for bit), "
          f"compute_image_mean .binaryproto (read back equal, within rtol 1e-6 of the app's), "
          f"test scores {scores} equal Solver.test's, extract_features fc7 bit for bit "
          f"FeaturizerApp's, time --fused {fused}, train {DB_CLI_TRAIN} iterations from "
          f"worker 0's DB (smoothed loss {losses[0]:.6f}, launches {counts}), device_query "
          f"{query['device_kind']}; seconds: "
          + ", ".join(f"{k} {s:.1f}" for k, s in walls) + f" [{card}]")
    return fused, tuple(a + b + c for a, b, c in zip(tested, timed, counts))


def phase_db_apps(card: str) -> dict:
    """Caffe's weight and record files, the DB apps and the CLI on the card
    (fused update, f32, TF32 off, deterministic cuDNN).  Returns the
    launches of the paths it drives."""
    import tempfile

    from sparknet_tpu_torch.common import set_config

    t_phase = time.perf_counter()
    set_config(fused_update=True, storage_dtype="f32")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    walls = [time.perf_counter()]
    total = [0, 0, 0]

    def add(c):
        for i, x in enumerate(c):
            total[i] += x

    try:
        with tempfile.TemporaryDirectory() as d:
            take_counts()
            weights, saved = db_caffemodel_round_trips(card, d)
            add(take_counts())
            walls.append(time.perf_counter())
            db_dir, info = db_create(card, d)
            walls.append(time.perf_counter())
            run = db_run(card, d, db_dir, weights, saved)
            add(run["counts"])
            del saved
            walls.append(time.perf_counter())
            trained, feats, counts = db_featurize(card, d, run.pop("app"), info)
            add(counts)
            gc.collect()
            torch.cuda.empty_cache()
            walls.append(time.perf_counter())
            take_counts()
            cifar_app, loader = db_cifar(card, d)
            add(take_counts())
            walls.append(time.perf_counter())
            fused, counts = db_cli(card, d, cifar_app, loader, info, weights, trained, feats)
            add(counts)
            add(take_counts())
            walls.append(time.perf_counter())
    finally:
        torch.backends.cudnn.deterministic = prev
        set_config(fused_update=False)
    print(f"db_apps: DB-fed CaffeNet b{DB_BATCH} step {run['ms']:.2f} ms "
          f"({DB_BATCH / run['ms'] * 1e3:.1f} img/s) beside the fixed-batch step "
          f"{run['fixed_ms']:.2f} ms and cli time --fused {fused['fused_step_ms']} ms [{card}]")
    print("db_apps: seconds by part: " + ", ".join(
        f"{part} {b - a:.1f}" for part, a, b in zip(
            (".caffemodel round trips", "ImageNetCreateDBApp", "ImageNetRunDBApp",
             "FeaturizerApp", "CifarDBApp", "cli"), walls, walls[1:])))
    print(f"db_apps: launches (lrn fwd, lrn bwd, fused) {tuple(total)}; phase done in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=total[0], lrn_backward=total[1], fused_update=total[2])


# The layer library's sweep: (label, layer text, input shapes and kinds,
# grads taken through) for each layer type ported with the MNIST families.
# Kinds: "x" randn, "pos" |randn| + 0.1, "relu" max(randn, 0), "prob" a
# softmax over dim 1, "lab5"/"lab2" integer labels < 5 / < 2 as floats,
# "unit" uniform [0, 1), "idx" batch indices with repeats, "sel" a 0/1/2
# selector.
LAYERS_SWEEP = [
    ("PReLU", 'type: "PReLU" prelu_param { filler { type: "uniform" min: -0.5 max: 0.5 } }',
     [((8, 16, 12, 12), "x")]),
    ("Sigmoid", 'type: "Sigmoid"', [((8, 16, 12, 12), "x")]),
    ("TanH", 'type: "TanH"', [((8, 16, 12, 12), "x")]),
    ("AbsVal", 'type: "AbsVal"', [((8, 16, 12, 12), "x")]),
    ("BNLL", 'type: "BNLL"', [((8, 16, 12, 12), "x")]),
    ("Exp", 'type: "Exp" exp_param { base: 2.0 scale: 0.5 shift: 0.1 }',
     [((8, 16, 12, 12), "x")]),
    ("Log", 'type: "Log" log_param { base: 10.0 scale: 2.0 shift: 1.0 }',
     [((8, 16, 12, 12), "pos")]),
    ("Power", 'type: "Power" power_param { power: 2.0 scale: 0.5 shift: 1.0 }',
     [((8, 16, 12, 12), "x")]),
    ("Threshold", 'type: "Threshold" threshold_param { threshold: 0.2 }',
     [((8, 16, 12, 12), "x")]),
    ("ELU", 'type: "ELU" elu_param { alpha: 0.7 }', [((8, 16, 12, 12), "x")]),
    ("EuclideanLoss", 'type: "EuclideanLoss"', [((64, 784), "x"), ((64, 784), "x")]),
    ("HingeLoss", 'type: "HingeLoss" hinge_loss_param { norm: L2 }',
     [((64, 5), "x"), ((64,), "lab5")]),
    ("MultinomialLogisticLoss", 'type: "MultinomialLogisticLoss"',
     [((64, 5), "prob"), ((64,), "lab5")]),
    ("InfogainLoss", 'type: "InfogainLoss"',
     [((64, 5), "prob"), ((64,), "lab5"), ((5, 5), "pos")]),
    ("SigmoidCrossEntropyLoss", 'type: "SigmoidCrossEntropyLoss"',
     [((100, 784), "x"), ((100, 784), "unit")]),
    ("ContrastiveLoss", 'type: "ContrastiveLoss"',
     [((64, 2), "x"), ((64, 2), "x"), ((64,), "lab2")]),
    ("Slice", 'type: "Slice" slice_param { slice_point: 1 }', [((64, 2, 28, 28), "x")], 2),
    ("Reshape", 'type: "Reshape" reshape_param { shape { dim: 0 dim: -1 dim: 4 } }',
     [((8, 16, 12, 12), "x")]),
    ("Tile", 'type: "Tile" tile_param { tiles: 3 }', [((8, 16, 12, 12), "x")]),
    ("ArgMax", 'type: "ArgMax" argmax_param { top_k: 3 out_max_val: true }',
     [((64, 10, 4, 4), "x")]),
    ("BatchReindex", 'type: "BatchReindex"', [((16, 16, 12, 12), "x"), ((64,), "idx")]),
    ("Reduction", 'type: "Reduction" reduction_param { operation: SUMSQ axis: 1 coeff: 0.5 }',
     [((8, 16, 12, 12), "x")]),
    ("MVN", 'type: "MVN" mvn_param { across_channels: true }', [((8, 16, 12, 12), "x")]),
    ("Silence", 'type: "Silence"', [((8, 16), "x")], 0),
    ("Filter", 'type: "Filter"', [((64, 16, 4, 4), "x"), ((64,), "sel")]),
    ("Deconvolution", 'type: "Deconvolution" convolution_param { num_output: 12 kernel_size: 4 '
     'stride: 2 pad: 1 group: 2 weight_filler { type: "gaussian" std: 0.1 } '
     'bias_filler { type: "uniform" min: -1 max: 1 } }', [((8, 16, 12, 12), "x")]),
    ("Im2col", 'type: "Im2col" convolution_param { kernel_size: 3 stride: 2 pad: 1 }',
     [((8, 16, 12, 12), "x")]),
    ("SPP", 'type: "SPP" spp_param { pyramid_height: 3 }', [((8, 16, 12, 12), "x")]),
    ("Pooling STOCHASTIC (TEST)", 'type: "Pooling" pooling_param { pool: STOCHASTIC '
     'kernel_size: 3 stride: 2 }', [((8, 16, 12, 12), "relu")]),
]
LAYERS_GATE = 1e-5  # the card against the CPU, of each array's largest |value|
LAYERS_TRAIN = (("mnist_siamese", 64), ("mnist_autoencoder", 100))
LAYERS_STEPS = 20  # steps a family, the first LAYERS_WARM untimed
LAYERS_WARM = 5
LAYERS_LOSS_RTOL = 1e-4  # each step's loss, the card against the CPU port
FCN_UPSCORE = ((1, 21, 16, 16), 64, 32)  # FCN-32s upscore: input, kernel, stride

PY_LAYERS_SRC = """
import numpy as np


class EuclideanLossLayer:
    def setup(self, bottom, top):
        pass

    def reshape(self, bottom, top):
        self.diff = np.zeros_like(bottom[0].data, dtype=np.float32)
        top[0].reshape(1)

    def forward(self, bottom, top):
        self.diff[...] = bottom[0].data - bottom[1].data
        top[0].data[...] = np.sum(self.diff ** 2) / bottom[0].num / 2.0

    def backward(self, top, propagate_down, bottom):
        for i in range(2):
            bottom[i].diff[...] = (1 if i == 0 else -1) * self.diff / bottom[i].num


class ScaledTanh:
    def apply(self, x):
        import torch

        return torch.tanh(x) * 2.5
"""


def layer_inputs(specs, gen) -> list:
    """The sweep's inputs on the CPU, float32."""
    out = []
    for shape, kind in specs:
        x = torch.randn(shape, generator=gen)
        if kind == "pos":
            x = x.abs() + 0.1
        elif kind == "relu":
            x = x.clamp(min=0)
        elif kind == "prob":
            x = torch.softmax(x, dim=1)
        elif kind in ("lab5", "lab2", "sel"):
            x = torch.randint(0, {"lab5": 5, "lab2": 2, "sel": 3}[kind], shape,
                              generator=gen).float()
        elif kind == "unit":
            x = torch.rand(shape, generator=gen)
        elif kind == "idx":
            x = torch.randint(0, 16, shape, generator=gen).float()
        out.append(x)
    return out


def layer_run(layer, params, xs, specs, device, dtype, cots=None, train=True,
              seed=SEED + 41):
    """A layer's outputs and its VJP (params and float inputs) on
    ``device`` in ``dtype``, as float64 host copies, and the cotangents:
    seeded (float32, on the CPU) unless given."""
    tp = [p.to(device, dtype).requires_grad_(True) for p in params]
    tx = [x.to(device, dtype) for x in xs]
    diff = [i for i, (_, kind) in enumerate(specs) if kind in ("x", "pos", "relu", "prob")]
    for i in diff:
        tx[i].requires_grad_(True)
    outs = layer.apply(tp, {}, tx, train=train).outputs
    if cots is None:
        gen = torch.Generator().manual_seed(seed)
        cots = [torch.randn(tuple(o.shape), generator=gen) for o in outs]
    live = [(o, c.to(device, dtype)) for o, c in zip(outs, cots) if o.requires_grad]
    wrt = tp + [tx[i] for i in diff]
    grads = (torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                 allow_unused=True) if live else [None] * len(wrt))
    grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
    return [t.detach().cpu().double() for t in list(outs) + grads], cots


def rel_err(got: list, ref: list) -> float:
    """The largest |got - ref| of each array over its largest |ref|."""
    err = 0.0
    for a, b in zip(got, ref, strict=True):
        if b.numel():
            err = max(err, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    return err


def reindex_captured(xs, cot) -> bool:
    """BatchReindex's backward (``blocks.reindex_backward``) captured into
    a CUDA graph, which fails on a host read: whether a replay gives the
    eager gradient bit for bit."""
    from sparknet_tpu_torch.ops.blocks import reindex_backward

    index, g, rows = xs[1].cuda().reshape(-1).long(), cot.cuda(), xs[0].shape[0]
    eager = reindex_backward(g, index, rows)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reindex_backward(g, index, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = reindex_backward(g, index, rows)
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager)
    del graph
    return same


def layers_sweep(card: str) -> None:
    """Every newly ported layer type, forward and backward, on the card
    against the same layer on the CPU (float32), beside the CPU's own
    float32 against float64 error; BatchReindex's backward twice on the
    card and from a CUDA graph, bit for bit; STOCHASTIC pooling in TRAIN
    with the same injected uniforms; DummyData's values; the Python layer
    in both styles, and its Caffe-compat style refusing a CUDA graph
    capture."""
    import os
    import tempfile

    from sparknet_tpu_torch.common import Phase, f32_precision
    from sparknet_tpu_torch.ops import create_layer, vision
    from sparknet_tpu_torch.proto import parse

    def make(text, phase=Phase.TRAIN):
        body = f'layer {{ name: "l" {text} }}'
        return create_layer(parse(body).get_all("layer")[0], phase)

    gen = torch.Generator().manual_seed(SEED + 40)
    worst = 0.0
    with f32_precision():
        for label, text, specs, *n_tops in LAYERS_SWEEP:
            tops = " ".join(f'top: "t{i}"' for i in range(n_tops[0] if n_tops else 1))
            bottoms = " ".join(f'bottom: "b{i}"' for i in range(len(specs)))
            layer = make(f"{text} {bottoms} {tops}")
            xs = layer_inputs(specs, gen)
            params, _ = layer.init(gen, [tuple(x.shape) for x in xs])

            def run(dev, dt, cots=None):
                return layer_run(layer, params, xs, specs, dev, dt, cots,
                                 train="(TEST)" not in label)

            cpu, cots = run("cpu", torch.float32)
            card_out, _ = run("cuda", torch.float32, cots)
            f64, _ = run("cpu", torch.float64, cots)
            err, ref_err = rel_err(card_out, cpu), rel_err(cpu, f64)
            worst = max(worst, err)
            extra = ""
            if label == "BatchReindex":
                again, _ = run("cuda", torch.float32, cots)
                same = all(torch.equal(a, b) for a, b in zip(card_out, again))
                captured = reindex_captured(xs, cots[0])
                extra = (f"; backward twice on the card bit for bit: {same}; replayed from "
                         f"a CUDA graph bit for bit the eager one: {captured}")
                check(same and captured, "layers: BatchReindex's backward is not repeatable")
            print(f"layers: {label}: card against CPU {err:.3g}, CPU f32 against f64 "
                  f"{ref_err:.3g} (of max|.|){extra}")
            check(err <= LAYERS_GATE, f"layers: {label} card against CPU {err:.3g}")
        # STOCHASTIC in TRAIN: the same uniforms on both sides
        x = layer_inputs([((8, 16, 12, 12), "relu")], gen)[0]
        u = torch.rand((8, 16, 6, 6), generator=gen)  # a uniform a window
        g = torch.randn((8, 16, 6, 6), generator=gen)
        res = []
        for dev in ("cpu", "cuda"):
            tx = x.to(dev).requires_grad_(True)
            y = vision.caffe_stochastic_pool(tx, (3, 3), (2, 2), train=True, uniforms=u.to(dev))
            (gx,) = torch.autograd.grad(y, tx, g.to(dev))
            res.append([y.detach().cpu().double(), gx.cpu().double()])
        err = rel_err(res[1], res[0])
        print(f"layers: Pooling STOCHASTIC (TRAIN, injected uniforms): card against CPU "
              f"{err:.3g}")
        check(err <= LAYERS_GATE, f"layers: STOCHASTIC TRAIN card against CPU {err:.3g}")
        dummy = make('type: "DummyData" top: "a" top: "b" dummy_data_param { shape { dim: 64 '
                     'dim: 10 } data_filler { type: "gaussian" std: 2 } data_filler { '
                     'type: "constant" value: 0.5 } }')
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(dummy.constant_values("cuda"), dummy.constant_values("cpu")))
        print(f"layers: DummyData values on the card bit for bit the CPU's: {same}")
        check(same, "layers: DummyData values")
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "chip_py_layers.py"), "w") as f:
                f.write(PY_LAYERS_SRC)
            sys.path.insert(0, d)
            try:
                for cls, specs in (("EuclideanLossLayer", [((64, 10), "x"), ((64, 10), "x")]),
                                   ("ScaledTanh", [((64, 10), "x")])):
                    bottoms = " ".join(f'bottom: "b{i}"' for i in range(len(specs)))
                    layer = make(f'type: "Python" {bottoms} top: "y" python_param {{ '
                                 f'module: "chip_py_layers" layer: "{cls}" }}')
                    xs = layer_inputs(specs, gen)
                    cpu, cots = layer_run(layer, [], xs, specs, "cpu", torch.float32)
                    card_out, _ = layer_run(layer, [], xs, specs, "cuda", torch.float32, cots)
                    err = rel_err(card_out, cpu)
                    print(f"layers: Python ({cls}): card against CPU {err:.3g}")
                    check(err <= LAYERS_GATE, f"layers: Python {cls} {err:.3g}")
                xs = [x.cuda() for x in layer_inputs([((64, 10), "x")] * 2, gen)]
                compat = make('type: "Python" bottom: "a" bottom: "b" top: "y" python_param '
                              '{ module: "chip_py_layers" layer: "EuclideanLossLayer" }')
                torch.cuda.synchronize()
                refused = False
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph):
                        compat.apply([], {}, xs, train=True)
                except RuntimeError as e:
                    refused = "cannot be captured" in str(e)
                del graph
                print(f"layers: the Caffe-compat Python layer refuses a CUDA graph capture: "
                      f"{refused}")
                check(refused, "layers: a Python layer was captured")
            finally:
                sys.path.remove(d)
                sys.modules.pop("chip_py_layers", None)
    print(f"layers: {len(LAYERS_SWEEP) + 3} checks, the worst card against CPU {worst:.3g} "
          f"(gate {LAYERS_GATE:g}) [{card}]")


def layers_fcn_upscore(card: str) -> None:
    """FCN-32s's upsampling Deconvolution (21 -> 21 channels, kernel 64,
    stride 32, no bias) from a [1,21,16,16] score map to 544x544: the card
    against the CPU, and its time by CUDA events beside the bound."""
    from sparknet_tpu_torch.common import Phase, f32_precision
    from sparknet_tpu_torch.ops import create_layer
    from sparknet_tpu_torch.proto import parse

    shape, k, stride = FCN_UPSCORE
    c = shape[1]
    layer = create_layer(parse(
        f'layer {{ name: "upscore" type: "Deconvolution" bottom: "score" top: "up" '
        f'convolution_param {{ num_output: {c} kernel_size: {k} stride: {stride} '
        f'bias_term: false weight_filler {{ type: "gaussian" std: 0.01 }} }} }}'
    ).get_all("layer")[0], Phase.TEST)
    gen = torch.Generator().manual_seed(SEED + 42)
    x = torch.randn(shape, generator=gen)
    (w,), _ = layer.init(gen, [shape])
    with f32_precision():
        ref = layer.apply([w], {}, [x], train=False).outputs[0]
        ref64 = layer.apply([w.double()], {}, [x.double()], train=False).outputs[0]
        xd, wd = x.cuda(), w.cuda()
        y = layer.apply([wd], {}, [xd], train=False).outputs[0]
        ms = time_ms(lambda: layer.apply([wd], {}, [xd], train=False))
    out = (shape[2] - 1) * stride + k
    check(tuple(y.shape) == (1, c, out, out), f"upscore shape {tuple(y.shape)}")
    err = rel_err([y.cpu().double()], [ref.double()])
    ref_err = rel_err([ref.double()], [ref64])
    bw, flops, _ = card_peaks(torch.cuda.get_device_name(0))
    byts = 4 * (x.numel() + w.numel() + y.numel())
    ops = 2 * c * c * k * k * shape[2] * shape[3]
    bound = max(byts / bw, ops / flops) * 1e3
    by = "bytes" if byts / bw >= ops / flops else "operations"
    print(f"layers: FCN-32s upscore [1,{c},{shape[2]},{shape[3]}] -> [1,{c},{out},{out}]: "
          f"card against CPU {err:.3g} (CPU f32 against f64 {ref_err:.3g}); {ms:.4f} ms by "
          f"events, bound {bound:.4f} ms ({by}, {100 * bound / ms:.1f} %) [{card}]")
    check(err <= LAYERS_GATE, f"layers: upscore card against CPU {err:.3g}")


def layers_batches(name: str, batch: int, n: int) -> list:
    """``n`` seeded batches on the CPU: siamese pairs of 10 class patterns
    with noise and a ``sim`` label (half the pairs one class); autoencoder
    pixels in [0, 1]."""
    gen = torch.Generator().manual_seed(SEED + 43)
    out = []
    if name == "mnist_siamese":
        patterns = (torch.rand((10, 28, 28), generator=gen) > 0.7).float()
        for _ in range(n):
            a = torch.randint(0, 10, (batch,), generator=gen)
            same = torch.rand((batch,), generator=gen) < 0.5
            b = torch.where(same, a, torch.randint(0, 10, (batch,), generator=gen))
            noise = torch.rand((batch, 2, 28, 28), generator=gen) * 0.3
            out.append({"pair_data": torch.stack([patterns[a], patterns[b]], 1) * 0.7 + noise,
                        "sim": (a == b).float()})
    else:
        for _ in range(n):
            out.append({"data": torch.rand((batch, 1, 28, 28), generator=gen)})
    return out


def layers_train(card: str) -> int:
    """Both MNIST families train ``LAYERS_STEPS`` steps through ``Solver``
    with the fused update on the card, against the CPU port's run of the
    same steps from the same init; then one step under torch.profiler, and
    B2 against its plain version on the family's arena.  Returns B2's
    launches in the ``LAYERS_STEPS`` steps."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.compiler.graph import is_placeholder

    fused_total = 0
    for name, batch in LAYERS_TRAIN:
        batches = layers_batches(name, batch, LAYERS_STEPS)
        net = getattr(models, name)(batch=batch)
        card_solver = zoo_solver(net, name)
        cpu_solver = zoo_solver(net, name, device="cpu")
        take_counts()
        losses, start = [], None
        for it, feeds in enumerate(batches):
            if it == LAYERS_WARM:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            losses.append(card_solver.train_iteration(feeds))
        stop = torch.cuda.Event(enable_timing=True)
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop) / (LAYERS_STEPS - LAYERS_WARM)
        fused = take_counts()[2]
        fused_total += fused
        cpu_losses = [float(cpu_solver.train_iteration(f)) for f in batches]
        losses = [float(x) for x in losses]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
        placeholders = sum(is_placeholder(p) for pl in card_solver.variables.params.values()
                           for p in pl)
        shared = sum(e.span == 0 for e in card_solver.layout.entries)
        print(f"layers: {name} b{batch}: {LAYERS_STEPS} steps, {ms:.3f} ms a step by events "
              f"(steps {LAYERS_WARM}-{LAYERS_STEPS - 1}); loss {losses[0]:.6g} -> "
              f"{losses[-1]:.6g}; card against the CPU port, worst step {rel:.3g} (gate "
              f"{LAYERS_LOSS_RTOL:g}); B2 launches {fused}; arena {card_solver.layout.total} "
              f"elements, {shared} placeholder blobs of 0 tiles [{card}]")
        check(all(math.isfinite(x) for x in losses), f"{name}: a loss is not finite")
        check(rel <= LAYERS_LOSS_RTOL, f"{name}: card against CPU {rel:.3g}")
        check(fused == LAYERS_STEPS, f"{name}: {fused} B2 launches in {LAYERS_STEPS} steps")
        check(placeholders == shared, f"{name}: {placeholders} placeholders against "
              f"{shared} 0-tile entries")
        if name == "mnist_siamese":
            check(shared == 10, f"mnist_siamese: {shared} shared blobs, want 10")
        # one more step under torch.profiler: the device's busy share
        device_ms, rows = device_breakdown(lambda: card_solver.train_iteration(batches[-1]),
                                           top=3)
        check(device_ms > 0.0, f"{name}: torch.profiler recorded no device time")
        print(f"layers: {name} b{batch}: one step under torch.profiler, {device_ms:.3f} ms of "
              f"kernels, {100 * device_ms / ms:.1f}% of the unprofiled {ms:.3f} ms a step "
              f"(device idle {100 * (1 - device_ms / ms):.1f}%); top kernels "
              + "; ".join(f"{k[:40]} {t:.3f} ms x{c}" for t, k, c in rows) + f" [{card}]")
        b2_against_plain(card, name, card_solver.layout, card_solver.config, card_solver.iter)
        take_counts()  # the profiled step's and the check's launches are off the path
        del card_solver, cpu_solver
    return fused_total


def phase_layers(card: str) -> dict:
    """The layer library, weight sharing and the MNIST families on the card
    (f32, TF32 off).  Returns the launches of the paths it drives."""
    t_phase = time.perf_counter()
    layers_sweep(card)
    layers_fcn_upscore(card)
    fused = layers_train(card)
    print(f"layers: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=0, lrn_backward=0, fused_update=fused)


# ---------------------------------------------------------------------------
# Reduced precision: bf16 compute, remat and activation storage, int8 serving
# ---------------------------------------------------------------------------

PREC_TURN = 5  # steps a turn; the bf16 and f32 steps alternate turns
PREC_TURNS = 4  # 20 timed steps of each
PREC_POLICY_STEPS = 3  # timed steps a remat/storage policy, after its held step
PREC_UPDATE_RTOL = 1e-2  # activation_dtype blocks' first update against no policy's (rel. L2)
PREC_LOSS_RTOL = 2e-2  # the bf16 step's first loss against the f32 step's
# the bf16 step's first gradient and update against the f32 step's from the
# same weights, batch and masks (relative L2): about twice the bf16 gap
# measured on the H100 (AlexNet 4.84e-2, the char LM 3.17e-3), a tenth or
# less of what a different step gives there (another dropout draw 1.20, the
# next batch 0.159); PERF.md's findings on reduced precision
PREC_GRAD_RTOL = 0.1
PREC_BF16_UPDATE_RTOL = 0.1
PREC_CHARLM_GRAD_RTOL = 1e-2
PREC_CHARLM_STEPS = 40  # char LM steps of each type, in turns of PREC_TURN
PREC_IMAGES = 8  # seeded images the CaffeNet Classifier scores (10 crops each)
PREC_CALIB_IMAGES = 4  # seeded images it calibrates on (40 crops, 4 batches)
PREC_INT8_FAMILIES = ("cifar10_quick", "lenet", "mobilenet")
PREC_ENGINE_REPS = 10  # CUDA-event samples of a replay's time

# dense int8 tensor-core operations a second (NVIDIA's H100 data sheet gives
# them with sparsity; dense is half), the first name that matches wins
INT8_PEAKS = [("H100 PCIe", 1513e12), ("H100 NVL", 1670.5e12), ("H100", 1979e12)]


@contextlib.contextmanager
def port_config(**kw):
    """The port's Config with ``kw`` for the block, restored after (the
    compute dtype and the policies are read as the forward runs)."""
    from sparknet_tpu_torch import common

    prev = common.get_config()
    common.set_config(**kw)
    try:
        yield
    finally:
        common._config = prev


def precision_lrn(card: str) -> None:
    """B1 and B1' in bf16 at the AlexNet and CaffeNet b256 shapes: against
    their plain versions (one bf16 ulp of the float32 result cast to bf16),
    timed beside the bound, the plain versions and F.local_response_norm
    (its autograd backward for B1') on the same bf16 inputs."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    bw, _, _ = card_peaks(card)
    for label, shape in MAIN_CASES:
        x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 50).to(torch.bfloat16)
        g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        y = kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0).float()
        ref = kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0).float()
        dx = kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0).float()
        dref = kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0).float()
        torch.cuda.synchronize()
        ulp_f = float(((y - ref).abs() / bf16_ulp(ref)).max())
        ulp_b = float(((dx - dref).abs() / bf16_ulp(dref)).max())
        check(ulp_f <= 1 and ulp_b <= 1,
              f"bf16 {label}: forward {ulp_f} / backward {ulp_b} ulps off the plain version")
        t_k = time_ms(lambda: kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0))
        t_kg = graph_ms(lambda: kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0))
        t_p = time_ms(lambda: kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0),
                      reps=10, inner=3)
        t_l = time_ms(lambda: F.local_response_norm(x, 5, ALPHA, 0.75, 1.0), reps=10, inner=3)
        t_b = time_ms(lambda: kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0))
        t_bp = time_ms(lambda: kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0),
                       reps=10, inner=3)
        xr = x.clone().requires_grad_(True)
        yr = F.local_response_norm(xr, 5, ALPHA, 0.75, 1.0)
        t_bl = time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True),
                       reps=10, inner=3)
        del xr, yr
        bound, by = lrn_bound_ms(shape, 5, 2, card)
        bound_b = 3 * x.numel() * 2 / bw * 1e3
        print(f"precision lrn {label} {list(shape)} bf16: forward {ulp_f:.2f} / backward "
              f"{ulp_b:.2f} bf16 ulps off the plain versions (gate 1); forward kernel "
              f"{t_k:.4f} ms ({100 * bound / t_k:.1f}% of {bound:.4f} ms, {by}), by graph "
              f"replay {t_kg:.4f} ms ({100 * bound / t_kg:.1f}%), plain {t_p:.4f} ms, "
              f"F.local_response_norm {t_l:.4f} ms; backward kernel {t_b:.4f} ms "
              f"({100 * bound_b / t_b:.1f}% of {bound_b:.4f} ms, bytes), plain {t_bp:.4f} "
              f"ms, autograd of F.local_response_norm {t_bl:.4f} ms [{card}]")


def _arena_state(solver):
    return (solver._param_arena.clone(), [a.clone() for a in solver._slot_arenas],
            solver.iter, {ln: dict(s) for ln, s in solver._state.items()})


def _arena_restore(solver, saved) -> None:
    arena, slots, it, state = saved
    solver._param_arena.copy_(arena)
    for a, b in zip(solver._slot_arenas, slots):
        a.copy_(b)
    solver.iter, solver._state = it, {ln: dict(s) for ln, s in state.items()}


def grad_capture(solver, grads: dict, tag: str) -> None:
    """Build ``solver``'s step with a reduce_grads hook that keeps a float32
    copy of the grad arena under ``grads[tag]`` and passes it on unchanged
    (``solver.set_reduce_grads(None)`` builds the plain step again)."""

    def keep(g):
        grads[tag] = g.detach().float().clone()
        return g

    solver.set_reduce_grads(keep)


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def precision_alexnet(card: str) -> tuple[int, int, int]:
    """AlexNet b256 at bf16 compute on float32 masters (fused update, B1 and
    B1' in bf16, B2 in float32): its first gradient and update held against
    the f32 step's from the same weights, batch and masks (PREC_GRAD_RTOL,
    PREC_BF16_UPDATE_RTOL; beside the f32 gradient of another dropout draw),
    then 20 steps timed in turns against the f32 step; then each remat
    policy and activation storage policy: one held step from the same state
    (a remat policy's loss and update bit for bit the policy-free step's,
    activation storage's within PREC_LOSS_RTOL and PREC_UPDATE_RTOL), then
    the peak memory and ms of PREC_POLICY_STEPS steps.  Returns the bf16
    steps' (LRN forward, LRN backward, fused update) launches."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.ops import kernels

    feeds = fixed_batch(256)
    dts = {"f32": "f32", "bf16": "bf16"}
    solvers = {}
    set_config(fused_update=True, storage_dtype="f32")
    try:
        for tag in dts:
            solvers[tag] = train_solver(models.alexnet(256), models.alexnet_solver())
    finally:
        set_config(fused_update=False)
    bf = solvers["bf16"]
    check(bf._param_arena.dtype == torch.float32 and bf.layout.storage_dtype == "f32",
          "bf16 compute: the master arena is not float32")
    f32 = solvers["f32"]
    start = _arena_state(f32)
    check(torch.equal(start[0], bf._param_arena), "bf16 and f32 solvers start apart")
    first, grads, upd = {}, {}, {}
    for tag, s in solvers.items():
        grad_capture(s, grads, tag)
        with port_config(compute_dtype=dts[tag]):
            s.step(1, lambda it: feeds)
        s.set_reduce_grads(None)
        first[tag] = float(s._loss_window[-1])
        upd[tag] = s._param_arena - start[0]
    # the yardstick: the f32 gradient from the same weights and batch under
    # another dropout draw (the solver's seed moved by one)
    after = _arena_state(f32)
    _arena_restore(f32, start)
    f32._seed += 1
    grad_capture(f32, grads, "other draw")
    f32.step(1, lambda it: feeds)
    f32._seed -= 1
    f32.set_reduce_grads(None)
    _arena_restore(f32, after)
    del start, after
    rel = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    g_rel = rel_l2(grads["bf16"], grads["f32"])
    g_other = rel_l2(grads["other draw"], grads["f32"])
    u_rel = rel_l2(upd["bf16"], upd["f32"])
    del grads, upd
    print(f"precision alexnet b256 first step, bf16 against f32 from the same weights, batch "
          f"and masks (relative L2): gradient {g_rel:.4e} (gate {PREC_GRAD_RTOL}), update "
          f"{u_rel:.4e} (gate {PREC_BF16_UPDATE_RTOL}), loss {rel:.3e} (gate "
          f"{PREC_LOSS_RTOL}); the f32 gradient under another dropout draw is {g_other:.4e} "
          f"off [{card}]")
    check(np.isfinite(first["bf16"]) and rel <= PREC_LOSS_RTOL,
          f"bf16 first loss {first['bf16']} against f32 {first['f32']}")
    check(g_rel <= PREC_GRAD_RTOL, f"bf16 first gradient {g_rel:.4e} off the f32 one")
    check(u_rel <= PREC_BF16_UPDATE_RTOL, f"bf16 first update {u_rel:.4e} off the f32 one")
    with port_config(compute_dtype="bf16"), torch.no_grad():
        blobs, _, _ = bf.train_net.apply(bf.variables, feeds,
                                         gen=torch.Generator(device="cuda").manual_seed(SEED))
    check(blobs["norm1"].dtype == blobs["norm2"].dtype == torch.bfloat16
          and blobs["loss"].dtype == torch.float32,
          f"bf16 step: norm1 {blobs['norm1'].dtype}, loss {blobs['loss'].dtype}")
    del blobs
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with port_config(compute_dtype="bf16"):
        bf.step(PREC_TURN, lambda it: feeds)
    torch.cuda.synchronize()
    counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
              kernels.FUSED_UPDATE_LAUNCHES)
    n = PREC_TURN
    check(counts == (2 * n, 2 * n, n), f"bf16 AlexNet launches {counts}, want {(2 * n,) * 2 + (n,)}")
    secs = {"f32": 0.0, "bf16": 0.0}
    for turn in range(PREC_TURNS):
        order = ("f32", "bf16") if turn % 2 == 0 else ("bf16", "f32")
        for tag in order:
            with port_config(compute_dtype=dts[tag]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solvers[tag].step(PREC_TURN, lambda it: feeds)
                torch.cuda.synchronize()
                secs[tag] += time.perf_counter() - t0
    steps = PREC_TURN * PREC_TURNS
    losses = {t: [float(l) for l in s._loss_window[-PREC_TURN:]] for t, s in solvers.items()}
    check(all(np.isfinite(losses["bf16"])), f"bf16 losses {losses['bf16']}")
    ms = {t: 1e3 * secs[t] / steps for t in secs}
    print(f"precision alexnet b256: first loss bf16 {first['bf16']:.6f} against f32 "
          f"{first['f32']:.6f} (rel {rel:.2e}, gate {PREC_LOSS_RTOL}); launches a bf16 step: "
          f"LRN forward {counts[0] // n} and backward {counts[1] // n} on bf16 blobs, fused "
          f"update {counts[2] // n} on the float32 master arena; {steps} steps each in turns "
          f"of {PREC_TURN}: bf16 {ms['bf16']:.3f} ms/step ({256e3 / ms['bf16']:.1f} img/s), "
          f"f32 {ms['f32']:.3f} ms/step ({256e3 / ms['f32']:.1f} img/s), bf16 "
          f"{ms['f32'] / ms['bf16']:.2f}x; last losses bf16 "
          f"{[round(l, 4) for l in losses['bf16']]} f32 "
          f"{[round(l, 4) for l in losses['f32']]} [{card}]")
    with port_config(compute_dtype="bf16"):
        step_turns(card, "AlexNet b256 bf16 compute", bf, lambda it: feeds, TURN_STEPS)

    with port_config(compute_dtype="bf16"):
        device_ms, rows = device_breakdown(lambda: bf.step(1, lambda it: feeds))
    if device_ms:
        print(f"precision alexnet bf16 profile: one step under torch.profiler: "
              f"{device_ms:.3f} ms of kernels, {100 * device_ms / ms['bf16']:.1f}% of the "
              f"unprofiled {ms['bf16']:.3f} ms/step [{card}]")
        for t, name, calls in rows:
            print(f"  {t:8.3f} ms  {100 * t / device_ms:5.1f}%  x{calls}  {name[:90]}")
    else:
        print("precision alexnet bf16 profile: torch.profiler recorded no device time")
    policies = [("bf16", "no policy", {}), ("bf16", "remat full", {"remat": "full"}),
                ("bf16", "remat dots", {"remat": "dots"}),
                ("bf16", "remat blocks", {"remat": "blocks"}),
                ("bf16", "activation_dtype blocks", {"activation_dtype": "blocks"}),
                ("f32", "no policy", {}),
                ("f32", "activation_dtype blocks", {"activation_dtype": "blocks"})]
    held = {}
    for tag, label, kw in policies:
        s = solvers[tag]
        saved = _arena_state(s)
        with port_config(compute_dtype=dts[tag], **kw):
            s.set_reduce_grads(None)  # the step is built with the policy
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            s.step(1, lambda it: feeds)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            loss = float(s._loss_window[-1])
            update = s._param_arena - saved[0]
            if label == "no policy":
                held[tag] = (loss, update)
            ref_loss, ref_update = held[tag]
            upd_rel = float((update - ref_update).norm() / ref_update.norm())
            t0 = time.perf_counter()
            s.step(PREC_POLICY_STEPS, lambda it: feeds)
            torch.cuda.synchronize()
            dt = 1e3 * (time.perf_counter() - t0) / PREC_POLICY_STEPS
        _arena_restore(s, saved)
        del saved
        same = loss == ref_loss
        same_update = torch.equal(update, ref_update)
        del update
        print(f"precision alexnet {tag} {label}: peak {peak / 2**20:.1f} MiB, of which the "
              f"step's own {(peak - base) / 2**20:.1f} MiB; {dt:.3f} ms/step; held step: loss "
              f"{loss:.6f} ({'bit for bit' if same else 'differs from'} the policy-free "
              f"{ref_loss:.6f}), update {upd_rel:.2e} of the policy-free update (relative L2"
              f"{', ' + ('bit for bit' if same_update else 'NOT bit for bit') if label.startswith('remat') else ''}; "
              f"gate {'bit for bit' if label.startswith('remat') else PREC_UPDATE_RTOL}) [{card}]")
        if label.startswith("remat"):
            check(same, f"{tag} {label}: the forward's loss moved")
            check(same_update, f"{tag} {label}: update {upd_rel:.3e} off the policy-free one")
        else:
            check(abs(loss - ref_loss) <= PREC_LOSS_RTOL * abs(ref_loss),
                  f"{tag} {label}: loss {loss} against {ref_loss}")
            check(upd_rel <= PREC_UPDATE_RTOL, f"{tag} {label}: update {upd_rel:.3e} off")
    with port_config():
        bf.set_reduce_grads(None)
    del solvers, bf, held
    gc.collect()
    return counts


def precision_charlm(card: str) -> tuple[int, int, int]:
    """The full-width char LM at bf16 compute through TPUNet (Adam, fused
    update on float32 masters): its first loss against the f32 handle's
    from the same seed, 40 steps of each in turns (ms/step, tokens/s), the
    bf16 run learning.  B3/B3' take the bf16 q, k, v cast to float32 in
    their wrappers.  Returns the bf16 steps' (flash, flash backward, fused
    update) launches."""
    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.data import char_lm_batches
    from sparknet_tpu_torch.ops import kernels

    text, vocab = charlm_text()
    batch, seq = CHARLM["slots"], CHARLM["seq_len"]
    feed = char_lm_batches(text, vocab, batch, seq, seed=SEED + 5)
    batches = [next(feed) for _ in range(PREC_CHARLM_STEPS + 1)]
    dts = {"f32": "f32", "bf16": "bf16"}
    try:
        nets = {tag: charlm_handle(True) for tag in dts}
    finally:
        set_config(fused_update=False)
    first, grads = {}, {}
    f = nets["f32"].solver
    start = _arena_state(f)
    check(torch.equal(start[0], nets["bf16"].solver._param_arena),
          "charlm bf16 and f32 handles start apart")
    for tag, net in nets.items():
        net.set_train_data(lambda it: batches[it])
        grad_capture(net.solver, grads, tag)
        with port_config(compute_dtype=dts[tag]):
            net.train(1)
        net.solver.set_reduce_grads(None)
        first[tag] = float(net.solver._loss_window[-1])
    # the yardstick: the f32 gradient of the next batch from the same weights
    after = _arena_state(f)
    _arena_restore(f, start)
    grad_capture(f, grads, "next batch")
    f.step(1, lambda it: batches[1])
    f.set_reduce_grads(None)
    _arena_restore(f, after)
    del start, after
    rel = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    g_rel = rel_l2(grads["bf16"], grads["f32"])
    g_other = rel_l2(grads["next batch"], grads["f32"])
    del grads
    print(f"precision charlm first step, bf16 against f32 from the same weights and batch "
          f"(relative L2): gradient {g_rel:.4e} (gate {PREC_CHARLM_GRAD_RTOL}), loss "
          f"{rel:.3e} (gate {PREC_LOSS_RTOL}); the f32 gradient of the next batch is "
          f"{g_other:.4e} off [{card}]")
    check(rel <= PREC_LOSS_RTOL, f"charlm bf16 first loss {first['bf16']} against {first['f32']}")
    check(g_rel <= PREC_CHARLM_GRAD_RTOL, f"charlm bf16 first gradient {g_rel:.4e} off")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    secs = {"f32": 0.0, "bf16": 0.0}
    losses = {"f32": [], "bf16": []}
    for turn in range(PREC_CHARLM_STEPS // PREC_TURN):
        order = ("f32", "bf16") if turn % 2 == 0 else ("bf16", "f32")
        for tag in order:
            before = (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
                      kernels.FUSED_UPDATE_LAUNCHES)
            with port_config(compute_dtype=dts[tag]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nets[tag].train(PREC_TURN)
                torch.cuda.synchronize()
                secs[tag] += time.perf_counter() - t0
            losses[tag] += [float(l) for l in nets[tag].solver._loss_window[-PREC_TURN:]]
            if tag == "f32":  # the f32 turns are the yardstick, off the count
                (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
                 kernels.FUSED_UPDATE_LAUNCHES) = before
    counts = (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
              kernels.FUSED_UPDATE_LAUNCHES)
    n = PREC_CHARLM_STEPS
    check(counts == (2 * n, 2 * n, n), f"charlm bf16 launches {counts}, want {(2 * n,) * 2 + (n,)}")
    lb = losses["bf16"]
    check(all(np.isfinite(lb)) and np.mean(lb[-10:]) < np.mean(lb[:10]),
          f"charlm bf16 did not learn: {lb[:3]} ... {lb[-3:]}")
    ms = {t: 1e3 * secs[t] / n for t in secs}
    print(f"precision charlm b{batch} x {seq}: first loss bf16 {first['bf16']:.6f} against f32 "
          f"{first['f32']:.6f} (rel {rel:.2e}); launches a bf16 step: flash "
          f"{counts[0] // n}, flash backward {counts[1] // n}, fused update {counts[2] // n}; "
          f"{n} steps each in turns: bf16 {ms['bf16']:.3f} ms/step "
          f"({batch * seq / ms['bf16'] * 1e3:.1f} tokens/s), f32 {ms['f32']:.3f} ms/step; "
          f"mean loss of the first / last 10: bf16 {np.mean(lb[:10]):.4f} / "
          f"{np.mean(lb[-10:]):.4f}, f32 {np.mean(losses['f32'][:10]):.4f} / "
          f"{np.mean(losses['f32'][-10:]):.4f} [{card}]")
    del nets
    gc.collect()
    return counts


def precision_classifier(card: str) -> int:
    """The CaffeNet Classifier at full width (seeded weights, 10 crops a
    request): float32 predictions, then ``calibrate_int8`` on other seeded
    images and int8 predictions of the same requests (top-1 agreement,
    exact launches); the int32 sums of conv1 (K 363), conv2 (group 2),
    conv3, conv4 and conv5 (group 2) bit for bit the float64 convolution
    of the same int8 values on the card; the int8 product (quantize,
    im2col, ``torch._int_mm``, dequantize) and ``torch._int_mm`` alone timed at conv1-5 beside
    cuDNN's float32 convolution (TF32 off) and the int8 bound.  Returns
    the LRN launches of the int8 requests."""
    from sparknet_tpu_torch import models, quant
    from sparknet_tpu_torch.common import Phase, f32_precision
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.proto import parse

    clf = models.Classifier(parse(CAFFENET_DEPLOY), image_dims=(256, 256),
                            mean=np.array([104.0, 117.0, 123.0], np.float32),
                            raw_scale=255.0, channel_swap=(2, 1, 0))
    clf.variables = Network(models.caffenet(10), Phase.TEST).init(
        torch.Generator().manual_seed(SEED))
    rs = np.random.RandomState(SEED + 23)
    images = [rs.rand(320, 480, 3).astype(np.float32) for _ in range(PREC_IMAGES)]
    calib = [rs.rand(320, 480, 3).astype(np.float32) for _ in range(PREC_CALIB_IMAGES)]
    blobs = clf.preprocess_images(images, oversample=True)
    p32 = clf.predict_blobs(blobs)
    t0 = time.perf_counter()
    qstate = clf.calibrate_int8(calib, oversample=True)
    t_cal = time.perf_counter() - t0
    check(set(qstate) == {"conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"},
          f"CaffeNet calibrated {sorted(qstate)}")
    clf.predict_blobs(blobs[:10])  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    p8 = clf.predict_blobs(blobs)
    t_int8 = time.perf_counter() - t0
    counts = (kernels.INT_MM_LAUNCHES, kernels.LRN_LAUNCHES)
    check(counts == (8 * PREC_IMAGES, 2 * PREC_IMAGES),
          f"int8 CaffeNet launches (int_mm, LRN) {counts}, want {(8 * PREC_IMAGES, 2 * PREC_IMAGES)}")
    check(p8.shape == (PREC_IMAGES, 1000) and np.isfinite(p8).all()
          and np.allclose(p8.sum(1), 1.0, atol=1e-4), "int8 probabilities")
    agree = float((p8.argmax(1) == p32.argmax(1)).mean())
    rel = float(np.linalg.norm(p8 - p32) / np.linalg.norm(p32))
    print(f"precision classifier: CaffeNet int8 (8 layers calibrated on {PREC_CALIB_IMAGES} "
          f"images x 10 crops in {t_cal:.2f} s): {PREC_IMAGES} requests, top-1 agreement with "
          f"f32 {agree:.3f}, probabilities {rel:.3e} off f32 (relative L2); launches "
          f"int_mm {counts[0]} and LRN {counts[1]} ({8} and 2 a forward); "
          f"{1e3 * t_int8 / PREC_IMAGES:.2f} ms a request [{card}]")
    check(rel < 0.5, f"int8 probabilities {rel:.3e} off f32")

    net, v, qrun = clf.network, clf.variables, clf._qrun
    x = torch.from_numpy(blobs[:10]).cuda()
    with torch.no_grad(), quant.quantized_inference(qrun):
        bl, _, _ = net.apply(v, {"data": x}, train=False)
    int8_peak = next(peak for key, peak in INT8_PEAKS if key in card)
    bw, _, _ = card_peaks(card)
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        layer = net.layers[net.layer_index(name)]
        c = layer._conf()
        d = (c["dilation"], c["dilation"])
        inp = bl[layer.bottoms[0]]
        q = qrun[name]
        x_q = quant.quantize_activation(inp, q["x_scale"])
        got = quant.conv_int32(x_q, q["w_q"], stride=c["stride"], padding=c["pad"],
                               dilation=d, groups=c["group"], w_mat=q["w_mat"])
        ref = F.conv2d(x_q.double(), q["w_q"].double(), stride=c["stride"], padding=c["pad"],
                       dilation=d, groups=c["group"])
        torch.cuda.synchronize()
        peak_sum = float(ref.abs().max())
        same = torch.equal(got.double(), ref)
        check(same, f"int8 {name}: int32 sums differ from the float64 convolution")
        a, _ = quant.im2col_int8(x_q, q["w_q"].shape[2:], stride=c["stride"],
                                 padding=c["pad"], dilation=d)
        b = q["w_mat"]
        t_mm = time_ms(lambda: torch._int_mm(a, b))
        t_path = time_ms(lambda: quant.int8_conv(inp, q, stride=c["stride"], padding=c["pad"],
                                                 dilation=d, groups=c["group"]))
        t_plain = time_ms(lambda: F.conv2d(x_q.double(), q["w_q"].double(), stride=c["stride"],
                                           padding=c["pad"], dilation=d, groups=c["group"]),
                          reps=5, inner=1)
        w = net.layer_params(name, v.params)
        with f32_precision():
            t_f32 = time_ms(lambda: F.conv2d(inp, w[0], w[1], stride=c["stride"],
                                             padding=c["pad"], dilation=d, groups=c["group"]))
        ops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
        useful = 2 * got.numel() * q["w_q"][0].numel()
        # the product's own bound: the im2col matrix, the weight and the
        # int32 sums once each (unpadded), or its useful int8 operations
        m, k, o = got.numel() // got.shape[1], q["w_q"][0].numel() * c["group"], got.shape[1]
        t_bytes = (m * k + k * o // c["group"] + 4 * m * o) / bw * 1e3
        t_ops = useful / int8_peak * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"precision int8 {name} (batch 10, M {a.shape[0]}, K {a.shape[1]}, N "
              f"{b.shape[1]}, padded to 8, group {c['group']}): int32 sums "
              f"{'bit for bit' if same else 'NOT equal to'} the float64 convolution "
              f"(max |sum| {peak_sum:.3e}); torch._int_mm {t_mm:.4f} ms "
              f"({ops / 1e9:.3f} G int8 ops, padding and block-diagonal zeros included), the "
              f"int8 path (quantize, im2col, product, dequantize) "
              f"{t_path:.4f} ms, the float64 plain version {t_plain:.4f} ms, cuDNN float32 "
              f"convolution {t_f32:.4f} ms; the product's "
              f"bound {bound:.4f} ms ({by}; {useful / 1e9:.3f} G useful ops at "
              f"{int8_peak / 1e12:.0f} TOPS: {t_ops:.4f} ms) [{card}]")
    del clf, bl
    gc.collect()
    return counts[1]


def precision_engine(card: str) -> None:
    """The engine's int8 arm (fold, then calibrate once, every bucket captured
    inside ``quantized_inference``) for cifar10_quick, lenet and mobilenet
    (trained 5 steps) at buckets 1/8/64/256: replay bit for bit eager,
    padded bit for bit full, the replays' int8 product launches, the
    scores beside the f32 arm's; 0 request-path captures, 0 dropped."""
    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS, ServeEngine, _synthetic_feeds
    from sparknet_tpu_torch.serve.engine import _int8_resident_bytes as engine_int8_bytes

    mfam = GRAPH_SWEEP_FAMILIES["mobilenet"]
    solver = zoo_solver(mfam.net(32), "mobilenet", cfg=mfam.solver())
    losses = [float(l) for l in zoo_steps(solver, zoo_batch(32, 64, classes=mfam.num_classes), 5)]
    check(all(np.isfinite(losses)), f"int8 engine mobilenet training losses {losses}")
    engine = ServeEngine(SERVE_BUCKETS, max_wait_ms=5.0, device="cuda")
    tickets = []
    try:
        for fam_name in PREC_INT8_FAMILIES:
            fam = GRAPH_SWEEP_FAMILIES[fam_name]
            variables = solver.variables if fam_name == "mobilenet" else None
            t0 = time.perf_counter()
            m = engine.load_model(f"{fam_name}_int8", family=fam_name, arm="int8",
                                  variables=variables)
            t_load = time.perf_counter() - t0
            f = engine.load_model(f"{fam_name}_f32", family=fam_name, arm="f32",
                                  variables=variables)
            # requests drawn as the calibration stream is (_synthetic_feeds),
            # so the int8 arm meets the activation ranges it was calibrated on
            items = _synthetic_feeds(fam, 256, seed=SEED + 29)["data"]
            n_q = len(m.qstate)
            for b, prog in m.programs.items():
                rows = items[:prog.batch]
                check(prog.launches.get("INT_MM_LAUNCHES") == n_q,
                      f"{fam_name} int8 bucket {b}: the capture recorded "
                      f"{prog.launches} int8 products, want {n_q}")
                before = kernels.INT_MM_LAUNCHES
                out = run_locked(m, prog, rows)
                replayed = kernels.INT_MM_LAUNCHES - before
                eager = prog.eager(torch.from_numpy(rows).cuda()).cpu().numpy()
                ref = run_locked(f, f.programs[b], rows)
                same = np.array_equal(out, eager)
                rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
                agree = float((out.argmax(-1) == ref.argmax(-1)).mean())
                t_q = time_ms(prog.graph.replay, reps=PREC_ENGINE_REPS, inner=5)
                t_f = time_ms(f.programs[b].graph.replay, reps=PREC_ENGINE_REPS, inner=5)
                print(f"precision engine {fam_name} int8 bucket {b} (exec {prog.batch} rows, "
                      f"{n_q} layers int8): replay and eager "
                      f"{'bit for bit equal' if same else 'DIFFER'}; {replayed} int8 "
                      f"products a replay; scores {rel:.3e} off the f32 arm (relative L2), "
                      f"top-1 agreement {agree:.3f}; replay {t_q:.4f} ms, f32 replay "
                      f"{t_f:.4f} ms [{card}]")
                check(same and np.isfinite(out).all() and replayed == n_q,
                      f"{fam_name} int8 bucket {b}: replay")
            for b in SERVE_BUCKETS[1:]:
                full = [engine.submit(m.name, it) for it in items[:b]]
                engine.pump(force=True)
                padded = [engine.submit(m.name, it) for it in items[:b // 2 + 1]]
                engine.pump(force=True)
                tickets += full + padded
                same = all(np.array_equal(p.result, q.result) for p, q in zip(padded, full))
                check(same and {t.bucket for t in full + padded} == {b},
                      f"{fam_name} int8 bucket {b}: padded rows changed a real row")
            priced = engine_int8_bytes(fam_name)()
            print(f"precision engine {fam_name} int8: loaded in {t_load:.2f} s (fold, "
                  f"calibrate, 4 captures), {len(m.folded)} chains folded; padded batches "
                  f"bit for bit the full ones in buckets {list(SERVE_BUCKETS[1:])}; device "
                  f"bytes after the captures: int8 {m.measured_bytes:,}, f32 "
                  f"{f.measured_bytes:,} (int8 - f32 {m.measured_bytes - f.measured_bytes:,}); "
                  f"the int8 records admission prices on top of the f32 row: "
                  f"{priced:,} [{card}]")
            engine.unload_model(f.name)
        dropped = sum(not t.done() or t.error is not None for t in tickets)
        print(f"precision engine: request-path captures {engine.serve_path_compiles}, "
              f"dropped {dropped} of {len(tickets)} [{card}]")
        check(engine.serve_path_compiles == 0, "int8 engine: a capture on the request path")
        check(dropped == 0, f"int8 engine: {dropped} tickets dropped")
    finally:
        engine.shutdown()
    del solver
    gc.collect()


def phase_precision(card: str) -> dict:
    """Reduced precision on the card: B1/B1' in bf16, the bf16 AlexNet and
    char LM train steps, the remat and activation storage policies, and the
    int8 deploy arm (Classifier and engine).  Returns the launches of the
    paths it drives."""
    t_phase = time.perf_counter()
    precision_lrn(card)
    lrn, lrn_bwd, fused = precision_alexnet(card)
    flash, flash_bwd, fused_lm = precision_charlm(card)
    lrn += precision_classifier(card)
    precision_engine(card)
    print(f"precision: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=lrn, lrn_backward=lrn_bwd, fused_update=fused + fused_lm, flash=flash,
                flash_backward=flash_bwd)


# The list-file data layers and the rest of the CLI: BVLC Caffe's
# finetune_flickr_style (ImageData), finetune_pascal_detection (WindowData)
# and the R-CNN deploy net, at CaffeNet's published widths on seeded data.
LF_IMAGES = 300  # seeded 320x240 JPEGs; the first LF_TRAIN in train.txt, the rest test.txt
LF_TRAIN = 250
LF_BATCH = 50  # finetune_flickr_style's batch_size, TRAIN and TEST
LF_CLASSES = 20  # fc8_flickr
LF_STEPS = 4  # 2 rounds at --tau 2; the steps after the first are timed
LF_TEST_ITERS = 2
LF_PASCAL_IMAGES = 100  # images of the window file, 2 fg and 4 bg windows each
LF_PASCAL_BATCH = 128
LF_PASCAL_CLASSES = 21  # fc8_pascal
LF_PASCAL_STEPS = 3
LF_DET_IMAGES, LF_DET_WINDOWS = 2, 16
LF_CLASSIFY_IMAGES = 4
# gates: the card's first flickr step against the CPU port's from the same
# weights, batch and masks (relative L2 of the gradient and of the update),
# about 5x the 2.1e-4 / 2.2e-4 measured on the H100 and a hundredth of what
# another dropout draw or the next batch gives (PREC_GRAD_RTOL's
# yardsticks); the Detector's scores against the CPU Detector's, of max|ref|,
# about 14x the 7.2e-7 measured (PERF.md's findings on the list-file slice)
LF_GRAD_RTOL = 1e-3
LF_DET_TOL = 1e-5

FLICKR_SOLVER = ('net: "{net}"\ntest_iter: 100\ntest_interval: 1000\nbase_lr: 0.001\n'
                 'lr_policy: "step"\ngamma: 0.1\nstepsize: 20000\ndisplay: 20\n'
                 "max_iter: 100000\nmomentum: 0.9\nweight_decay: 0.0005\n"
                 "snapshot: 10000\n")


def lf_data(d: str) -> dict:
    """LF_IMAGES seeded 320x240 JPEGs (128 + noise x40 + a +-80 pattern a
    class, as the db_apps phase's), the flickr lists, an R-CNN window file
    of the first LF_PASCAL_IMAGES (2 fg windows of overlap 0.6-0.9, label
    1-20, and 4 bg of overlap 0-0.4 a image); returns the paths."""
    import io
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    pattern = 80 * np.sign(np.random.default_rng(SEED + 30).standard_normal(
        (LF_CLASSES, 240, 320, 3), dtype=np.float32))

    def jpeg(i: int) -> None:
        noise = np.random.default_rng([SEED + 30, i]).standard_normal((240, 320, 3),
                                                                       dtype=np.float32)
        Image.fromarray(np.clip(128 + 40 * noise + pattern[i % LF_CLASSES], 0, 255).astype(
            np.uint8)).save(os.path.join(d, f"img{i:03d}.jpg"), format="JPEG")

    with ThreadPoolExecutor(8) as pool:  # numpy's and PIL's loops leave the GIL
        list(pool.map(jpeg, range(LF_IMAGES)))
    lines = [f"img{i:03d}.jpg {i % LF_CLASSES}\n" for i in range(LF_IMAGES)]
    paths = {k: os.path.join(d, f"{k}.txt") for k in ("train", "test", "windows")}
    with open(paths["train"], "w") as f:
        f.writelines(lines[:LF_TRAIN])
    with open(paths["test"], "w") as f:
        f.writelines(lines[LF_TRAIN:])
    rs = np.random.RandomState(SEED + 31)
    wl = []
    for i in range(LF_PASCAL_IMAGES):
        wins = []
        for k in range(6):
            x1, y1 = rs.randint(0, 200), rs.randint(0, 140)
            x2, y2 = min(319, x1 + rs.randint(40, 160)), min(239, y1 + rs.randint(40, 120))
            fg = k < 2
            wins.append(f"{(i + k) % (LF_PASCAL_CLASSES - 1) + 1 if fg else 0} "
                        f"{rs.uniform(0.6, 0.9) if fg else rs.uniform(0.0, 0.4):.3f} "
                        f"{x1} {y1} {x2} {y2}")
        wl += [f"# {i}", f"img{i:03d}.jpg", "3 240 320", str(len(wins))] + wins
    with open(paths["windows"], "w") as f:
        f.write("\n".join(wl) + "\n")
    paths["images"] = [os.path.join(d, f"img{i:03d}.jpg") for i in range(LF_IMAGES)]
    return paths


def lf_caffenet_body(head: str, classes: int) -> str:
    """zoo.caffenet's layers but its RDD inputs, fc8 renamed ``head`` with
    ``classes`` outputs (the fine-tuning nets' new head)."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.proto import serialize

    out = []
    for lp in models.caffenet(LF_BATCH).get_all("layer"):
        if lp.get_str("type") == "JavaData":
            continue
        text = serialize(lp, 1)
        if lp.get_str("name") == "fc8":
            text = text.replace('"fc8"', f'"{head}"').replace("num_output: 1000",
                                                             f"num_output: {classes}")
        elif "fc8" in lp.get_all("bottom"):
            text = text.replace('bottom: "fc8"', f'bottom: "{head}"')
        out.append("layer {\n" + text + "\n}")
    return "\n".join(out) + "\n"


def lf_nets(d: str, paths: dict, mean: str) -> tuple[str, str]:
    """The flickr and pascal solver files: BVLC Caffe's
    models/finetune_flickr_style/train_val.prototxt (ImageData: batch 50,
    new 256x256, crop 227, mirror in TRAIN, the mean file; fc8_flickr of
    20) and examples/finetune_pascal_detection/
    pascal_finetune_trainval_test.prototxt (WindowData: batch 128,
    fg/bg threshold 0.5, fg_fraction 0.25, context_pad 16, warp, crop 227,
    mirror, the mean file; fc8_pascal of 21), with the flickr solver."""
    import os

    tp = f'mean_file: "{mean}" crop_size: 227'
    flickr = 'name: "FlickrStyleCaffeNet"\n' + "".join(
        f'layer {{ name: "data" type: "ImageData" top: "data" top: "label"\n'
        f"  include {{ phase: {ph} }} transform_param {{ mirror: {m} {tp} }}\n"
        f'  image_data_param {{ source: "{paths[lst]}" root_folder: "{d}/" '
        f"batch_size: {LF_BATCH} new_height: 256 new_width: 256 }} }}\n"
        for ph, m, lst in (("TRAIN", "true", "train"), ("TEST", "false", "test"))
    ) + lf_caffenet_body("fc8_flickr", LF_CLASSES)
    pascal = 'name: "CaffeNet"\n' + "".join(
        f'layer {{ name: "data" type: "WindowData" top: "data" top: "label"\n'
        f"  include {{ phase: {ph} }} transform_param {{ mirror: {m} {tp} }}\n"
        f'  window_data_param {{ source: "{paths["windows"]}" root_folder: "{d}/" '
        f"batch_size: {LF_PASCAL_BATCH} fg_threshold: 0.5 bg_threshold: 0.5 "
        f'fg_fraction: 0.25 context_pad: 16 crop_mode: "warp" }} }}\n'
        for ph, m in (("TRAIN", "true"), ("TEST", "false"))
    ) + lf_caffenet_body("fc8_pascal", LF_PASCAL_CLASSES)
    out = []
    for name, text in (("flickr", flickr), ("pascal", pascal)):
        net, solver = os.path.join(d, f"{name}.prototxt"), os.path.join(d, f"{name}_solver.prototxt")
        with open(net, "w") as f:
            f.write(text)
        with open(solver, "w") as f:
            f.write(FLICKR_SOLVER.format(net=net))
        out.append(solver)
    return out[0], out[1]


def lf_deploy(head: str, classes: int, prob: bool) -> str:
    """A CaffeNet deploy net (input 10x3x227x227, no dropout's labels) whose
    last layer is ``head`` of ``classes`` (BVLC Caffe's
    models/bvlc_reference_rcnn_ilsvrc13/deploy.prototxt with head fc-rcnn
    of 200 and no softmax; the flickr deploy with fc8_flickr and prob)."""
    text = CAFFENET_DEPLOY.replace('"fc8"', f'"{head}"').replace(
        "num_output: 1000", f"num_output: {classes}")
    return text if prob else text[:text.index('layer { name: "prob"')]


@contextlib.contextmanager
def dropout_masks(masks: dict, replay: bool):
    """Every Dropout layer keeps the mask it draws under ``masks[name]``
    (on the host), or, with ``replay``, applies the kept one: the CPU step
    then sees the card step's masks.  The same arithmetic as
    ``ops/neuron.Dropout``."""
    from sparknet_tpu_torch.ops import neuron
    from sparknet_tpu_torch.ops.base import LayerOutput

    orig = neuron.Dropout.apply

    def apply(self, params, state, inputs, *, train, gen=None):
        ratio = self.lp.get_msg("dropout_param").get_float("dropout_ratio", 0.5)
        x = inputs[0]
        if not train or ratio == 0.0:
            return orig(self, params, state, inputs, train=train, gen=gen)
        keep = 1.0 - ratio
        if replay:
            mask = masks[self.name].to(x.device)
        else:
            mask = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            mask = mask.bernoulli_(keep, generator=gen).bool()
            masks[self.name] = mask.cpu()
        return LayerOutput([torch.where(mask, x / keep, 0.0).to(x.dtype)])

    neuron.Dropout.apply = apply
    try:
        yield
    finally:
        neuron.Dropout.apply = orig


@contextlib.contextmanager
def patched(owner, name: str, wrapper):
    """``owner.name`` replaced by ``wrapper(original)`` for the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def lf_cli(argv, walls: list) -> str:
    """``cli.main(argv)`` in process; its stdout, and its seconds in ``walls``."""
    import io

    from sparknet_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    check(rc == 0, f"cli {argv[0]} exited {rc}")
    walls.append((argv[0] + (" --tau " + argv[argv.index("--tau") + 1]
                             if "--tau" in argv else ""), time.perf_counter() - t0))
    return buf.getvalue()


def lf_source_share(steps: list, spans: list) -> tuple[float, float, float]:
    """(ms a step, the share of it in the source's calls, the share in
    ``train_iteration``'s own call): the steps between the second and the
    last ``train_iteration`` entries (the first meets the new shapes); each
    enqueues its step, waits on its loss (the CLI's hook reads it), then
    on the next batch.  ``steps``: (entry, exit) clock pairs."""
    lo, hi = steps[1][0], steps[-1][0]
    host = sum(b - a for a, b in spans if lo <= a and b <= hi)
    call = sum(b - a for a, b in steps[1:-1])
    return 1e3 * (hi - lo) / (len(steps) - 2), host / (hi - lo), call / (hi - lo)


def lf_first_step_vs_cpu(card: str, cap: dict, solver_file: str) -> dict:
    """The card's first flickr step against the CPU port's from the same
    weights, batch and dropout masks: loss, gradient and update."""
    from sparknet_tpu_torch.proto.text_format import parse_file
    from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig, load_solver_net

    msg = parse_file(solver_file)
    cpu = Solver(SolverConfig.from_proto(msg), load_solver_net(msg), device="cpu")
    check(cpu.layout is not None and cpu.layout.total == cap["w0"].numel(),
          "the CPU solver's arena does not match the card's")
    with torch.no_grad():
        cpu._param_arena.copy_(cap["w0"].cpu())
    grads = {}
    grad_capture(cpu, grads, "cpu")
    with dropout_masks(cap["masks"], replay=True):
        loss = float(cpu.train_iteration(cap["feeds"]))
    cpu.set_reduce_grads(None)
    out = {"loss": abs(cap["loss"] - loss) / abs(loss),
           "grad": rel_l2(cap["grad"].cpu(), grads["cpu"]),
           "update": rel_l2(cap["update"].cpu(), cpu._param_arena - cap["w0"].cpu()),
           "cpu_loss": loss}
    del cpu, grads
    gc.collect()
    return out


def lf_kernels_vs_plain(card: str, layout, cfg) -> None:
    """B1 and B1' against their plain versions at the flickr and pascal
    steps' LRN shapes, and B2 on the flickr arena (bit for bit)."""
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    for b in (LF_BATCH, LF_PASCAL_BATCH):
        for shape in ((b, 96, 27, 27), (b, 256, 13, 13)):
            x = torch.relu(torch.randn(shape, generator=gen, device="cuda") * 50)
            g = torch.randn(shape, generator=gen, device="cuda")
            for what, got, ref in (
                    ("forward", kernels.lrn_across_channels(x, 5, ALPHA, 0.75, 1.0),
                     kernels.lrn_across_channels_torch(x, 5, ALPHA, 0.75, 1.0)),
                    ("backward", kernels.lrn_backward(x, g, 5, ALPHA, 0.75, 1.0),
                     kernels.lrn_backward_torch(x, g, 5, ALPHA, 0.75, 1.0))):
                err = (got - ref).abs()
                ok = bool((err <= F32_TOL["atol"] + F32_TOL["rtol"] * ref.abs()).all())
                print(f"listfile LRN {what} {list(shape)}: max abs err {float(err.max()):.3e} "
                      f"(rtol 1e-5, atol 1e-6) {'ok' if ok else 'FAIL'}")
                check(ok, f"listfile LRN {what} {shape}")
    b2_against_plain(card, "flickr CaffeNet", layout, cfg, 0)


def phase_listfile(card: str) -> dict:
    """The list-file data layers and the rest of the CLI on the card (fused
    update, f32, TF32 off, deterministic cuDNN).  Returns the launches of
    the paths it drives."""
    import os
    import tempfile

    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.data import listfile as lf
    from sparknet_tpu_torch.data.io_utils import load_image
    from sparknet_tpu_torch.data.transform import load_mean_file
    from sparknet_tpu_torch.interop import netvars_from_numpy
    from sparknet_tpu_torch.models import Classifier, Detector
    from sparknet_tpu_torch.net import export_caffemodel
    from sparknet_tpu_torch.parallel import trainer as trainer_mod
    from sparknet_tpu_torch.proto import parse
    from sparknet_tpu_torch.solvers import solver as solver_mod

    t_phase = time.perf_counter()
    set_config(fused_update=True, storage_dtype="f32")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    walls, total = [], [0, 0, 0]

    def add(counts, want, what):
        check(counts == want, f"listfile {what}: launches (lrn fwd, lrn bwd, fused) {counts}, "
                              f"want {want}")
        for i, x in enumerate(counts):
            total[i] += x

    try:
        with tempfile.TemporaryDirectory() as d:
            os.environ["SPARKNET_TRAIN_LOG_DIR"] = d
            t0 = time.perf_counter()
            paths = lf_data(d)
            t_data = time.perf_counter() - t0
            db, mean = os.path.join(d, "train.sndb"), os.path.join(d, "mean.binaryproto")
            lf_cli(["convert_imageset", "--root", d, "--listfile", paths["train"], "--db", db,
                    "--resize", "256"], walls)
            lf_cli(["compute_image_mean", "--db", db, "--out", mean], walls)
            flickr, pascal = lf_nets(d, paths, mean)
            take_counts()

            # flickr: train --data auto from the net's own ImageData lists
            cap, steps, spans = {}, [], []

            def clocked(orig):
                def ti(self, feeds):
                    t = time.perf_counter()
                    loss = orig(self, feeds)
                    steps.append((t, time.perf_counter()))
                    return loss
                return ti

            def spy_iteration(orig):
                orig = clocked(orig)

                def ti(self, feeds):
                    if "w0" in cap:
                        return orig(self, feeds)
                    cap.update(solver=self, w0=self._param_arena.detach().clone(),
                               feeds={k: np.array(v) for k, v in feeds.items()}, masks={})
                    grads = {}
                    grad_capture(self, grads, "card")
                    with dropout_masks(cap["masks"], replay=False):
                        loss = orig(self, feeds)
                    self.set_reduce_grads(None)
                    cap.update(loss=float(loss), grad=grads["card"],
                               update=self._param_arena.detach() - cap["w0"])
                    return loss
                return ti

            def timed_source(orig):
                def call(self, it):
                    t = time.perf_counter()
                    out = orig(self, it)
                    if self.train:
                        spans.append((t, time.perf_counter()))
                    return out
                return call

            with patched(solver_mod.Solver, "train_iteration", spy_iteration), \
                    patched(lf.ImageDataSource, "__call__", timed_source):
                lf_cli(["train", "--solver", flickr, "--iterations", str(LF_STEPS),
                        "--test-iters", str(LF_TEST_ITERS), "--output",
                        os.path.join(d, "flickr_final")], walls)
            add(take_counts(), (2 * LF_STEPS + 2 * LF_TEST_ITERS, 2 * LF_STEPS, LF_STEPS),
                "flickr train")
            flickr_ms, host_share, call_share = lf_source_share(steps, spans)
            solver = cap.pop("solver")
            feeds = solver._feeds_on_device(cap["feeds"])
            solver.train_iteration(feeds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LF_STEPS):
                solver.train_iteration(feeds)
            torch.cuda.synchronize()
            fixed_ms = 1e3 * (time.perf_counter() - t0) / LF_STEPS
            take_counts()
            lf_kernels_vs_plain(card, solver.layout, solver.config)
            take_counts()
            del solver, feeds
            gc.collect()
            vs_cpu = lf_first_step_vs_cpu(card, cap, flickr)
            print(f"listfile flickr first step, the card against the CPU port from the same "
                  f"weights, batch and masks: loss {cap['loss']:.6f} vs {vs_cpu['cpu_loss']:.6f} "
                  f"(rel {vs_cpu['loss']:.2e}), gradient {vs_cpu['grad']:.3e}, update "
                  f"{vs_cpu['update']:.3e} (relative L2; gate {LF_GRAD_RTOL}) [{card}]")
            check(np.isfinite(cap["loss"]) and vs_cpu["grad"] <= LF_GRAD_RTOL
                  and vs_cpu["update"] <= LF_GRAD_RTOL and vs_cpu["loss"] <= LF_GRAD_RTOL,
                  "the card's first flickr step is off the CPU port's")
            del cap
            gc.collect()

            # the same training as SparkNet's tau-2 rounds in a world of one
            rounds = []

            def timed_round(orig):
                def train_round(self, data_fn):
                    t = time.perf_counter()
                    loss = orig(self, data_fn)
                    rounds.append(1e3 * (time.perf_counter() - t))
                    return loss
                return train_round

            with patched(trainer_mod.ParallelTrainer, "train_round", timed_round):
                lf_cli(["train", "--solver", flickr, "--iterations", str(LF_STEPS), "--tau",
                        "2", "--output", os.path.join(d, "tau_final")], walls)
            add(take_counts(), (2 * LF_STEPS, 2 * LF_STEPS, LF_STEPS), "flickr --tau 2")
            snaps = []
            for name in ("flickr_final", "tau_final"):
                with np.load(os.path.join(d, name + ".solverstate.npz")) as z:
                    snaps.append({k: z[k] for k in z.files if k != "__meta__"})
            same = snaps[0].keys() == snaps[1].keys() and all(
                np.array_equal(snaps[0][k], snaps[1][k]) for k in snaps[0])
            print(f"listfile flickr --tau 2 in a world of one: {len(rounds)} rounds "
                  f"{[round(r, 3) for r in rounds]} ms; params and history "
                  f"{'bit for bit' if same else 'NOT bit for bit'} the plain run's [{card}]")
            check(same and len(rounds) == LF_STEPS // 2, "--tau 2 is not the plain run")
            params = {}
            for k, v in snaps[0].items():
                if k.startswith("param/"):
                    _, layer, i = k.split("/")
                    params.setdefault(layer, {})[int(i)] = v
            params = {ln: [b[i] for i in sorted(b)] for ln, b in params.items()}
            del snaps

            # pascal: train --data proto from the net's own WindowData file
            steps.clear()
            spans.clear()
            with patched(solver_mod.Solver, "train_iteration", clocked), \
                    patched(lf.WindowDataSource, "__call__", timed_source):
                lf_cli(["train", "--solver", pascal, "--data", "proto", "--iterations",
                        str(LF_PASCAL_STEPS), "--output", os.path.join(d, "pascal_final")],
                       walls)
            add(take_counts(), (2 * LF_PASCAL_STEPS, 2 * LF_PASCAL_STEPS, LF_PASCAL_STEPS),
                "pascal train")
            pascal_ms, pascal_share, pascal_call = lf_source_share(steps, spans)
            gc.collect()
            torch.cuda.empty_cache()

            # the R-CNN Detector over 2 images x 16 windows, card and CPU
            m = load_mean_file(mean)
            channel_mean = m.reshape(3, -1).mean(axis=1)
            rs = np.random.RandomState(SEED + 33)
            windows = []
            for _ in range(LF_DET_IMAGES):
                y1, x1 = rs.randint(0, 180, LF_DET_WINDOWS), rs.randint(0, 260, LF_DET_WINDOWS)
                windows.append([(a, b, min(239, a + rs.randint(30, 200)),
                                 min(319, b + rs.randint(30, 280))) for a, b in zip(y1, x1)])
            pairs = list(zip(paths["images"][:LF_DET_IMAGES], windows))
            rcnn = parse(lf_deploy("fc-rcnn", 200, prob=False))
            head = np.random.RandomState(SEED + 34)
            det_params = {ln: params[ln] for ln in params if not ln.startswith("fc8")}
            det_params["fc-rcnn"] = [(head.randn(200, 4096) * 0.01).astype(np.float32),
                                     np.zeros(200, np.float32)]
            dets = {}
            for dev in ("cuda", "cpu"):
                det = Detector(rcnn, mean=channel_mean, raw_scale=255.0,
                               channel_swap=(2, 1, 0), context_pad=16, device=dev)
                det.variables = netvars_from_numpy(det_params, device=dev)
                if dev == "cuda":
                    take_counts()
                    t0 = time.perf_counter()
                    dets[dev] = det.detect_windows(pairs)
                    det_ms = 1e3 * (time.perf_counter() - t0)
                    n_fwd = -(-LF_DET_IMAGES * LF_DET_WINDOWS // 10)
                    add(take_counts(), (2 * n_fwd, 0, 0), "Detector")
                    inputs = det.window_inputs([(p, [np.asarray(w) for w in ws])
                                                for p, ws in pairs])
                else:
                    dets[dev] = det.detect_windows(pairs)
                    same_in = np.array_equal(inputs, det.window_inputs(
                        [(p, [np.asarray(w) for w in ws]) for p, ws in pairs]))
                del det
            got = np.stack([x["prediction"] for x in dets["cuda"]])
            ref = np.stack([x["prediction"] for x in dets["cpu"]])
            det_err = float(np.abs(got - ref).max() / np.abs(ref).max())
            print(f"listfile R-CNN Detector ({LF_DET_IMAGES} images x {LF_DET_WINDOWS} windows, "
                  f"context_pad 16, fc-rcnn 200): {det_ms:.1f} ms on the card; net inputs "
                  f"{'bit for bit' if same_in else 'NOT equal to'} the CPU Detector's, scores "
                  f"{det_err:.2e} of max|ref| off its (gate {LF_DET_TOL}) [{card}]")
            check(same_in and got.shape == (LF_DET_IMAGES * LF_DET_WINDOWS, 200)
                  and np.isfinite(got).all() and det_err <= LF_DET_TOL,
                  "the card's Detector is off the CPU's")

            # classify: the flickr deploy net with the trained weights
            deploy = os.path.join(d, "flickr_deploy.prototxt")
            with open(deploy, "w") as f:
                f.write(lf_deploy("fc8_flickr", LF_CLASSES, prob=True))
            from sparknet_tpu_torch.common import Phase
            from sparknet_tpu_torch.compiler.graph import Network

            weights = export_caffemodel(Network(parse(open(deploy).read()), Phase.TEST,
                                                device="cpu"),
                                        params, os.path.join(d, "flickr.caffemodel"))
            images = paths["images"][LF_TRAIN:LF_TRAIN + LF_CLASSIFY_IMAGES]
            take_counts()
            out = json.loads(lf_cli(["classify", "--model", deploy, "--weights", weights,
                                     "--mean", mean, *images], walls).strip().splitlines()[-1])
            add(take_counts(), (2, 0, 0), "classify")
            clf = Classifier(deploy, weights, mean=channel_mean, raw_scale=255.0)
            probs = clf.predict([load_image(p) for p in images], oversample=False)
            take_counts()
            want = [[int(i) for i in np.argsort(p)[::-1][:5]] for p in probs]
            top5 = [[p["label"] for p in r["predictions"]] for r in out]
            print(f"listfile classify {LF_CLASSIFY_IMAGES} images through the flickr deploy "
                  f"net: top-5 {top5} {'equal to' if top5 == want else 'NOT'} "
                  f"Classifier.predict's on the card [{card}]")
            check(top5 == want, f"classify top-5 {top5} against Classifier.predict's {want}")
            del clf, params, det_params
            del os.environ["SPARKNET_TRAIN_LOG_DIR"]
    finally:
        torch.backends.cudnn.deterministic = prev
        set_config(fused_update=False)
    print(f"listfile: flickr ImageData step (CaffeNet b{LF_BATCH}, --data auto) {flickr_ms:.2f} "
          f"ms, {100 * host_share:.1f}% of it waiting on the host's decode and transform, "
          f"{100 * call_share:.1f}% in train_iteration's call, beside the fixed-batch step "
          f"{fixed_ms:.2f} ms; --tau 2 rounds after the first {np.median(rounds[1:]):.2f} ms "
          f"(median; all {[round(r, 2) for r in rounds]}); pascal WindowData step "
          f"(b{LF_PASCAL_BATCH}, --data proto) {pascal_ms:.2f} ms, {100 * pascal_share:.1f}% "
          f"of it in the window source, {100 * pascal_call:.1f}% in train_iteration's call "
          f"[{card}]")
    print(f"listfile: data written in {t_data:.1f} s; cli seconds: "
          + ", ".join(f"{k} {s:.1f}" for k, s in walls))
    print(f"listfile: launches (lrn fwd, lrn bwd, fused) {tuple(total)}; phase done in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(lrn=total[0], lrn_backward=total[1], fused_update=total[2])


# ---------------------------------------------------------------------------
# Sequence parallelism, MoE and the GPipe schedule over four gloo ranks
# ---------------------------------------------------------------------------

SP_POOL = 4
SP_STEPS = 3  # checked steps a run, each against a lone Solver step from its state
SP_TIMED = 5  # timed steps a run, after the checked ones
SP_IMPLS = ("ring", "ulysses")
SP_MOE = (4096, 64, 4, 256)  # tokens, D, experts, hidden
SP_PIPE = (4, 64, 8, 32)  # stages, D, microbatches, rows a microbatch
SP_MOE_TOL = 1e-5  # of max|dense|: the sharded layer and the dispatch against the dense
SP_BLOCKS = (  # (label, shape, causal): B3/B3' at the shapes the two impls give them
    ("ring block", (32, 4, 32, 16), False),
    ("ring diagonal block", (32, 4, 32, 16), True),
    ("Ulysses head group", (32, 1, 128, 16), True),
)


def sp_batches() -> list:
    """The char LM's batches of this checkout's docs: the checked steps'
    and the timed steps'."""
    from sparknet_tpu_torch.data import char_lm_batches

    text, vocab = charlm_text()
    feed = char_lm_batches(text, vocab, CHARLM["slots"], CHARLM["seq_len"], seed=SEED + 19)
    return [next(feed) for _ in range(SP_STEPS + SP_TIMED)]


def sp_solver():
    """The full-width char LM's Solver on the card (charlm_solver: Adam,
    fused update, f32), weights from SEED."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.solvers.solver import Solver

    geo = {k: v for k, v in CHARLM.items() if k != "slots"}
    cfg = dataclasses.replace(models.charlm_solver(), random_seed=SEED, display=0)
    return Solver(cfg, models.charlm(batch=CHARLM["slots"], **geo))


def sp_arenas(solver) -> list:
    return [a.detach().clone().cpu() for a in (solver._param_arena, *solver._slot_arenas)]


def sp_host_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` over ``reps`` synchronised calls after one."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def sp_p2p_probe(rank: int, work: str) -> None:
    """gloo's answer for point-to-point on CUDA tensors: one hop between
    two ranks on cuda:0 (a rank that aborts is the answer)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{work}/p2p_store", 2),
                            rank=rank, world_size=2)
    x = torch.full((4,), float(rank), device="cuda")
    got = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                   dist.P2POp(dist.irecv, got, 1 - rank)])
    for r in reqs:
        r.wait()
    torch.cuda.synchronize()
    with open(f"{work}/p2p{rank}.json", "w") as f:
        json.dump(bool(torch.equal(got, torch.full_like(x, float(1 - rank)))), f)
    dist.destroy_process_group()


def sp_worker(rank: int, work: str) -> None:
    """One rank of the pool: gloo, every rank on cuda:0, joined through a
    FileStore in ``work``.  gloo's all-to-all and the host-staged ring hop
    on CUDA tensors with their values; the full-width char LM trained
    SP_STEPS checked and SP_TIMED timed steps under ring and under Ulysses
    over a seq axis of 4 (rank 0 saves the arenas before and after each
    checked step for the parent's oracle); the collectives timed alone;
    the MoE layer over a model axis of 4, the expert dispatch and the
    pipeline against their oracles.  Writes its results into ``work``.
    Spawned by ``phase_seq_parallel`` (start method spawn)."""
    import torch.distributed as dist

    from sparknet_tpu_torch.common import f32_precision, set_config
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.ops.moe import moe_dense, moe_model_parallel
    from sparknet_tpu_torch.parallel import (
        ParallelTrainer,
        ShardingRules,
        auto_mesh,
        collectives,
        expert_parallel_moe,
        initialize_distributed,
        pipeline_blocks,
        process_mesh,
        sequential_blocks,
        stack_stage_params,
    )

    torch.cuda.set_device(0)
    set_config(fused_update=True, storage_dtype="f32")
    initialize_distributed(backend="gloo", store_path=f"{work}/store", rank=rank,
                           world_size=SP_POOL)
    res: dict = {}
    try:
        mesh = auto_mesh(seq_parallel=SP_POOL, device="cuda")
        seq = mesh.comm("seq")
        res["host_staged"] = sorted(seq.host_staged)
        n = SP_POOL
        x = (torch.arange(4 * n, device="cuda", dtype=torch.float32) + 100 * rank).view(n, 4)
        want = torch.stack([torch.arange(4, device="cuda") + 4 * rank + 100 * j
                            for j in range(n)]).float()
        res["a2a_ok"] = bool(torch.equal(collectives.all_to_all(x, 0, 0, seq), want.view(-1, 4)))
        (hop,) = collectives.ring_shift([x], seq)
        res["hop_ok"] = bool(torch.equal(hop, x - 100 * rank + 100 * ((rank - 1) % n)))

        batches = sp_batches()
        for impl in SP_IMPLS:
            solver = sp_solver()
            tr = ParallelTrainer(solver, mesh=mesh, rules=ShardingRules(attention_impl=impl))
            rows = []
            for step in range(SP_STEPS):
                if rank == 0:
                    torch.save(sp_arenas(solver), f"{work}/{impl}{step}_pre.pt")
                dist.barrier()
                kernels.reset_launch_counts()
                collectives.reset_staged_counts()
                loss = tr.train_round(lambda it: batches[it])
                rows.append(dict(loss=loss, counts=[
                    kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
                    kernels.FUSED_UPDATE_LAUNCHES], staged=[
                    collectives.STAGED_CALLS, collectives.STAGED_BYTES]))
                if rank == 0:
                    torch.save(sp_arenas(solver), f"{work}/{impl}{step}_post.pt")
            dist.barrier()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(SP_TIMED):
                tr.train_round(lambda it: batches[it])
            torch.cuda.synchronize()
            res[impl] = dict(rows=rows, ms=1e3 * (time.perf_counter() - t0) / SP_TIMED,
                             timed=[kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
                                    kernels.FUSED_UPDATE_LAUNCHES])
            tr.close()
            del tr, solver
        # the collectives alone: Ulysses' all-to-all of q, k, v and one ring
        # hop of a K/V block pair (host-staged)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 29 + rank)
        qkv = torch.randn((3, 32, 4, 32, 16), generator=gen, device="cuda")
        kv = [torch.randn((32, 4, 32, 16), generator=gen, device="cuda") for _ in range(2)]

        def aligned(fn):
            def run():
                dist.barrier()
                fn()
            return run

        res["a2a_ms"] = sp_host_ms(aligned(lambda: collectives.all_to_all(qkv, 2, 3, seq)))
        res["hop_ms"] = sp_host_ms(aligned(lambda: collectives.ring_shift(kv, seq)))
        res["barrier_ms"] = sp_host_ms(aligned(lambda: None))

        # MoE over a model axis of 4, the expert dispatch, the pipeline
        tokens, d, e, h = SP_MOE
        gen = torch.Generator(device="cuda").manual_seed(SEED + 31)  # the same on every rank
        params = [torch.randn(s, generator=gen, device="cuda") * c for s, c in (
            ((e, d), 0.5), ((e, h, d), 0.1), ((e, h), 0.1), ((e, d, h), 0.1), ((e, d), 0.1))]
        xm = torch.randn((tokens, d), generator=gen, device="cuda")
        model = auto_mesh(model_parallel=SP_POOL, device="cuda").comm("model")
        emesh = process_mesh({"expert": SP_POOL}, device="cuda")
        smesh = process_mesh({"stage": SP_POOL}, device="cuda")
        with f32_precision():
            dense = moe_dense(params, xm)
            mine = [p[model.rank:model.rank + 1] for p in params]
            y = moe_model_parallel(mine, xm, model)
            full = expert_parallel_moe(emesh, params, xm, capacity_factor=float(e))
            tight = expert_parallel_moe(emesh, params, xm, capacity_factor=1.0)
            kept = ~torch.all(tight == 0, dim=1)
            res["moe"] = dict(
                scale=float(dense.abs().max()), layer=float((y - dense).abs().max()),
                dispatch=float((full - dense).abs().max()),
                tight=float((tight[kept] - dense[kept]).abs().max()),
                dropped=int((~kept).sum()),
                layer_ms=sp_host_ms(aligned(lambda: moe_model_parallel(mine, xm, model))),
                dense_ms=sp_host_ms(lambda: moe_dense(params, xm)),
                dispatch_ms=sp_host_ms(aligned(lambda: expert_parallel_moe(
                    emesh, params, xm, capacity_factor=1.0))))
            stages, pd, micro, rows_ = SP_PIPE
            stacked = stack_stage_params([
                {"w": torch.randn((pd, pd), generator=gen, device="cuda") / pd ** 0.5,
                 "b": torch.randn((pd,), generator=gen, device="cuda") * 0.1}
                for _ in range(stages)])
            xp = torch.randn((micro, rows_, pd), generator=gen, device="cuda")

            def block(p, a):
                return torch.tanh(a @ p["w"] + p["b"])

            pipe = pipeline_blocks(smesh, block, stacked, xp)
            ref = sequential_blocks(block, stacked, xp)
            res["pipe"] = dict(err=float((pipe - ref).abs().max()),
                               ms=sp_host_ms(aligned(lambda: pipeline_blocks(
                                   smesh, block, stacked, xp))))
        with open(f"{work}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def sp_blob_close(got, want, layout, base_lr: float) -> tuple[bool, float]:
    """The char LM's one-step Adam gate (``charlm_compare``'s), blob by blob
    of two param arenas: rtol 1e-4, atol 1e-5 x the blob's max|want| + 1e-2
    x base_lr."""
    ok, worst = True, 0.0
    for ent in layout.entries:
        a = got[ent.offset:ent.offset + ent.size]
        b = want[ent.offset:ent.offset + ent.size]
        atol = 1e-5 * float(b.abs().max()) + 1e-2 * base_lr
        ok = ok and bool(torch.allclose(a, b, rtol=1e-4, atol=atol))
        worst = max(worst, float((a - b).abs().max()))
    return ok, worst


def sp_kernel_blocks(card: str) -> dict:
    """B3 (with lse) and B3' at the blocks the ring and Ulysses give them,
    against their plain versions at the attention gates, timed by CUDA
    graph beside the plain versions, SDPA and the bound."""
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    out = {}
    with f32_precision():
        for label, shape, causal in SP_BLOCKS:
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            o, lse = kernels._flash_attention_cuda(q, k, v, causal, with_lse=True)
            o_ref, lse_ref = kernels.flash_attention_forward_lse_torch(q, k, v, causal)
            got = kernels._flash_attention_backward_cuda(q, k, v, o, lse, g, causal)
            ref = kernels.flash_attention_backward_torch(q, k, v, o, lse, g, causal)
            torch.cuda.synchronize()
            o_ok, o_err = attention_within(o, o_ref, 1e-6)
            lse_ok, lse_err = attention_within(lse, lse_ref, 1e-5)
            oks, errs, _ = zip(*(grads_within(a, r, 1e-5, 1e-6) for a, r in zip(got, ref)))
            print(f"seq_parallel: B3 at the {label} {list(shape)} causal {int(causal)}: o max "
                  f"abs err {o_err:.3e} (rtol 1e-5, atol 1e-6) {'ok' if o_ok else 'FAIL'}, lse "
                  f"{lse_err:.3e} (1e-5) {'ok' if lse_ok else 'FAIL'}; B3' dq {errs[0]:.3e} "
                  f"dk {errs[1]:.3e} dv {errs[2]:.3e} (rtol 1e-5, atol 1e-6 x max|ref|) "
                  f"{'ok' if all(oks) else 'FAIL'}")
            check(o_ok and lse_ok and all(oks), f"seq_parallel: the kernels at the {label}")
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

            def sdpa_forward():
                return F.scaled_dot_product_attention(*leaves, is_causal=causal)

            def sdpa_both():
                return torch.autograd.grad(sdpa_forward(), leaves, g)

            t = dict(
                fwd=graph_ms(lambda: kernels._flash_attention_cuda(q, k, v, causal, True)),
                fwd_plain=graph_ms(lambda: kernels.flash_attention_forward_lse_torch(
                    q, k, v, causal)),
                fwd_lib=graph_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)),
                bwd=graph_ms(lambda: kernels._flash_attention_backward_cuda(
                    q, k, v, o, lse, g, causal)),
                bwd_plain=graph_ms(lambda: kernels.flash_attention_backward_torch(
                    q, k, v, o, lse, g, causal)))
            try:
                t["bwd_lib"] = graph_ms(sdpa_both) - graph_ms(sdpa_forward)
            except RuntimeError as err:  # a backward that will not capture
                print(f"seq_parallel {label}: SDPA's backward not timed by CUDA graph "
                      f"({str(err)[:120]}); events over back-to-back calls instead")
                torch.cuda.synchronize()
                t["bwd_lib"] = time_ms(sdpa_both) - time_ms(sdpa_forward)
            fb, fby = flash_bound_ms(shape, causal, card)
            bb, bby = flash_backward_bound_ms(shape, causal, card)
            print(f"time seq_parallel {label} {list(shape)} causal {int(causal)} (CUDA graph): "
                  f"B3 with lse {t['fwd']:.4f} ms ({100 * fb / t['fwd']:.1f}% of bound "
                  f"{fb:.5f} ms, {fby}), plain {t['fwd_plain']:.4f} ms, "
                  f"F.scaled_dot_product_attention {t['fwd_lib']:.4f} ms; B3' {t['bwd']:.4f} "
                  f"ms ({100 * bb / t['bwd']:.1f}% of bound {bb:.5f} ms, {bby}), plain (float64) "
                  f"{t['bwd_plain']:.4f} ms, SDPA's autograd backward {t['bwd_lib']:.4f} ms "
                  f"[{card}]")
            out[label] = dict(t, fwd_bound=fb, bwd_bound=bb,
                              max_abs_err=max(o_err, *errs))
            del leaves
    return out


def phase_seq_parallel(card: str) -> dict:
    """Sequence parallelism, MoE and the GPipe schedule: gloo's answers on
    CUDA tensors, then a pool of four gloo ranks on cuda:0 trains the
    full-width char LM over a seq axis of 4 under ring and Ulysses
    attention, each checked step held against a lone Solver step from the
    same state, with exact launches; the MoE layer, the expert dispatch and
    the pipeline against their oracles; B3 and B3' at the blocks the two
    impls give them."""
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.parallel.collectives import GLOO_CUDA_HOST_STAGED

    t_phase = time.perf_counter()
    counts = [0, 0, 0]
    set_config(fused_update=True, storage_dtype="f32")
    try:
        with tempfile.TemporaryDirectory(prefix="sparknet_sp_") as work:
            probe = mp.start_processes(sp_p2p_probe, args=(work,), nprocs=2, join=False,
                                       start_method="spawn")
            pool = mp.start_processes(sp_worker, args=(work,), nprocs=SP_POOL, join=False,
                                      start_method="spawn")
            try:
                while not probe.join():
                    pass
                p2p = "takes them: both ranks received the other's values " + str(
                    [json.load(open(f"{work}/p2p{r}.json")) for r in range(2)])
            except ProcessException as err:  # a rank raised, or aborted
                p2p = f"refuses them: {str(err).strip().splitlines()[-1]}"
            while not pool.join():
                pass
            ranks = []
            for r in range(SP_POOL):
                with open(f"{work}/rank{r}.json") as f:
                    ranks.append(json.load(f))
            r0 = ranks[0]
            print(f"seq_parallel: gloo and CUDA tensors (torch {torch.__version__}): "
                  f"all_to_all_single {'exact' if all(x['a2a_ok'] for x in ranks) else 'WRONG'} "
                  f"on every rank; batch_isend_irecv {p2p}; the port stages "
                  f"{sorted(GLOO_CUDA_HOST_STAGED)} through pinned host buffers, the ring's "
                  f"hop {'exact' if all(x['hop_ok'] for x in ranks) else 'WRONG'}")
            check(all(x["a2a_ok"] and x["hop_ok"] for x in ranks),
                  "seq_parallel: a collective on CUDA tensors gave wrong values")
            check(r0["host_staged"] == sorted(GLOO_CUDA_HOST_STAGED),
                  f"seq_parallel: the seq group stages {r0['host_staged']}")

            batches = sp_batches()
            solver = sp_solver()
            base_lr = solver.config.base_lr
            tokens = CHARLM["slots"] * CHARLM["seq_len"]
            for impl in SP_IMPLS:
                for step in range(SP_STEPS):
                    pre = torch.load(f"{work}/{impl}{step}_pre.pt")
                    post = torch.load(f"{work}/{impl}{step}_post.pt")
                    with torch.no_grad():
                        for a, b in zip((solver._param_arena, *solver._slot_arenas), pre):
                            a.copy_(b)
                    solver.iter = step
                    want = float(solver.train_iteration(batches[step]))
                    got = r0[impl]["rows"][step]["loss"]
                    loss_ok = abs(got - want) <= 1e-4 * abs(want)
                    ok, worst = sp_blob_close(post[0].cuda(), solver._param_arena,
                                              solver.layout, base_lr)
                    rows = [x[impl]["rows"][step] for x in ranks]
                    per_rank = [row["counts"] for row in rows]
                    expect = [[2 * (r + 1), 2 * (r + 1), 1] if impl == "ring" else [2, 2, 1]
                              for r in range(SP_POOL)]
                    print(f"seq_parallel: {impl} step {step} over 4 ranks against a lone Solver "
                          f"step from the same params and history: loss {got:.6f} / {want:.6f} "
                          f"(rtol 1e-4) {'ok' if loss_ok else 'FAIL'}; params max abs diff "
                          f"{worst:.3e} (rtol 1e-4, atol 1e-5 x max + 1e-2 x base_lr) "
                          f"{'ok' if ok else 'FAIL'}; launches (B3, B3', B2) by rank "
                          f"{per_rank}; host-staged hops by rank "
                          f"{[row['staged'][0] for row in rows]} ({rows[0]['staged'][1]} bytes "
                          f"on rank 0) [{card}]")
                    check(loss_ok and ok, f"seq_parallel: {impl} step {step} differs from the "
                                          "lone Solver step")
                    check(per_rank == expect, f"seq_parallel: {impl} launches {per_rank}, "
                                              f"want {expect}")
                    counts = [c + sum(rc[i] for rc in per_rank) for i, c in enumerate(counts)]
                timed = [x[impl]["timed"] for x in ranks]
                counts = [c + sum(t[i] for t in timed) for i, c in enumerate(counts)]
                ms = max(x[impl]["ms"] for x in ranks)
                print(f"seq_parallel: {impl}, {SP_TIMED} timed steps: {ms:.3f} ms/step "
                      f"({tokens / ms * 1e3:.1f} tokens/s; 4 gloo ranks share one card: this "
                      f"measures gloo and the host, not scaling), launches by rank {timed} "
                      f"[{card}]")
            kernels.reset_launch_counts()
            one_ms = sp_host_ms(lambda: solver.train_iteration(batches[0]))
            kernels.reset_launch_counts()
            print(f"seq_parallel: a lone Solver step of the same net and batch: "
                  f"{one_ms:.3f} ms/step ({tokens / one_ms * 1e3:.1f} tokens/s) [{card}]")
            print(f"seq_parallel: collectives alone (host clock, median of 5, after a "
                  f"barrier of {r0['barrier_ms']:.3f} ms): Ulysses' all-to-all of q, k, v "
                  f"[3,32,4,32,16] {r0['a2a_ms']:.3f} ms, one ring hop of a K/V block pair "
                  f"2 x [32,4,32,16] (host-staged) {r0['hop_ms']:.3f} ms [{card}]")
            m = r0["moe"]
            moe_ok = max(m["layer"], m["dispatch"], m["tight"]) <= SP_MOE_TOL * m["scale"]
            print(f"seq_parallel: MoE [{SP_MOE[0]}, {SP_MOE[1]}] tokens, E {SP_MOE[2]}, H "
                  f"{SP_MOE[3]}: the layer with one expert a rank over a model axis of 4 "
                  f"against the dense layer, max abs diff {m['layer']:.3e}; "
                  f"expert_parallel_moe at capacity E {m['dispatch']:.3e}, at 1.0 "
                  f"{m['tight']:.3e} on the kept rows ({m['dropped']} dropped) (gate "
                  f"{SP_MOE_TOL:g} x max|dense| = {SP_MOE_TOL * m['scale']:.3e}) "
                  f"{'ok' if moe_ok else 'FAIL'}; ms: the sharded layer {m['layer_ms']:.3f}, "
                  f"dense {m['dense_ms']:.3f}, dispatch {m['dispatch_ms']:.3f} [{card}]")
            check(moe_ok, "seq_parallel: MoE differs from the dense layer")
            pe = max(x["pipe"]["err"] for x in ranks)
            print(f"seq_parallel: pipeline_blocks S {SP_PIPE[0]}, D {SP_PIPE[1]}, M "
                  f"{SP_PIPE[2]} x [{SP_PIPE[3]}, {SP_PIPE[1]}] against sequential_blocks on "
                  f"every rank: max abs diff {pe:.3e} (1e-5) {'ok' if pe <= 1e-5 else 'FAIL'}, "
                  f"{r0['pipe']['ms']:.3f} ms [{card}]")
            check(pe <= 1e-5, "seq_parallel: the pipeline differs from the sequential blocks")
            del solver
        blocks = sp_kernel_blocks(card)
    finally:
        set_config(fused_update=False)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"seq_parallel: phase done in {time.perf_counter() - t_phase:.1f} s")
    return dict(flash=counts[0], flash_backward=counts[1], fused_update=counts[2],
                blocks=blocks)


# ---------------------------------------------------------------------------
# The train-to-serve production loop and its obs journal
# ---------------------------------------------------------------------------

LOOP_BATCH = 100  # cifar10_quick's published batch, a worker
LOOP_TAU = 2
LOOP_ROUNDS = 2  # elastic rounds a rollout
LOOP_ITERS = 2  # train -> checkpoint -> rollout cycles of the cifar10_quick run
LOOP_TOKEN_BATCH = 32  # the transformer family's batch a worker
LOOP_REQUESTS = 48
LOOP_LATENCY_S = 1.0  # seconds of traffic before the first rollout
LOOP_ROLLOUTS = 8  # rollouts under traffic, so a phase's p99 rests on hundreds of requests
LOOP_AFTER_S = 0.25  # seconds of traffic after each rollout
LOOP_GAP_S = 0.002  # the client's pause between two requests


def loop_counts() -> dict:
    from sparknet_tpu_torch.ops import kernels

    return {"lrn": kernels.LRN_LAUNCHES, "lrn_backward": kernels.LRN_BACKWARD_LAUNCHES,
            "fused_update": kernels.FUSED_UPDATE_LAUNCHES, "flash": kernels.FLASH_LAUNCHES,
            "flash_backward": kernels.FLASH_BACKWARD_LAUNCHES,
            "paged": kernels.PAGED_LAUNCHES}


def loop_journal_gates(card: str, path: str, label: str) -> list:
    """The journal validates under the port's validator and its lineage
    audit finds no dangling parent; returns its events."""
    from sparknet_tpu_torch.obs import lineage, schema

    n, _, errors = schema.validate_journal(path)
    audit = lineage.audit(schema.stream_journal(path))
    print(f"loop {label}: journal of {n} lines, {len(errors)} schema finding(s); lineage "
          f"{audit['spans']} spans, {audit['edges']} edges, {audit['requests_linked']} "
          f"requests linked, dangling {audit['dangling'][:3]}")
    check(n > 0 and not errors, f"loop {label}: the journal fails validation: {errors[:3]}")
    check(not audit["dangling"], f"loop {label}: dangling lineage {audit['dangling'][:3]}")
    return schema.load_journal(path)


def loop_gates(label: str, s: dict) -> None:
    gates = {k: s[k] for k in ("ok", "serve_path_compiles", "serving_thread_captures",
                               "dropped", "swap_drained", "rollback_drained",
                               "scores_changed", "scores_restored", "refused",
                               "incumbent_intact_after_refusal")}
    print(f"loop {label}: gates {gates}; {s['requests']} requests, {s['rounds']} rounds, "
          f"{s['rollouts']} rollout(s), {s['replays']} replays, {s['captures']} captures "
          f"(the builder's: {s['rollout']['captures']} the last rollout), loss "
          f"{s['loss']:.6f}, {s['wall_s']:.1f} s")
    check(s["ok"] and s["serve_path_compiles"] == 0 and s["serving_thread_captures"] == 0,
          f"loop {label}: a gate failed: {gates}")


def loop_run_counted(**kw) -> tuple[dict, dict]:
    """``loop_run`` on the card with every launch count set to 0 just before
    it; returns the summary and the counts just after."""
    from sparknet_tpu_torch.loop.dryrun import loop_run
    from sparknet_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    summary = loop_run(device="cuda", **kw)
    torch.cuda.synchronize()
    return summary, loop_counts()


def loop_cifar(card: str, work: str) -> dict:
    """cifar10_quick at batch 100, a world of one (NCCL), obs on then off:
    the gates, B2's launches against the steps, the journal, and obs off
    bit for bit obs on with the same launches."""
    import glob

    from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS

    kw = dict(family="cifar10_quick", iterations=LOOP_ITERS, rounds_per_rollout=LOOP_ROUNDS,
              per_worker_batch=LOOP_BATCH, tau=LOOP_TAU, buckets=SERVE_BUCKETS,
              requests=LOOP_REQUESTS)
    runs = {}
    for armed in (True, False):
        path = f"{work}/cifar.jsonl"
        rec = set_recorder(Recorder(path if armed else None))
        t0 = time.perf_counter()
        try:
            s, counts = loop_run_counted(workdir=f"{work}/cifar_{int(armed)}", **kw)
        finally:
            rec.close()
            set_recorder(None)
        wall = time.perf_counter() - t0
        label = f"cifar10_quick b{LOOP_BATCH} obs {'on' if armed else 'off'}"
        loop_gates(label, s)
        steps = LOOP_ITERS * LOOP_ROUNDS * LOOP_TAU
        print(f"loop {label}: launches {counts} ({steps} steps), {wall:.1f} s [{card}]")
        check(counts["fused_update"] == steps,
              f"loop {label}: B2 launched {counts['fused_update']} times for {steps} steps")
        check(s["rollout"]["captures"] == len(SERVE_BUCKETS),
              f"loop {label}: the builder captured {s['rollout']['captures']} graphs")
        last = sorted(glob.glob(f"{work}/cifar_{int(armed)}/*.solverstate.npz"))[-1]
        with np.load(last) as data:
            runs[armed] = (counts, {k: data[k] for k in data.files})
        if armed:
            loop_journal_print(card, loop_journal_gates(card, path, label))
    (c_on, a_on), (c_off, a_off) = runs[True], runs[False]
    same = sorted(a_on) == sorted(a_off) and all(np.array_equal(a_on[k], a_off[k])
                                                 for k in a_on)
    print(f"loop: obs off against obs on: launches {c_off} against {c_on}; the last "
          f"checkpoint's {len(a_on)} arrays {'bit for bit equal' if same else 'DIFFER'}")
    check(same and c_on == c_off, "loop: obs off is not obs on")
    return {k: c_on[k] + c_off[k] for k in c_on}


def loop_journal_print(card: str, events: list) -> None:
    """The walls the journal holds: rounds, the atomic save, the candidate's
    build and captures, the swap and what it drained."""
    rounds = [e["wall_s"] * 1e3 for e in events if e["event"] == "round"]
    ckpt = [e["wall_s"] * 1e3 for e in events
            if e["event"] == "loop" and e["kind"] == "checkpoint"]
    built = [(e["wall_s"] * 1e3, len(e["buckets"])) for e in events
             if e["event"] == "serve" and e["kind"] == "candidate_built"]
    swaps = [(e["wall_s"] * 1e3, e["drained"]) for e in events
             if e["event"] == "serve" and e["kind"] == "rollout"]
    print(f"loop journal: round walls (fenced on the round's loss) "
          f"{[round(x, 2) for x in rounds]} ms; sync_to_solver + Solver.save "
          f"{[round(x, 2) for x in ckpt]} ms; candidate builds (ms, graphs captured) "
          f"{[(round(a, 1), b) for a, b in built]}; swaps (ms, drained) "
          f"{[(round(a, 2), b) for a, b in swaps]} [{card}]")


def loop_latency(card: str, work: str) -> dict:
    """Serving latency before, during and after rollouts: a pump thread
    (``serve_forever``) and a client thread serve cifar10_quick while the
    main thread, ``LOOP_ROLLOUTS`` times, trains two rounds, checkpoints and
    rolls the candidate out (captured on the builder thread).  The Python
    collector's pauses are timed beside the slowest request.  Returns the
    launch counts."""
    import threading

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.loop import ProductionLoop, synthetic_shard_feed
    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS, ServeEngine, percentile
    from sparknet_tpu_torch.serve.loadgen import synthetic_items
    from sparknet_tpu_torch.solvers.solver import Solver

    fam = GRAPH_SWEEP_FAMILIES["cifar10_quick"]
    engine = ServeEngine(buckets=SERVE_BUCKETS, device="cuda")
    loop = ProductionLoop(Solver(models.cifar10_quick_solver(), models.cifar10_quick(LOOP_BATCH),
                                 device="cuda"), engine,
                          synthetic_shard_feed(fam, LOOP_BATCH, seed=1), workdir=f"{work}/lat",
                          buckets=SERVE_BUCKETS, tau=LOOP_TAU)
    gc_spans: list = []  # (start, end, generation) on the engine's clock
    gc_start = [0.0]

    def on_gc(stage: str, info: dict) -> None:
        if stage == "start":
            gc_start[0] = time.monotonic()
        else:
            gc_spans.append((gc_start[0], time.monotonic(), info["generation"]))

    kernels.reset_launch_counts()
    try:
        model = loop.ensure_serving()
        rs = np.random.RandomState(SEED + 41)
        items = synthetic_items(model, 64, rs)
        for b in SERVE_BUCKETS:
            for item in items[:max(1, b // 2)]:
                engine.submit("live", item)
            engine.pump(force=True)
        compiles0 = engine.serve_path_compiles
        phase = ["before"]
        tickets: list = []
        infos: list = []
        stop = threading.Event()
        pump = threading.Thread(target=engine.serve_forever, kwargs={"until": stop.is_set},
                                daemon=True)

        def client():
            i = 0
            while not stop.is_set():
                tickets.append((phase[0], engine.submit("live", items[i % len(items)])))
                i += 1
                time.sleep(LOOP_GAP_S)

        feeder = threading.Thread(target=client, daemon=True)
        gc.callbacks.append(on_gc)
        pump.start()
        feeder.start()
        try:
            time.sleep(LOOP_LATENCY_S)
            for _ in range(LOOP_ROLLOUTS):
                phase[0] = "training"
                loop.trainer.train(LOOP_ROUNDS, loop.data_fn)
                path = loop.checkpoint()
                phase[0] = "rollout"
                t0 = time.perf_counter()
                info = loop.rollout(path)
                infos.append((time.perf_counter() - t0, info))
                phase[0] = "after"
                time.sleep(LOOP_AFTER_S)
        finally:
            stop.set()
            feeder.join(timeout=30.0)
            pump.join(timeout=30.0)
            gc.callbacks.remove(on_gc)
        engine.shutdown()
        for _, t in tickets:
            t.wait(timeout=60.0)
        torch.cuda.synchronize()
        dropped = sum(not t.done() for _, t in tickets)
        lat, split = {}, {}
        for tag in ("before", "training", "rollout", "after"):
            done = [t for p, t in tickets if p == tag and t.done()]
            ms = [(t.t_done - t.t_submit) * 1e3 for t in done]
            lat[tag] = (len(ms), percentile(ms, 50), percentile(ms, 99), max(ms, default=0.0))
            # the wait for a batch (the pump thread) against the batch's run
            # (copy in, replay, copy out)
            split[tag] = (percentile([(t.t_batch - t.t_submit) * 1e3 for t in done], 99),
                          percentile([(t.t_done - t.t_batch) * 1e3 for t in done], 99))
        worst_tag, worst = max(((p, t) for p, t in tickets if t.done()),
                               key=lambda pt: pt[1].t_done - pt[1].t_submit)
        overlap = [(b - a) * 1e3 for a, b, g in gc_spans
                   if a < worst.t_done and b > worst.t_submit]
        gen2 = [(b - a) * 1e3 for a, b, g in gc_spans if g == 2]
        captured = engine.serve_path_compiles - compiles0
        walls = [w * 1e3 for w, _ in infos]
        builds = [i["build_s"] * 1e3 for _, i in infos]
        swaps = [i["swap_wall_s"] * 1e3 for _, i in infos]
        print(f"loop latency (host clock, submit to result, requests every "
              f"{LOOP_GAP_S * 1e3:.0f} ms while a pump thread serves, {LOOP_ROLLOUTS} "
              f"rollouts): "
              + "; ".join(f"{tag} {n} requests p50 {p50:.2f} ms p99 {p99:.2f} ms max "
                          f"{top:.2f} ms" for tag, (n, p50, p99, top) in lat.items())
              + f"; rollouts {min(walls):.1f}-{max(walls):.1f} ms (builds "
              f"{min(builds):.1f}-{max(builds):.1f} ms, {infos[-1][1]['captures']} graphs "
              f"each captured on the builder thread; swaps {min(swaps):.2f}-{max(swaps):.2f} "
              f"ms, {sum(i['drained'] for _, i in infos)} drained); {captured} captures on "
              f"the request path, {dropped} dropped [{card}]")
        print(f"loop latency: the slowest request ({worst_tag}) "
              f"{(worst.t_done - worst.t_submit) * 1e3:.2f} ms overlapped {len(overlap)} of "
              f"{len(gc_spans)} collector pauses ({sum(overlap):.2f} ms of them); the "
              f"longest generation-2 pause {max(gen2, default=0.0):.2f} ms of {len(gen2)}; "
              f"p99 of the wait for a batch / of the batch's run: "
              + "; ".join(f"{tag} {q:.2f} / {r:.2f} ms" for tag, (q, r) in split.items())
              + f" [{card}]")
        check(captured == 0 and dropped == 0 and lat["rollout"][0] > 0,
              f"loop latency: {captured} request-path captures, {dropped} dropped, "
              f"{lat['rollout'][0]} requests during the rollouts")
        counts = loop_counts()
        steps = LOOP_ROLLOUTS * LOOP_ROUNDS * LOOP_TAU
        check(counts["fused_update"] == steps,
              f"loop latency: B2 launched {counts['fused_update']} times for {steps} steps")
        return counts
    finally:
        loop.close()


def loop_cli(card: str, work: str) -> dict:
    """``tpunet loop`` in process, as a user calls it, with ``--obs``:
    cifar10_quick at batch 100 over the serving buckets, two iterations, the
    fused update on (the phase's config; ``SPARKNET_FUSED_UPDATE=1`` seeds it
    in a fresh process).  Exit 0, B2's launches against the steps, the
    summary's gates and the journal.  The environment's ``SPARKNET_OBS`` is
    put back after."""
    import io
    import os

    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.obs.recorder import get_recorder, rebuild_from_env
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS

    path, iters = f"{work}/cli.jsonl", 2
    argv = ["--obs", path, "loop", "--batch", str(LOOP_BATCH), "--iterations", str(iters),
            "--rounds", str(LOOP_ROUNDS), "--tau", str(LOOP_TAU),
            "--buckets", ",".join(str(b) for b in SERVE_BUCKETS),
            "--requests", str(LOOP_REQUESTS), "--workdir", f"{work}/cli"]
    prev = os.environ.get("SPARKNET_OBS")
    out = io.StringIO()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        counts = loop_counts()
        get_recorder().close()
    finally:
        if prev is None:
            os.environ.pop("SPARKNET_OBS", None)
        else:
            os.environ["SPARKNET_OBS"] = prev
        rebuild_from_env()
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and lines, f"loop cli: exit {rc}, stdout {lines[-3:]}")
    s = json.loads(lines[-1])  # the summary; a solver's display lines come before it
    loop_gates(f"cli b{LOOP_BATCH} x{iters}", s)
    steps = iters * LOOP_ROUNDS * LOOP_TAU
    print(f"loop cli: exit {rc}, launches {counts} ({steps} steps), "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(counts["fused_update"] == steps,
          f"loop cli: B2 launched {counts['fused_update']} times for {steps} steps")
    events = loop_journal_gates(card, path, "cli")
    check(sum(e["event"] == "round" for e in events) == iters * LOOP_ROUNDS,
          "loop cli: the journal's round records")
    return counts


def loop_transformer(card: str) -> dict:
    """The transformer family, one iteration: the gates, and B3's and B3''s
    launches against the engine's replays and captures and the steps."""
    from sparknet_tpu_torch.common import Phase
    from sparknet_tpu_torch.compiler.graph import Network
    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
    from sparknet_tpu_torch.ops.attention import MultiHeadAttentionLayer
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS
    from sparknet_tpu_torch.serve.graphs import WARMUP_FORWARDS

    fam = GRAPH_SWEEP_FAMILIES["transformer"]
    layers = sum(isinstance(layer, MultiHeadAttentionLayer)
                 for layer in Network(fam.net(2), Phase.TEST, device="cuda").layers)
    s, counts = loop_run_counted(family="transformer", iterations=1,
                                 rounds_per_rollout=LOOP_ROUNDS,
                                 per_worker_batch=LOOP_TOKEN_BATCH, tau=LOOP_TAU,
                                 buckets=SERVE_BUCKETS, requests=LOOP_REQUESTS)
    loop_gates(f"transformer b{LOOP_TOKEN_BATCH}", s)
    steps = LOOP_ROUNDS * LOOP_TAU
    want = layers * (s["replays"] + WARMUP_FORWARDS * s["captures"] + steps)
    print(f"loop transformer: launches {counts}; {layers} attention layer(s) x "
          f"({s['replays']} replays + {WARMUP_FORWARDS} x {s['captures']} capture warm-ups "
          f"+ {steps} training forwards) = {want} B3, {layers} x {steps} = {layers * steps} "
          f"B3' [{card}]")
    check(counts["flash"] == want, f"loop transformer: B3 launched {counts['flash']}, "
                                   f"the books give {want}")
    check(counts["flash_backward"] == layers * steps and counts["fused_update"] == steps,
          f"loop transformer: B3'/B2 launches {counts}")
    return counts


def loop_kernels(card: str) -> None:
    """B2 on the loop's cifar10_quick and transformer arenas; B3 (with lse) and B3' at the
    transformer family's training and top serving shapes, against their
    plain versions."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS, exec_batch
    from sparknet_tpu_torch.solvers.solver import Solver

    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES

    s = Solver(models.cifar10_quick_solver(), models.cifar10_quick(LOOP_BATCH), device="cuda")
    b2_against_plain(card, f"cifar10_quick b{LOOP_BATCH} (loop)", s.layout, s.config, it=0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    feeds = {"data": torch.randn((LOOP_BATCH, 3, 32, 32), generator=gen, device="cuda") * 40,
             "label": torch.randint(0, 10, (LOOP_BATCH,), generator=gen, device="cuda",
                                    dtype=torch.int32)}
    s.step(1, lambda it: feeds)  # warm-up: cuDNN's set-up
    step_turns(card, f"cifar10_quick b{LOOP_BATCH}", s, lambda it: feeds, 4 * TURN_STEPS)
    fam = GRAPH_SWEEP_FAMILIES["transformer"]
    s = Solver(fam.solver(), fam.net(LOOP_TOKEN_BATCH), device="cuda")
    b2_against_plain(card, f"transformer b{LOOP_TOKEN_BATCH} (loop)", s.layout, s.config,
                     it=0)
    del s
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    with f32_precision():
        for rows in (LOOP_TOKEN_BATCH, exec_batch(SERVE_BUCKETS[-1])):
            shape = (rows, 4, 32, 4)  # the family's heads, sequence and head width
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            o, lse = kernels._flash_attention_cuda(q, k, v, True, with_lse=True)
            o_ref, lse_ref = kernels.flash_attention_forward_lse_torch(q, k, v, True)
            got = kernels._flash_attention_backward_cuda(q, k, v, o, lse, g, True)
            ref = kernels.flash_attention_backward_torch(q, k, v, o, lse, g, True)
            torch.cuda.synchronize()
            o_ok, o_err = attention_within(o, o_ref, 1e-6)
            lse_ok, lse_err = attention_within(lse, lse_ref, 1e-5)
            oks, errs, _ = zip(*(grads_within(a, r, 1e-5, 1e-6) for a, r in zip(got, ref)))
            print(f"loop: B3 at the transformer's {list(shape)} causal: o max abs err "
                  f"{o_err:.3e} (rtol 1e-5, atol 1e-6), lse {lse_err:.3e} (1e-5); B3' dq "
                  f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (rtol 1e-5, atol 1e-6 x "
                  f"max|ref|) {'ok' if o_ok and lse_ok and all(oks) else 'FAIL'} [{card}]")
            check(o_ok and lse_ok and all(oks), f"loop: B3/B3' at {list(shape)}")


def loop_pool_worker(rank: int, work: str) -> None:
    """One rank of the loop's pool of two: gloo on cuda:0, joined through a
    FileStore; rank 0 serves and journals.  The plan kills worker 1 at
    round 1.  Writes its summary and launch counts into ``work``.  Spawned
    by ``phase_loop`` (start method spawn), so module level."""
    import torch.distributed as dist

    from sparknet_tpu_torch.common import set_config
    from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder
    from sparknet_tpu_torch.parallel import FaultPlan, initialize_distributed, kill
    from sparknet_tpu_torch.serve.engine import SERVE_BUCKETS

    torch.cuda.set_device(0)
    set_config(fused_update=True, storage_dtype="f32")
    initialize_distributed(backend="gloo", store_path=f"{work}/store", rank=rank,
                           world_size=2)
    if rank == 0:
        set_recorder(Recorder(f"{work}/pool.jsonl"))
    try:
        s, counts = loop_run_counted(
            family="cifar10_quick", iterations=1, rounds_per_rollout=LOOP_ROUNDS,
            per_worker_batch=LOOP_BATCH, tau=LOOP_TAU, buckets=SERVE_BUCKETS,
            requests=LOOP_REQUESTS, plan=FaultPlan([kill(1, at_round=1)]))
        with open(f"{work}/pool{rank}.json", "w") as f:
            json.dump({"summary": s, "counts": counts}, f, default=str)
        dist.barrier()
    finally:
        if rank == 0:
            set_recorder(None)
        dist.destroy_process_group()


def loop_pool(card: str, work: str) -> dict:
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    pool = mp.start_processes(loop_pool_worker, args=(work,), nprocs=2, join=False,
                              start_method="spawn")
    while not pool.join():
        pass
    ranks = [json.load(open(f"{work}/pool{r}.json")) for r in range(2)]
    s = ranks[0]["summary"]
    loop_gates("pool of two (gloo on cuda:0), worker 1 killed at round 1", s)
    events = loop_journal_gates(card, f"{work}/pool.jsonl", "pool of two")
    member = [(e["event"], e.get("worker"), e["round"], e.get("width", e.get("to_width")))
              for e in events if e["event"] in ("worker_lost", "worker_joined", "mesh_resize")]
    rounds = [(e["devices"], e["batch"]) for e in events if e["event"] == "round"]
    counts = [r["counts"] for r in ranks]
    print(f"loop pool: rank 0's journal: membership {member}, rounds (width, images a step) "
          f"{rounds}; launches by rank {counts}; {time.perf_counter() - t0:.1f} s spawned, "
          f"ran and joined [{card}]")
    check(member == [("worker_lost", 1, 1, 1), ("mesh_resize", None, 1, 1)],
          f"loop pool: the membership events {member}")
    check(rounds == [(2, 2 * LOOP_BATCH), (1, LOOP_BATCH)], f"loop pool: rounds {rounds}")
    check([c["fused_update"] for c in counts] == [2 * LOOP_TAU, LOOP_TAU],
          f"loop pool: B2 launches by rank {[c['fused_update'] for c in counts]}")
    return {k: counts[0][k] + counts[1][k] for k in counts[0]}


def phase_loop(card: str) -> dict:
    """The train-to-serve production loop (``loop_run``) on the card with
    its obs journal: cifar10_quick at its published batch (obs on, then
    off), ``tpunet loop --obs`` in process, the serving latency across
    rollouts, the transformer family, a
    pool of two gloo ranks losing a worker, and the kernels of the path
    against their plain versions.  Returns the launch counts."""
    import tempfile

    from sparknet_tpu_torch.common import set_config

    t_phase = time.perf_counter()
    set_config(fused_update=True, storage_dtype="f32")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    total: dict = {}
    try:
        with tempfile.TemporaryDirectory(prefix="sparknet_loop_") as work:
            for got in (loop_cifar(card, work), loop_cli(card, work),
                        loop_latency(card, work), loop_transformer(card),
                        loop_pool(card, work)):
                total = {k: total.get(k, 0) + n for k, n in got.items()}
            loop_kernels(card)
    finally:
        torch.backends.cudnn.deterministic = prev
        set_config(fused_update=False)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"loop: phase done in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


TRACE_ITERS = 5  # steps of `time --trace`'s final window (its short window is 1)
LOST_WINDOWS = 100  # one-replay trace_step windows of a transformer bucket (half as many bare)
TRACE_BUCKET = 8
FRESH_OBS_TIMEOUT_S = 150  # an `obs` command in a process of its own (about 25 s)


def trace_cli(argv, walls: list) -> str:
    """``cli.main(argv)`` in process, stdout captured and printed; its
    seconds in ``walls``."""
    import io

    from sparknet_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    walls.append((" ".join(argv[:2]), time.perf_counter() - t0))
    print(buf.getvalue().rstrip())
    check(rc == 0, f"trace: cli {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def trace_obs(argv, walls: list, fresh: bool = False) -> None:
    """``python -m sparknet_tpu_torch.obs`` in process, or with ``fresh`` in
    a new process of its own from the checkout's root, as a user starts it
    (its lines printed); it must exit 0."""
    from sparknet_tpu_torch.obs.__main__ import main as obs_main

    t0 = time.perf_counter()
    if fresh:
        import multiprocessing
        import threading

        # what this process holds while the new one runs beside it
        print(f"  (fresh process) started beside this process's "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated and "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved on the card, its "
              f"threads {sorted(t.name for t in threading.enumerate())}, children "
              f"{[p.pid for p in multiprocessing.active_children()]}, load average "
              f"{open('/proc/loadavg').read().split()[:3]}")
        # faulthandler on: a process that outlives its limit is sent SIGABRT,
        # which prints every thread's stack before it dies
        proc = subprocess.Popen([sys.executable, "-m", "sparknet_tpu_torch.obs", *argv],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                env={**os.environ, "PYTHONFAULTHANDLER": "1"},
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out, err = proc.communicate(timeout=FRESH_OBS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGABRT)
            try:
                out, err = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            journal = argv[argv.index("--out") + 1] if "--out" in argv else None
            lines = (sum(1 for _ in open(journal)) if journal and os.path.exists(journal)
                     else None)
            err += (f"\n(fresh process) stopped after {FRESH_OBS_TIMEOUT_S} s, its journal "
                    f"{lines} line(s) long")
        print("\n".join(f"  (fresh process) {line}" for line in
                        (out + err).splitlines() if "queue p99" in line))
        rc = proc.returncode
        if rc:  # on standard error, whose end a failed run's report shows
            print(out[-4000:] + err[-12000:], file=sys.stderr)
    else:
        rc = obs_main(list(argv))
    walls.append(("obs " + " ".join(a for a in argv[:2] if not a.startswith("/"))
                  + (" (fresh process)" if fresh else ""), time.perf_counter() - t0))
    check(rc == 0, f"trace: obs {' '.join(argv)} exited {rc}")


def journal_write_cost(card: str, work: str, lines: int = 6000) -> None:
    """What one journal line costs the thread that emits it, on the
    filesystem of the phase's journals: ``Recorder.emit`` of a serving
    ``request`` event, and its write alone through the Recorder's one open
    handle against reopening the file a line, as the Recorder did before
    fault C18's fix (printed, not gated)."""
    from sparknet_tpu_torch.obs.recorder import Recorder

    real = os.path.realpath(work)
    fs = max((m for m in (line.split() for line in open("/proc/mounts"))
              if real == m[1] or real.startswith(m[1].rstrip("/") + "/")),
             key=lambda m: len(m[1]))
    path = f"{work}/write_cost.jsonl"
    rec = Recorder(path)
    t0 = time.perf_counter()
    for _ in range(lines):
        rec.emit("request", model="m", bucket=64, queue_wait_ms=1.0, batch_assembly_ms=0.1,
                 device_ms=0.5, total_ms=1.6, batch_n=50, padded=True, deadline_flush=True,
                 lineage={"parent": "gen:m:v0"})
    emit_us = 1e6 * (time.perf_counter() - t0) / lines
    rec.close()
    with open(path, encoding="utf-8") as f:
        payload = f.readlines()[1]  # the first request event
    costs = {}
    for mode in ("one handle", "reopened a line"):
        ts = []
        f = open(path, "a", encoding="utf-8") if mode == "one handle" else None
        for _ in range(lines):
            t = time.perf_counter()
            if f is None:
                with open(path, "a", encoding="utf-8") as g:
                    g.write(payload)
            else:
                f.write(payload)
                f.flush()
            ts.append(time.perf_counter() - t)
        if f is not None:
            f.close()
        ts.sort()
        costs[mode] = (1e6 * sum(ts) / lines, 1e6 * ts[int(0.99 * lines)], 1e3 * ts[-1])
    os.remove(path)
    print(f"obs_cli: a journal line on {fs[1]} ({fs[2]}): Recorder.emit of a request event "
          f"{emit_us:.1f} us; the write alone " + "; ".join(
              f"{m} mean {a:.1f} us, p99 {b:.1f} us, max {c:.3f} ms"
              for m, (a, b, c) in costs.items()) + f" ({lines} lines each) [{card}]")


def trace_time(card: str, work: str, solver: str, batch: int, walls: list) -> dict:
    """``tpunet time --trace`` on the card through the CLI: its artifact,
    with every kernel record of both traced windows (``events``), held
    against the launch counts the CLI banked for the same windows."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.utils import op_profile

    out = f"{work}/{solver[4:]}_trace.json"
    kernels.reset_launch_counts()
    trace_cli(["time", "--trace", "--solver", solver, "--batch", str(batch), "--data",
               "synthetic", "--iterations", str(TRACE_ITERS), "--trace-out", out], walls)
    art = json.load(open(out))
    art["counts"] = {k: getattr(kernels, k) for k in op_profile.KERNEL_RECORDS}
    art["events"] = []
    for d, key in ((art["trace_dir_short"], "kernel_launches_short"),
                   (art["trace_dir"], "kernel_launches")):
        events = op_profile._device_events(d, full=True)
        records = op_profile.kernel_records(events)
        launched = art[key]
        got = {k: records[k] for k in op_profile.KERNEL_RECORDS if records[k] or k in launched}
        print(f"trace {solver}: window {d}: hand-kernel records {got}, launches {launched} "
              f"[{card}]")
        check(got == launched, f"trace {solver}: records {got} against launches {launched}")
        art["events"] += events
    wall_us = art["wall_ms_per_step"] * 1e3
    print(f"trace {solver}: device {art['device_us_per_step'] / 1e3:.3f} ms a step against "
          f"the wall's {wall_us / 1e3:.3f} ms (attributed {100 * art['attributed_frac']:.1f} "
          f"%); MFU {art['mfu']} of {art['mfu_vs_peak']}, {art['gflop_per_step']} GFLOP a "
          f"step (FlopCounterMode); untraced {art['wall_ms_per_step_untraced']} ms a step; "
          f"windows taken again for lost records {art['windows_discarded']} [{card}]")
    check(art["device_us_per_step"] <= wall_us,
          f"trace {solver}: device time {art['device_us_per_step']} us above the wall "
          f"{wall_us} us (lanes counted twice?)")
    check(art["mfu"] is not None and 0 < art["mfu"] < 1.0
          and art["mfu_vs_peak"] == "h100_sxm_f32",
          f"trace {solver}: mfu {art['mfu']} of {art['mfu_vs_peak']}")
    return art


def trace_scopes(events: list, counter: str) -> collections.Counter:
    """The scopes of one hand kernel's records: Counter of tf_op."""
    from sparknet_tpu_torch.utils import op_profile

    groups = op_profile.KERNEL_RECORDS[counter]
    return collections.Counter(
        e["args"].get("tf_op", "") for e in events
        if any(op_profile._kernel_group(e["name"], g) for g in groups))


def trace_other(card: str, label: str, events: list) -> set:
    """Print the unattributed kernels of a trace by name; their names."""
    other = collections.Counter(
        e["name"] for e in events if not re.search(r"\bL\.", e["args"].get("tf_op", "")))
    print(f"trace {label}: (other) holds {sum(other.values())} record(s): "
          + "; ".join(f"{n} x{k}" for n, k in other.most_common()) + f" [{card}]")
    return set(other)


def trace_alexnet(card: str, work: str, walls: list) -> dict:
    art = trace_time(card, work, "zoo:alexnet", 256, walls)
    rows = {n: (f, b) for n, f, b in art["rows_fwd_bwd"]}
    for layer in ("norm1", "norm2"):
        f, b = rows.get(layer, (0.0, 0.0))
        check(f > 0 and b > 0, f"trace alexnet: {layer} fwd {f} bwd {b} us")
    fwd = trace_scopes(art["events"], "LRN_LAUNCHES")
    bwd = trace_scopes(art["events"], "LRN_BACKWARD_LAUNCHES")
    print(f"trace alexnet: B1 records by scope {dict(fwd)}; B1' {dict(bwd)} [{card}]")
    check(set(fwd) == {"L.norm1", "L.norm2"}, f"trace alexnet: B1 scopes {dict(fwd)}")
    check(set(bwd) == {"transpose(jvp(L.norm1))", "transpose(jvp(L.norm2))"},
          f"trace alexnet: B1' scopes {dict(bwd)}")
    other = trace_other(card, "alexnet", art["events"])
    check(not any(re.search(r"\b(lrn|flash|paged)_\w*kernel\b", n) for n in other),
          f"trace alexnet: a layer's hand kernel in (other): {other}")
    check(any("fused_update_kernel" in n for n in other),
          "trace alexnet: the update (B2) is not in (other)")
    return art["counts"]


def trace_charlm(card: str, work: str, walls: list) -> dict:
    from sparknet_tpu_torch import models

    art = trace_time(card, work, "zoo:charlm", 32, walls)
    attention = {f"transpose(jvp(L.{lp.get_str('name').replace('/', '.')}))"
                 for lp in models.charlm(32).get_all("layer")
                 if lp.get_str("type") == "MultiHeadAttention"}
    bwd = trace_scopes(art["events"], "FLASH_BACKWARD_LAUNCHES")
    fwd = trace_scopes(art["events"], "FLASH_LAUNCHES")
    print(f"trace charlm: B3 records by scope {dict(fwd)}; B3' {dict(bwd)} (attention "
          f"layers {sorted(attention)}) [{card}]")
    check(set(bwd) == attention, f"trace charlm: B3' scopes {dict(bwd)}")
    trace_other(card, "charlm", art["events"])
    return art["counts"]


def trace_bits(card: str) -> None:
    """One AlexNet b256 step with the profiler and the layer scopes on, one
    with them off, from the same weights, batch and dropout masks: the
    same loss, params and history bit for bit, the same launches."""
    import tempfile

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.common import f32_precision
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.utils import profiling

    feeds = fixed_batch(256)
    got = []
    with f32_precision(), deterministic_algorithms():
        for traced in (False, True):
            s = train_solver(models.alexnet(256), models.alexnet_solver())
            s.train_iteration(feeds)  # warm-up: cuDNN's algorithm choice
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with (tempfile.TemporaryDirectory(prefix="chip_smoke_bits_") as d,
                  profiling.trace(d) if traced else contextlib.nullcontext()):
                loss = float(s.train_iteration(feeds))
            counts = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
                      kernels.FUSED_UPDATE_LAUNCHES)
            got.append((loss, solver_state(s), counts))
            del s
            gc.collect()
    (l0, (p0, h0), c0), (l1, (p1, h1), c1) = got
    same = l0 == l1 and all(
        torch.equal(a, b) for ln in p0 for a, b in zip(p0[ln], p1[ln])) and all(
        torch.equal(a, b) for ln in h0 for x, y in zip(h0[ln], h1[ln]) for a, b in zip(x, y))
    print(f"trace bits: an AlexNet b256 step traced and untraced: loss {l0!r} / {l1!r}, "
          f"params and history {'bit for bit equal' if same else 'DIFFER'}, launches "
          f"{c0} / {c1} [{card}]")
    check(same and c0 == c1, "trace bits: profiling changed the step")


def trace_train_profile(card: str, work: str, walls: list) -> dict:
    """``tpunet train --profile DIR``: its trace holds every hand-kernel
    launch of the run."""
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.utils import op_profile

    d = f"{work}/train_profile"
    kernels.reset_launch_counts()
    trace_cli(["train", "--solver", "zoo:alexnet", "--batch", "64", "--data", "synthetic",
               "--iterations", "2", "--profile", d, "--output", f"{work}/final"], walls)
    counts = {k: getattr(kernels, k) for k in op_profile.KERNEL_RECORDS}
    records = op_profile.kernel_records(op_profile._device_events(d, full=True))
    print(f"trace train --profile: {sorted(os.listdir(d))}: records {records}, launches "
          f"{counts} [{card}]")
    check(counts["LRN_LAUNCHES"] > 0 and all(records[k] >= n for k, n in counts.items()),
          f"trace train --profile: records {records} against launches {counts}")
    return counts


def trace_token(card: str, work: str) -> tuple[str, dict]:
    """The 64-request token mix through a PagedDecoder with a Recorder
    armed: one request event a ticket, one prefill event a prefill, a
    clean summary.  Returns the journal and the launches."""
    from sparknet_tpu_torch.obs.recorder import Recorder
    from sparknet_tpu_torch.obs.schema import stream_journal
    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.paged import PagedDecoder

    path = f"{work}/token.jsonl"
    rec = Recorder(path)
    d = PagedDecoder(**CHARLM, block_tokens=BLOCK_TOKENS, seed=SEED, recorder=rec)
    reqs = request_mix(N_REQUESTS, SEED + 6)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tickets = [d.submit(p, m) for p, m in reqs]
    d.run()
    counts = {"flash": kernels.FLASH_LAUNCHES, "paged": kernels.PAGED_LAUNCHES}
    rec.close()
    st = d.stats()
    kinds = collections.Counter(e.get("kind") for e in stream_journal(path)
                                if e.get("event") == "token")
    summary = [e for e in stream_journal(path) if e.get("kind") == "summary"]
    print(f"trace token: {len(reqs)} requests journaled: {dict(kinds)}; summary "
          f"{summary[-1] if summary else None}; launches {counts} [{card}]")
    check(all(t.done() for t in tickets), "trace token: a ticket did not resolve")
    check(kinds == {"request": len(reqs), "prefill": st["prefills"], "summary": 1},
          f"trace token: events {dict(kinds)}")
    check(summary[0]["leaked"] == 0 and summary[0]["requests"] == len(reqs),
          f"trace token: summary {summary[0]}")
    check(counts == {"flash": 2 * st["prefills"], "paged": 2 * st["steps"]},
          f"trace token: launches {counts}")
    return path, counts


def trace_window_kinds(d: str) -> tuple[collections.Counter, float | None]:
    """A window's records by kind (device events by category, and the
    host's runtime calls that carry a correlation id), and the least lag
    of a device record's start behind its launch's, in µs (negative: the
    device's timestamps were converted to the host's clock early)."""
    from sparknet_tpu_torch.utils import op_profile

    (trace,) = op_profile._traces(d)
    raw = trace["traceEvents"]
    dev = op_profile._device_pids(raw)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in raw
                 if e.get("ph") == "X" and e.get("pid") not in dev
                 and "correlation" in (e.get("args") or {})}
    kinds = collections.Counter(
        (e.get("cat") if e.get("pid") in dev else "host " + str(e.get("cat")))
        for e in raw if e.get("ph") == "X"
        and (e.get("pid") in dev or "correlation" in (e.get("args") or {})))
    lags = [e["ts"] - launch_ts[e["args"]["correlation"]] for e in raw
            if e.get("ph") == "X" and e.get("pid") in dev
            and (e.get("args") or {}).get("correlation") in launch_ts]
    return kinds, (min(lags) if lags else None)


def trace_lost_records(card: str) -> None:
    """One-replay profiler windows of a transformer bucket (as the engine
    phase's), late in the script: through ``op_profile.trace_step`` (``profiling.trace``,
    with its start margin) and through a bare ``torch.profiler`` window
    around the replay.  How many lose B3's record, the kinds of record
    they lose, and the device records' least lag behind their launches
    (a figure, not a gate)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch.ops import kernels
    from sparknet_tpu_torch.serve.engine import ServeEngine
    from sparknet_tpu_torch.utils import op_profile

    engine = ServeEngine((TRACE_BUCKET,), max_wait_ms=5.0, device="cuda")
    prog = engine.load_model("t", family="transformer", seed=SEED).programs[TRACE_BUCKET]
    prog.run()
    for label, windows in (("trace_step", LOST_WINDOWS),
                           ("a bare profiler window", LOST_WINDOWS // 2)):
        lost, kinds, lags = [], [], []
        for i in range(windows):
            if label == "trace_step":
                try:
                    d = op_profile.trace_step(prog.run, (), iters=1)["trace_dir"]
                except op_profile.LostRecords as e:
                    d = e.trace_dir
                    lost.append(i)
            else:
                d = tempfile.mkdtemp(prefix="chip_smoke_window_")
                before = kernels.FLASH_LAUNCHES
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    prog.run()
                    torch.cuda.synchronize()
                prof.export_chrome_trace(f"{d}/w.trace.json.gz")
                records = op_profile.kernel_records(op_profile._device_events(d))
                if records["FLASH_LAUNCHES"] < kernels.FLASH_LAUNCHES - before:
                    lost.append(i)
            k, lag = trace_window_kinds(d)
            kinds.append(k)
            lags.append(lag)
        full = {key: max(c[key] for c in kinds) for c in kinds for key in c}
        missing = collections.Counter(key for i in lost for key, n in full.items()
                                      if kinds[i][key] < n)
        lost_lags = sorted(round(lags[i]) for i in lost if lags[i] is not None)
        kept = [x for j, x in enumerate(lags) if j not in lost and x is not None]
        print(f"trace lost records, {label}: {len(lost)} of {windows} one-replay "
              f"windows of the transformer bucket {TRACE_BUCKET} lost B3's record; the most "
              f"records of a window by kind {full}; kinds short in the lost windows "
              f"{dict(missing)}; least device-after-launch lag (us) in the lost windows "
              f"{lost_lags[:10]}, in the others "
              f"{f'{min(kept):.1f} to {max(kept):.1f}' if kept else 'none'} [{card}]")
    del prog, engine


def phase_trace(card: str) -> dict:
    """The port's profiler on the card (``utils/op_profile``,
    ``utils/profiling``, ``time --trace``, ``train --profile``).  Returns
    the launch counts of its main paths (the two ``time --trace`` runs,
    ``train --profile``)."""
    import tempfile

    from sparknet_tpu_torch.common import set_config

    t_phase = time.perf_counter()
    walls: list = []
    set_config(fused_update=True, storage_dtype="f32")
    total = collections.Counter()
    try:
        with tempfile.TemporaryDirectory(prefix="sparknet_trace_") as work:
            for counts in (trace_alexnet(card, work, walls), trace_charlm(card, work, walls),
                           trace_train_profile(card, work, walls)):
                total.update(counts)
            trace_bits(card)
    finally:
        set_config(fused_update=False)
        gc.collect()
        torch.cuda.empty_cache()
    print("trace: seconds by command: " + "; ".join(f"{n} {s:.1f}" for n, s in walls))
    print(f"trace: phase done in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(total)


def phase_obs_cli(card: str) -> dict:
    """The journaled token serving and the obs CLI on the card (``obs
    dryrun`` legs, ``validate``, ``report --lineage``, ``top``), then the
    late profiler windows (:func:`trace_lost_records`).  Returns the token
    run's launch counts."""
    import tempfile

    t_phase = time.perf_counter()
    walls: list = []
    with tempfile.TemporaryDirectory(prefix="sparknet_obs_") as work:
        journal_write_cost(card, work)
        journal, counts = trace_token(card, work)
        journals = [journal]
        # the replica leg also in a process of its own, the way a user runs it
        journals.append(f"{work}/dryrun_replica_fresh.jsonl")
        trace_obs(["dryrun", "--replica", "--replicas", "2", "--out", journals[-1]], walls,
                  fresh=True)
        for leg in (["--serve", "--family", "transformer"], ["--replica", "--replicas", "2"],
                    ["--devices", "2", "--elastic"], ["--ctl"]):
            journals.append(f"{work}/dryrun_{leg[0][2:]}.jsonl")
            trace_obs(["dryrun", *leg, "--out", journals[-1]], walls)
        for path in journals:
            trace_obs(["validate", path], walls)
            trace_obs(["report", path, "--lineage", "--out", path + ".md"], walls)
            print(f"obs report --lineage {os.path.basename(path)}: "
                  f"{len(open(path + '.md').read().splitlines())} lines")
        trace_obs(["top", "--once", journal], walls)
    gc.collect()
    torch.cuda.empty_cache()
    trace_lost_records(card)
    print("obs_cli: seconds by command: " + "; ".join(f"{n} {s:.1f}" for n, s in walls))
    print(f"obs_cli: phase done in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"FLASH_LAUNCHES": counts["flash"], "PAGED_LAUNCHES": counts["paged"]}


PHASES = ("trace", "kernel", "path", "serve", "profile", "lrn_backward", "train",
          "fused_update", "train_profile", "fused_vs_blob", "parallel", "elastic", "feed",
          "cifar_app", "flash", "flash_backward", "paged", "token", "token_profile",
          "charlm_train", "engine", "replica", "zoo", "db_apps", "layers", "precision",
          "listfile", "seq_parallel", "loop", "obs_cli")


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

    from sparknet_tpu_torch.ops import kernels

    copies = [kernels.FUSED_GRAD_COPIES]

    def lap(name: str) -> None:
        laps.append(time.perf_counter())
        print(f"chip_smoke: {name} took {laps[-1] - laps[-2]:.1f} s; gradients B2's "
              f"wrapper copied: {kernels.FUSED_GRAD_COPIES - copies[-1]}")
        copies.append(kernels.FUSED_GRAD_COPIES)

    card = phase_card()
    phase_build()
    lap("build")
    stats = {}
    launches = {"lrn_across_channels": 0, "lrn_backward": 0, "fused_update": 0,
                "flash_attention": 0, "flash_attention_backward": 0,
                "paged_attention": 0}
    if "trace" in phases:
        # first: late in a long process about half of all profiler windows
        # lose device records (PERF.md §7; obs_cli, the last phase, counts them)
        got = phase_trace(card)
        launches["lrn_across_channels"] += got.get("LRN_LAUNCHES", 0)
        launches["lrn_backward"] += got.get("LRN_BACKWARD_LAUNCHES", 0)
        launches["fused_update"] += got.get("FUSED_UPDATE_LAUNCHES", 0)
        launches["flash_attention"] += got.get("FLASH_LAUNCHES", 0)
        launches["flash_attention_backward"] += got.get("FLASH_BACKWARD_LAUNCHES", 0)
        launches["paged_attention"] += got.get("PAGED_LAUNCHES", 0)
        lap("trace")
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
    for name, run in (("zoo", phase_zoo), ("db_apps", phase_db_apps),
                      ("layers", phase_layers)):
        if name in phases:
            got = run(card)
            launches["lrn_across_channels"] += got["lrn"]
            launches["lrn_backward"] += got["lrn_backward"]
            launches["fused_update"] += got["fused_update"]
            lap(name)
    if "precision" in phases:
        prec = phase_precision(card)
        launches["lrn_across_channels"] += prec["lrn"]
        launches["lrn_backward"] += prec["lrn_backward"]
        launches["fused_update"] += prec["fused_update"]
        launches["flash_attention"] += prec["flash"]
        launches["flash_attention_backward"] += prec["flash_backward"]
        lap("precision")
    if "listfile" in phases:
        got = phase_listfile(card)
        launches["lrn_across_channels"] += got["lrn"]
        launches["lrn_backward"] += got["lrn_backward"]
        launches["fused_update"] += got["fused_update"]
        lap("listfile")
    if "seq_parallel" in phases:
        got = phase_seq_parallel(card)
        launches["flash_attention"] += got["flash"]
        launches["flash_attention_backward"] += got["flash_backward"]
        launches["fused_update"] += got["fused_update"]
        lap("seq_parallel")
    if "loop" in phases:
        got = phase_loop(card)
        launches["fused_update"] += got["fused_update"]
        launches["flash_attention"] += got["flash"]
        launches["flash_attention_backward"] += got["flash_backward"]
        lap("loop")
    if "obs_cli" in phases:
        got = phase_obs_cli(card)
        launches["flash_attention"] += got["FLASH_LAUNCHES"]
        launches["paged_attention"] += got["PAGED_LAUNCHES"]
        lap("obs_cli")
    print(f"chip_smoke: phases {phases} done in {time.perf_counter() - t_start:.1f} s")
    if len(phases) < len(PHASES):
        return 0
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print(f"chip_smoke: gradients B2's wrapper copied on every path: "
          f"{kernels.FUSED_GRAD_COPIES} (non-contiguous, misaligned or of another type)")
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
        # arena fed by gradient segments (events; the bound counts each
        # gradient read once in its own type); flash: the char LM's
        # prefill shape [32,4,128,16] causal;
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
        # adds none; the ImageNet families' training steps; the DB apps;
        # the MNIST families' steps; the precision phase's bf16 AlexNet and
        # char LM steps and int8 CaffeNet requests; the listfile phase's CLI
        # training, Detector and classify; the seq_parallel phase's char LM
        # steps on its four ranks; the loop phase's training rounds, replays
        # and capture warm-ups), each counted from 0
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
