"""The serving engine: per-bucket CUDA graphs and priced multi-model residency.

Counterpart of ``sparknet_tpu/serve/engine.py``.  One ``ServeEngine``
holds several zoo models resident at once.  Loading a model (a) prices its
worst-case bucket footprint against a batch-fit table and REFUSES a load
that would not fit the device's usable memory (``serve/residency.py``),
then (b) captures one forward CUDA graph per batch bucket
(``serve/graphs.py``), the counterpart of the JAX engine's AOT
executables, so steady-state traffic never captures anything.

Request flow: ``submit`` -> per-model ``DynamicBatcher`` -> a flush
(bucket-full or ``max_wait_ms`` deadline) -> zero-padded assembly into the
smallest fitting bucket -> one graph replay -> per-row results.  Each
bucket executes at ``exec_batch(bucket) = max(bucket, EXEC_FLOOR)`` rows.

Exactness policy (ROADMAP Queue C item 3).  The JAX engine promises that
row i of any bucket is bit-identical to a batch-1 run.  The port promises
less, and says what it measured:

* **Within a bucket, bit for bit.**  A padded batch and a full batch in
  the same bucket give each real row the same bits: the eval forwards of
  the served families have no op across examples, and one bucket always
  runs at one shape, so cuBLAS and cuDNN pick the same kernels.
* **Replay against eager, bit for bit**, at the same ``exec_batch``, with
  TF32 and ``cudnn.benchmark`` off (``serve/graphs.py``).
* **Across buckets, not promised.**  cuBLAS picks its GEMM by row count
  and cuDNN may pick a convolution algorithm by batch, so the same request
  in bucket 1 (2 rows) and bucket 256 may differ in last bits.
  ``chip_smoke.py`` measures the largest difference across the four
  buckets on the card and PERF.md states it; on the CPU with one intra-op
  thread the tests state what holds there.

Hot reload: ``build_candidate`` captures a replacement's whole bucket
ladder on the CALLER's thread (a rollout builder, never the request path),
then ``swap_model`` replaces the incumbent atomically under the engine's
pump lock and drains the incumbent's pending tickets with the incumbent's
OWN graphs (zero dropped tickets).  The retired model stays resident for
one generation, graphs and all, so ``rollback`` restores it: same object,
same graphs, bitwise-identical scores.  ``serve_path_compiles`` is the
graph captures made on the request path, and it is zero by construction:
only ``BucketProgram``'s constructor captures (a load, a candidate build,
a replica join), and the request path (``submit``, ``pump``,
``_execute``) constructs none.  It stays as the JAX engine's gate, which
there counts lazy recompiles that a CUDA graph cannot have.

Deploy arms: ``f32`` serves the weights as they are; ``fold_bn`` folds the
BatchNorm(+Scale) chains into their producers ONCE, at load, from the
given variables (``models/fold_bn.py``), and builds every bucket's net
from that folded layer list at the bucket's rows (a no-op for the
BN-free families, whose ``fold_bn`` programs are the ``f32`` ones).  The
JAX engine folds again for each bucket from the already-folded
variables, which leaves a later bucket's BatchNorm layers without their
state; the port does not repeat that.  ``int8`` folds the same way, then
calibrates once, at the smallest bucket's net on ``_synthetic_feeds``
(``quant.calibrate``, the JAX arm's stream), and captures every bucket's
graph inside ``quant.quantized_inference`` on the capturing thread, so
each graph records the int8 convolutions and products
(``quant.int_matmul``: ``torch._int_mm`` on the card).  Integer sums are
exact, so within a bucket the int8 arm is bit for bit too.

The obs journal: with ``SPARKNET_OBS`` armed the engine writes the JAX
engine's ``serve`` events (``model_loaded``, ``load_refused`` before any
capture, ``model_unloaded``, ``candidate_built``, ``rollout``,
``rollback``, a throttled ``shed`` line, ``shutdown``), a fenced
``serve_device`` span and one ``request`` record a ticket, each with its
lineage: a generation ``gen:<model>:v<V>`` descends from the seed, from the
loop's checkpoint (``lineage.ambient``) or from the generation it
displaced, and a request names its generation.  ``serve_path_compiles``
is the capture sentinel's count on the serving thread across each replay
(``obs/sentinel.py``): a candidate's captures land on its builder's
thread, never there.  With obs off none of the journal's work runs.  The
engine defaults to CUDA (``device=None``) and raises without
a card; a CPU engine (the tests) must be given ``hbm_bytes``.

ref: apps/FeaturizerApp.scala:1 (the reference's batch-scoring inference
app).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from sparknet_tpu_torch.common import Phase, resolve_device
from sparknet_tpu_torch.obs import lineage as obs_lineage
from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.obs.sentinel import get_sentinel
from sparknet_tpu_torch.serve.batcher import DynamicBatcher, Ticket
from sparknet_tpu_torch.serve.graphs import BucketProgram
from sparknet_tpu_torch.serve.residency import AdmissionPolicy

__all__ = [
    "EXEC_FLOOR",
    "SERVE_BUCKETS",
    "SHED_TICK_MS",
    "AdmissionRefused",
    "ServeEngine",
    "ServedModel",
    "build_serve_program",
    "exec_batch",
    "percentile",
]

# the bucket ladder: 1 (pure-latency floor), 8 (trickle), 64 (steady),
# 256 (the throughput batch).  Four graphs keep load time and per-model
# residency small.
SERVE_BUCKETS = (1, 8, 64, 256)

# the 1-bucket executes at a batch of 2 (one permanently-zero pad row), as
# in the JAX engine: a one-row product may take a gemv whose order of sums
# differs from the batched GEMM's
EXEC_FLOOR = 2


def exec_batch(bucket: int) -> int:
    """The batch a bucket's program actually runs at."""
    return max(int(bucket), EXEC_FLOOR)


# one pump tick (ms): the grace the shed gate adds on top of max_wait_ms
# (a flush decision is at most one scheduling tick away)
SHED_TICK_MS = 15.0

_ARMS = ("f32", "fold_bn", "int8")

# the int8 arm's calibration stream: batches of 8 synthetic requests (the
# JAX engine's default)
INT8_CALIBRATION_BATCHES = 2


def _check_arm(arm: str) -> None:
    if arm not in _ARMS:
        raise ValueError(f"unknown arm {arm!r}; one of {_ARMS}")


class AdmissionRefused(RuntimeError):
    """A model load predicted not to fit the device's usable memory (the
    verdict dict rides on ``.verdict``)."""

    def __init__(self, verdict: dict):
        self.verdict = verdict
        super().__init__(
            f"model load refused: {verdict['family']} at bucket "
            f"{verdict['max_bucket']} predicts "
            f"{verdict['predicted_bytes']:,} B next to "
            f"{verdict['resident_bytes']:,} B resident — over the "
            f"{verdict['budget_bytes']:,} B usable-memory budget")


# ---------------------------------------------------------------------------
# Forward-program construction
# ---------------------------------------------------------------------------


def _score_blob(network) -> str:
    """The blob the engine returns per request: the first loss/accuracy
    layer's non-label bottom (every zoo classifier wires ``score, label ->
    loss``), else the net's last declared output."""
    for layer in network.layers:
        if "label" in layer.bottoms:
            return next(b for b in layer.bottoms if b != "label")
    return network.output_blobs()[-1]


def _end_layer(network, blob: str) -> str:
    """The last layer producing ``blob``: where the serve forward stops
    (in-place chains rebind a blob several times)."""
    name = None
    for layer in network.layers:
        if blob in layer.tops:
            name = layer.name
    if name is None:
        raise ValueError(f"no layer produces blob {blob!r}")
    return name


def _forward_fn(network, blob: str, end: str, qstate: dict | None = None):
    """The score forward; with ``qstate`` it runs inside
    ``quant.quantized_inference`` on the calling thread (a capture's
    warm-up and the capture itself included)."""
    import contextlib

    from sparknet_tpu_torch import quant

    def forward(variables, feeds):
        ctx = (quant.quantized_inference(qstate) if qstate is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            blobs, _, _ = network.apply(variables, feeds, train=False, end=end)
        return blobs[blob]
    return forward


def _with_inputs_of(folded, net_param):
    """``folded``'s layer list with its input layers (the ones that carry
    the batch) taken from ``net_param``, a build of the same family at
    another batch."""
    from sparknet_tpu_torch.ops.data_layers import InputLayer
    from sparknet_tpu_torch.ops.registry import get_layer_class
    from sparknet_tpu_torch.proto.text_format import Message

    inputs = {lp.get_str("name"): lp for lp in net_param.get_all("layer")
              if issubclass(get_layer_class(lp.get_str("type")), InputLayer)}
    out = Message()
    for field, values in folded.fields.items():
        for v in values:
            if field == "layer" and v.get_str("name") in inputs:
                v = inputs[v.get_str("name")]
            out.add(field, v)
    return out


def _family(family_name: str):
    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES

    if family_name not in GRAPH_SWEEP_FAMILIES:
        raise KeyError(
            f"unknown zoo family {family_name!r}; serveable families: "
            f"{sorted(GRAPH_SWEEP_FAMILIES)}")
    return GRAPH_SWEEP_FAMILIES[family_name]


def _synthetic_feeds(family, batch: int, seed: int = 0) -> dict:
    """Batcher-shaped synthetic feeds, NCHW: the JAX package's
    ``parallel/modes._feeds_for`` (same draws from the same seed)."""
    rs = np.random.RandomState(seed)
    if family.feed == "tokens":
        data = rs.randint(0, family.vocab, (batch, family.seq_len)).astype(np.int32)
    else:
        data = rs.randn(batch, *family.image_shape).astype(np.float32) * 10
    label = rs.randint(0, family.num_classes, batch).astype(np.int32)
    return {"data": data, "label": label}


def build_serve_program(family_name: str = "cifar10_quick", bucket: int = 1,
                        seed: int = 0, device=None):
    """The f32 forward the engine runs for one bucket: ``(fn, variables,
    feeds, alt_feeds)``, ``fn(variables, feeds)`` the score blob at
    ``exec_batch(bucket)`` rows, the seeded weights on ``device``, and two
    feeds of that shape with different values."""
    from sparknet_tpu_torch.compiler.graph import Network

    device = resolve_device(device)
    family = _family(family_name)
    batch = exec_batch(bucket)
    network = Network(family.net(batch), Phase.TEST, device=device)
    variables = network.init(torch.Generator().manual_seed(seed))
    blob = _score_blob(network)
    fn = _forward_fn(network, blob, _end_layer(network, blob))

    def feeds(s: int) -> dict:
        return {k: torch.from_numpy(v).to(device)
                for k, v in _synthetic_feeds(family, batch, s).items()}

    return fn, variables, feeds(seed), feeds(seed + 1)


# ---------------------------------------------------------------------------
# Served model: weights + one captured program per bucket
# ---------------------------------------------------------------------------


def _on(variables, device):
    """A copy of ``variables`` (a ``NetVars``) on ``device``."""
    from sparknet_tpu_torch.compiler.graph import NetVars

    return NetVars(
        params={ln: [torch.as_tensor(p).to(device, copy=True) for p in pl]
                for ln, pl in variables.params.items()},
        state={ln: {k: torch.as_tensor(v).to(device, copy=True) for k, v in s.items()}
               for ln, s in variables.state.items()})


class ServedModel:
    """One resident model: its weights on the engine's device, one
    :class:`~sparknet_tpu_torch.serve.graphs.BucketProgram` per bucket, and
    its own request batcher.

    ``variables`` injects trained weights (a ``NetVars``, e.g. from
    ``interop.netvars_from_numpy``), copied onto the device; the default is
    the seeded init.  ``source_variables`` keeps them as loaded (on the
    host under the ``fold_bn`` arm, which folds them there); ``variables``
    are the ones served (folded under ``fold_bn``, whose chain labels
    ``folded`` lists).  ``version``/``previous`` are the hot-reload lineage
    the engine maintains.  ``measured_bytes`` is the device memory the
    load took (``torch.cuda.memory_allocated`` before and after, weights,
    static buffers and graph outputs included, and on a device's first
    load the capture stream's cuBLAS workspace; None on the CPU).
    """

    def __init__(self, name: str, family_name: str, arm: str, buckets: tuple,
                 max_wait_ms: float, clock, predicted_bytes: int, seed: int = 0,
                 variables=None, device=None):
        from sparknet_tpu_torch.compiler.graph import Network, NetVars

        _check_arm(arm)
        self.name = name
        self.family_name = family_name
        self.arm = arm
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.predicted_bytes = int(predicted_bytes)
        self.device = resolve_device(device)
        self.batcher = DynamicBatcher(self.buckets, max_wait_ms, clock)
        self.version = 0
        self.previous: ServedModel | None = None
        # serialises this model's replays: the programs' static buffers (and
        # the graph pool they share) take one batch at a time
        self.lock = threading.Lock()

        family = _family(family_name)
        self.family = family
        if family.feed == "tokens":
            self.item_shape: tuple = (family.seq_len,)
            self.item_dtype = np.int32
        else:
            self.item_shape = tuple(family.image_shape)
            self.item_dtype = np.float32

        cuda = self.device.type == "cuda"
        mem0 = torch.cuda.memory_allocated(self.device) if cuda else 0
        base = Network(family.net(self.buckets[0]), Phase.TEST, device=self.device)
        if variables is None:
            self.variables = base.init(torch.Generator().manual_seed(seed))
        else:
            # a copy the model owns: a joining replica copies the live
            # weights, it does not share them
            self.variables = _on(variables, self.device)
        self.score_blob = _score_blob(base)
        # the weights as loaded: a joining replica copies these (folding
        # folded weights again would find no BatchNorm state)
        self.source_variables = self.variables
        self.folded: list[str] = []
        folded_net = None
        if arm in ("fold_bn", "int8"):
            from sparknet_tpu_torch.models.fold_bn import fold_batchnorm

            # the unfolded weights stay on the host, where the fold runs:
            # the device holds the folded ones alone
            self.source_variables = _on(self.variables, torch.device("cpu"))
            self.variables = None
            folded_net, params, state, self.folded = fold_batchnorm(
                base.net_param, self.source_variables.params, self.source_variables.state)
            self.variables = _on(NetVars(params=params, state=state), self.device)

        # the int8 arm's quant state (calibrated once, at the smallest
        # bucket; the stream is batch-invariant) and its records prepared
        # for the forward
        self.qstate: dict | None = None
        qrun = None
        if arm == "int8":
            from sparknet_tpu_torch import quant

            net_param = family.net(exec_batch(self.buckets[0]))
            if folded_net is not None:
                net_param = _with_inputs_of(folded_net, net_param)
            net0 = Network(net_param, Phase.TEST, device=self.device)
            self.qstate = quant.calibrate(
                net0, self.variables,
                (_synthetic_feeds(family, 8, seed=s + 1)
                 for s in range(INT8_CALIBRATION_BATCHES)),
                num_batches=INT8_CALIBRATION_BATCHES)
            qrun = quant.prepare(self.qstate, net0)

        pool = torch.cuda.graph_pool_handle() if cuda else None
        self.programs: dict[int, BucketProgram] = {}
        t0 = time.perf_counter()
        for bucket in self.buckets:
            net_param = family.net(exec_batch(bucket))
            if folded_net is not None:
                net_param = _with_inputs_of(folded_net, net_param)
            net_b = Network(net_param, Phase.TEST, device=self.device)
            fn = _forward_fn(net_b, self.score_blob, _end_layer(net_b, self.score_blob),
                             qrun)
            self.programs[bucket] = BucketProgram(
                lambda data, label, fn=fn: fn(self.variables, {"data": data, "label": label}),
                self.item_shape, self.item_dtype, exec_batch(bucket), self.device, pool)
        self.compile_wall_s = time.perf_counter() - t0
        self.measured_bytes = (torch.cuda.memory_allocated(self.device) - mem0
                               if cuda else None)

        # per-request latencies (ms, host clock)
        self.lat_total_ms: list[float] = []
        self.lat_queue_ms: list[float] = []
        self.lat_device_ms: list[float] = []
        self.requests = 0
        self.batches = 0
        self.padded_rows = 0


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _int8_resident_bytes(family_name: str):
    """The int8 arm's price on top of the f32 row, as a function the
    admission calls only for a priced family: ``quant.resident_bytes`` of
    the family's weight shapes (a host init, no device work)."""

    def price() -> int:
        from sparknet_tpu_torch import quant
        from sparknet_tpu_torch.compiler.graph import Network

        net = Network(_family(family_name).net(1), Phase.TEST, device="cpu")
        return quant.resident_bytes(net, net.init().params)

    return price


class ServeEngine:
    """Multi-model serving front end: priced loads, dynamic batching,
    per-bucket graph execution, per-request latency ledgers.

    ``clock`` is injectable (batcher deadline tests drive a fake one); the
    device walls always come from ``time.perf_counter``.  ``fit_table`` is
    the batch-fit table admission prices against (None: admit
    everything); ``hbm_bytes`` the device memory it budgets (default: the
    card's; required on the CPU).
    """

    def __init__(self, buckets: tuple = SERVE_BUCKETS, max_wait_ms: float = 5.0, *,
                 fit_table: dict | None = None, hbm_bytes: int | None = None,
                 clock=time.monotonic, device=None):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_wait_ms = float(max_wait_ms)
        self.clock = clock
        self.device = resolve_device(device)
        if hbm_bytes is None:
            if self.device.type != "cuda":
                raise ValueError("hbm_bytes: pass the memory to price admission "
                                 "against when not on CUDA")
            hbm_bytes = torch.cuda.get_device_properties(self.device).total_memory
        self.policy = AdmissionPolicy(fit_table, hbm_bytes=hbm_bytes)
        self._models: dict[str, ServedModel] = {}
        self._resident_bytes = 0
        self._closed = False
        # the pump lock: makes a hot swap atomic against submits (a ticket
        # lands either in the retiring model's queue, drained by the swap,
        # or in the candidate's, never in a drained queue).  Execution runs
        # outside it, under the model's own lock.
        self._lock = threading.RLock()
        # graph captures attributed (per thread, obs/sentinel.py) to the
        # replays on the request path: 0 by construction (the module
        # docstring), kept as the JAX engine's gate
        self.serve_path_compiles = 0
        # the deadline-shed ledger: rejections journal THROTTLED, at most
        # one ``serve/shed`` line an interval with the count since the last
        self.shed_total = 0
        self._shed_pending = 0
        self._shed_last_emit: float | None = None
        self._shed_emit_interval_s = 0.25

    # -- model lifecycle ---------------------------------------------------

    def resident_bytes(self) -> int:
        return self._resident_bytes

    def models(self) -> list[str]:
        return list(self._models)

    def _admit(self, name: str, family: str, buckets: tuple, arm: str,
               note: str) -> dict:
        extra = _int8_resident_bytes(family) if arm == "int8" else 0
        verdict = self.policy.admit(family, buckets[-1], self._resident_bytes, extra)
        if not verdict["fits"]:
            get_recorder().emit(
                "serve", kind="load_refused", model=name, family=family, arm=arm,
                buckets=list(buckets), predicted_bytes=verdict["predicted_bytes"],
                resident_bytes=verdict["resident_bytes"],
                budget_bytes=verdict["budget_bytes"], note=note)
            raise AdmissionRefused(verdict)
        return verdict

    def load_model(self, name: str, family: str = "cifar10_quick", arm: str = "f32",
                   buckets: tuple | None = None, seed: int = 0,
                   variables=None) -> ServedModel:
        """Price, maybe refuse, else capture every bucket.  The refusal
        happens before any device work.  ``variables`` seeds the load with
        existing weights instead of the seed init (a joining replica copies
        the live weights, ``serve/router.py``)."""
        _check_arm(arm)
        if name in self._models:
            raise ValueError(f"model {name!r} already resident")
        buckets = tuple(sorted(set(buckets or self.buckets)))
        verdict = self._admit(name, family, buckets, arm,
                              "the fit table predicts over-budget residency: refused "
                              "before any capture")
        model = ServedModel(name, family, arm, buckets, self.max_wait_ms, self.clock,
                            verdict["predicted_bytes"], seed=seed,
                            variables=variables, device=self.device)
        with self._lock:
            self._models[name] = model
            self._resident_bytes += model.predicted_bytes
        rec = get_recorder()
        if rec:
            # this load defines generation v0: seeded weights are a root,
            # injected ones adopt the caller's ambient parent when pushed
            lin: dict = {"span": obs_lineage.generation_span(name, model.version)}
            parent = obs_lineage.current_parent() or (
                obs_lineage.seed_root(seed) if variables is None else None)
            if parent:
                lin["parent"] = parent
            rec.emit("serve", kind="model_loaded", model=name, family=family, arm=arm,
                     buckets=list(model.buckets), predicted_bytes=model.predicted_bytes,
                     resident_bytes=self._resident_bytes,
                     budget_bytes=verdict["budget_bytes"],
                     wall_s=round(model.compile_wall_s, 6), lineage=lin,
                     note="every bucket captured at load (one CUDA graph a bucket)")
        return model

    def unload_model(self, name: str) -> None:
        with self._lock:
            model = self._models.pop(name)
            self._resident_bytes -= model.predicted_bytes
            if model.previous is not None:
                self._resident_bytes -= model.previous.predicted_bytes
                model.previous = None
        model.batcher.close(drain=False)
        get_recorder().emit("serve", kind="model_unloaded", model=name,
                            family=model.family_name, arm=model.arm,
                            resident_bytes=self._resident_bytes)

    # -- hot reload --------------------------------------------------------

    def build_candidate(self, name: str, family: str = "cifar10_quick",
                        arm: str = "f32", buckets: tuple | None = None,
                        variables=None, seed: int = 0) -> ServedModel:
        """Capture a replacement for resident model ``name`` OFF the request
        path, on the caller's thread, before anything touches the live
        engine.  Priced first against the CURRENT resident set (the
        incumbent stays resident through the rollback window, so both
        generations must fit); an over-budget candidate raises
        :class:`AdmissionRefused` and the incumbent is untouched."""
        _check_arm(arm)
        if name not in self._models:
            raise ValueError(f"no resident model {name!r} to replace — use "
                             "load_model for the first generation")
        buckets = tuple(sorted(set(buckets or self.buckets)))
        verdict = self._admit(name, family, buckets, arm,
                              "rollout candidate refused by the fit-table pricing: the "
                              "incumbent keeps serving, nothing captured")
        candidate = ServedModel(name, family, arm, buckets, self.max_wait_ms, self.clock,
                                verdict["predicted_bytes"], seed=seed,
                                variables=variables, device=self.device)
        rec = get_recorder()
        if rec:
            fields: dict = {}
            parent = obs_lineage.current_parent()
            if parent:
                # the loop pushed its checkpoint span; the candidate has no
                # generation until the swap, so it carries the edge only
                fields["lineage"] = {"parent": parent}
            rec.emit("serve", kind="candidate_built", model=name, family=family, arm=arm,
                     buckets=list(candidate.buckets),
                     predicted_bytes=candidate.predicted_bytes,
                     wall_s=round(candidate.compile_wall_s, 6),
                     note="every bucket captured on the builder's thread: none on the "
                          "request path", **fields)
        return candidate

    def swap_model(self, name: str, candidate: ServedModel) -> dict:
        """Atomically replace resident model ``name`` with a captured
        ``candidate`` (from :meth:`build_candidate`).  Under the pump lock
        the routing flips and the incumbent's pending tickets are taken;
        then they execute with the incumbent's OWN graphs.  The incumbent
        is kept as ``candidate.previous`` (one rollback generation; the
        grandparent retires and its bytes are released).  Returns swap
        telemetry."""
        t0 = time.perf_counter()
        with self._lock:
            old = self._models[name]
            grand, old.previous = old.previous, None
            candidate.version = old.version + 1
            candidate.previous = old
            self._models[name] = candidate
            self._resident_bytes += candidate.predicted_bytes
            if grand is not None:
                self._resident_bytes -= grand.predicted_bytes
            stale = old.batcher.drain()
        drained = 0
        for batch in stale:
            self._execute(old, batch)
            drained += len(batch)
        wall = time.perf_counter() - t0
        rec = get_recorder()
        if rec:
            # the new generation descends from the loop's ambient checkpoint
            # when one is pushed, else from the generation it displaced
            parent = (obs_lineage.current_parent()
                      or obs_lineage.generation_span(name, old.version))
            rec.emit("serve", kind="rollout", model=name, family=candidate.family_name,
                     arm=candidate.arm, buckets=list(candidate.buckets),
                     version=candidate.version, drained=drained,
                     predicted_bytes=candidate.predicted_bytes,
                     resident_bytes=self._resident_bytes, wall_s=round(wall, 6),
                     lineage={"span": obs_lineage.generation_span(name, candidate.version),
                              "parent": parent},
                     note="hot swap under the pump lock: the incumbent drained with "
                          "its own graphs, zero dropped tickets")
        return {"version": candidate.version, "drained": drained, "swap_wall_s": wall}

    def rollback(self, name: str) -> ServedModel:
        """Restore the previous generation of resident model ``name``: the
        SAME ``ServedModel`` the last swap retired, graphs and weights
        untouched, so its scores are bitwise the pre-rollout scores.  The
        rolled-back candidate's pending tickets drain through its own
        graphs first."""
        with self._lock:
            cur = self._models[name]
            prev = cur.previous
            if prev is None:
                raise RuntimeError(f"model {name!r} has no previous generation to "
                                   "roll back to")
            cur.previous = None
            self._models[name] = prev
            self._resident_bytes -= cur.predicted_bytes
            stale = cur.batcher.drain()
        drained = 0
        for batch in stale:
            self._execute(cur, batch)
            drained += len(batch)
        get_recorder().emit(
            "serve", kind="rollback", model=name, family=prev.family_name, arm=prev.arm,
            buckets=list(prev.buckets), version=prev.version, drained=drained,
            resident_bytes=self._resident_bytes,
            lineage={"span": obs_lineage.generation_span(name, prev.version)},
            note="previous ServedModel restored bitwise (same object, same graphs); "
                 "the rolled-back candidate drained with its own graphs")
        return prev

    # -- request path ------------------------------------------------------

    def _item(self, model: ServedModel, item) -> np.ndarray:
        item = np.asarray(item, model.item_dtype)
        if item.shape != model.item_shape:
            raise ValueError(f"request shape {item.shape} != model item shape "
                             f"{model.item_shape}")
        return item

    def submit(self, model_name: str, item, *, shed: bool = False) -> Ticket | None:
        """Enqueue one request (one example, item-shaped).  Holds the pump
        lock across lookup + enqueue so a concurrent hot swap can never
        strand the ticket in an already-drained queue.  ``shed=True``
        routes through the batcher's deadline-aware admission: a request
        whose projected queue wait exceeds ``max_wait_ms`` + one pump tick
        is rejected (None, counted on ``shed_total``)."""
        ticket, line = self.submit_deferred(model_name, item, shed=shed)
        self.emit_shed(line)
        return ticket

    def submit_deferred(self, model_name: str, item, *,
                        shed: bool = False) -> tuple[Ticket | None, dict | None]:
        """:meth:`submit` without the journal write: returns ``(ticket,
        line)``, where ``line`` is a throttled ``serve/shed`` line for
        :meth:`emit_shed` or None.  A caller that holds a lock of its own
        (the router) journals after releasing it."""
        line = None
        with self._lock:
            model = self._models[model_name]
            item = self._item(model, item)
            if not shed:
                return model.batcher.submit(item), None
            ticket = model.batcher.shed(item, tick_ms=SHED_TICK_MS)
            if ticket is None:
                line = self._note_shed_locked(model_name, model, 1)
        return ticket, line

    def submit_many(self, model_name: str, items: list, *,
                    shed: bool = False) -> tuple[list, int]:
        """The whole arrival chunk under ONE pump-lock acquisition and one
        batcher lock (batcher ``submit_many``).  Returns ``(tickets,
        shed_n)``."""
        tickets, n_shed, line = self.submit_many_deferred(model_name, items, shed=shed)
        self.emit_shed(line)
        return tickets, n_shed

    def submit_many_deferred(self, model_name: str, items: list, *,
                             shed: bool = False) -> tuple[list, int, dict | None]:
        """:meth:`submit_many` without the journal write: ``(tickets,
        shed_n, line)``, as :meth:`submit_deferred`."""
        line = None
        with self._lock:
            model = self._models[model_name]
            payloads = [self._item(model, item) for item in items]
            tickets, n_shed = model.batcher.submit_many(payloads, shed=shed,
                                                        tick_ms=SHED_TICK_MS)
            if n_shed:
                line = self._note_shed_locked(model_name, model, n_shed)
        return tickets, n_shed, line

    def _note_shed_locked(self, model_name: str, model: ServedModel,
                          n: int) -> dict | None:
        """Count ``n`` rejections and decide the throttled ``serve/shed``
        line (at most one an interval, with the count since the previous
        line).  The caller holds the pump lock and journals the returned
        fields with :meth:`emit_shed` after releasing it, so a slow journal
        write stalls neither ``submit`` nor the pump."""
        self.shed_total += n
        if not get_recorder():
            return None
        self._shed_pending += n
        now = self.clock()
        if (self._shed_last_emit is not None
                and now - self._shed_last_emit < self._shed_emit_interval_s):
            return None
        pending, self._shed_pending = self._shed_pending, 0
        self._shed_last_emit = now
        return dict(model=model_name, shed=pending,
                    projected_wait_ms=round(model.batcher.last_projected_ms, 3))

    @staticmethod
    def emit_shed(line: dict | None) -> None:
        """Journal a ``serve/shed`` line decided under the pump lock (None:
        nothing); called with no serving lock held."""
        if line is None:
            return
        get_recorder().emit(
            "serve", kind="shed", **line, tick_ms=SHED_TICK_MS,
            note="deadline-aware admission: projected queue wait over "
                 "max_wait_ms + one pump tick, rejected, not queued (count "
                 "since the previous shed line)")

    def infer(self, model_name: str, item, timeout: float | None = 60.0):
        """Synchronous single request: submit, flush now, return the scores.
        It pumps one batch a model at a time until its own ticket resolves
        (the JAX engine drains every queue, which never ends while another
        thread keeps submitting)."""
        ticket = self.submit(model_name, item)
        while not ticket.done() and self.pump(force=True, max_batches=1):
            pass
        return ticket.wait(timeout)

    def pump(self, force: bool = False, max_batches: int | None = None) -> int:
        """Execute every model's due batches on the caller's thread; returns
        the number of batches executed.  ``max_batches`` caps the batches
        taken PER MODEL (a pod pump sweeping several replicas passes 1: an
        uncapped drain of a continuously-fed queue never exits)."""
        executed = 0
        for model in list(self._models.values()):
            taken = 0
            while max_batches is None or taken < max_batches:
                # take and run under the model's lock: whoever retires the
                # model's ledger (a swap, a kill) waits for a taken batch
                with model.lock:
                    batch = model.batcher.take(force=force)
                    if batch is None:
                        break
                    lines = self._run(model, batch)
                self._journal(lines)
                taken += 1
            executed += taken
        return executed

    def serve_forever(self, until=None, poll_s: float = 0.05) -> int:
        """Worker loop: block on flush deadlines, execute batches, exit when
        ``until()`` goes truthy or the engine shuts down.  Returns batches
        executed."""
        executed = 0
        while not self._closed and not (until and until()):
            models = list(self._models.values())
            if not models:
                time.sleep(poll_s)
            for model in models:
                if model.batcher.wait_due(timeout=poll_s):
                    executed += self.pump()
                    break
        return executed

    def shutdown(self) -> int:
        """Drain: every in-flight request is executed before the engine
        stops accepting work.  Returns requests served during the drain."""
        self._closed = True
        drained = 0
        for model in list(self._models.values()):
            for batch in model.batcher.close(drain=True):
                self._execute(model, batch)
                drained += len(batch)
        get_recorder().emit("serve", kind="shutdown", requests=drained,
                            note="queue drained on shutdown: zero in-flight requests lost")
        return drained

    # -- execution ---------------------------------------------------------

    def _execute(self, model: ServedModel, tickets: list) -> None:
        """One padded-bucket replay under the model's lock; resolves every
        ticket and records its latencies, then journals them."""
        with model.lock:
            lines = self._run(model, tickets)
        self._journal(lines)

    @staticmethod
    def _journal(lines: list) -> None:
        """Write the journal lines a batch's run deferred (its device span,
        a ``request`` line a ticket), with no serving lock held: a stalled
        journal write holds up only the thread that ran the batch."""
        if not lines:
            return
        rec = get_recorder()
        for line in lines:
            if isinstance(line, dict):
                rec.emit("request", **line)
            else:
                line.emit()

    def _run(self, model: ServedModel, tickets: list) -> list:
        """:meth:`_execute`'s body; the caller holds ``model.lock`` (the
        programs' static buffers take one batch at a time).  Returns the
        batch's journal lines for :meth:`_journal` (none when obs is
        off)."""
        bucket = tickets[0].bucket
        program = model.programs[bucket]
        asm0 = time.perf_counter()
        data = program.host_input
        for i, t in enumerate(tickets):
            data[i] = t.payload
        data[len(tickets):] = 0
        asm_ms = (time.perf_counter() - asm0) * 1e3
        rec = get_recorder()
        sentinel = get_sentinel()
        captures0 = sentinel.thread_count()
        dev0 = time.perf_counter()
        lines: list = []
        try:
            if rec:
                sp = rec.span("serve_device", note=f"{model.name}/b{bucket}", defer=True)
                lines.append(sp)
                with sp:
                    out = program.run()
                    # the scores were copied from the graph's own output after
                    # its stream finished: their last value is the fence
                    sp.fence_value(float(out.ravel()[-1]))
            else:
                out = program.run()
        except Exception as e:
            for t in tickets:
                t.resolve(error=e)
            self._journal(lines)  # the failed batch's span, as it closed
            raise
        device_ms = (time.perf_counter() - dev0) * 1e3
        # per-THREAD attribution: a concurrent builder's captures land on its
        # own thread's count, so a delta here means the replay itself captured
        captured = sentinel.thread_count() - captures0
        if captured:
            with self._lock:
                self.serve_path_compiles += captured
        now = self.clock()
        model.batches += 1
        model.padded_rows += bucket - len(tickets)
        # one shared lineage dict a batch: every row's parent is the generation
        lineage = {"parent": f"gen:{model.name}:v{model.version}"} if rec else None
        for i, t in enumerate(tickets):
            t.t_done = now
            queue_ms = max(0.0, (t.t_batch - t.t_submit) * 1e3)
            total_ms = queue_ms + asm_ms + device_ms
            t.resolve(result=out[i])
            model.requests += 1
            model.lat_total_ms.append(total_ms)
            model.lat_queue_ms.append(queue_ms)
            model.lat_device_ms.append(device_ms)
            if rec:
                lines.append(dict(model=model.name, bucket=bucket,
                                  queue_wait_ms=round(queue_ms, 4),
                                  batch_assembly_ms=round(asm_ms, 4),
                                  device_ms=round(device_ms, 4),
                                  total_ms=round(total_ms, 4), batch_n=len(tickets),
                                  padded=bucket > len(tickets),
                                  deadline_flush=bool(t.deadline_flush), lineage=lineage))
        return lines

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        """Per-model latency/throughput roll-up (host-clock walls)."""
        out: dict = {}
        for name, model in self._models.items():
            out[name] = {
                "family": model.family_name,
                "arm": model.arm,
                "buckets": list(model.buckets),
                "requests": model.requests,
                "batches": model.batches,
                "padded_rows": model.padded_rows,
                "predicted_bytes": model.predicted_bytes,
                "measured_bytes": model.measured_bytes,
                "p50_ms": percentile(model.lat_total_ms, 50),
                "p99_ms": percentile(model.lat_total_ms, 99),
                "queue_p50_ms": percentile(model.lat_queue_ms, 50),
                "queue_p99_ms": percentile(model.lat_queue_ms, 99),
                "device_p50_ms": percentile(model.lat_device_ms, 50),
            }
        return out


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile (p99 of 100 samples is the 99th sorted
    value, no interpolation).  Empty input reads 0.0."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, int(np.ceil(q / 100.0 * len(ordered))))
    return float(ordered[rank - 1])
