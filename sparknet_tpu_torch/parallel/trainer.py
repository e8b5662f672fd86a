"""The distributed trainer: SparkNet's algorithm on ``torch.distributed``.

Counterpart of ``sparknet_tpu/parallel/trainer.py``.  The reference's outer
loop (ref: src/main/scala/apps/CifarApp.scala:95-136):

    broadcast(weights); workers.foreach(setWeights)       # Spark master -> workers
    workers: train(tau)  # tau local SGD steps            # compute
    weights = workers.map(getWeights).reduce(add) / n     # workers -> Spark master

runs here as one process a worker.  Each process's wrapped ``Solver`` is
its worker's replica: the trainer steps it with ``Solver.train_iteration``
and averages its params (and state) in place; the collect-and-average is an
all-reduce over the worker group: NCCL between cards, gloo on the CPU or
for several ranks on one card.

* ``tau == 1``: synchronous data parallelism.  The gradients are averaged
  between the backward and the update (the Solver's ``reduce_grads``
  hook: one all-reduce of the grad arena on the fused path, of one flat
  buffer of the blobs' grads per blob), so every rank applies the same
  update and the replicas stay identical.
* ``tau > 1``: tau local steps a worker at iterations ``it .. it+tau-1``,
  then the mean over workers of the params and the state; the solver
  history (slots) stays per worker.
* ``elastic_alpha > 0``: EASGD (Zhang, Choromanska, LeCun 2015): tau local
  steps, then ``x_i -= a(x_i - c)`` and ``c += a * sum_i(x_i - c)``, the
  differences taken before the worker update; the center ``c`` is
  replicated on every rank, the state hard-averaged.

A round makes two all-reduce calls: the params (the param arena itself on
the fused path, one flat copy of the blobs per blob; the differences
``x_i - c`` under EASGD, the grads at ``tau == 1``) and one small buffer
holding the round's loss and the state blobs.

Feeds: each process feeds its own partition, as each Spark executor reads
its own.  On rank r ``data_fn(it)`` returns ``[B_local, ...]`` arrays
(``tau == 1``) or ``[tau, B_local, ...]`` (``tau > 1`` and EASGD);
``sharding.local_shard`` cuts them from a global batch.  The feeds are
placed on the solver's device as they come (uint8 stays uint8), then
``feed_device_fn(feeds, it)``, when set, runs on them before the round:
the uint8-wire augment hook (``DeviceAugment.trainer_device_fn``, which
gives each slot of a rank-5 feed its own draws).  ``test`` applies no hook,
as in the JAX package.

A mesh (``mesh=auto_mesh(model_parallel=, seq_parallel=)``, JAX's
``(data, model[, seq])`` layout over the ranks) adds the model and seq
axes, at ``tau == 1`` for seq (JAX's refusal otherwise):

* the workers are the data axis; ranks that share a data coordinate get
  the same batch from ``data_fn``, and under a seq axis a feed of rank 2
  or more keeps this rank's block of axis 1 (``sharding.seq_shard``,
  JAX's ``_put_feeds`` rule, ``ShardingRules.seq_feeds``); the steps and
  ``test`` run under ``ops.attention.sequence_parallel``, so
  ``Network.apply`` follows the blocks and MultiHeadAttention runs ring
  or Ulysses attention (``ShardingRules.attention_impl``);
* MoE blobs split axis 0 over the model axis (``sharding.param_shardings``;
  Megatron splits of other layers raise, not yet ported): the wrapped
  Solver holds this rank's experts (``Solver.hold``) and the steps run
  under ``ops.moe.model_parallel``;
* the gradient rule: every grad is averaged over the data x seq ranks, none
  over the model ranks (a replicated blob's grad is the same on each model
  rank, a sharded blob's is its own slice's).  Under a seq axis each rank's
  loss is its blocks' mean, and the gathers' backward sums the seq ranks'
  gradients, so the mean over the seq ranks is the whole sequence's
  gradient, for blobs before and after a gather alike;
* ``get_weights``, ``sync_to_solver`` and ``snapshot_arrays`` (what
  ``interop.solverstate_from_port`` writes) gather the sharded blobs back
  to whole ones (collectives: every rank calls them); the next round
  splits them again.

Dropout: rank r's Solver has ``worker = r``, so its generator is reseeded
at every iteration from (seed, r, it) (``solvers.solver.dropout_seed``);
rank 0 draws the masks a ``Solver`` alone would.  The JAX package folds
the worker index into its key instead; the two never agree, so parity
with it runs at dropout 0.

With ``SPARKNET_OBS`` armed each round writes the JAX trainer's
``round`` record (modes ``dp``, ``tau``, ``easgd``); only rank 0 journals.
The record's optional ``comm`` field (the JAX package's analytic
collective budget) is left out until A14 brings its model.

Not ported: ``save``/``restore`` (orbax); ``train_rounds`` is a loop of
rounds (a CUDA graph of it is ROADMAP A5).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from sparknet_tpu_torch.compiler.graph import NetVars
from sparknet_tpu_torch.net import (
    WeightCollection,
    collection_to_variables,
    variables_to_collection,
)
from sparknet_tpu_torch.common import get_config
from sparknet_tpu_torch.obs import lineage as obs_lineage
from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.parallel.collectives import all_gather
from sparknet_tpu_torch.parallel.mesh import default_backend, mesh_model_size, mesh_seq_size
from sparknet_tpu_torch.parallel.sharding import ShardingRules, param_shardings, seq_shard

DataFn = Callable[[int], dict[str, Any]]


def _flat(tensors: list) -> torch.Tensor:
    """One contiguous buffer of ``tensors``: the tensor itself when there is
    one contiguous tensor (an arena), else a concatenated copy."""
    if len(tensors) == 1 and tensors[0].is_contiguous():
        return tensors[0].view(-1)
    return torch.cat([t.reshape(-1) for t in tensors])


def _views(flat: torch.Tensor, like: list) -> list:
    """Views of ``flat`` shaped like each of ``like``, in order."""
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in like]), like)]


def all_reduce_mean_(tensors: list, group, divisor: float, weight: float = 1.0) -> None:
    """Each of ``tensors`` := (sum over the group's ranks of weight * t) /
    divisor, in place, by one all-reduce (SUM).  ``weight`` is this rank's
    (1.0 multiplies nothing: the plain mean is sum / workers).  Several
    tensors go through one flat copy and back into their own storage: the
    update then reads the same allocations as a lone Solver's, so its
    vectorised arithmetic rounds the same way."""
    if not tensors:
        return
    flat = _flat(tensors)
    if weight != 1.0:
        flat.mul_(weight)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(divisor)
    if flat.data_ptr() != tensors[0].data_ptr():
        for t, v in zip(tensors, _views(flat, tensors)):
            t.copy_(v)


def param_tensors(solver) -> list:
    """A Solver's params as the collectives move them: the param arena, or
    every param blob in params-dict order."""
    if solver.layout is not None:
        return [solver._param_arena]
    return [p for pl in solver._params.values() for p in pl]


def slot_tensors(solver) -> list:
    """A Solver's history: the slot arenas, or every slot blob in order."""
    if solver.layout is not None:
        return list(solver._slot_arenas)
    return [h for sl in solver._slots.values() for hl in sl for h in hl]


def state_tensors(solver) -> list:
    """A Solver's state blobs (running statistics), in order."""
    return [v for s in solver._state.values() for v in s.values()]


class ParallelTrainer:
    """Distributed trainer over a process group, one replica a process: the
    wrapped ``solver`` itself, which the trainer steps and averages in
    place (so ``solver.variables``/``solver.slots`` are this worker's
    replica and history).

    ``group``: the worker set (``data_parallel_group``); by default the
    whole default group.  With no process group initialized the trainer
    forms a world of one on the solver's device (NCCL on CUDA, gloo on the
    CPU) and destroys it on :meth:`close`; the collectives still go
    through ``torch.distributed``.  :meth:`close` also hands the solver
    back to stepping alone (no grad hook, worker 0).
    """

    def __init__(self, solver, group=None, tau: int = 1, elastic_alpha: float = 0.0,
                 mesh=None, rules: ShardingRules | None = None):
        cfg = solver.config
        if cfg.iter_size > 1:
            raise ValueError(
                "ParallelTrainer does not support iter_size > 1: the feed "
                "layout [iter_size, B, ...] conflicts with the trainer's "
                "batch/tau axis contract. Use a larger per-device batch or "
                "tau-step accumulation instead.")
        self.tau = int(tau)
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {tau}")
        self.mesh = mesh
        self.rules = rules or ShardingRules()
        if mesh is not None:
            if group is not None:
                raise ValueError("ParallelTrainer takes a group or a mesh, not both")
            group = mesh.comm(get_config().data_axis).group
        self._seq_size = (mesh_seq_size(mesh) if mesh is not None
                          and self.rules.sequence_parallel else 1)
        if self._seq_size > 1 and (self.tau > 1 or elastic_alpha > 0):
            raise ValueError(
                "sequence parallelism (a 'seq' mesh axis) composes with "
                "tau=1 synchronous DP only: the tau>1/EASGD rounds are "
                "already a manual shard_map over 'data' and cannot nest "
                "the seq-axis attention shard_map. Use tau=1, or a mesh "
                "without a 'seq' axis.")
        num_workers = dist.get_world_size(group) if dist.is_initialized() else 1
        self.elastic_alpha = float(elastic_alpha)
        self._elastic = self.elastic_alpha > 0.0
        if elastic_alpha and not 0.0 < elastic_alpha * num_workers <= 1.0:
            # EASGD stability: the center's moving rate is beta = p*alpha
            # and must stay in (0, 1] (Zhang et al. 2015 use beta = 0.9)
            raise ValueError(
                f"elastic_alpha={elastic_alpha} violates the stability "
                f"bound alpha*num_workers <= 1 with "
                f"{num_workers} workers; use ~0.9/{num_workers}")
        self.solver = solver
        self.device = solver.device
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            dist.init_process_group(default_backend(self.device),
                                    store=dist.HashStore(), rank=0, world_size=1)
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        if self.rank < 0:
            raise ValueError("this process is not in the trainer's group")
        self.num_workers = dist.get_world_size(self.group)
        # the ranks a grad, the loss and the state are averaged over: the
        # data x seq ranks (the workers alone without a seq axis)
        self._grad_group, self._grad_ranks = self.group, self.num_workers
        if self._seq_size > 1:
            cfg_axes = get_config()
            both = mesh.comm(cfg_axes.data_axis, cfg_axes.seq_axis)
            self._grad_group, self._grad_ranks = both.group, both.size
        self._shardings = None
        if mesh is not None and mesh_model_size(mesh) > 1:
            self._shardings = param_shardings(solver.train_net, solver.variables, mesh,
                                              self.rules).params
            if not any(sh.axis for specs in self._shardings.values() for sh in specs):
                self._shardings = None
        self._split = False  # whether the Solver holds this rank's slices
        solver.worker = self.rank if mesh is None else int(
            mesh.coords[get_config().data_axis])
        # fn(feeds, it) -> feeds, applied after placement, before the round
        self.feed_device_fn = None
        if self.tau == 1 and not self._elastic:
            solver.set_reduce_grads(self._mean_grads)
        self._split_solver()
        # EASGD's center: a replicated copy of the params
        with torch.no_grad():
            self._center = ([t.clone() for t in param_tensors(self.solver)]
                            if self._elastic else None)

    @property
    def iter(self) -> int:
        """The next iteration: the replica's own count."""
        return self.solver.iter

    @property
    def center(self) -> dict | None:
        """EASGD's center params, blob-wise (None without EASGD)."""
        if self._center is None:
            return None
        if self.solver.layout is not None:
            from sparknet_tpu_torch.solvers.arena import unpack

            with torch.no_grad():
                return unpack(self.solver.layout, self._center[0])
        out, it = {}, iter(self._center)
        for ln, pl in self.solver._params.items():
            out[ln] = [next(it) for _ in pl]
        return out

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)

    def _mean_(self, tensors: list) -> None:
        """Each of ``tensors`` := its mean over the workers, in place, by one
        all-reduce (``all_reduce_mean_``)."""
        all_reduce_mean_(tensors, self.group, self.num_workers)

    def _mean_grads(self, grads):
        """The ``reduce_grads`` hook of sync data parallelism: the grad arena
        (fused) or the list of blob grads, averaged over the workers (and
        the seq ranks) by one all-reduce."""
        if isinstance(grads, torch.Tensor):
            dist.all_reduce(grads, op=dist.ReduceOp.SUM, group=self._grad_group)
            return grads.div_(self._grad_ranks)
        all_reduce_mean_(grads, self._grad_group, self._grad_ranks)
        return grads

    def _mean_loss_and_state(self, loss: torch.Tensor) -> torch.Tensor:
        """The round's loss and the state blobs, averaged over the workers
        (and the seq ranks) by one all-reduce of a small buffer; returns the
        mean loss."""
        state = state_tensors(self.solver)
        buf = torch.cat([loss.detach().reshape(1).float()]
                        + [s.reshape(-1).float() for s in state])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self._grad_group)
        buf.div_(self._grad_ranks)
        for s, v in zip(state, _views(buf[1:], state)):
            s.copy_(v)
        return buf[0]

    def _elastic_update(self) -> None:
        """x_i -= a(x_i - c);  c += a * sum_i(x_i - c), with the differences
        taken before the worker update (ref: sparknet_tpu trainer's
        ``_make_elastic_round``)."""
        a = self.elastic_alpha
        xs = param_tensors(self.solver)
        diff = _flat([x - c for x, c in zip(xs, self._center)])
        for x, d in zip(xs, _views(diff, xs)):
            x.sub_(a * d)
        self._all_reduce(diff)
        for c, d in zip(self._center, _views(diff, xs)):
            c.add_(a * d)

    # -- the mesh's axes ----------------------------------------------------
    def _place(self, raw: dict) -> tuple[dict, frozenset]:
        """This rank's feeds on the device (its seq block of each split feed)
        and the names of the split feeds."""
        split = frozenset()
        if self._seq_size > 1:
            seq = self.mesh.comm(get_config().seq_axis)
            raw, split = seq_shard(raw, seq.rank, seq.size, self.rules.seq_feeds)
        return {k: torch.as_tensor(v, device=self.device) for k, v in raw.items()}, split

    def _context(self, split: frozenset = frozenset()):
        """The parallel modes' contexts for a step or a test forward:
        sequence parallelism over the split feeds, the MoE layers' model
        group."""
        from sparknet_tpu_torch.ops.attention import sequence_parallel
        from sparknet_tpu_torch.ops.moe import model_parallel

        stack = contextlib.ExitStack()
        if self._seq_size > 1:
            stack.enter_context(sequence_parallel(self.mesh, self.rules.attention_impl, split))
        if self.mesh is not None and mesh_model_size(self.mesh) > 1:
            stack.enter_context(model_parallel(self.mesh))
        return stack

    def _whole(self, tensors: list, specs: list) -> list:
        """The whole blobs of this rank's ``tensors`` (their slices by
        ``specs``), gathered on axis 0 over each blob's group."""
        with torch.no_grad():
            return [t if sh.axis is None else all_gather(t, 0, sh.comm)
                    for t, sh in zip(tensors, specs)]

    def _split_solver(self) -> None:
        """Make the Solver hold this rank's slices of the sharded blobs."""
        if self._shardings is None or self._split:
            return
        v, slots = self.solver.variables, self.solver.slots
        params = {ln: [sh.local(p) for p, sh in zip(pl, self._shardings[ln])]
                  for ln, pl in v.params.items()}
        slots = {ln: [[sh.local(h) for h in hl] for hl, sh in zip(sl, self._shardings[ln])]
                 for ln, sl in slots.items()}
        self.solver.hold(NetVars(params=params, state=v.state), slots)
        self._split = True

    def _whole_variables(self, variables: NetVars) -> NetVars:
        if not self._split:
            return variables
        return NetVars(params={ln: self._whole(pl, self._shardings[ln])
                               for ln, pl in variables.params.items()},
                       state=variables.state)

    # -- rounds ------------------------------------------------------------
    def train_round(self, data_fn: DataFn) -> float:
        """One outer iteration; returns the mean loss over the workers (at
        tau > 1 and under EASGD each worker's mean over its tau steps,
        averaged).  Every rank must call it.

        With ``SPARKNET_OBS`` armed (rank 0 alone journals) each round
        writes one ``round`` record, its wall fence-stamped on the round's
        loss VALUE, the one read this method always makes."""
        rec = get_recorder()
        t0 = time.perf_counter() if rec else 0.0
        self._split_solver()
        raw = data_fn(self.iter)
        feeds, split = self._place(raw)
        if self.feed_device_fn is not None:
            feeds = self.feed_device_fn(feeds, self.iter)
        if self.tau == 1 and not self._elastic:
            with self._context(split):
                loss = self.solver.train_iteration(feeds)
            loss = float(self._mean_loss_and_state(loss))
        else:
            with self._context():
                losses = [self.solver.train_iteration({k: v[i] for k, v in feeds.items()})
                          for i in range(self.tau)]
            with torch.no_grad():
                if self._elastic:
                    self._elastic_update()
                else:
                    # THE sync: collect + average (ref: CifarApp.scala:132-134)
                    self._mean_(param_tensors(self.solver))
                loss = float(self._mean_loss_and_state(torch.stack(losses).mean()))
        if rec:
            self._emit_obs_round(rec, raw, t0, loss)
        return loss

    def _obs_mode(self) -> str:
        """The mode name this trainer's rounds journal as."""
        if self._elastic:
            return "easgd"
        return "tau" if self.tau > 1 else "dp"

    def _emit_obs_round(self, rec, raw: dict, t0: float, loss: float) -> None:
        """One ``round`` record with the JAX trainer's fields: ``batch`` is
        the images a step over the workers (each rank feeds its own
        ``B_local``), ``devices`` the ranks of the default group."""
        stacked = self.tau > 1 or self._elastic
        batch = 0
        for v in raw.values():
            shp = np.shape(v)
            if shp:
                batch = int(shp[1] if stacked and len(shp) > 1 else shp[0])
                break
        it_consumed = self.tau if stacked else 1
        mode = self._obs_mode()
        rec.round(
            mode=mode, tau=self.tau, devices=dist.get_world_size(),
            workers=self.num_workers, iters=it_consumed,
            batch=batch * self.num_workers, wall_s=time.perf_counter() - t0,
            loss=loss, fenced=True, iteration=self.iter,
            lineage=obs_lineage.round_lineage(
                mode, self.iter - it_consumed, self.iter - it_consumed, self.iter - 1))

    def train(self, num_outer: int, data_fn: DataFn, callback=None) -> float:
        loss = 0.0
        for _ in range(num_outer):
            loss = self.train_round(data_fn)
            if callback:
                callback(self.iter, loss)
        return loss

    def train_rounds(self, n: int, data_fn: DataFn) -> float:
        """``n`` rounds (at least one); returns the last round's loss, as
        the JAX package's scan of rounds does."""
        loss = 0.0
        for _ in range(max(n, 1)):
            loss = self.train_round(data_fn)
        return loss

    # -- evaluation and weight exchange ------------------------------------
    def _averaged_variables(self) -> NetVars:
        """The model the outer loop sees: the replica (identical on every rank
        after a round), or under EASGD the center with the averaged
        state."""
        if self._elastic:
            return NetVars(params=self.center, state=self.solver._state)
        return self.solver.variables

    def test(self, num_batches: int, data_fn: DataFn) -> dict[str, float]:
        """Distributed eval with the reference's sum-then-normalize semantics
        (ref: Solver::TestAndStoreResult solver.cpp:414-444 +
        CifarApp.scala:113-115).  Each rank evaluates its own shard
        (``data_fn(b)`` gives its ``[B_local, ...]`` slice of batch b); a
        scalar output (a mean over the batch, as the loss and accuracy
        layers give) is averaged over the workers, an output with a batch
        axis summed.  Every rank must call it."""
        net = self.solver.test_net
        outputs = net.output_blobs()
        variables = self._averaged_variables()
        sums: dict[str, float] = {}
        scalar: dict[str, bool] = {}
        with torch.inference_mode():
            for b in range(num_batches):
                feeds, split = self._place(data_fn(b))
                with self._context(split):
                    blobs, _, _ = net.apply(variables, feeds, train=False)
                for name in outputs:
                    if name in blobs:
                        sums[name] = sums.get(name, 0.0) + float(torch.sum(blobs[name]))
                        scalar[name] = blobs[name].numel() == 1
        names = sorted(sums)
        buf = torch.tensor([sums[n] for n in names], dtype=torch.float64,
                           device=self.device)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self._grad_group)
        return {n: float(buf[i]) / (self._grad_ranks if scalar[n] else 1) / num_batches
                for i, n in enumerate(names)}

    def get_weights(self) -> WeightCollection:
        """The outer loop's model as host arrays (ref: Net.scala
        getWeights), sharded blobs whole (a collective then)."""
        return variables_to_collection(self._whole_variables(self._averaged_variables()))

    def set_weights(self, wc: WeightCollection) -> None:
        """Load ``wc`` (whole blobs) into this worker's replica (and the
        EASGD center); the history is kept.  Every rank should load the
        same weights (a collective when blobs are model-sharded)."""
        v = collection_to_variables(wc, self._whole_variables(self.solver.variables))
        if self._split:
            v = NetVars(params={ln: [sh.local(p) for p, sh in zip(pl, self._shardings[ln])]
                                for ln, pl in v.params.items()}, state=v.state)
        self.solver.variables = v
        if self._elastic:
            with torch.no_grad():
                self._center = [t.clone() for t in param_tensors(self.solver)]

    def sync_to_solver(self) -> None:
        """Make the wrapped Solver hold the outer loop's model and history,
        so its ``save`` snapshots them.  At tau > 1 and under EASGD the
        history is per worker and is averaged in place (a collective: every
        rank must call it); under EASGD the params become the center.
        Rounds after it start from what it leaves: call it when training
        ends or before a snapshot."""
        with torch.no_grad():
            if self.tau > 1 or self._elastic:
                self._mean_(slot_tensors(self.solver))
            if self._elastic:
                for x, c in zip(param_tensors(self.solver), self._center):
                    x.copy_(c)
        if self._split:
            slots = {ln: [self._whole(hs, [sh] * len(hs)) for hs, sh in
                          zip(sl, self._shardings[ln])]
                     for ln, sl in self.solver.slots.items()}
            self.solver.hold(self._whole_variables(self.solver.variables), slots)
            self._split = False

    def snapshot_arrays(self) -> dict:
        """The Solver's snapshot arrays with whole blobs
        (``interop.solverstate_from_port`` writes them): ``sync_to_solver``,
        then ``Solver.snapshot_arrays``.  A collective."""
        self.sync_to_solver()
        return self.solver.snapshot_arrays()

    def save(self, prefix: str) -> str:
        raise NotImplementedError(
            "ParallelTrainer.save: sharded orbax checkpoints are not ported "
            "(ROADMAP Queue A, A5); call sync_to_solver() and Solver.save")

    def restore(self, path: str) -> None:
        raise NotImplementedError(
            "ParallelTrainer.restore: sharded orbax checkpoints are not "
            "ported (ROADMAP Queue A, A5); use Solver.restore, then build "
            "the trainer")

    def close(self) -> None:
        """Hand the solver back to stepping alone, and destroy the world of
        one this trainer formed (if it formed one).  A Solver holding its
        rank's slices of model-sharded blobs keeps them: call
        :meth:`sync_to_solver` first for whole ones."""
        self.solver.set_reduce_grads(None)
        self.solver.worker = 0
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
