"""Elastic τ-averaging: SparkNet's rounds over a worker set that loses,
gains and parks workers between rounds.

Counterpart of ``sparknet_tpu/parallel/elastic.py``.  SparkNet's argument
for periodic model averaging is that it tolerates slow and lost workers
(Moritz et al., ICLR 2016; ref: CifarApp.scala:27-33 re-forms its
executors).  Membership changes only at round BOUNDARIES; inside a round
the worker set is fixed and the round is the plain τ round.

The pool is the default process group: P processes, one a worker slot, as
``ParallelTrainer`` runs one process a worker (a device of the JAX
package's pool is a rank here).  Each rank's wrapped ``Solver`` is the
replica of the worker it holds, stepped and averaged in place.  A rank is

* active: it holds a worker (a stable worker id; ids never recycle) at a
  position of the round's worker set;
* parked: it holds a straggler's replica, untouched, until its rejoin
  round;
* idle: killed, dropped, or not joined yet.  Idle and parked ranks take
  part only in the boundary's collectives.

Every rank replays the same ``FaultPlan``, so every rank knows the whole
membership and makes the same ``torch.distributed.new_group`` calls in
the same order (the call is collective): a width-W round runs over the
process group of its W active ranks (``mesh.worker_group``, one group a
set, cached).

* **Shards** (:func:`round_shards`): ``data_fn(g)`` gives one per-worker
  batch for global shard id ``g``; a round at width W takes the next
  ``tau * W`` ids from the cursor, and the worker at position ``w`` owns
  those with ``g % W == w``, so a resize never drops or repeats a shard.
* **The round**: τ local ``Solver`` steps a worker on its own shards,
  then the weighted average ``Σ w_i x_i / Σ w_i`` of the params and state
  (one all-reduce of each rank's ``w_i x_i``; integer state takes the
  plain mean); slots stay per worker; the loss is the mean over workers
  of each worker's mean.  With every weight 1 the round is
  ``ParallelTrainer``'s τ round bit for bit (a multiply by 1.0 and a
  divide by W are exact; the same flat all-reduce, ``all_reduce_mean_``).
* **Kill**: the rank goes idle; its params and slots still fold into the
  consensus a joiner adopts at the same boundary.
* **Join**: an idle rank takes a fresh worker id and adopts the mean of the
  entry pool's params, state and slots (every rank active at the
  boundary's entry, kills included), formed by one all-reduce over the
  default group.
* **Delay**: the straggler parks with its own state for
  ``ceil(steps / tau)`` rounds, then rejoins with weight
  ``staleness_decay ** s`` (s = rounds parked); one staler than
  ``staleness_bound`` is dropped and never averaged.

* **Feeds**: an active rank places its tau shards on the device (uint8
  stays uint8); ``feed_device_fn(feeds, it)``, when set, runs on them
  stacked ``[tau, B, ...]`` before the steps (the uint8-wire augment hook,
  ``DeviceAugment.trainer_device_fn``: a draw per slot).

* **Journal**: with ``SPARKNET_OBS`` armed, rank 0 writes the JAX
  trainer's membership events (``worker_lost``, ``worker_joined``,
  ``mesh_resize``, from the boundary every rank replays) and one
  ``round`` record a round (mode ``elastic``, the shard range as its
  lineage; ``batch`` the images a step over the workers).  The other
  ranks' recorders are disabled.  A round in which rank 0 holds no worker
  has no loss on rank 0 and journals no round record (its membership
  events still land).  The optional ``comm`` field waits for A14.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from sparknet_tpu_torch.compiler.graph import NetVars
from sparknet_tpu_torch.net import WeightCollection, variables_to_collection
from sparknet_tpu_torch.obs import lineage as obs_lineage
from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.parallel.mesh import default_backend, worker_group
from sparknet_tpu_torch.parallel.trainer import (
    _views,
    all_reduce_mean_,
    param_tensors,
    slot_tensors,
    state_tensors,
)

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "ElasticTrainer",
    "kill",
    "join",
    "delay",
    "round_shards",
]

# A shard-id data function: ``data_fn(g)`` returns ONE per-worker batch for
# global shard id ``g`` (a pure function of g: that is what makes a dead
# worker's shards re-ownable without coordination).
ShardFn = Callable[[int], dict[str, Any]]


# ---------------------------------------------------------------------------
# Fault injection (host only, copied from the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled membership change, applied at the BOUNDARY before
    round ``round`` runs.  ``worker`` is the stable worker id (positions
    renumber on every resize; ids never recycle)."""

    round: int
    kind: str  # "kill" | "join" | "delay"
    worker: int = -1  # kill/delay target (stable id)
    count: int = 1  # join: how many workers arrive
    steps: int = 0  # delay: local steps the straggler falls behind


def kill(worker: int, at_round: int) -> FaultEvent:
    """Worker ``worker`` dies at the boundary before round ``at_round``."""
    return FaultEvent(round=at_round, kind="kill", worker=worker)


def join(at_round: int, count: int = 1) -> FaultEvent:
    """``count`` fresh workers join before round ``at_round`` (adopting
    the consensus params + slot history)."""
    return FaultEvent(round=at_round, kind="join", count=count)


def delay(worker: int, at_round: int, steps: int) -> FaultEvent:
    """Worker ``worker`` straggles by ``steps`` local steps starting at
    the boundary before round ``at_round``: it misses
    ``ceil(steps / tau)`` full rounds, then rejoins staleness-damped."""
    return FaultEvent(round=at_round, kind="delay", worker=worker, steps=steps)


class FaultPlan:
    """A deterministic schedule of membership faults: windows die
    mid-run, capacity comes back later."""

    def __init__(self, events: tuple[FaultEvent, ...] | list = ()):
        self.events = tuple(sorted(events, key=lambda e: e.round))
        for e in self.events:
            if e.kind not in ("kill", "join", "delay"):
                raise ValueError(f"unknown fault kind {e.kind!r}")
            if e.kind == "delay" and e.steps <= 0:
                raise ValueError("delay events need steps > 0")
            if e.kind == "join" and e.count <= 0:
                raise ValueError("join events need count > 0")

    def at(self, rnd: int) -> list[FaultEvent]:
        return [e for e in self.events if e.round == rnd]


def round_shards(cursor: int, tau: int, width: int) -> np.ndarray:
    """Global shard ids one round consumes, as ``[tau, width]``: column
    ``w`` holds, in order, the ids with ``g % width == w``.

    The round takes the next ``tau * width`` consecutive ids from the
    cursor; since the block length is a multiple of ``width``, every worker
    owns exactly ``tau`` of them whatever the cursor's alignment, so a
    resize redistributes ownership without dropping or repeating a shard.
    """
    if width < 1 or tau < 1:
        raise ValueError(f"need tau >= 1 and width >= 1 "
                         f"(got tau={tau}, width={width})")
    ids = np.arange(cursor, cursor + tau * width, dtype=np.int64)
    cols = [ids[ids % width == w] for w in range(width)]
    return np.stack(cols, axis=1)  # [tau, width]


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Parked:
    """A straggler while it misses rounds: the rank that keeps its replica
    in its Solver.  ``variables``/``slots`` are filled (blob-wise numpy)
    only in ``state_dict``'s copy."""

    wid: int
    variables: Any
    slots: Any
    parked_round: int
    rejoin_round: int
    rank: int = -1


def _numpy_tree(tree):
    """A nested dict/list of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def _stack_trees(rows: list):
    """Row-wise trees stacked leaf by leaf into [len(rows), ...] arrays."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: _stack_trees([r[k] for r in rows]) for k in first}
    if isinstance(first, list):
        return [_stack_trees([r[i] for r in rows]) for i in range(len(first))]
    return np.stack(rows)


def _tree_row(tree, i: int):
    """Row ``i`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _tree_row(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_row(v, i) for v in tree]
    return np.asarray(tree[i])


class ElasticTrainer:
    """The τ-averaging round loop over a worker set that can change between
    rounds (see the module docstring).

    ``solver``'s net carries the PER-WORKER batch; ``data_fn`` follows the
    shard-id contract (:data:`ShardFn`).  ``width``: the workers of round 0
    (ranks 0 .. width - 1; the default group's size by default; the other
    ranks start idle).  With no process group initialized the trainer forms
    a world of one on the solver's device and destroys it on :meth:`close`.
    Every rank must make every call (the boundaries, rounds and state
    surface are collectives or replayed on every rank)."""

    def __init__(self, solver, *, width: int | None = None, tau: int = 1,
                 staleness_decay: float = 0.5, staleness_bound: int = 3,
                 plan: FaultPlan | None = None):
        if solver.config.iter_size > 1:
            raise ValueError(
                "ElasticTrainer does not support iter_size > 1 (same "
                "feed-layout conflict as ParallelTrainer)")
        if not (0.0 < staleness_decay <= 1.0):
            raise ValueError(
                f"staleness_decay must be in (0, 1] (got "
                f"{staleness_decay}); decay**s is the rejoin weight")
        self.solver = solver
        self.tau = int(tau)
        self.staleness_decay = float(staleness_decay)
        self.staleness_bound = int(staleness_bound)
        self.plan = plan or FaultPlan()
        self._owns_group = not dist.is_initialized()
        self.pool = dist.get_world_size() if not self._owns_group else 1
        self.width = int(width) if width is not None else self.pool
        if not (1 <= self.width <= self.pool):
            raise ValueError(
                f"width {self.width} needs 1..{self.pool} devices in the pool")
        if self._owns_group:
            dist.init_process_group(default_backend(solver.device),
                                    store=dist.HashStore(), rank=0, world_size=1)
        self.rank = dist.get_rank()
        self._groups: dict = {}  # worker set -> process group (worker_group)
        # stable worker ids by position, and the rank holding each
        self._wids = list(range(self.width))
        self._rank_of = {w: w for w in range(self.width)}
        self._next_wid = self.width
        self._parked: list[_Parked] = []
        self._round_weights = [1.0] * self.width
        self.iter = 0  # solver iterations (advances by tau a round)
        self.round = 0  # averaging rounds completed
        self.cursor = 0  # global shard ids consumed
        # fn(feeds, it) -> feeds on the stacked [tau, B, ...] shards of an
        # active rank, after placement, before the steps
        self.feed_device_fn = None

    # -- membership --------------------------------------------------------

    @property
    def active(self) -> bool:
        """Whether this rank holds a worker of the current set."""
        return self.rank in self._ranks()

    @property
    def worker_ids(self) -> list[int]:
        """The current set's stable worker ids, by position."""
        return list(self._wids)

    @property
    def round_weights(self) -> list[float]:
        """Each position's weight in the next (or current) round average."""
        return list(self._round_weights)

    def _ranks(self) -> list[int]:
        return [self._rank_of[w] for w in self._wids]

    def _emit_member(self, event: str, **fields) -> None:
        """Journal one membership event (``worker_lost``,
        ``worker_joined``, ``mesh_resize``); rank 0 alone writes."""
        rec = get_recorder()
        if rec:
            rec.emit(event, **fields)

    def _apply_boundary(self, rnd: int) -> None:
        """Apply rejoins due and the plan's events for round ``rnd``: the
        same on every rank, with one collective when a worker joins."""
        due = [p for p in self._parked if p.rejoin_round <= rnd]
        events = self.plan.at(rnd)
        if not due and not events:
            self._round_weights = [1.0] * self.width
            return
        rows = [{"wid": w, "rank": self._rank_of[w], "weight": 1.0} for w in self._wids]
        # a departing worker's params and slots fold into the consensus a
        # joiner adopts: the entry pool, kills included
        entry_ranks = [r["rank"] for r in rows]
        from_width = self.width
        joiners = []
        for ev in events:
            if ev.kind == "kill":
                match = [r for r in rows if r["wid"] == ev.worker]
                if not match:
                    raise ValueError(
                        f"FaultPlan kills worker {ev.worker} at round "
                        f"{rnd} but it is not active (active ids: "
                        f"{[r['wid'] for r in rows]})")
                if len(rows) == 1:
                    raise ValueError("FaultPlan would kill the last active worker")
                rows.remove(match[0])
                self._emit_member("worker_lost", worker=ev.worker, round=rnd,
                                  width=len(rows), reason="killed (fault plan)")
            elif ev.kind == "delay":
                match = [r for r in rows if r["wid"] == ev.worker]
                if not match:
                    raise ValueError(
                        f"FaultPlan delays worker {ev.worker} at round "
                        f"{rnd} but it is not active")
                if len(rows) == 1:
                    raise ValueError("FaultPlan would park the last active worker")
                rows.remove(match[0])
                missed = max(1, math.ceil(ev.steps / self.tau))
                self._parked.append(_Parked(
                    wid=ev.worker, variables=None, slots=None, parked_round=rnd,
                    rejoin_round=rnd + missed, rank=match[0]["rank"]))
                self._emit_member("worker_lost", worker=ev.worker, round=rnd,
                                  width=len(rows),
                                  reason=f"straggler: {ev.steps} step(s) "
                                         f"(~{missed} round(s)) behind")
            elif ev.kind == "join":
                for _ in range(ev.count):
                    row = {"wid": self._next_wid, "rank": None, "weight": 1.0}
                    self._next_wid += 1
                    rows.append(row)
                    joiners.append(row)
                    self._emit_member("worker_joined", worker=row["wid"], round=rnd,
                                      width=len(rows), staleness=0, weight=1.0,
                                      reason="joined fresh from consensus")
        # rejoins: a stale replica re-enters damped, or is dropped past the
        # bound (nothing older than the bound enters the average)
        for p in due:
            self._parked.remove(p)
            s = rnd - p.parked_round
            if s > self.staleness_bound:
                self._emit_member("worker_lost", worker=p.wid, round=rnd,
                                  width=len(rows), staleness=s,
                                  reason=f"staleness {s} exceeds bound "
                                         f"{self.staleness_bound}; contribution "
                                         "dropped")
                continue
            weight = self.staleness_decay ** s
            rows.append({"wid": p.wid, "rank": p.rank, "weight": weight})
            self._emit_member("worker_joined", worker=p.wid, round=rnd,
                              width=len(rows), staleness=s, weight=float(weight),
                              reason="straggler rejoined staleness-damped")

        new_width = len(rows)
        if not (1 <= new_width <= self.pool):
            raise ValueError(
                f"round {rnd}: worker set of {new_width} does not fit "
                f"the device pool ({self.pool})")
        # a joiner takes the lowest idle rank: not in the set, not parked
        held = {r["rank"] for r in rows} | {p.rank for p in self._parked}
        idle = [r for r in range(self.pool) if r not in held]
        if len(idle) < len(joiners):
            raise ValueError(
                f"round {rnd}: {len(joiners)} joining worker(s) find "
                f"{len(idle)} idle rank(s): {len(self._parked)} parked "
                f"straggler(s) hold ranks of the pool ({self.pool})")
        for row, rank in zip(joiners, idle):
            row["rank"] = rank
        if joiners:
            self._adopt_consensus(entry_ranks, [r["rank"] for r in joiners])
        self._wids = [r["wid"] for r in rows]
        for r in rows:
            self._rank_of[r["wid"]] = r["rank"]
        self._round_weights = [r["weight"] for r in rows]
        if new_width != from_width:
            self._emit_member("mesh_resize", round=rnd, from_width=from_width,
                              to_width=new_width, devices=new_width)
        self.width = new_width

    def _adopt_consensus(self, entry_ranks: list[int], joiner_ranks: list[int]) -> None:
        """The joiners' replicas := the mean over the entry ranks of their
        params, state and slots: one all-reduce over the default group, to
        which the entry ranks give their own and every other rank zeros."""
        s = self.solver
        tensors = param_tensors(s) + slot_tensors(s) + state_tensors(s)
        with torch.no_grad():
            buf = torch.cat([t.reshape(-1).float() for t in tensors])
            if self.rank not in entry_ranks:
                buf.zero_()
            all_reduce_mean_([buf], dist.group.WORLD, len(entry_ranks))
            if self.rank in joiner_ranks:
                for t, v in zip(tensors, _views(buf, tensors)):
                    t.copy_(v)
                s.iter = self.iter

    # -- the round ---------------------------------------------------------

    def _group(self):
        return worker_group(self._ranks(), self._groups)

    def train_round(self, data_fn: ShardFn) -> float | None:
        """One elastic round: the boundary's membership changes, then tau
        local steps a worker on its shards and the weighted average.
        Returns the mean loss over the workers on an active rank, None on
        an idle or parked one.  Every rank must call it."""
        rec = get_recorder()
        t0 = time.perf_counter() if rec else 0.0
        rnd = self.round
        self._apply_boundary(rnd)
        W = self.width
        group = self._group()  # collective the first time a set is seen
        grid = round_shards(self.cursor, self.tau, W)
        loss = None
        batch = 0
        if self.active:
            pos = self._ranks().index(self.rank)
            s = self.solver
            s.iter, s.worker = self.iter, pos
            shards = [{k: torch.as_tensor(v, device=s.device)
                       for k, v in data_fn(int(grid[t, pos])).items()}
                      for t in range(self.tau)]
            if self.feed_device_fn is not None:
                stacked = self.feed_device_fn(
                    {k: torch.stack([f[k] for f in shards]) for k in shards[0]},
                    self.iter)
                shards = [{k: v[t] for k, v in stacked.items()}
                          for t in range(self.tau)]
            losses = [s.train_iteration(f) for f in shards]
            with torch.no_grad():
                loss = self._weighted_average(group, pos, torch.stack(losses).mean())
            batch = next((int(v.shape[0]) for v in shards[0].values() if v.dim()), 0)
        cursor0 = self.cursor
        self.iter += self.tau
        self.cursor += self.tau * W
        self.round += 1
        if rec and loss is not None:
            # fenced on the round's loss VALUE, read in the weighted average
            rec.round(
                mode="elastic", tau=self.tau, devices=W, workers=W, iters=self.tau,
                batch=batch * W, wall_s=time.perf_counter() - t0, loss=loss,
                fenced=True, iteration=self.iter,
                lineage=obs_lineage.round_lineage(
                    "elastic", rnd, cursor0, cursor0 + self.tau * W - 1))
        return loss

    def _weighted_average(self, group, pos: int, loss: torch.Tensor) -> float:
        """The round's consensus over ``group``: params and floating state
        := Σ w_i x_i / Σ w_i, integer state its plain mean; returns the mean
        of the workers' losses.  Two all-reduces, as ``ParallelTrainer``'s
        round makes (the params; then the loss and the state)."""
        w = self._round_weights[pos]
        total = sum(self._round_weights)
        all_reduce_mean_(param_tensors(self.solver), group, total, w)
        state = state_tensors(self.solver)
        plain = [t for t in state if not t.is_floating_point()]
        weighted = [t for t in state if t.is_floating_point()]
        buf = torch.cat([loss.detach().reshape(1).float()]
                        + [t.reshape(-1).float() for t in plain]
                        + [t.reshape(-1).float() * w for t in weighted])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        n = 1 + sum(t.numel() for t in plain)
        buf[:n].div_(self.width)
        buf[n:].div_(total)
        for t, v in zip(plain + weighted, _views(buf[1:], plain + weighted)):
            t.copy_(v)
        return float(buf[0])

    def train(self, num_rounds: int, data_fn: ShardFn, callback=None):
        loss = None
        for _ in range(num_rounds):
            loss = self.train_round(data_fn)
            if callback:
                callback(self.round, loss)
        return loss

    # -- the state surface -------------------------------------------------

    def _my_row(self):
        """(variables, slots) of this rank's replica, blob-wise numpy."""
        v = self.solver.variables
        return ({"params": _numpy_tree(v.params), "state": _numpy_tree(v.state)},
                _numpy_tree(self.solver.slots))

    def state_dict(self) -> dict:
        """The whole pool, blob-wise on the host, as the JAX trainer's:
        ``variables`` and ``slots`` stacked by position, parked stragglers
        with their own replicas.  A collective (every rank gets it)."""
        rows = [None] * self.pool
        holds = self.rank in self._ranks() or any(p.rank == self.rank for p in self._parked)
        dist.all_gather_object(rows, self._my_row() if holds else None)
        at = [rows[r] for r in self._ranks()]
        variables = NetVars(params=_stack_trees([a[0]["params"] for a in at]),
                            state=_stack_trees([a[0]["state"] for a in at]))
        parked = [dataclasses.replace(p, variables=NetVars(**rows[p.rank][0]),
                                      slots=rows[p.rank][1]) for p in self._parked]
        return {
            "width": self.width,
            "wids": list(self._wids),
            "ranks": self._ranks(),
            "next_wid": self._next_wid,
            "variables": variables,
            "slots": _stack_trees([a[1] for a in at]),
            "iter": self.iter,
            "round": self.round,
            "cursor": self.cursor,
            "parked": parked,
        }

    def load_state_dict(self, state: dict) -> None:
        """Seat ``state`` on the pool: each worker and parked straggler on
        the rank the state names (``ranks``, a parked entry's ``rank``), or
        else the workers on ranks 0 .. width - 1 by position and the
        stragglers on the next ranks; each rank loads its own row.  Every
        rank must call it with the same state."""
        width = int(state["width"])
        parked = list(state.get("parked", []))
        if not (1 <= width <= self.pool):
            raise ValueError(f"state width {width} does not fit the device pool")
        ranks = list(state.get("ranks") or range(width))
        ranks += [getattr(p, "rank", -1) if getattr(p, "rank", -1) >= 0 else width + i
                  for i, p in enumerate(parked)]
        if len(set(ranks)) != len(ranks) or max(ranks) >= self.pool:
            raise ValueError(f"state width {width} and {len(parked)} parked "
                             f"straggler(s) do not fit the device pool ({self.pool})")
        self.width = width
        self._wids = list(state["wids"])
        self._rank_of = dict(zip(self._wids, ranks))
        self._next_wid = int(state["next_wid"])
        self._parked = [_Parked(wid=p.wid, variables=None, slots=None,
                                parked_round=p.parked_round, rejoin_round=p.rejoin_round,
                                rank=r) for p, r in zip(parked, ranks[width:])]
        self.iter = int(state["iter"])
        self.round = int(state["round"])
        self.cursor = int(state["cursor"])
        self._round_weights = [1.0] * width
        if self.rank in ranks[:width]:
            row = ranks.index(self.rank)
            v, slots = state["variables"], state["slots"]
            self._load_row(_tree_row(v.params, row), _tree_row(v.state, row),
                           _tree_row(slots, row))
        elif self.rank in ranks:
            p = parked[ranks.index(self.rank) - width]
            self._load_row(p.variables.params, p.variables.state, p.slots)

    def _load_row(self, params, state, slots) -> None:
        t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
        self.solver.variables = NetVars(
            params={ln: [t(a) for a in pl] for ln, pl in params.items()},
            state={ln: {k: t(a) for k, a in s.items()} for ln, s in state.items()})
        self.solver.slots = {ln: [[t(h) for h in hl] for hl in sl] for ln, sl in slots.items()}
        self.solver.iter = self.iter

    # -- the consensus -----------------------------------------------------

    def _pool_mean_(self, tensors: list, keep: bool) -> list:
        """The mean over the active ranks of ``tensors`` (one all-reduce
        over the default group, to which the other ranks give zeros),
        written into ``tensors`` when ``keep``, else into float32 copies
        that are returned."""
        out = tensors if keep else [t.float().clone() for t in tensors]
        if not self.active:
            for t in out:
                t.zero_()
        all_reduce_mean_(out, dist.group.WORLD, self.width)
        return out

    def get_weights(self) -> WeightCollection:
        """The consensus model (the replicas are equal right after a round;
        at a boundary the mean is the consensus).  A collective."""
        v = self.solver.variables
        with torch.no_grad():
            params = [p for pl in v.params.values() for p in pl]
            state = [t for s in v.state.values() for t in s.values()]
            mean = iter(self._pool_mean_(params + state, keep=False))
            avg = NetVars(params={ln: [next(mean).to(p.dtype) for p in pl]
                                  for ln, pl in v.params.items()},
                          state={ln: {k: next(mean).to(t.dtype) for k, t in s.items()}
                                 for ln, s in v.state.items()})
        return variables_to_collection(avg)

    def sync_to_solver(self) -> None:
        """Fold the pool into the wrapped Solver: the mean over the workers
        of the params, state and slots (the tau mode's sync), and the
        trainer's iteration.  A collective; a parked straggler's Solver
        keeps its own replica (it rejoins with it)."""
        parked = any(p.rank == self.rank for p in self._parked)
        s = self.solver
        with torch.no_grad():
            self._pool_mean_(param_tensors(s) + slot_tensors(s) + state_tensors(s),
                             keep=not parked)
        if not parked:
            s.iter = self.iter

    def close(self) -> None:
        """Hand the solver back to stepping alone, and destroy the world of
        one this trainer formed (if it formed one)."""
        self.solver.worker = 0
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
