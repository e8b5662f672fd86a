"""ProductionLoop: elastic rounds -> checkpoint -> candidate -> rollout.

Counterpart of ``sparknet_tpu/loop/controller.py``.  One object owns the
whole train-to-serve cycle the reference ran as a single Spark app (ref:
apps/FeaturizerApp.scala:1): it wraps an
:class:`~sparknet_tpu_torch.parallel.elastic.ElasticTrainer` (the training
side) and a live :class:`~sparknet_tpu_torch.serve.engine.ServeEngine` (the
serving side), and each iteration of :meth:`run`

1. trains ``rounds_per_rollout`` elastic rounds off the shard feed,
2. folds the pool into the solver (``sync_to_solver``) and writes an
   ATOMIC checkpoint (``Solver.save``: a temp file, then ``os.replace``),
3. reads the checkpoint back (``loop/deploy.py``, the durable hand-off,
   exercised every rollout),
4. captures the candidate's bucket graphs on a BUILDER thread
   (``engine.build_candidate``, priced against the resident memory first;
   a refusal journals and keeps the incumbent serving), and
5. hot-swaps it in (``engine.swap_model``: the routing flips under the pump
   lock, the incumbent drains with its own graphs and stays one generation
   for :meth:`rollback`).

The pool is the default process group, one process a rank, as the elastic
trainer runs it (the JAX loop runs its pool on one process's mesh).  Every
rank trains and takes part in the checkpoint's ``sync_to_solver``; rank 0
alone holds the engine: it writes the checkpoint, builds and swaps the
candidate, and a barrier ends each rollout.  A world of one is the usual
case (the trainer forms it when no group exists: NCCL on the card, gloo on
the CPU; several ranks on one card go through gloo).  Rank 0 also
broadcasts the trainer's ``FaultPlan`` at the start of each iteration, so
a plan change made there (the SLO controller's ``LoopPlane`` lending
training width) is replayed by every rank.

Every transition journals a ``loop`` event (``obs/schema.py``) beside the
engine's ``serve`` rollout and rollback records, with lineage: a
checkpoint descends from the last round folded into it, a candidate and a
generation from the checkpoint.
"""

from __future__ import annotations

import os
import threading
import time

import torch.distributed as dist

from sparknet_tpu_torch.obs import lineage as obs_lineage
from sparknet_tpu_torch.obs.recorder import get_recorder
from sparknet_tpu_torch.obs.sentinel import get_sentinel

__all__ = ["ProductionLoop"]


class ProductionLoop:
    """Drive a solver's elastic training INTO a live serving engine.

    ``data_fn`` follows the elastic ShardFn contract (``loop/feed.py``);
    ``workdir`` receives the ``round{N:05d}`` snapshots; ``serve_name`` is
    the engine-resident model the rollouts replace (loaded by
    :meth:`ensure_serving` if absent).  ``engine`` is the live engine on
    rank 0 and None on every other rank.
    """

    def __init__(self, solver, engine, data_fn, *, workdir: str,
                 family: str = "cifar10_quick", arm: str = "f32",
                 buckets: tuple | None = None, serve_name: str = "live",
                 tau: int = 1, width: int | None = None, plan=None,
                 staleness_decay: float = 0.5):
        from sparknet_tpu_torch.parallel.elastic import ElasticTrainer

        self.trainer = ElasticTrainer(solver, width=width, tau=tau, plan=plan,
                                      staleness_decay=staleness_decay)
        self.rank = self.trainer.rank
        if (engine is None) != (self.rank != 0):
            self.trainer.close()
            raise ValueError(f"rank {self.rank}: rank 0 alone holds the engine "
                             "(pass engine=None on every other rank)")
        self.engine = engine
        self.data_fn = data_fn
        self.workdir = workdir
        self.family = family
        self.arm = arm
        self.buckets = tuple(buckets) if buckets else None
        self.serve_name = serve_name
        self.rollouts = 0
        self.rollbacks = 0
        self.checkpoints = 0
        # the last rollout's telemetry: swap_model's, plus the build's wall
        # and the captures the builder thread made
        self.last_rollout: dict | None = None
        if self.rank == 0:
            os.makedirs(workdir, exist_ok=True)

    def _emit(self, kind: str, **fields) -> None:
        get_recorder().emit("loop", kind=kind, model=self.serve_name,
                            family=self.family, **fields)

    def _barrier(self) -> None:
        if dist.get_world_size() > 1:
            dist.barrier()

    # -- serving-side lifecycle --------------------------------------------

    def ensure_serving(self, seed: int = 0):
        """Load the first generation (seed-initialized) if ``serve_name`` is
        not yet resident (rank 0; None elsewhere)."""
        if self.engine is None:
            return None
        if self.serve_name in self.engine.models():
            return self.engine._models[self.serve_name]
        return self.engine.load_model(self.serve_name, family=self.family, arm=self.arm,
                                      buckets=self.buckets, seed=seed)

    # -- the cycle stages --------------------------------------------------

    def checkpoint(self) -> str:
        """Fold the elastic pool into the solver (a collective: every rank
        calls it) and snapshot it atomically on rank 0; returns the npz
        path (the rollout's input) on every rank."""
        t0 = time.perf_counter()
        self.trainer.sync_to_solver()
        prefix = os.path.join(self.workdir, f"round{self.trainer.round:05d}")
        path = f"{prefix}.solverstate.npz"
        if self.rank == 0:
            path = self.trainer.solver.save(prefix)
        self.checkpoints += 1
        # the artifact descends from the LAST round folded in (its span id
        # recomputes, no plumbing); a zero-round checkpoint is seed-born
        parent = (obs_lineage.round_span("elastic", self.trainer.round - 1)
                  if self.trainer.round > 0 else None)
        self._emit("checkpoint", round=self.trainer.round,
                   iteration=int(self.trainer.solver.iter), path=path,
                   wall_s=round(time.perf_counter() - t0, 6),
                   lineage=obs_lineage.checkpoint_lineage(path, parent),
                   note="atomic npz (temp + os.replace): pollers never see a "
                        "torn archive")
        return path

    def _build(self, variables, ckpt_span: str) -> dict:
        """``engine.build_candidate`` on a builder thread (its captures land
        on that thread's count, never on the serving thread's); returns
        ``{"candidate" | "error", "build_s", "captures"}``."""
        out: dict = {}
        sentinel = get_sentinel()

        def build() -> None:
            c0 = sentinel.thread_count()
            t0 = time.perf_counter()
            try:
                # the engine's serve events adopt the checkpoint as parent
                with obs_lineage.ambient(ckpt_span):
                    out["candidate"] = self.engine.build_candidate(
                        self.serve_name, family=self.family, arm=self.arm,
                        buckets=self.buckets, variables=variables)
            except BaseException as e:  # re-raised on the caller's thread
                out["error"] = e
            out["build_s"] = time.perf_counter() - t0
            out["captures"] = sentinel.thread_count() - c0

        builder = threading.Thread(target=build, name="rollout-builder")
        builder.start()
        builder.join()
        return out

    def rollout(self, path: str) -> dict | None:
        """Checkpoint -> candidate -> hot swap on rank 0, then a barrier on
        every rank.  Returns the swap telemetry (``version``, ``drained``,
        ``swap_wall_s``, ``build_s``, ``captures``) on rank 0, or None when
        admission pricing refuses the candidate (journaled; the incumbent
        keeps serving) and on every other rank."""
        from sparknet_tpu_torch.loop.deploy import variables_from_checkpoint
        from sparknet_tpu_torch.serve.engine import AdmissionRefused

        if self.engine is None:
            self._barrier()
            return None
        t0 = time.perf_counter()
        ckpt_span = obs_lineage.checkpoint_span(path)
        cand_lineage = {"span": obs_lineage.candidate_span(path), "parent": ckpt_span}
        variables = variables_from_checkpoint(path)
        self._emit("candidate", arm=self.arm, path=path, round=self.trainer.round,
                   lineage=cand_lineage)
        built = self._build(variables, ckpt_span)
        err = built.get("error")
        if isinstance(err, AdmissionRefused):
            self._emit("refused", arm=self.arm, path=path, round=self.trainer.round,
                       lineage=cand_lineage, note=str(err))
            self._barrier()
            return None
        if err is not None:
            raise err
        with obs_lineage.ambient(ckpt_span):
            info = self.engine.swap_model(self.serve_name, built["candidate"])
        info.update(build_s=built["build_s"], captures=built["captures"])
        self.rollouts += 1
        self._emit("rollout", arm=self.arm, path=path, round=self.trainer.round,
                   version=info["version"], drained=info["drained"],
                   lineage={"span": obs_lineage.generation_span(self.serve_name,
                                                                info["version"]),
                            "parent": ckpt_span},
                   wall_s=round(time.perf_counter() - t0, 6))
        # the candidate's captures were made on purpose: fold them into the
        # by-design ledger so the next round's record does not claim them
        get_recorder().absorb_compiles("deploy")
        self.last_rollout = info
        self._barrier()
        return info

    def rollback(self):
        """Restore the previous serving generation (bitwise: the same
        retained ``ServedModel``); returns it.  Rank 0 only."""
        if self.engine is None:
            raise RuntimeError(f"rank {self.rank} holds no engine to roll back")
        prev = self.engine.rollback(self.serve_name)
        self.rollbacks += 1
        self._emit("rollback", version=prev.version,
                   lineage={"span": obs_lineage.generation_span(self.serve_name,
                                                                prev.version)},
                   note="previous generation restored bitwise")
        return prev

    def _sync_plan(self) -> None:
        """Every rank takes rank 0's FaultPlan (a collective)."""
        if dist.get_world_size() == 1:
            return
        box = [self.trainer.plan if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        self.trainer.plan = box[0]

    # -- the loop ----------------------------------------------------------

    def run(self, iterations: int = 1, rounds_per_rollout: int = 2,
            seed: int = 0, before_rollout=None) -> dict:
        """``iterations`` full train -> checkpoint -> rollout cycles against
        the live engine; returns a summary (also journaled).  Every rank
        calls it; ``loss`` is rank 0's last round loss (None when rank 0
        held no worker in it).  ``before_rollout(i)``, when given, runs
        after iteration ``i``'s checkpoint, before its rollout."""
        self.ensure_serving(seed=seed)
        t0 = time.perf_counter()
        losses = []
        for i in range(iterations):
            self._sync_plan()
            losses.append(self.trainer.train(rounds_per_rollout, self.data_fn))
            path = self.checkpoint()
            if before_rollout is not None:
                before_rollout(i)
            self.rollout(path)
        summary = {
            "iterations": iterations,
            "rounds": self.trainer.round,
            "rollouts": self.rollouts,
            "rollbacks": self.rollbacks,
            "checkpoints": self.checkpoints,
            "loss": losses[-1] if losses else 0.0,
            "wall_s": time.perf_counter() - t0,
        }
        fields = {}
        if summary["loss"] is not None:
            fields["loss"] = float(summary["loss"])
        self._emit("summary", iteration=iterations, round=self.trainer.round,
                   rollouts=self.rollouts, rollbacks=self.rollbacks,
                   checkpoints=self.checkpoints, wall_s=round(summary["wall_s"], 6),
                   **fields)
        return summary

    def close(self) -> None:
        """Hand the solver back and end a world of one the trainer formed."""
        self.trainer.close()
