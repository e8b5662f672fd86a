"""The obs dryrun's training legs over a world of ranks.

Counterpart of the dp, tau and elastic legs of ``sparknet_tpu/obs/
__main__.py``'s ``dryrun``.  The JAX package runs them on a virtual
8-device CPU mesh in one process; the port runs one process a rank, joined
as ``tpunet train --num-processes`` joins them (a TCP store on this host,
gloo, or NCCL where the machine has a card a rank), with the Recorder
armed on rank 0 (the only rank that journals):

* **dp**: ``ParallelTrainer`` at tau 1 (synchronous SGD), ``rounds``
  rounds;
* **tau**: ``ParallelTrainer`` at ``tau`` (SparkNet's averaging),
  ``rounds`` rounds;
* **elastic** (optional): ``ElasticTrainer`` over the whole world with the
  JAX dryrun's ``FaultPlan``: kill rank W-1 at round 1, join one at round
  2, delay rank 0 by ``tau`` steps at round 2; at least 4 rounds.

Every rank trains the zoo family's net (``GRAPH_SWEEP_FAMILIES``) at 2
examples a rank on seeded synthetic feeds (:func:`feeds_for`).
"""

from __future__ import annotations

import socket
import sys

import numpy as np

PER_RANK = 2  # examples a rank a step (the JAX dryrun's per-device batch)


def feeds_for(family, batch: int, rs: np.random.RandomState, tau: int = 0) -> dict:
    """Synthetic feeds matching the family's data layer shapes (NCHW); a
    leading [tau] axis when the round carries tau local steps.  The port's
    copy of ``sparknet_tpu/parallel/modes.py``'s ``_feeds_for``."""
    if family.feed == "tokens":
        data = rs.randint(0, family.vocab, (batch, family.seq_len))
        data = data.astype(np.int32)
    else:
        data = rs.randn(batch, *family.image_shape).astype(np.float32) * 10
    label = rs.randint(0, family.num_classes, batch).astype(np.int32)
    if tau:
        data = np.stack([data] * tau)
        label = np.stack([label] * tau)
    return {"data": data, "label": label}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, coordinator: str, device: str, journal: str,
              family: str, rounds: int, tau: int, elastic: bool) -> None:
    """One rank of the legs (spawned: module level)."""
    import torch
    import torch.distributed as dist

    from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES
    from sparknet_tpu_torch.obs.recorder import Recorder, set_recorder
    from sparknet_tpu_torch.parallel import (
        ElasticTrainer, FaultPlan, ParallelTrainer, delay, initialize_distributed, join,
        kill)
    from sparknet_tpu_torch.solvers.solver import Solver

    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        # a card a rank (NCCL) where the machine has them; else every rank
        # on the first card, through gloo (NCCL refuses two ranks a card)
        nccl = world <= torch.cuda.device_count()
        dev = torch.device("cuda", rank if nccl else 0)
        backend = "nccl" if nccl else "gloo"
        torch.cuda.set_device(dev)
    initialize_distributed(backend=backend, coordinator=coordinator, rank=rank,
                           world_size=world)
    rec = set_recorder(Recorder(journal)) if rank == 0 else None
    try:
        fam = GRAPH_SWEEP_FAMILIES[family]
        rs = np.random.RandomState(rank)  # each rank its own partition
        for leg_tau in (1, tau):
            if rank == 0:
                print(f"obs dryrun: {'dp' if leg_tau == 1 else f'tau={leg_tau}'} mode, "
                      f"{rounds} round(s) ...", file=sys.stderr)
            tr = ParallelTrainer(Solver(fam.solver(), fam.net(PER_RANK), device=dev),
                                 tau=leg_tau)
            for _ in range(rounds):
                tr.train_round(lambda it: feeds_for(fam, PER_RANK, rs,
                                                    tau=leg_tau if leg_tau > 1 else 0))
            tr.close()
        if elastic:
            n = max(rounds, 4)  # enough rounds for every fault
            if rank == 0:
                print(f"obs dryrun: elastic mode, {n} round(s) with kill/join/straggle ...",
                      file=sys.stderr)
            plan = FaultPlan([kill(world - 1, at_round=1), join(at_round=2),
                              delay(0, at_round=2, steps=tau)])
            el = ElasticTrainer(Solver(fam.solver(), fam.net(PER_RANK), device=dev),
                                width=world, tau=tau, plan=plan)
            el.train(n, lambda g: feeds_for(fam, PER_RANK, np.random.RandomState(g % 997)))
            el.close()
    finally:
        if rec is not None:
            rec.close()
            set_recorder(None)
        dist.destroy_process_group()


def train_legs(*, devices: int, rounds: int, tau: int, family: str, elastic: bool,
               device: str, journal: str, timeout_s: float = 900.0) -> int:
    """Spawn ``devices`` ranks running :func:`rank_main`; 0 when every rank
    exits 0, else 1."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=rank_main, name=f"obs-dryrun-rank-{r}",
                         args=(r, devices, coordinator, device, journal, family,
                               rounds, tau, elastic))
             for r in range(devices)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    rc = 0
    for r, p in enumerate(procs):
        if p.is_alive():
            p.terminate()
            p.join(10.0)
            print(f"obs dryrun: rank {r} did not finish in {timeout_s:.0f} s",
                  file=sys.stderr)
            rc = 1
        elif p.exitcode != 0:
            print(f"obs dryrun: rank {r} exited {p.exitcode}", file=sys.stderr)
            rc = 1
    return rc
