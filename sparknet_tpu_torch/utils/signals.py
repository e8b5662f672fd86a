"""Graceful stop/snapshot on signals.

Counterpart of ``sparknet_tpu/utils/signals.py``, the equivalent of Caffe's
signal control (ref: caffe/src/caffe/util/signal_handler.cpp:16-43 maps
SIGINT/SIGHUP to ``SolverAction::{STOP,SNAPSHOT}``, polled once per
iteration in Solver::Step, ref: caffe/src/caffe/solver.cpp:267-280).
Async-signal-safe by construction: the handler only flips a flag; the
training loop polls ``check()`` between steps.
"""

from __future__ import annotations

import enum
import signal

import torch
import torch.distributed as dist


class SolverAction(enum.Enum):
    NONE = 0
    STOP = 1
    SNAPSHOT = 2


# the order in which actions win an agreement: any STOP, else any SNAPSHOT
_PRIORITY = (SolverAction.NONE, SolverAction.SNAPSHOT, SolverAction.STOP)


def agree_action(action: SolverAction, group=None) -> SolverAction:
    """Agree on one action across the processes of ``group`` (default: the
    whole default group).

    POSIX delivers a signal to one process only, but acting on it involves
    collectives (``sync_to_solver``) and control flow (breaking the round
    loop) that every process must take together, or the run diverges into a
    distributed hang.  Each process contributes its locally-pending action;
    any STOP wins, else any SNAPSHOT, else NONE: a MAX all-reduce of each
    action's rank in that order.  Without a process group, or in a world of
    one: the identity, no collective.
    """
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return action
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    code = torch.tensor([_PRIORITY.index(action)], dtype=torch.int32, device=device)
    dist.all_reduce(code, op=dist.ReduceOp.MAX, group=group)
    return _PRIORITY[int(code.item())]


class SignalHandler:
    """Install with desired actions; poll ``check()`` each iteration."""

    def __init__(
        self,
        sigint_action: SolverAction = SolverAction.STOP,
        sighup_action: SolverAction = SolverAction.SNAPSHOT,
    ):
        self._actions = {
            signal.SIGINT: sigint_action,
            signal.SIGHUP: sighup_action,
        }
        self._pending: SolverAction = SolverAction.NONE
        self._previous: dict[int, object] = {}

    def _handler(self, signum, frame):
        self._pending = self._actions.get(signum, SolverAction.NONE)

    def install(self) -> "SignalHandler":
        for sig, action in self._actions.items():
            if action is not SolverAction.NONE:
                self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def check(self) -> SolverAction:
        """Pop the pending action (one-shot, like GotSIGINT/GotSIGHUP)."""
        action, self._pending = self._pending, SolverAction.NONE
        return action

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
