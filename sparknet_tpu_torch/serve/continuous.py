"""Continuous batching: slot-level admission per decode step, no cache.

Counterpart of ``sparknet_tpu/serve/continuous.py``.  The decoder owns a
fixed [slots, seq_len] int32 arena and runs ONE full-window forward of the
char LM per decode step (``Network.apply(..., end="fc")``; on the card its
two attention layers are two flash-attention launches); between steps it
retires finished slots and admits waiting requests into the freed rows.

Exactness: the arena forward is a per-row computation (causal attention
within the row, per-token layers), so a request decoded interleaved with
arbitrary neighbours produces the same greedy continuation as decoded
alone.  Windows are right-padded and the logits are read at the last real
position, which causal masking keeps independent of the padding.  This is
the cacheless cross-check of the paged decoder (``serve/paged.py``).
"""

from __future__ import annotations

import collections
import itertools
import time

import numpy as np
import torch

from sparknet_tpu_torch.common import Phase, resolve_device
from sparknet_tpu_torch.serve.batcher import Ticket

__all__ = ["ContinuousDecoder", "charlm_network"]


def charlm_network(slots: int, seq_len: int, vocab: int, embed_dim: int,
                   heads: int, ffn_dim: int, blocks: int, seed: int,
                   variables, device: torch.device):
    """The TEST-phase char LM ``Network`` of a decoder on ``device`` and its
    variables: ``variables`` moved to the device, or (None) the seeded
    init."""
    from sparknet_tpu_torch.compiler.graph import Network, NetVars
    from sparknet_tpu_torch.models.zoo import charlm

    network = Network(charlm(batch=slots, seq_len=seq_len, vocab=vocab,
                             embed_dim=embed_dim, heads=heads, ffn_dim=ffn_dim,
                             blocks=blocks), Phase.TEST, device=device)
    if variables is None:
        variables = network.init(torch.Generator().manual_seed(seed))
    else:
        variables = NetVars(
            params={k: [t.to(device) for t in v] for k, v in variables.params.items()},
            state={k: {n: t.to(device) for n, t in v.items()}
                   for k, v in variables.state.items()})
    return network, variables


class _Slot:
    __slots__ = ("ticket", "ids", "n_prompt", "remaining")

    def __init__(self, ticket: Ticket, ids: list[int], remaining: int):
        self.ticket = ticket
        self.ids = ids
        self.n_prompt = len(ids)
        self.remaining = remaining


class ContinuousDecoder:
    """Greedy decode over a fixed [slots, seq_len] arena, slot-level
    admission between steps.

    ``variables`` injects charlm weights (a ``NetVars``, moved to the
    decoder's device); the default is the seeded init.  ``device=None``
    means CUDA and raises without a card; tests pass ``device="cpu"``.
    """

    def __init__(self, slots: int = 8, seq_len: int = 32, vocab: int = 64,
                 embed_dim: int = 32, heads: int = 4, ffn_dim: int = 64,
                 blocks: int = 1, seed: int = 0, variables=None, device=None):
        if slots < 2:
            raise ValueError(f"need >= 2 slots, got {slots}")
        self.slots = int(slots)
        self.seq_len = int(seq_len)
        self.vocab = int(vocab)
        self.device = resolve_device(device)
        self.network, self.variables = charlm_network(
            self.slots, self.seq_len, self.vocab, embed_dim, heads, ffn_dim,
            blocks, seed, variables, self.device)
        self._label = torch.zeros((self.slots, self.seq_len), dtype=torch.int32,
                                  device=self.device)
        self._ids = itertools.count()
        self._waiting: collections.deque[_Slot] = collections.deque()
        self._active: dict[int, _Slot] = {}  # slot index -> state
        self._free = list(range(self.slots - 1, -1, -1))
        self.steps = 0
        self.admitted = 0
        self.completed = 0

    # -- submit side -------------------------------------------------------

    def submit(self, prompt_ids, max_new: int) -> Ticket:
        """Queue one generation request; its Ticket resolves with the
        greedy continuation (an int list of length ``max_new``)."""
        prompt = [int(i) for i in prompt_ids]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if any(not 0 <= i < self.vocab for i in prompt):
            raise ValueError(f"prompt ids outside [0, {self.vocab})")
        if max_new <= 0:
            raise ValueError(f"max_new must be positive, got {max_new}")
        ticket = Ticket(next(self._ids), prompt, time.perf_counter())
        self._waiting.append(_Slot(ticket, prompt, int(max_new)))
        return ticket

    def pending(self) -> int:
        return len(self._waiting)

    def active(self) -> int:
        return len(self._active)

    # -- decode loop -------------------------------------------------------

    def forward_logits(self, data) -> torch.Tensor:
        """The arena forward: [slots, seq_len] ids -> ``fc`` logits
        [slots, seq_len, vocab] on the device."""
        with torch.no_grad():
            blobs, _, _ = self.network.apply(
                self.variables, {"data": data, "label": self._label}, end="fc")
        return blobs["fc"]

    def _admit(self) -> int:
        n = 0
        while self._free and self._waiting:
            slot = self._free.pop()
            self._active[slot] = self._waiting.popleft()
            n += 1
        self.admitted += n
        return n

    def step(self) -> int:
        """One decode step: admit into free slots, ONE arena forward, a
        greedy token per active slot, retire finished slots.  Returns
        tokens produced (0 = arena idle)."""
        self._admit()
        if not self._active:
            return 0
        data = np.zeros((self.slots, self.seq_len), np.int32)
        last = {}
        for s, st in self._active.items():
            window = st.ids[-self.seq_len:]
            data[s, :len(window)] = window  # right-pad: causal-safe
            last[s] = len(window) - 1
        # argmax on the device, one host copy a step
        picks = self.forward_logits(data).argmax(-1).cpu().numpy()
        self.steps += 1
        produced = 0
        for s in list(self._active):
            st = self._active[s]
            st.ids.append(int(picks[s, last[s]]))
            st.remaining -= 1
            produced += 1
            if st.remaining == 0:
                st.ticket.resolve(result=st.ids[st.n_prompt:])
                del self._active[s]
                self._free.append(s)
                self.completed += 1
        return produced

    def run(self, max_steps: int = 10_000) -> int:
        """Step until every queued request completes; returns tokens
        produced.  ``max_steps`` is a runaway bound, not a policy."""
        produced = 0
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self._waiting:
                return produced
            produced += n
        raise RuntimeError(
            f"decode did not drain within {max_steps} steps "
            f"({len(self._waiting)} waiting, {len(self._active)} active)")

    def stats(self) -> dict:
        return {"slots": self.slots, "seq_len": self.seq_len,
                "steps": self.steps, "admitted": self.admitted,
                "completed": self.completed}
