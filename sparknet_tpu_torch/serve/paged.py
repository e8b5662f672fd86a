"""Paged K/V-cache decode: token serving without O(seq_len) recompute.

Counterpart of ``sparknet_tpu/serve/paged.py``:

* **Block pool**: K/V live in fixed-size blocks inside shared
  ``[n_attn_layers, num_blocks, block_tokens, H, D]`` pools on the device
  (``torch.zeros``: a line no request wrote stays 0, so every stale line
  the kernel could meet is finite).  A free list hands blocks out; each
  slot owns an int32 block table.  Block 0 is the null block: unused
  table entries point at it and the attention mask keeps it out of every
  live row.  The zero-leak ledger: over a drained run, ``allocated -
  freed == 0``.
* **Prefill/decode disaggregation**: a prompt is ONE full-window forward
  (``models/zoo.build_prefill``: flash attention, writing K/V through the
  tables); every later token is ONE cached step
  (``models/zoo.build_decode_step``: paged attention) over the slot
  arena.  Params + pools are priced against the device's memory before
  any pool is allocated (``AdmissionRefused``).
* **Exactness**: every row's decode output is a function of its own
  (token, position, table), so interleaved decode gives the same greedy
  continuation as decoding alone.

What differs from the JAX decoder: PyTorch runs eagerly and compiles
nothing (no AOT programs, no recompile sentinel); the pools are updated
in place; ``hbm_bytes`` defaults to the card's memory; ``stats()`` carries
TTFT, inter-token and decode-step percentiles (host clock).  Prefill
shape: the JAX decoder pads admissions to a power-of-two ladder of row
buckets; here every prefill runs at the full ``slots`` rows on every
device, because a GEMM of another row count may take another kernel
(cuBLAS, or a threaded CPU GEMM) and so other bits for the same row, and
"interleaved == alone" would break.

With the obs Recorder armed (``recorder=``, or ``SPARKNET_OBS``) the
decoder journals the JAX decoder's ``token`` events, with its names and
fields: ``admission_refused``, one ``request`` a retired generation, one
``prefill`` a prefill (its ``bucket`` is the rows it ran: ``slots``), and a
``summary`` when :meth:`PagedDecoder.run` drains.  With it off no event is
built and no wall is taken for one.

The graph-analysis twins (``build_rect_program``/``build_decode_program``)
are ROADMAP Queue A14.
"""

from __future__ import annotations

import collections
import itertools
import math
import time

import numpy as np
import torch

from sparknet_tpu_torch.common import resolve_device
from sparknet_tpu_torch.ops.kernels import kernel_head_dim
from sparknet_tpu_torch.serve.batcher import Ticket
from sparknet_tpu_torch.serve.continuous import charlm_network
from sparknet_tpu_torch.serve.engine import AdmissionRefused, percentile
from sparknet_tpu_torch.serve.residency import HBM_USABLE_FRAC

__all__ = [
    "BlockPool",
    "PagedDecoder",
    "PoolExhausted",
    "TokenRouter",
    "capacity_ratio",
    "pool_bytes",
]


class PoolExhausted(RuntimeError):
    """An allocation the free list cannot cover (admission backpressure:
    the decoder keeps the request queued)."""


class BlockPool:
    """Free-list block allocator with an exact zero-leak ledger.

    Block 0 is the NULL block: never allocated, never freed.  ``alloc`` is
    all-or-nothing; ``free`` refuses double-frees and foreign ids."""

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (null + 1 usable), got {num_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        # LIFO free list over 1..N-1; block 0 is the null block
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._owned: set[int] = set()
        self.allocated = 0
        self.freed = 0

    def available(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return len(self._owned)

    def alloc(self, n: int) -> list[int]:
        if n <= 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(f"need {n} blocks, {len(self._free)} free of "
                                f"{self.num_blocks - 1} usable")
        blocks = [self._free.pop() for _ in range(n)]
        self._owned.update(blocks)
        self.allocated += n
        return blocks

    def free(self, blocks) -> None:
        blocks = list(blocks)
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is the null block — never freed")
            if b not in self._owned:
                raise ValueError(f"block {b} is not allocated (double-free or foreign id)")
        for b in blocks:
            self._owned.discard(b)
            self._free.append(b)
        self.freed += len(blocks)

    def ledger(self) -> dict:
        """At quiesce (nothing in use), ``leaked`` must be 0."""
        return {"allocated": self.allocated, "freed": self.freed,
                "in_use": len(self._owned),
                "leaked": self.allocated - self.freed - len(self._owned)}


def pool_bytes(n_attn: int, num_blocks: int, block_tokens: int, heads: int,
               head_dim: int, itemsize: int = 4) -> int:
    """Exact K+V pool bytes, the paged plane's admission price."""
    return 2 * n_attn * num_blocks * block_tokens * heads * head_dim * itemsize


def capacity_ratio(seq_len: int, block_tokens: int, totals) -> float:
    """Concurrent-sequence capacity of paged vs rectangle K/V residency at
    equal memory: a rectangle reserves ``seq_len`` lines a sequence, paged
    ``ceil(total / T) * T``.  ``totals``: per-request prompt + generated
    lengths."""
    totals = [int(t) for t in totals]
    if not totals:
        raise ValueError("capacity_ratio needs at least one request")
    paged = sum(math.ceil(t / block_tokens) * block_tokens for t in totals) / len(totals)
    return float(seq_len) / paged


class _Gen:
    __slots__ = ("ticket", "ids", "n_prompt", "remaining", "blocks",
                 "t_prev", "logits", "t_first", "deltas_ms")

    def __init__(self, ticket: Ticket, ids: list[int], remaining: int):
        self.ticket = ticket
        self.ids = ids
        self.n_prompt = len(ids)
        self.remaining = remaining
        self.blocks: list[int] = []
        self.t_prev: float | None = None
        self.logits: list = []
        self.t_first: float | None = None
        self.deltas_ms: list[float] = []  # inter-token gaps, journaled runs only


class PagedDecoder:
    """Greedy decode over a block-paged K/V cache: prefill of newly
    admitted rows, then one cached decode step over a fixed [slots] arena.
    API mirrors ``ContinuousDecoder`` (submit / pending / active / step /
    run / stats).

    ``num_blocks`` defaults to full capacity (every slot can hold
    ``seq_len`` tokens).  Requests with ``n_prompt + max_new > seq_len``
    are refused at submit: RoPE positions are absolute, so the cache never
    slides.  ``device=None`` means CUDA and raises without a card;
    ``hbm_bytes`` (the memory admission prices against) defaults to the
    card's, and must be given on the CPU.  ``keep_logits`` keeps every
    generated token's logits row on the device (``generation_logits``,
    by ticket id) for checks against a full-window forward.  ``recorder``
    (default: the process's, ``obs.get_recorder()``) journals the ``token``
    events under ``note=run_id`` (a ``TokenRouter``'s replica
    ``token_router/r<i>``).
    """

    def __init__(self, slots: int = 8, seq_len: int = 32, vocab: int = 64,
                 embed_dim: int = 32, heads: int = 4, ffn_dim: int = 64,
                 blocks: int = 1, seed: int = 0, variables=None, device=None,
                 block_tokens: int = 8, num_blocks: int | None = None,
                 hbm_bytes: int | None = None, keep_logits: bool = False,
                 recorder=None, run_id: str = "paged"):
        from sparknet_tpu_torch.models.zoo import (
            build_decode_step, build_prefill, decode_spec)
        from sparknet_tpu_torch.obs.recorder import get_recorder

        if slots < 2:
            raise ValueError(f"need >= 2 slots, got {slots}")
        self.slots = int(slots)
        self.seq_len = int(seq_len)
        self.vocab = int(vocab)
        self.block_tokens = int(block_tokens)
        self.device = resolve_device(device)
        self._rec = recorder if recorder is not None else get_recorder()
        self._run_id = run_id
        if hbm_bytes is None:
            if self.device.type != "cuda":
                raise ValueError("hbm_bytes: pass the memory to price "
                                 "admission against when not on CUDA")
            hbm_bytes = torch.cuda.get_device_properties(self.device).total_memory
        self.network, self.variables = charlm_network(
            self.slots, self.seq_len, self.vocab, embed_dim, heads, ffn_dim,
            blocks, seed, variables, self.device)
        self.spec = decode_spec(self.network)
        # table width: the most blocks any request can ever need
        self.blocks_per_slot = math.ceil(self.seq_len / self.block_tokens)
        if num_blocks is None:
            num_blocks = 1 + self.slots * self.blocks_per_slot
        self.pool = BlockPool(num_blocks, self.block_tokens)

        # -- admission pricing BEFORE any pool is allocated ---------------
        params_bytes = sum(t.numel() * t.element_size()
                           for pl in self.variables.params.values() for t in pl)
        n_attn = len(self.spec.attn_layers)
        # the pools hold each head at the attention kernels' width (zero
        # lanes beyond the head), on every device; priced as allocated
        h, d = self.spec.heads, kernel_head_dim(self.spec.head_dim)
        self.pool_hbm_bytes = pool_bytes(n_attn, num_blocks, self.block_tokens, h, d)
        predicted = params_bytes + self.pool_hbm_bytes
        budget = int(hbm_bytes * HBM_USABLE_FRAC)
        if predicted > budget:
            if self._rec:
                self._rec.emit("token", kind="admission_refused", note=self._run_id,
                               predicted_bytes=predicted, budget_bytes=budget,
                               blocks_total=num_blocks - 1)
            raise AdmissionRefused({
                "family": "charlm", "max_bucket": self.slots,
                "predicted_bytes": predicted, "resident_bytes": 0,
                "budget_bytes": budget, "priced": True, "fits": False})

        shape = (n_attn, num_blocks, self.block_tokens, h, d)
        self._k_pool = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._v_pool = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._tables = np.zeros((self.slots, self.blocks_per_slot), np.int32)
        self._decode_fn = build_decode_step(self.network)
        self._prefill_fn = build_prefill(self.network)

        self.keep_logits = bool(keep_logits)
        self.generation_logits: dict[int, torch.Tensor] = {}
        self._ids = itertools.count()
        self._waiting: collections.deque[_Gen] = collections.deque()
        self._active: dict[int, _Gen] = {}
        self._free_slots = list(range(self.slots - 1, -1, -1))
        self.steps = 0
        self.prefills = 0
        self.admitted = 0
        self.completed = 0
        self._ttft_ms: list[float] = []
        self._inter_ms: list[float] = []
        self._step_ms: list[float] = []
        self._prefill_ms: list[float] = []

    # -- submit side -------------------------------------------------------

    def submit(self, prompt_ids, max_new: int) -> Ticket:
        """Queue one generation; the Ticket resolves with the greedy
        continuation (int list of length ``max_new``)."""
        prompt = [int(i) for i in prompt_ids]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if any(not 0 <= i < self.vocab for i in prompt):
            raise ValueError(f"prompt ids outside [0, {self.vocab})")
        if max_new <= 0:
            raise ValueError(f"max_new must be positive, got {max_new}")
        if len(prompt) + max_new > self.seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds the "
                f"{self.seq_len}-token context — the paged cache never slides "
                "(absolute RoPE positions)")
        ticket = Ticket(next(self._ids), prompt, time.perf_counter())
        self._waiting.append(_Gen(ticket, prompt, int(max_new)))
        return ticket

    def pending(self) -> int:
        return len(self._waiting)

    def active(self) -> int:
        return len(self._active)

    # -- decode loop -------------------------------------------------------

    def _retire(self, slot: int) -> None:
        st = self._active.pop(slot)
        st.ticket.resolve(result=st.ids[st.n_prompt:])
        if self.keep_logits:
            self.generation_logits[st.ticket.id] = torch.stack(st.logits)
        self.pool.free(st.blocks)
        self._tables[slot] = 0
        self._free_slots.append(slot)
        self.completed += 1
        if self._rec:
            d = sorted(st.deltas_ms)
            self._rec.emit(
                "token", kind="request", note=self._run_id,
                tokens=len(st.ids) - st.n_prompt, prompt_tokens=st.n_prompt,
                ttft_ms=round((st.t_first - st.ticket.t_submit) * 1e3, 3),
                total_ms=round((time.perf_counter() - st.ticket.t_submit) * 1e3, 3),
                inter_token_p50_ms=round(d[len(d) // 2], 3) if d else 0.0,
                inter_token_max_ms=round(d[-1], 3) if d else 0.0)

    def _admit(self) -> list[int]:
        """A request enters only when a slot AND its whole block budget
        (``ceil((n_prompt + max_new) / T)``, allocated up front so a
        generation never dies of pool exhaustion) are free.  FIFO without
        skipping."""
        newly: list[int] = []
        while self._free_slots and self._waiting:
            st = self._waiting[0]
            need = math.ceil((st.n_prompt + st.remaining) / self.block_tokens)
            try:
                blocks = self.pool.alloc(need)
            except PoolExhausted:
                break
            self._waiting.popleft()
            st.blocks = blocks
            slot = self._free_slots.pop()
            self._active[slot] = st
            self._tables[slot] = 0
            self._tables[slot, :need] = blocks
            newly.append(slot)
        self.admitted += len(newly)
        return newly

    def _emit(self, slot: int, token: int, logits, now: float) -> None:
        st = self._active[slot]
        st.ids.append(token)
        st.remaining -= 1
        if self.keep_logits:
            st.logits.append(logits)
        if st.t_prev is None:
            st.t_first = now
            self._ttft_ms.append((now - st.ticket.t_submit) * 1e3)
        else:
            self._inter_ms.append((now - st.t_prev) * 1e3)
            if self._rec:
                st.deltas_ms.append(self._inter_ms[-1])
        st.t_prev = now
        if st.remaining == 0:
            self._retire(slot)

    def _prefill(self, slots: list[int]) -> int:
        """One prefill over the newly admitted rows: writes their prompt
        K/V through the tables and emits each row's FIRST generated token.
        It always has ``slots`` rows, so a prompt's K/V and first token do
        not depend on how many requests it was admitted with; pad rows have
        length 1 and null tables.  Returns tokens produced."""
        pb = self.slots
        s, mb = self.seq_len, self.blocks_per_slot
        # one int32 upload: tokens [pb, S] | lengths [pb] | tables [pb, MB]
        host = np.zeros(pb * (s + 1 + mb), np.int32)
        tokens = host[:pb * s].reshape(pb, s)
        lengths = host[pb * s:pb * (s + 1)]
        tables = host[pb * (s + 1):].reshape(pb, mb)
        lengths[:] = 1
        for i, slot in enumerate(slots):
            st = self._active[slot]
            tokens[i, :st.n_prompt] = st.ids
            lengths[i] = st.n_prompt
            tables[i] = self._tables[slot]
        t0 = time.perf_counter()
        dev = torch.from_numpy(host).to(self.device)
        last = self._prefill_fn(
            self.variables, dev[:pb * s].view(pb, s), dev[pb * s:pb * (s + 1)],
            self._k_pool, self._v_pool, dev[pb * (s + 1):].view(pb, mb))
        picks = last[:len(slots)].argmax(-1).cpu().tolist()  # one host copy
        now = time.perf_counter()
        self._prefill_ms.append((now - t0) * 1e3)
        self.prefills += 1
        for i, slot in enumerate(slots):
            self._emit(slot, picks[i], last[i], now)
        if self._rec:
            self._rec.emit(
                "token", kind="prefill", note=self._run_id, rows=len(slots), bucket=pb,
                prompt_tokens=int(lengths[:len(slots)].sum()),
                wall_ms=round((now - t0) * 1e3, 3), blocks_free=self.pool.available(),
                blocks_total=self.pool.num_blocks - 1)
        return len(slots)

    def step(self) -> int:
        """One engine tick: admit + prefill new rows, then ONE cached
        decode step over the arena.  Returns tokens produced."""
        produced = 0
        newly = self._admit()
        if newly:
            produced += self._prefill(newly)
        if not self._active:
            return produced
        n, mb = self.slots, self.blocks_per_slot
        # one int32 upload: tokens [n] | positions [n] | tables [n, MB];
        # idle rows decode token 0 at position 0 into the null block
        host = np.zeros(n * (2 + mb), np.int32)
        for slot, st in self._active.items():
            host[slot] = st.ids[-1]
            host[n + slot] = len(st.ids) - 1
        host[2 * n:] = self._tables.reshape(-1)
        t0 = time.perf_counter()
        dev = torch.from_numpy(host).to(self.device)
        logits = self._decode_fn(
            self.variables, self._k_pool, self._v_pool, dev[:n].view(n, 1),
            dev[n:2 * n], dev[2 * n:].view(n, mb))[:, 0]
        picks = logits.argmax(-1).cpu().tolist()  # one host copy
        now = time.perf_counter()
        self._step_ms.append((now - t0) * 1e3)
        self.steps += 1
        for slot in list(self._active):
            self._emit(slot, picks[slot], logits[slot], now)
            produced += 1
        return produced

    def run(self, max_steps: int = 10_000) -> int:
        """Step until every queued request completes; returns tokens
        produced.  ``max_steps`` is a runaway bound, not a policy."""
        produced = 0
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self._waiting:
                self._emit_summary()
                return produced
            produced += n
        raise RuntimeError(
            f"decode did not drain within {max_steps} steps "
            f"({len(self._waiting)} waiting, {len(self._active)} active)")

    def _emit_summary(self) -> None:
        if not self._rec:
            return
        ledger = self.pool.ledger()
        # compiles: the port captures no graph on the decode path
        self._rec.emit(
            "token", kind="summary", note=self._run_id, requests=self.completed,
            steps=self.steps, prefills=self.prefills, compiles=0,
            allocated=ledger["allocated"], freed=ledger["freed"], leaked=ledger["leaked"],
            dropped=0, blocks_total=self.pool.num_blocks - 1,
            blocks_free=self.pool.available())

    def stats(self) -> dict:
        """Counters, the pool ledger, and host-clock percentiles (ms):
        time to first token (submit to the prefill's host copy), the gaps
        between a request's later tokens, and the decode step and prefill
        walls (upload to host copy)."""
        pct = {}
        for name, vals in (("ttft", self._ttft_ms), ("inter_token", self._inter_ms),
                           ("decode_step", self._step_ms), ("prefill", self._prefill_ms)):
            for q in (50, 99):
                pct[f"{name}_ms_p{q}"] = percentile(vals, q)
        return {
            "slots": self.slots, "seq_len": self.seq_len,
            "block_tokens": self.block_tokens,
            "blocks_total": self.pool.num_blocks - 1,
            "pool_hbm_bytes": self.pool_hbm_bytes,
            "steps": self.steps, "prefills": self.prefills,
            "admitted": self.admitted, "completed": self.completed,
            **pct, "ledger": self.pool.ledger(),
        }


class TokenRouter:
    """K ``PagedDecoder`` replicas, least-projected-work routing, a fair
    one-step-per-replica sweep, and the zero-drop ledger (``submitted -
    resolved`` must be 0 over any drained run).  Single-threaded: the
    sweep is the scheduler."""

    def __init__(self, replicas: int = 2, **decoder_kwargs):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        # each replica journals under its own note, as the JAX router names them
        run_id = decoder_kwargs.pop("run_id", "token_router")
        self.decoders = [PagedDecoder(run_id=f"{run_id}/r{i}", **decoder_kwargs)
                         for i in range(replicas)]
        self.submitted = 0
        self._tickets: list[Ticket] = []
        self._sweep = 0

    def _projected_work(self, d: PagedDecoder) -> int:
        """Tokens this replica is still committed to emit."""
        return (sum(st.remaining for st in d._active.values())
                + sum(st.remaining for st in d._waiting))

    def submit(self, prompt_ids, max_new: int) -> Ticket:
        d = min(self.decoders, key=self._projected_work)
        ticket = d.submit(prompt_ids, max_new)
        self.submitted += 1
        self._tickets.append(ticket)
        return ticket

    def sweep(self) -> int:
        """One fair pass: every replica gets exactly one step, rotated so
        no replica is systematically first."""
        n = len(self.decoders)
        produced = 0
        for i in range(n):
            produced += self.decoders[(self._sweep + i) % n].step()
        self._sweep = (self._sweep + 1) % n
        return produced

    def run(self, max_steps: int = 10_000) -> int:
        produced = 0
        for _ in range(max_steps):
            n = self.sweep()
            if n == 0 and not any(d.pending() for d in self.decoders):
                return produced
            produced += n
        raise RuntimeError(f"router did not drain within {max_steps} sweeps")

    def resolved(self) -> int:
        return sum(1 for t in self._tickets if t.done())

    def ledger(self) -> dict:
        pool = {"allocated": 0, "freed": 0, "in_use": 0, "leaked": 0}
        for d in self.decoders:
            for k, v in d.pool.ledger().items():
                pool[k] += v
        return {"submitted": self.submitted, "resolved": self.resolved(),
                "dropped": self.submitted - self.resolved(), "pool": pool}

    def stats(self) -> dict:
        return {"replicas": len(self.decoders), "ledger": self.ledger(),
                "decoders": [d.stats() for d in self.decoders]}
