"""Causal lineage: deterministic trace spans across the whole loop.

Counterpart of ``sparknet_tpu/obs/lineage.py``, copied whole: the span
ids are strings made from their inputs alone, so the port mints the same
ids as the JAX package for the same inputs.

SparkNet had no cross-subsystem provenance at all (a trained model was
whatever the master last averaged, ref: src/main/scala/apps/
CifarApp.scala:134).  This module adds the edges without runtime id
plumbing: every span id is a pure function of identifiers the subsystems
already carry (the shard cursor, the round counter, the checkpoint
basename, the serve swap generation), so producers mint ids
independently and the ids LINK BY RECOMPUTATION: the checkpoint names its
parent round without the trainer passing anything down.

Span vocabulary (host-side strings; lineage never enters a captured
graph or a kernel's arguments):

- ``shard:<g>``         one global batch index of the shard cursor
                        (events carry ``shards: [lo, hi]`` ranges)
- ``feed:<name>``       a feed reporting window; ``batches: [lo, hi]``
                        is the global-index range it delivered
- ``round:<mode>:<n>``  one training round; ``shards`` the range it
                        consumed
- ``ckpt:<basename>``   one checkpoint artifact; parent is the last
                        round folded into it
- ``candidate:<basename>`` deploy-arm variables read from an artifact
- ``gen:<model>:v<V>``  one serve generation (the swap counter);
                        request events name their generation as parent
- ``seed:<n>``          a ROOT: weights born from an RNG seed (no
                        parent resolution expected)

An event participates by carrying an optional ``lineage`` dict
(``{"span": <id>, "parent": <id>, ...attrs}``), validated structurally
by the schema (``lineage: dict``) and semantically by :func:`audit`:
every ``parent`` must resolve to a span some event in the journal
defines, or be a declared root.

Deliberately stdlib-only.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Iterable, Iterator

__all__ = [
    "ROOT_PREFIXES",
    "feed_span", "round_span", "checkpoint_span", "candidate_span",
    "generation_span", "seed_root",
    "feed_lineage", "round_lineage", "checkpoint_lineage",
    "ambient", "current_parent",
    "spans", "audit", "chain",
]

# parents with these prefixes are roots: they name where state was BORN
# (an RNG seed), not an event, so audit never expects a definition
ROOT_PREFIXES = ("seed:",)

# events whose lineage["span"] DEFINES a span other events may name as
# parent (request events only consume — their per-ticket span ids would
# swamp the journal for nothing)
_DEFINING_EVENTS = ("feed", "round", "loop", "serve", "replica")


# -- span id minting (pure functions of existing identifiers) -----------

def feed_span(name: str) -> str:
    return f"feed:{name}"


def round_span(mode: str, rnd: int) -> str:
    return f"round:{mode}:{int(rnd)}"


def checkpoint_span(path: str) -> str:
    return f"ckpt:{os.path.basename(path)}"


def candidate_span(path: str) -> str:
    return f"candidate:{os.path.basename(path)}"


def generation_span(model: str, version: int) -> str:
    return f"gen:{model}:v{int(version)}"


def seed_root(seed: int) -> str:
    return f"seed:{int(seed)}"


# -- lineage payload builders ------------------------------------------

def feed_lineage(name: str, first_index: int, last_index: int) -> dict:
    """One feed window's lineage: the global batch-index range the ring
    delivered — minted from the deterministic ``(epoch, index)`` cursor
    (``data/records.py RecordShardSource._record_ids`` territory)."""
    return {"span": feed_span(name),
            "batches": [int(first_index), int(last_index)]}


def round_lineage(mode: str, rnd: int, shard_lo: int,
                  shard_hi: int) -> dict:
    """One round's lineage: the inclusive global shard-id range it
    consumed (elastic's ``round_shards`` grid; iteration range for the
    fixed-mesh modes)."""
    return {"span": round_span(mode, rnd),
            "shards": [int(shard_lo), int(shard_hi)]}


def checkpoint_lineage(path: str, parent: str | None) -> dict:
    fields: dict = {"span": checkpoint_span(path)}
    if parent:
        fields["parent"] = parent
    return fields


# -- ambient parent context --------------------------------------------
# For producer call sites that cannot take a parent through their API
# without entangling layers (the loop drives engine.build_candidate /
# swap_model; the engine should not grow checkpoint parameters).  The
# loop pushes its checkpoint span; the engine's serve events adopt it.

_ambient = threading.local()


@contextmanager
def ambient(parent: str | None) -> Iterator[None]:
    """Push a parent span for lineage minted inside the block (this
    thread only; re-entrant — inner pushes shadow outer ones)."""
    stack = getattr(_ambient, "stack", None)
    if stack is None:
        stack = _ambient.stack = []
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def current_parent() -> str | None:
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


# -- journal-side resolution -------------------------------------------

def spans(events: Iterable[dict]) -> dict[str, dict]:
    """Span id -> the event that defined it (first definition wins;
    later re-definitions of the same deterministic id describe the same
    thing, e.g. the same generation booted on two replicas)."""
    defined: dict[str, dict] = {}
    for ev in events:
        if ev.get("event") not in _DEFINING_EVENTS:
            continue
        lin = ev.get("lineage")
        if isinstance(lin, dict):
            span = lin.get("span")
            if isinstance(span, str) and span not in defined:
                defined[span] = ev
    return defined


def _is_root(parent: str) -> bool:
    return parent.startswith(ROOT_PREFIXES)


def audit(events: Iterable[dict]) -> dict:
    """Semantic lineage check over one journal: every ``parent`` ref
    must resolve to a defined span or a declared root.  Returns
    ``{"spans", "edges", "requests_linked", "dangling"}`` — a journal is
    lineage-complete when ``dangling`` is empty (and, where both
    training and serving ran, :func:`chain` walks a ticket back to its
    shard range)."""
    events = list(events)
    defined = spans(events)
    edges = 0
    requests_linked = 0
    dangling: list[str] = []
    for ev in events:
        lin = ev.get("lineage")
        if not isinstance(lin, dict):
            continue
        parent = lin.get("parent")
        if not isinstance(parent, str):
            continue
        edges += 1
        if ev.get("event") == "request":
            requests_linked += 1
        if parent not in defined and not _is_root(parent):
            ref = lin.get("span") or ev.get("event")
            dangling.append(f"{ref} -> {parent}")
    return {"spans": len(defined), "edges": edges,
            "requests_linked": requests_linked,
            "dangling": sorted(set(dangling))}


def chain(events: Iterable[dict], lin: dict,
          max_depth: int = 16) -> list[dict]:
    """Walk one lineage dict up its parent edges.  Each hop is
    ``{"span", "event", "attrs"}`` — the span id, the name of the event
    that defined it (None for the starting lineage and for roots), and
    the defining lineage dict (None when the parent ref is dangling).
    Ends at a root, an unresolvable parent, or ``max_depth``."""
    defined = spans(events)
    hops: list[dict] = []
    span = lin.get("span")
    attrs: dict | None = lin
    event_name: str | None = None
    seen: set[str] = set()
    while len(hops) < max_depth:
        hops.append({"span": span, "event": event_name, "attrs": attrs})
        parent = attrs.get("parent") if isinstance(attrs, dict) else None
        if not isinstance(parent, str) or parent in seen:
            break
        seen.add(parent)
        if _is_root(parent):
            hops.append({"span": parent, "event": None,
                         "attrs": {"span": parent}})
            break
        ev = defined.get(parent)
        if ev is None:
            hops.append({"span": parent, "event": None, "attrs": None})
            break
        span = parent
        attrs = ev.get("lineage") or {}
        event_name = ev.get("event")
    return hops
