"""Autoregressive sampling from a trained causal LM (``models.charlm``).

Counterpart of ``sparknet_tpu/models/generate.py``.  Decoding rides the
cached per-token step of token serving (``models/zoo.build_prefill`` and
``build_decode_step``): the prompt is ONE full-window prefill (the flash
attention kernel) that writes K/V through a single-slot block table, then
every generated char is ONE cached step (the paged attention kernel)
instead of an O(seq_len) re-forward.  The two programs and the pools are
built once and cached on the net handle.

When the requested continuation cannot fit the window
(``len(prompt) + n > seq_len``) the cache would have to slide, and
absolute RoPE positions make a slid cache line invalid: those calls take
the sliding-window full forward instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sparknet_tpu_torch.data.text import CharVocab

BLOCK_TOKENS = 8  # tokens a block of the single-slot pool


def _cached_decode_fns(net, seq_len: int, logits_blob: str):
    """Build (or fetch) the prefill and decode-step programs and the
    single-slot pool for ``net``'s TEST graph.  Returns None when the graph
    is not a cacheable decoder (``decode_spec`` refuses) or its window is
    not ``seq_len``: callers take the full-forward path."""
    from sparknet_tpu_torch.models.zoo import (
        build_decode_step, build_prefill, decode_spec)
    from sparknet_tpu_torch.ops.kernels import kernel_head_dim

    cache = getattr(net, "_decode_cache", None)
    if cache is None:
        cache = net._decode_cache = {}
    key = (seq_len, logits_blob)
    if key in cache:
        return cache[key]
    network = net.test_net
    try:
        spec = decode_spec(network, end=logits_blob)
    except (KeyError, ValueError):
        cache[key] = None
        return None
    if spec.seq_len != seq_len:
        cache[key] = None
        return None
    mb = math.ceil(seq_len / BLOCK_TOKENS)
    # pools at the kernel's width, zero beyond the head (as PagedDecoder's)
    k_pool = torch.zeros((len(spec.attn_layers), 1 + mb, BLOCK_TOKENS, spec.heads,
                          kernel_head_dim(spec.head_dim)), dtype=torch.float32,
                         device=net.device)
    cache[key] = {
        "prefill": build_prefill(network, end=logits_blob),
        "step": build_decode_step(network, end=logits_blob),
        "k_pool": k_pool,
        "v_pool": torch.zeros_like(k_pool),
        "tables": torch.arange(1, mb + 1, dtype=torch.int32, device=net.device)[None, :],
    }
    return cache[key]


def _pick(logits: np.ndarray, temperature: float, top_k: int, rs) -> int:
    logits = logits.astype(np.float64)
    if top_k > 0:
        cut = np.sort(logits)[-top_k]
        logits = np.where(logits < cut, -np.inf, logits)
    if temperature <= 0:
        return int(np.argmax(logits))
    z = (logits - logits.max()) / temperature
    p = np.exp(z) / np.exp(z).sum()
    return int(rs.choice(p.size, p=p))


def generate_chars(
    net,
    vocab: CharVocab,
    prompt: str,
    n: int,
    seq_len: int,
    temperature: float = 1.0,
    top_k: int = 0,
    seed: int | None = 0,
    logits_blob: str = "fc",
) -> str:
    """Sample ``n`` chars continuing ``prompt`` from a trained ``TPUNet``
    built over ``models.charlm(batch=1, seq_len=seq_len, ...)``, on the
    handle's device.

    ``temperature=0`` decodes greedily; ``top_k > 0`` restricts sampling
    to the k most likely chars (numpy draws from ``seed``, as the JAX
    package's).  While the continuation fits the ``seq_len`` window the
    decode is cached: one prefill, then one step per char; longer requests
    slide the window through the full forward."""
    if not prompt:
        raise ValueError("prompt must be non-empty")
    if n <= 0:
        return ""
    rs = np.random.RandomState(seed)
    ids = list(vocab.encode(prompt))
    n_prompt = len(ids)
    dev = net.device

    fns = None
    if n_prompt + n <= seq_len:
        fns = _cached_decode_fns(net, seq_len, logits_blob)
    if fns is not None:
        variables = net.solver.variables
        tokens = torch.zeros((1, seq_len), dtype=torch.int32)
        tokens[0, :n_prompt] = torch.as_tensor(ids)
        last = fns["prefill"](variables, tokens.to(dev),
                              torch.tensor([n_prompt], dtype=torch.int32, device=dev),
                              fns["k_pool"], fns["v_pool"], fns["tables"])
        ids.append(_pick(last[0].cpu().numpy(), temperature, top_k, rs))
        for _ in range(n - 1):
            tok = torch.tensor([[ids[-1]]], dtype=torch.int32, device=dev)
            pos = torch.tensor([len(ids) - 1], dtype=torch.int32, device=dev)
            logits = fns["step"](variables, fns["k_pool"], fns["v_pool"], tok, pos,
                                 fns["tables"])
            ids.append(_pick(logits[0, 0].cpu().numpy(), temperature, top_k, rs))
        return vocab.decode(ids[n_prompt:])

    # the sliding window: every char pays the full forward
    dummy_label = np.zeros((1, seq_len), np.int32)
    for _ in range(n):
        window = ids[-seq_len:]
        t = len(window) - 1
        data = np.zeros((1, seq_len), np.int32)
        data[0, : len(window)] = window  # right-pad: causal-safe
        blobs = net.forward({"data": data, "label": dummy_label})
        ids.append(_pick(blobs[logits_blob][0, t].cpu().numpy(), temperature,
                         top_k, rs))
    return vocab.decode(ids[n_prompt:])
