"""The port's token-serving plane on the CPU (``sparknet_tpu_torch/serve``).

1. **Block pool**: the stdlib allocator tests of ``tests/test_paged.py``,
   carried over: all-or-nothing alloc, loud double-free/null-block/foreign
   refusals, the exact zero-leak ledger, the capacity byte model.
2. **Exactness**: a request decoded on the port's ``PagedDecoder``
   interleaved with neighbours gives the same greedy continuation as
   decoded alone and as the cacheless ``ContinuousDecoder``; seeded churn
   schedules never leak a block and stay equal to decoding alone.
3. **Admission and routing**: refusals at submit, ``AdmissionRefused``
   before any pool is allocated, ``TokenRouter``'s zero-drop ledger.
4. **Against the JAX decoder**: the same weights and request mix give the
   same token ids as the JAX ``PagedDecoder``, up to a position whose
   top-2 logit margin is 1e-4 or less (chip_smoke.py's rule).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.serve.continuous import ContinuousDecoder  # noqa: E402
from sparknet_tpu_torch.serve.engine import AdmissionRefused, percentile  # noqa: E402
from sparknet_tpu_torch.serve.paged import (  # noqa: E402
    BlockPool, PagedDecoder, PoolExhausted, TokenRouter, capacity_ratio, pool_bytes)

# the geometry of tests/test_paged.py: 2 attention blocks, so the per-layer
# pool indexing is exercised
GEO = dict(slots=4, seq_len=16, vocab=32, embed_dim=32, heads=4, ffn_dim=32,
           blocks=2, seed=0, block_tokens=4)
NET = {k: GEO[k] for k in ("slots", "seq_len", "vocab", "embed_dim", "heads",
                           "ffn_dim", "blocks")}
CPU = dict(device="cpu", hbm_bytes=16 << 30)
MARGIN = 1e-4


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    kernels.reset_launch_counts()
    yield
    assert kernels.FLASH_LAUNCHES == 0 and kernels.PAGED_LAUNCHES == 0


@pytest.fixture(scope="module")
def jax_decoder():
    """The JAX PagedDecoder at GEO (its weights are every test's weights)."""
    from sparknet_tpu.serve.paged import PagedDecoder as JaxPagedDecoder

    return JaxPagedDecoder(**GEO)


@pytest.fixture(scope="module")
def weights(jax_decoder):
    v = jax_decoder.variables
    return interop.netvars_from_numpy(v.params, v.state, device="cpu")


@pytest.fixture(scope="module")
def alone(weights):
    """Decoded-alone continuations, memoized: (prompt, max_new) -> ids."""
    ref = PagedDecoder(**GEO, variables=weights, **CPU)
    cache = {}

    def run(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in cache:
            t = ref.submit(prompt, max_new)
            ref.run()
            cache[key] = t.result
        return cache[key]

    return run


def _mix(seed, n, max_prompt=10):
    rs = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        n_p = int(rs.randint(1, max_prompt))
        reqs.append((list(rs.randint(0, GEO["vocab"], n_p)),
                     int(rs.randint(1, GEO["seq_len"] - n_p + 1))))
    return reqs


# -- 1. block pool ----------------------------------------------------------


def test_block_pool_ledger_and_refusals():
    pool = BlockPool(num_blocks=8, block_tokens=4)
    assert pool.available() == 7  # block 0 is the null block
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert 0 not in a + b and len(set(a + b)) == 5
    pool.free(a)
    with pytest.raises(ValueError, match="double-free|not allocated"):
        pool.free(a)
    with pytest.raises(ValueError, match="null block"):
        pool.free([0])
    with pytest.raises(ValueError, match="not allocated"):
        pool.free([6 if 6 not in b else 5])
    pool.free(b)
    assert pool.ledger() == {"allocated": 5, "freed": 5, "in_use": 0, "leaked": 0}


def test_block_pool_alloc_is_all_or_nothing():
    pool = BlockPool(num_blocks=4, block_tokens=4)
    pool.alloc(2)
    with pytest.raises(PoolExhausted):
        pool.alloc(2)
    assert pool.available() == 1
    with pytest.raises(ValueError):
        pool.alloc(0)
    with pytest.raises(ValueError):
        BlockPool(num_blocks=1, block_tokens=4)
    with pytest.raises(ValueError):
        BlockPool(num_blocks=4, block_tokens=0)


def test_capacity_model_and_pool_bytes():
    assert capacity_ratio(2048, 16, [32, 64, 96, 128, 256, 512, 777]) >= 2.0
    assert capacity_ratio(256, 16, [256, 256]) == pytest.approx(1.0)
    assert pool_bytes(2, 8, 4, 4, 8, itemsize=4) == 2 * 2 * 8 * 4 * 4 * 8 * 4
    with pytest.raises(ValueError):
        capacity_ratio(16, 4, [])


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert percentile(vals, 50) == 50.0 and percentile(vals, 99) == 99.0
    assert percentile([], 99) == 0.0 and percentile([3.0], 50) == 3.0


# -- 2. exactness -----------------------------------------------------------


def test_paged_interleaved_matches_alone_and_rectangle(weights, alone):
    d = PagedDecoder(**GEO, variables=weights, **CPU)
    reqs = _mix(3, 9)
    tickets = [d.submit(p, m) for p, m in reqs]
    d.run()
    rect = ContinuousDecoder(**NET, variables=weights, device="cpu")
    rect_tickets = [rect.submit(p, m) for p, m in reqs]
    rect.run()
    for t, rt, (p, m) in zip(tickets, rect_tickets, reqs):
        assert len(t.result) == m
        assert t.result == alone(p, m)  # interleaved == alone
        assert t.result == rt.result  # paged == rectangle
    assert d.pool.ledger()["leaked"] == 0 and d.pool.ledger()["in_use"] == 0
    st = d.stats()
    assert st["completed"] == 9 and st["prefills"] >= 3 and st["steps"] > 0
    assert all(st[k] > 0 for k in ("ttft_ms_p50", "ttft_ms_p99", "decode_step_ms_p50",
                                   "inter_token_ms_p99", "prefill_ms_p50"))
    assert rect.stats()["completed"] == 9


def test_keep_logits_match_full_window_forward(weights):
    """The paged path's logits for every generated token equal one
    full-window forward of prompt + continuation at that position."""
    d = PagedDecoder(**GEO, variables=weights, keep_logits=True, **CPU)
    rect = ContinuousDecoder(**NET, variables=weights, device="cpu")
    reqs = _mix(4, 4)
    tickets = [d.submit(p, m) for p, m in reqs]
    d.run()
    data = np.zeros((GEO["slots"], GEO["seq_len"]), np.int32)
    for row, ((p, _), t) in enumerate(zip(reqs, tickets)):
        ids = p + t.result
        data[row, :len(ids)] = ids
    full = rect.forward_logits(data)
    for row, ((p, m), t) in enumerate(zip(reqs, tickets)):
        got = d.generation_logits[t.id]
        assert tuple(got.shape) == (m, GEO["vocab"])
        np.testing.assert_allclose(got.numpy(), full[row, len(p) - 1:len(p) - 1 + m].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert t.result == got.argmax(-1).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occupancy_churn_fuzz_never_leaks_and_stays_exact(weights, alone, seed):
    """Seeded admit/retire schedules over a tight pool (10 usable blocks <
    4 slots x 4 blocks), so admission waits on blocks as well as slots; at
    every churn point the ledger is exact, and every continuation equals
    its decoded-alone reference."""
    d = PagedDecoder(**{**GEO, "num_blocks": 11}, variables=weights, **CPU)
    rs = np.random.RandomState(seed)
    live: list = []
    done = 0
    while done < 14:
        if len(live) < 14 and rs.rand() < 0.6:
            n_p = int(rs.randint(1, 9))
            m = int(rs.randint(1, GEO["seq_len"] - n_p + 1))
            p = list(rs.randint(0, GEO["vocab"], n_p))
            live.append((d.submit(p, m), p, m))
        d.step()
        led = d.pool.ledger()
        assert led["leaked"] == 0
        assert d.pool.available() + d.pool.in_use() == d.pool.num_blocks - 1
        for t, p, m in [x for x in live if x[0].done()]:
            assert t.result == alone(p, m)
            live.remove((t, p, m))
            done += 1
    d.run()
    for t, p, m in live:
        assert t.result == alone(p, m)
    led = d.pool.ledger()
    assert led["in_use"] == 0 and led["leaked"] == 0
    assert led["allocated"] == led["freed"] > 0


# -- 3. admission & routing -------------------------------------------------


def test_submit_refusals(weights):
    d = PagedDecoder(**GEO, variables=weights, **CPU)
    with pytest.raises(ValueError, match="never slides"):
        d.submit([1] * 10, GEO["seq_len"])
    with pytest.raises(ValueError, match="non-empty"):
        d.submit([], 4)
    with pytest.raises(ValueError, match="outside"):
        d.submit([GEO["vocab"]], 4)
    with pytest.raises(ValueError, match="positive"):
        d.submit([1], 0)
    rect = ContinuousDecoder(**NET, variables=weights, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        rect.submit([], 4)
    with pytest.raises(ValueError, match="positive"):
        rect.submit([1], 0)
    for cls, kw in ((PagedDecoder, CPU), (ContinuousDecoder, {"device": "cpu"})):
        with pytest.raises(ValueError, match=">= 2 slots"):
            cls(**{**NET, "slots": 1}, variables=weights, **kw)
    with pytest.raises(ValueError, match="hbm_bytes"):
        PagedDecoder(**GEO, variables=weights, device="cpu")


def test_admission_refuses_before_any_pool_is_allocated(weights, monkeypatch):
    shapes = []
    zeros = torch.zeros

    def recording_zeros(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int)
                      else shape)
        return zeros(*shape, **kw)

    monkeypatch.setattr(torch, "zeros", recording_zeros)
    with pytest.raises(AdmissionRefused) as exc:
        PagedDecoder(**GEO, variables=weights, device="cpu", hbm_bytes=1024)
    v = exc.value.verdict
    assert v["fits"] is False and v["priced"] is True
    assert v["predicted_bytes"] > v["budget_bytes"]
    assert not [s for s in shapes if len(s) == 5]  # no [A, NB, T, H, D] pool
    PagedDecoder(**GEO, variables=weights, **CPU)  # the same decoder fits 16 GiB
    assert [s for s in shapes if len(s) == 5]


def test_token_router_zero_drop_ledger(weights, alone):
    r = TokenRouter(replicas=2, **GEO, variables=weights, **CPU)
    reqs = _mix(5, 10, max_prompt=8)
    tickets = [r.submit(p, m) for p, m in reqs]
    r.run()
    led = r.ledger()
    assert led["submitted"] == 10 and led["resolved"] == 10 and led["dropped"] == 0
    assert led["pool"]["leaked"] == 0 and led["pool"]["in_use"] == 0
    assert all(d.completed > 0 for d in r.decoders)  # both replicas served
    for t, (p, m) in zip(tickets, reqs):
        assert t.result == alone(p, m)
    assert r.stats()["replicas"] == 2


def test_seeded_init_serves_without_given_weights():
    """The default weights: the port's own seeded init (Network.init through
    Embed, MultiHeadAttention and the per-token InnerProducts)."""
    d = PagedDecoder(**GEO, **CPU)
    t = d.submit([1, 2, 3], 5)
    d.run()
    assert len(t.wait(timeout=0)) == 5 and all(0 <= i < GEO["vocab"] for i in t.result)


# -- 4. against the JAX decoder ----------------------------------------------


def test_token_ids_match_the_jax_decoder(jax_decoder, weights):
    reqs = _mix(7, 8)
    jt = [jax_decoder.submit(p, m) for p, m in reqs]
    jax_decoder.run()
    d = PagedDecoder(**GEO, variables=weights, **CPU)
    tickets = [d.submit(p, m) for p, m in reqs]
    d.run()
    rect = ContinuousDecoder(**NET, variables=weights, device="cpu")
    for (p, _), a, b in zip(reqs, tickets, jt):
        for j, (x, y) in enumerate(zip(a.result, b.result)):
            if x != y:  # a tie in the port's own full-window logits
                data = np.zeros((GEO["slots"], GEO["seq_len"]), np.int32)
                ids = p + a.result
                data[0, :len(ids)] = ids
                top = torch.topk(rect.forward_logits(data)[0, len(p) - 1 + j], 2).values
                assert float(top[0] - top[1]) <= MARGIN
                break
        else:
            assert a.result == b.result


def _padded_pools_match_the_jax_decoder(embed_dim: int, heads: int, lanes: int):
    """A decoder whose head dim ``embed_dim / heads`` is not a kernel
    width: its pools hold each head at ``lanes``, zero beyond the head,
    priced as allocated; its token ids equal the JAX decoder's and the
    rectangle decoder's (up to a tie, as above)."""
    from sparknet_tpu.serve.paged import PagedDecoder as JaxPagedDecoder

    hd = embed_dim // heads
    geo = dict(GEO, embed_dim=embed_dim, heads=heads)
    jd = JaxPagedDecoder(**geo)
    w = interop.netvars_from_numpy(jd.variables.params, jd.variables.state, device="cpu")
    d = PagedDecoder(**geo, variables=w, **CPU)
    assert d.spec.head_dim == hd and d._k_pool.shape[-1] == lanes
    assert d.pool_hbm_bytes == d._k_pool.numel() * 4 * 2
    reqs = _mix(12, 6)
    jt = [jd.submit(p, m) for p, m in reqs]
    jd.run()
    tickets = [d.submit(p, m) for p, m in reqs]
    d.run()
    assert not d._k_pool[..., hd:].any() and not d._v_pool[..., hd:].any()
    assert d._k_pool[..., :hd].any()
    rect = ContinuousDecoder(**{**NET, "embed_dim": embed_dim, "heads": heads},
                             variables=w, device="cpu")
    rt = [rect.submit(p, m) for p, m in reqs]
    rect.run()
    for (p, _), a, b, c in zip(reqs, tickets, jt, rt):
        for j, (x, y) in enumerate(zip(a.result, b.result)):
            if x != y:  # a tie in the port's own full-window logits
                data = np.zeros((GEO["slots"], GEO["seq_len"]), np.int32)
                ids = p + a.result
                data[0, :len(ids)] = ids
                top = torch.topk(rect.forward_logits(data)[0, len(p) - 1 + j], 2).values
                assert float(top[0] - top[1]) <= MARGIN
                break
        else:
            assert a.result == b.result
        assert a.result == c.result


def test_head_dim_12_pools_are_padded_and_match_the_jax_decoder():
    """``embed_dim`` 48 over 4 heads (D = 12, between the attention
    kernels' widths): the pools hold each head at 16 lanes."""
    _padded_pools_match_the_jax_decoder(48, 4, 16)


@pytest.mark.parametrize("embed_dim,lanes", [(640, 384), (1024, 512)],
                         ids=["d320", "d512"])
def test_wide_head_pools_match_the_jax_decoder(embed_dim, lanes):
    """Heads above 256 lanes (2 heads of 320 and of 512, the chunked paged
    kernel's widths): 320 is held at 384 lanes, 512 as it is."""
    _padded_pools_match_the_jax_decoder(embed_dim, 2, lanes)
