"""The port's fused optimizer update and its arenas against the JAX package.

``fused_update_torch`` (the plain version of ``csrc/fused_update.cu``) is
held against the JAX ``fused_update`` in both of its CPU forms: the XLA
formulation (``force="xla"``) and the Pallas kernel body in interpret mode
(``force="interpret"``), for the six rules x f32/bf16 storage x L1/L2/no
regularization x clip on/off, on the same numpy arenas.  ``solvers/arena``
is held against the JAX ``solvers/arena`` on the same net: tables, index
map, pack/unpack, pad zones.  The CUDA kernel itself is checked against
the plain version on the card by ``chip_smoke.py``.

Tolerances: SGD and Nesterov in float32 are bitwise against the XLA
formulation (the same IEEE multiplies and adds in the same order on both
sides; the JAX package pins the same between its own two paths).  The
interpret-mode kernel body and the other f32 rules take rtol 1e-6 plus an
absolute 1e-6 of the largest |value|: XLA may contract a multiply-add
inside the interpreted body, and the sqrt/divide rules may round through
other instruction sequences, a few ulps, which near a cancelling sum
(h = mu*h + lr*g) is a large relative but a one-ulp absolute difference.
bf16 storage is held to one bf16 ulp of the result (8 significant bits: a
one-ulp difference before the final cast can round to the neighbouring
bf16).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JaxNetwork  # noqa: E402
from sparknet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402
from sparknet_tpu.solvers import arena as jarena  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.solvers import arena  # noqa: E402
from sparknet_tpu_torch.solvers.solver import SolverConfig  # noqa: E402

RULES = list(kernels.FUSED_RULE_SLOTS)
N_TILES = 2
TILE = kernels.ARENA_TILE


def _arenas(rule, seed=0):
    rs = np.random.RandomState(seed)
    total = N_TILES * TILE
    w = (rs.randn(total) * 0.05).astype(np.float32)
    g = (rs.randn(total) * 0.01).astype(np.float32)
    slots = [np.abs(rs.randn(total) * 0.01).astype(np.float32)
             for _ in range(kernels.FUSED_RULE_SLOTS[rule])]
    # a zero pad zone at the end of the last tile, as the arena layout makes
    for a in (w, g, *slots):
        a[-300:] = 0.0
    tile_lr = np.array([1.0, 2.0], np.float32)
    tile_decay = np.array([5e-4, 0.0], np.float32)
    scalars = np.array([0.01, 0.6, 0.93], np.float32)
    return w, g, slots, tile_lr, tile_decay, scalars


def _bf16_ulp(ref):
    _, exp = np.frexp(np.abs(ref).astype(np.float32))
    return np.ldexp(np.ones_like(ref, np.float32), exp - 8)


def _to_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


CASES = [(rule, dtype, reg, clip) for rule in RULES for dtype in ("f32", "bf16")
         for reg in ("l1", "l2", "none") for clip in (False, True)]


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("rule,dtype,reg,clip", CASES,
                         ids=[f"{r}-{d}-{g}-clip{int(c)}" for r, d, g, c in CASES])
def test_fused_update_torch_matches_jax(rule, dtype, reg, clip, impl):
    w, g, slots, tile_lr, tile_decay, scalars = _arenas(rule)
    kw = dict(momentum=0.9, momentum2=0.999, rms_decay=0.98, delta=1e-8,
              iter_size=2, reg=reg, clip=clip)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jw, js = jpk.fused_update(
        rule, jpk.UpdateStatics(**kw), jnp.asarray(w, jdt), jnp.asarray(g, jdt),
        [jnp.asarray(s, jdt) for s in slots], jnp.asarray(tile_lr),
        jnp.asarray(tile_decay), jnp.asarray(scalars), force=impl)
    tw, ts = kernels.fused_update_torch(
        rule, kernels.UpdateStatics(**kw), torch.from_numpy(w).to(tdt),
        torch.from_numpy(g).to(tdt), [torch.from_numpy(s).to(tdt) for s in slots],
        torch.from_numpy(tile_lr), torch.from_numpy(tile_decay),
        torch.from_numpy(scalars))
    assert tw.dtype == tdt and all(s.dtype == tdt for s in ts)
    for ours, ref in zip([tw, *ts], [jw, *js]):
        ours, ref = _to_np(ours), _to_np(ref)
        assert not ours[-300:].any()  # pad zone stays zero
        if dtype == "bf16":
            assert (np.abs(ours - ref) <= _bf16_ulp(ref)).all()
        elif rule in ("SGD", "Nesterov") and impl == "xla":
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("rule", RULES)
def test_fused_update_wrapper_is_in_place_on_cpu(rule):
    """On CPU tensors the wrapper runs the plain version and writes w and
    the slots in place; g is only read; no kernel is launched."""
    w, g, slots, tile_lr, tile_decay, scalars = _arenas(rule, seed=1)
    st = kernels.UpdateStatics(momentum=0.9, reg="l2", clip=True)
    tw, tg = torch.from_numpy(w.copy()), torch.from_numpy(g.copy())
    ts = [torch.from_numpy(s.copy()) for s in slots]
    args = (torch.from_numpy(tile_lr), torch.from_numpy(tile_decay),
            torch.from_numpy(scalars))
    ref_w, ref_s = kernels.fused_update_torch(rule, st, tw, tg, ts, *args)
    ptrs = [t.data_ptr() for t in (tw, *ts)]
    before = kernels.FUSED_UPDATE_LAUNCHES
    assert kernels.fused_update(rule, st, tw, tg, ts, *args) is None
    assert kernels.FUSED_UPDATE_LAUNCHES == before
    assert [t.data_ptr() for t in (tw, *ts)] == ptrs
    assert torch.equal(tw, ref_w) and all(torch.equal(a, b) for a, b in zip(ts, ref_s))
    assert torch.equal(tg, torch.from_numpy(g))


def test_fused_update_rejects_bad_arenas():
    w, g, slots, tile_lr, tile_decay, scalars = _arenas("SGD")
    st = kernels.UpdateStatics()
    t = torch.from_numpy
    args = (t(tile_lr), t(tile_decay), t(scalars))
    with pytest.raises(ValueError, match="tiles"):
        kernels.fused_update("SGD", st, t(w[:-1]), t(g[:-1]), [t(slots[0][:-1])], *args)
    with pytest.raises(ValueError, match="slot arena"):
        kernels.fused_update("Adam", st, t(w), t(g), [t(slots[0])], *args)
    with pytest.raises(ValueError, match="unknown fused update rule"):
        kernels.fused_update("Momentum", st, t(w), t(g), [t(slots[0])], *args)


# ---------------------------------------------------------------------------
# Arenas
# ---------------------------------------------------------------------------

# non-uniform multipliers: weight lr 1 / decay 1, bias lr 2 / decay 0, as
# the published Caffe nets set them
MULT_NET = """name: "mult"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 4 dim: 3 dim: 9 dim: 9 } } }
layer { name: "label" type: "Input" top: "label" input_param { shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "ip1" type: "InnerProduct" bottom: "conv1" top: "ip1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip2" bottom: "label" top: "loss" }
"""


@pytest.fixture(scope="module")
def mult_layouts():
    """The same net's arena layout in both packages (SGD, weight decay
    5e-4), with the JAX package's params."""
    import jax

    jnet = JaxNetwork(jax_parse(MULT_NET), JPhase.TRAIN)
    jvars = jnet.init(jax.random.key(0))
    jspecs = jnet.param_specs_for(jvars)
    jlay = jarena.build_layout(jvars.params, jspecs,
                               JSolverConfig(weight_decay=5e-4, momentum=0.9),
                               storage_dtype="f32")
    net = Network(parse(MULT_NET), Phase.TRAIN, device="cpu")
    params = {ln: [torch.from_numpy(np.array(p)) for p in pl]
              for ln, pl in jvars.params.items()}
    specs = net.param_specs_for(net.init())
    lay = arena.build_layout(params, specs,
                             SolverConfig(weight_decay=5e-4, momentum=0.9),
                             storage_dtype="f32")
    return jlay, lay, jvars.params, params


def test_layout_tables_and_index_map_match_jax(mult_layouts):
    jlay, lay, _, _ = mult_layouts
    assert lay.index_map() == jlay.index_map()
    assert (lay.total, lay.n_tiles, lay.tile, lay.n_slots) == (
        jlay.total, jlay.n_tiles, jlay.tile, jlay.n_slots)
    np.testing.assert_array_equal(lay.tile_lr, jlay.tile_lr)
    np.testing.assert_array_equal(lay.tile_decay, jlay.tile_decay)
    # the multipliers really vary: biases take lr 2 and no decay
    assert set(lay.tile_lr.tolist()) == {1.0, 2.0}
    assert 0.0 in lay.tile_decay and np.float32(5e-4) in lay.tile_decay


def test_zoo_alexnet_layout_matches_jax():
    """The AlexNet arena geometry (16 blobs, ~61M params) from shapes alone
    in both packages."""
    import jax

    from sparknet_tpu import models as jm
    from sparknet_tpu_torch import models as tm

    jnet = JaxNetwork(jm.alexnet(2), JPhase.TRAIN)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0))
    jlay = jarena.build_layout(shapes.params, jnet.param_specs_for(shapes),
                               jm.alexnet_solver(), storage_dtype="bf16")
    net = Network(tm.alexnet(2), Phase.TRAIN, device="cpu")
    meta = {ln: [torch.empty(tuple(p.shape), device="meta") for p in pl]
            for ln, pl in shapes.params.items()}
    specs = {ln: next(l for l in net.layers if l.name == ln).param_specs(len(pl))
             for ln, pl in meta.items()}
    lay = arena.build_layout(meta, specs, tm.alexnet_solver(), storage_dtype="bf16")
    assert lay.index_map() == jlay.index_map()
    assert lay.total == jlay.total and lay.total_bytes == jlay.total_bytes
    assert lay.param_count() == 60_965_224
    np.testing.assert_array_equal(lay.tile_decay, jlay.tile_decay)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_pack_unpack_round_trip(mult_layouts, storage):
    _, lay, jparams, params = mult_layouts
    lay = dataclasses.replace(lay, storage_dtype=storage)
    a = arena.pack(lay, params)
    assert a.dtype == lay.storage and a.shape == (lay.total,)
    back = arena.unpack(lay, a)
    for ln, pl in params.items():
        for p, q in zip(pl, back[ln]):
            assert q.dtype == p.dtype and q.shape == p.shape
            assert torch.equal(q, p.to(lay.storage).to(p.dtype))
    real = torch.zeros(lay.total, dtype=torch.bool)
    for e in lay.entries:
        real[e.offset:e.offset + e.size] = True
    assert not a[~real].any()
    # the JAX pack gives the same arena
    jlay = dataclasses.replace(mult_layouts[0], storage_dtype=storage)
    np.testing.assert_array_equal(a.float().numpy(),
                                  np.asarray(jarena.pack(jlay, jparams), np.float32))


def test_unpack_views_share_the_arena_and_grad_is_packed(mult_layouts):
    """f32 blobs are views of the arena; the grad w.r.t. the arena is the
    blobs' grads packed, zero in the pad zones."""
    _, lay, _, params = mult_layouts
    a = arena.pack(lay, params).requires_grad_(True)
    blobs = arena.unpack(lay, a)
    e = lay.entries[0]
    assert blobs[e.lname][e.index].data_ptr() == a.data_ptr() + 4 * e.offset
    loss = sum((b * (i + 1)).sum() for i, bl in enumerate(blobs.values()) for b in bl)
    (g,) = torch.autograd.grad(loss, a)
    for i, (ln, bl) in enumerate(blobs.items()):
        for k, _ in enumerate(bl):
            ent = next(x for x in lay.entries if x.lname == ln and x.index == k)
            assert torch.equal(g[ent.offset:ent.offset + ent.size],
                               torch.full((ent.size,), float(i + 1)))
            assert not g[ent.offset + ent.size:ent.offset + ent.span].any()


@pytest.mark.parametrize("rule", RULES)
def test_pad_zones_stay_zero_under_every_rule(mult_layouts, rule):
    _, lay, _, params = mult_layouts
    cfg = SolverConfig(solver_type=rule, momentum=0.9, weight_decay=5e-4,
                       clip_gradients=1.0)
    lay = dataclasses.replace(lay, rule=rule, n_slots=kernels.FUSED_RULE_SLOTS[rule])
    w = arena.pack(lay, params)
    g = arena.pack(lay, {ln: [torch.randn_like(p) for p in pl]
                         for ln, pl in params.items()})
    slots = arena.init_slot_arenas(lay, device="cpu")
    real = torch.zeros(lay.total, dtype=torch.bool)
    for e in lay.entries:
        real[e.offset:e.offset + e.size] = True
    for it in range(3):
        arena.arena_apply_update(cfg, lay, w, g, slots, torch.tensor(0.01), it)
        for t in (w, *slots):
            assert torch.isfinite(t).all()
            assert not t[~real].any()
    assert w[real].ne(arena.pack(lay, params)[real]).any()
