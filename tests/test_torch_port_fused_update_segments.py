"""The fused update fed by gradient segments, against the JAX package and
against the packed grad arena.

The fused step hands the update each blob's gradient where autograd left
it: one segment a blob with a span, read through the layout's segment
table (``kernels.GradSegments``, made in ``arena.ArenaTables``), with no
grad arena.  Here, on the CPU:

* the segment form of the plain version (``fused_update_torch`` with
  ``segments``) against the JAX ``fused_update`` on the JAX-packed grad
  arena, in its XLA and interpret forms, for the six rules x f32/bf16
  storage x L1/L2/no regularization.  The blobs have sizes that are
  neither multiples of 4 nor of the tile; one blob has no gradient (its
  segment is None, the JAX side packs zeros); one is a shared blob's
  0-size placeholder (no span, no segment); one is bf16 in the f32 arena
  (float32 gradients in a bf16 arena round as packing them does).  The
  tolerances are those of ``test_torch_port_fused_update.py``, and the
  segment form is bit for bit the port's packed form;
* the rows the CUDA wrapper hands the C entry: only the pointers filled
  in on the steps' case, each row checked (and a copy counted) otherwise;
* the Solver's fused step on the segment path bit for bit its packed path
  (``build_fused_step(..., reduce_grads=lambda g: g)``, an identity
  reduction) from the same JAX-initialized weights: SGD and Adam in f32,
  SGD with bf16 storage, the shared blobs of ``mnist_siamese`` and the
  transformer's mixed bf16-in-f32 arena.  The segment path never runs
  ``unpack``'s backward (``arena.UNPACK_BACKWARDS``);
* the packed path is still taken under iter_size > 1, clipping and
  ``reduce_grads``.

The CUDA kernel itself is held against the plain version, and the segment
path against the packed path, on the card by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.models.zoo import GRAPH_SWEEP_FAMILIES as JGRAPH_SWEEP_FAMILIES  # noqa: E402
from sparknet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from sparknet_tpu.solvers import arena as jarena  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import get_config, set_config  # noqa: E402
from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.solvers import arena  # noqa: E402
from sparknet_tpu_torch.solvers.solver import (  # noqa: E402
    Solver,
    SolverConfig,
    build_fused_step,
)

RULES = list(kernels.FUSED_RULE_SLOTS)


@dataclasses.dataclass(frozen=True)
class Spec:
    lr_mult: float
    decay_mult: float


# (layer, blobs): (shape, blob dtype, lr_mult, decay_mult, has a gradient)
BLOBS = {
    "a": [((5,), "float32", 1.0, 1.0, True), ((41, 50), "float32", 2.0, 0.0, True)],
    "shared": [((0,), "float32", 1.0, 1.0, True)],  # a sharer's placeholder
    "b": [((1,), "float32", 1.0, 1.0, False)],  # no gradient reaches it
    "c": [((3, 343), "bfloat16", 1.0, 2.0, True)],  # bf16 beside f32 blobs
}


def _blob_layouts(storage: str, cfg):
    """The BLOBS geometry in both packages, with seeded params, history and
    gradients on each blob (numpy, float32 values exact in the blob's
    type)."""
    rs = np.random.RandomState(3)

    def draw(shape, dtype, scale, positive=False):
        x = rs.randn(*shape).astype(np.float32) * scale
        x = np.abs(x) if positive else x
        return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))

    params, grads, slots = {}, {}, {}
    for ln, bl in BLOBS.items():
        params[ln] = [draw(s, d, 0.05) for s, d, *_ in bl]
        grads[ln] = [draw(s, d, 0.01) if has else None for s, d, _, _, has in bl]
        slots[ln] = [[draw(s, d, 0.01, positive=True)
                      for _ in range(kernels.FUSED_RULE_SLOTS[cfg.solver_type])]
                     for s, d, *_ in bl]
    specs = {ln: [Spec(lr, dm) for _, _, lr, dm, _ in bl] for ln, bl in BLOBS.items()}
    jparams = {ln: [jnp.asarray(p, d) for p, (_, d, *_) in zip(pl, BLOBS[ln])]
               for ln, pl in params.items()}
    jlay = jarena.build_layout(jparams, specs, cfg, storage_dtype=storage)
    tparams = {ln: [torch.from_numpy(p).to(getattr(torch, d))
                    for p, (_, d, *_) in zip(pl, BLOBS[ln])]
               for ln, pl in params.items()}
    lay = arena.build_layout(tparams, specs, cfg, storage_dtype=storage)
    return jlay, lay, params, grads, slots


def _bf16_ulp(ref):
    _, exp = np.frexp(np.abs(ref).astype(np.float32))
    return np.ldexp(np.ones_like(ref, np.float32), exp - 8)


CASES = [(rule, dtype, reg) for rule in RULES for dtype in ("f32", "bf16")
         for reg in ("l1", "l2", "none")]


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("rule,storage,reg", CASES,
                         ids=[f"{r}-{d}-{g}" for r, d, g in CASES])
def test_segments_match_jax_on_the_packed_arena(rule, storage, reg, impl):
    cfg = JSolverConfig(solver_type=rule, weight_decay=5e-4)
    jlay, lay, params, grads, slots = _blob_layouts(storage, cfg)
    assert lay.index_map() == jlay.index_map()
    assert [e.span for e in lay.entries] == [2048, 4096, 0, 2048, 2048]
    tables = arena.ArenaTables(lay, "cpu")
    seg = tables.segments
    assert len(seg) == 4 and seg.first_tile == (0, 1, 3, 4)
    assert seg.size == (5, 2050, 1, 1029)
    assert seg.tile_seg.tolist() == [[0, 0], [1, 1], [1, 1], [2, 3], [3, 4]]
    kw = dict(momentum=0.9, momentum2=0.999, rms_decay=0.98, delta=1e-8,
              iter_size=1, reg=reg, clip=False)
    jdt = jnp.bfloat16 if storage == "bf16" else jnp.float32
    tdt = lay.storage
    zeros = {ln: [np.zeros(s, np.float32) if g is None else g
                  for g, (s, *_) in zip(gl, BLOBS[ln])] for ln, gl in grads.items()}
    j_tree = lambda d: {ln: [jnp.asarray(x, bd) for x, (_, bd, *_) in  # noqa: E731
                             zip(xl, BLOBS[ln])] for ln, xl in d.items()}
    jw = jarena.pack(jlay, j_tree(params))
    jg = jarena.pack(jlay, j_tree(zeros))
    js = [jarena.pack(jlay, j_tree({ln: [h[k] for h in hl] for ln, hl in slots.items()}))
          for k in range(lay.n_slots)]
    scalars = np.array([0.01, 1.0, 0.93], np.float32)
    jw2, js2 = jpk.fused_update(rule, jpk.UpdateStatics(**kw), jw, jg, js,
                                jnp.asarray(lay.tile_lr), jnp.asarray(lay.tile_decay),
                                jnp.asarray(scalars), force=impl)
    assert jw.dtype == jdt

    t_tree = lambda d: {ln: [torch.from_numpy(x).to(getattr(torch, bd))  # noqa: E731
                             for x, (_, bd, *_) in zip(xl, BLOBS[ln])]
                        for ln, xl in d.items()}
    tw = arena.pack(lay, t_tree(params))
    ts = arena.pack_slots(lay, {ln: [[torch.from_numpy(h).to(getattr(torch, BLOBS[ln][i][1]))
                                      for h in hl] for i, hl in enumerate(sl)]
                                for ln, sl in slots.items()})
    tgrads = arena.segment_blobs(lay, {
        ln: [None if g is None else torch.from_numpy(g).to(getattr(torch, bd))
             for g, (_, bd, *_) in zip(gl, BLOBS[ln])] for ln, gl in grads.items()})
    assert [None if g is None else g.dtype for g in tgrads] == [
        torch.float32, torch.float32, None, torch.bfloat16]
    args = (torch.from_numpy(lay.tile_lr), torch.from_numpy(lay.tile_decay),
            torch.from_numpy(scalars))
    st = kernels.UpdateStatics(**kw)
    ours_w, ours_s = kernels.fused_update_torch(rule, st, tw, tgrads, ts, *args, seg)
    # the segment form is the packed form, bit for bit
    packed_w, packed_s = kernels.fused_update_torch(
        rule, st, tw, arena.pack(lay, t_tree(zeros)), ts, *args)
    assert ours_w.dtype == tdt and all(s.dtype == tdt for s in ours_s)
    for a, b in zip([ours_w, *ours_s], [packed_w, *packed_s]):
        assert torch.equal(a, b)
    real = np.zeros(lay.total, bool)
    for e in lay.entries:
        real[e.offset:e.offset + e.size] = True
    for ours, ref in zip([ours_w, *ours_s], [jw2, *js2]):
        ours, ref = ours.float().numpy(), np.asarray(jnp.asarray(ref, jnp.float32))
        assert not ours[~real].any()  # pad zones stay zero
        if storage == "bf16":
            assert (np.abs(ours - ref) <= _bf16_ulp(ref)).all()
        elif rule in ("SGD", "Nesterov") and impl == "xla":
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(ref).max()))


def test_segment_wrapper_is_in_place_and_reads_gradients_only():
    """On CPU tensors the wrapper writes w and the slots in place from the
    segments, leaves every gradient as it was and launches nothing; a
    table of the wrong length is refused."""
    cfg = JSolverConfig(solver_type="Adam", weight_decay=5e-4)
    _, lay, params, grads, _ = _blob_layouts("f32", cfg)
    tables = arena.ArenaTables(lay, "cpu")
    w = arena.pack(lay, {ln: [torch.from_numpy(p) for p in pl] for ln, pl in params.items()})
    slots = arena.init_slot_arenas(lay, device="cpu")
    tgrads = arena.segment_blobs(lay, {ln: [None if g is None else torch.from_numpy(g)
                                            for g in gl] for ln, gl in grads.items()})
    before = [None if g is None else g.clone() for g in tgrads]
    sc = torch.tensor([0.01, 1.0, 0.9])
    st = kernels.UpdateStatics(momentum=0.9, reg="l2")
    ref_w, ref_s = kernels.fused_update_torch("Adam", st, w, tgrads, slots, tables.tile_lr,
                                              tables.tile_decay, sc, tables.segments)
    ptrs = [t.data_ptr() for t in (w, *slots)]
    launches = kernels.FUSED_UPDATE_LAUNCHES
    kernels.fused_update("Adam", st, w, tgrads, slots, tables.tile_lr, tables.tile_decay,
                         sc, tables.segments)
    assert kernels.FUSED_UPDATE_LAUNCHES == launches
    assert [t.data_ptr() for t in (w, *slots)] == ptrs
    assert torch.equal(w, ref_w) and all(torch.equal(a, b) for a, b in zip(slots, ref_s))
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(tgrads, before))
    with pytest.raises(ValueError, match="segments"):
        kernels.fused_update("Adam", st, w, tgrads[:-1], slots, tables.tile_lr,
                             tables.tile_decay, sc, tables.segments)
    with pytest.raises(ValueError, match="tile"):
        kernels.GradSegments.build((0, 2), (5, 10), 2, "cpu")


def test_segment_rows_fill_pointers_and_check_the_rest():
    """The C entry's rows: on the steps' case (every gradient there,
    contiguous, aligned, of its segment's count and type) the layout's
    rows with only the pointers filled in and nothing kept; otherwise each
    row checked, a non-contiguous gradient copied and counted, a wrong
    count refused.  A blob without a gradient is a null pointer either
    way.  The layout's rows
    are never written."""
    seg = kernels.GradSegments.build((0, 1, 3), (5, 2050, 7), 4, "cpu",
                                     (torch.float32, torch.bfloat16, torch.float32))
    assert seg.rows.tolist() == [[0, 5, 0, 0], [0, 2050, 1, 1], [0, 7, 0, 3]]
    w = torch.zeros(4 * kernels.ARENA_TILE)
    g = [torch.randn(5), torch.randn(41, 50).to(torch.bfloat16), torch.randn(7)]
    copies = kernels.FUSED_GRAD_COPIES
    rows, keep = kernels._segment_rows(w, g, seg)
    assert keep == () and rows.tolist() == [
        [t.data_ptr(), n, b, f] for t, n, b, f in zip(g, (5, 2050, 7), (0, 1, 0), (0, 1, 3))]
    rows, keep = kernels._segment_rows(w, [g[0], None, g[2]], seg)  # a blob without one
    assert keep == () and rows.tolist() == [[g[0].data_ptr(), 5, 0, 0], [0, 2050, 1, 1],
                                            [g[2].data_ptr(), 7, 0, 3]]
    g[1] = torch.randn(50, 41).to(torch.bfloat16).t()  # not contiguous
    rows, keep = kernels._segment_rows(w, [g[0], g[1], None], seg)
    assert len(keep) == 1 and torch.equal(keep[0], g[1]) and keep[0].is_contiguous()
    assert rows.tolist() == [[g[0].data_ptr(), 5, 0, 0], [keep[0].data_ptr(), 2050, 1, 1],
                             [0, 7, 0, 3]]
    assert kernels.FUSED_GRAD_COPIES == copies + 1
    with pytest.raises(ValueError, match="segment of 7 elements"):
        kernels._segment_rows(w, [g[0], g[1], torch.randn(8)], seg)
    assert seg.rows.tolist() == [[0, 5, 0, 0], [0, 2050, 1, 1], [0, 7, 0, 3]]
    packed, keep = kernels._segment_rows(w, w, None)
    assert packed.tolist() == [[w.data_ptr(), w.numel(), 0, 0]] and keep == [w]


# ---------------------------------------------------------------------------
# the Solver's fused step, segments against the packed arena
# ---------------------------------------------------------------------------

TRANSFORMER = GRAPH_SWEEP_FAMILIES["transformer"]


def _feeds(name: str, n: int) -> list:
    rs = np.random.RandomState(5)
    out = []
    for _ in range(n):
        if name == "cifar10_quick":
            out.append({"data": (rs.randn(2, 3, 32, 32) * 40).astype(np.float32),
                        "label": rs.randint(0, 10, 2).astype(np.int32)})
        elif name == "mnist_siamese":
            out.append({"pair_data": rs.rand(2, 2, 28, 28).astype(np.float32),
                        "sim": rs.randint(0, 2, 2).astype(np.float32)})
        else:
            out.append({"data": rs.randint(0, 16, (2, 32)).astype(np.int32),
                        "label": rs.randint(0, 4, 2).astype(np.int32)})
    return out


NETS = {
    # name -> (JAX net, port net, port solver)
    "cifar10_quick": (lambda: jm.cifar10_quick(2), lambda: models.cifar10_quick(2),
                      models.cifar10_quick_solver),
    "mnist_siamese": (lambda: jm.mnist_siamese(batch=2), lambda: models.mnist_siamese(batch=2),
                      models.mnist_siamese_solver),
    "transformer": (lambda: JGRAPH_SWEEP_FAMILIES["transformer"].net(2),
                    lambda: TRANSFORMER.net(2), TRANSFORMER.solver),
}


@pytest.fixture
def port_config():
    """``set_config`` for one test, put back after."""
    saved = get_config()
    yield set_config
    set_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype,
               param_dtype=saved.param_dtype)


def _solver_pair(name: str, cfg_kw: dict, packed: bool, **config) -> Solver:
    """A fused port Solver of ``name`` from the JAX net's seed-0 init, its
    step on the packed path when ``packed``."""
    jnet_fn, tnet_fn, solver_fn = NETS[name]
    set_config(fused_update=True, **config)
    cfg = dataclasses.replace(solver_fn(), **cfg_kw)
    s = Solver(cfg, tnet_fn(), device="cpu")
    jv = JNetwork(jnet_fn(), JPhase.TRAIN).init(jax.random.key(0))
    params = {ln: [np.asarray(jnp.asarray(p, jnp.float32)) for p in pl]
              for ln, pl in jv.params.items()}
    v = interop.netvars_from_numpy(params, device="cpu")
    s.variables = type(v)(
        {ln: [p.to(q.dtype) for p, q in zip(pl, s.variables.params[ln])]
         for ln, pl in v.params.items()}, s.variables.state)
    if packed:
        s._fused_step = build_fused_step(s.config, s.train_net, s.layout, s._tables,
                                         reduce_grads=lambda g: g)
    return s


SOLVER_CASES = {
    "cifar10_quick-SGD-f32": ("cifar10_quick", dict(solver_type="SGD"), {}),
    "cifar10_quick-Adam-f32": ("cifar10_quick", dict(solver_type="Adam", base_lr=1e-3), {}),
    "cifar10_quick-SGD-bf16": ("cifar10_quick", dict(solver_type="SGD"),
                               dict(storage_dtype="bf16")),
    "mnist_siamese-shared": ("mnist_siamese", {}, {}),
    "transformer-mixed": ("transformer", dict(base_lr=0.1, momentum=0.9),
                          dict(param_dtype="bf16")),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_segment_step_is_bitwise_the_packed_step(case, port_config):
    name, cfg_kw, config = SOLVER_CASES[case]
    feeds = _feeds(name, 2)
    runs = []
    for packed in (True, False):
        s = _solver_pair(name, cfg_kw, packed, **config)
        start = s._param_arena.clone()
        calls = arena.UNPACK_BACKWARDS
        losses = s.step(2, lambda it: feeds[it])
        runs.append((s, arena.UNPACK_BACKWARDS - calls, losses))
    (sp, calls_p, loss_p), (ss, calls_s, loss_s) = runs
    assert not torch.equal(start, ss._param_arena)  # the steps moved the weights
    assert calls_p == 2 and calls_s == 0  # no pack on the segment path
    if name == "mnist_siamese":
        assert any(e.span == 0 for e in ss.layout.entries)
    if name == "transformer":
        assert ss.layout.mixed
    if "storage_dtype" in config:
        assert ss.layout.storage == torch.bfloat16
    assert loss_p == loss_s
    assert torch.equal(sp._param_arena, ss._param_arena)
    assert all(torch.equal(a, b) for a, b in zip(sp._slot_arenas, ss._slot_arenas))


@pytest.mark.parametrize("what", ["iter_size", "clip", "reduce_grads"])
def test_packed_path_kept_where_the_arena_is_needed(what, port_config):
    """iter_size > 1 accumulates into a float32 arena, clipping takes the
    arena's norm, ``reduce_grads`` takes the grad arena: each step packs
    (one ``unpack`` backward a micro-batch) and still updates in one
    launch's worth of the plain version."""
    kw = {"iter_size": dict(iter_size=2), "clip": dict(clip_gradients=0.5),
          "reduce_grads": {}}[what]
    s = _solver_pair("cifar10_quick", kw, packed=False)
    seen = []
    if what == "reduce_grads":
        s.set_reduce_grads(lambda g: seen.append(g.shape) or g)
    feeds = _feeds("cifar10_quick", 2)
    if what == "iter_size":
        feeds = [{k: np.stack([a[k], b[k]]) for k in a} for a, b in [feeds]]
    calls = arena.UNPACK_BACKWARDS
    before = s._param_arena.clone()
    s.step(1, lambda it: feeds[it])
    assert arena.UNPACK_BACKWARDS - calls == (2 if what == "iter_size" else 1)
    assert not torch.equal(before, s._param_arena)
    if what == "reduce_grads":
        assert seen == [(s.layout.total,)]
    with pytest.raises(ValueError, match="packed"):
        arena.arena_apply_update(SolverConfig(clip_gradients=1.0), s.layout,
                                 s._param_arena, [None] * len(s._tables.segments),
                                 s._slot_arenas, torch.tensor(0.01), 0, s._tables)
