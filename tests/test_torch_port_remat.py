"""Rematerialization in the port: ``Config.remat`` / ``SolverConfig.remat``
(``solvers/solver.apply_remat`` over ``torch.utils.checkpoint``).

Each policy (``full``: nothing saved; ``dots``: matrix-product outputs
saved; ``blocks``: only Pooling outputs saved) must give the step it
rematerializes: the loss, the gradients, the updated params and history
and the BatchNorm state bit for bit the no-remat step's, on the CPU with
one intra-op thread, on the per-blob and the fused paths.  That includes a
TRAIN step with Dropout 0.5 and STOCHASTIC pooling, whose draws come from
the step's generator, which ``torch.utils.checkpoint`` does not restore:
the recompute sets the generator's state at the region's entry again, and
without that the recomputed masks would differ and the gradient would be
wrong with no error.  Against the JAX package, each remat step lands
within rtol/atol 1e-5 of the JAX remat step from the same weights.
"""

import contextlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparknet_tpu.common as jcommon  # noqa: E402
from sparknet_tpu import models as jax_models  # noqa: E402

import sparknet_tpu_torch.common as tcommon  # noqa: E402
from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import (  # noqa: E402
    Network,
    NetVars,
    _dots_policy,
    _pool_segments,
)
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.solvers.solver import (  # noqa: E402
    Solver,
    SolverConfig,
    apply_remat,
    remat_policy,
)

RANDOM_NET = """
name: "RandomLayers"
layer { name: "data" type: "Input" top: "data" input_param { shape { dim: 4 dim: 3 dim: 16 dim: 16 } } }
layer { name: "label" type: "Input" top: "label" input_param { shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc1" type: "InnerProduct" bottom: "pool2" top: "fc1"
  inner_product_param { num_output: 32 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "relu3" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "drop1" type: "Dropout" bottom: "fc1" top: "fc1" dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  inner_product_param { num_output: 5 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" bottom: "label" top: "loss" }
"""

BN_NET = """
name: "BNRemat"
layer { name: "data" type: "Input" top: "data" input_param { shape { dim: 4 dim: 3 dim: 12 dim: 12 } } }
layer { name: "label" type: "Input" top: "label" input_param { shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 weight_filler { type: "msra" } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1" scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool1" top: "fc"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label" top: "loss" }
"""

TRANSFORMER = dict(batch=2, seq_len=8, vocab=16, embed_dim=16, heads=2, ffn_dim=16,
                   blocks=2, num_classes=4)


def _net(name):
    rs = np.random.RandomState(5)
    if name == "random_layers":
        return parse(RANDOM_NET), {"data": rs.randn(4, 3, 16, 16).astype(np.float32),
                                   "label": rs.randint(0, 5, 4).astype(np.int32)}
    if name == "bn":
        return parse(BN_NET), {"data": (rs.randn(4, 3, 12, 12) * 2).astype(np.float32),
                               "label": rs.randint(0, 5, 4).astype(np.int32)}
    if name == "cifar10_quick":
        return models.cifar10_quick(2), {"data": (rs.randn(2, 3, 32, 32) * 40).astype(np.float32),
                                         "label": rs.randint(0, 10, 2).astype(np.int32)}
    if name == "transformer":
        return models.transformer(**TRANSFORMER), {
            "data": rs.randint(0, 16, (2, 8)).astype(np.int32),
            "label": rs.randint(0, 4, 2).astype(np.int32)}
    raise KeyError(name)


@pytest.fixture(autouse=True)
def _one_thread_and_config():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev, jprev = tcommon.get_config(), jcommon.get_config()
    yield
    torch.set_num_threads(threads)
    tcommon._config = prev
    jcommon._config = jprev


@contextlib.contextmanager
def _config(**kw):
    prev = tcommon.get_config()
    tcommon.set_config(**kw)
    try:
        yield
    finally:
        tcommon._config = prev


def _grads(net, variables, feeds, policy, seed=3):
    leaves = {ln: [p.detach().clone().requires_grad_(True) for p in pl]
              for ln, pl in variables.params.items()}
    gen = torch.Generator().manual_seed(seed)
    _, state, loss = apply_remat(net, policy)(NetVars(leaves, variables.state), feeds, gen)
    flat = [p for pl in leaves.values() for p in pl]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), grads, state


@pytest.mark.parametrize("policy", ["full", "dots", "blocks"])
@pytest.mark.parametrize("name", ["random_layers", "bn", "cifar10_quick", "transformer"])
def test_remat_forward_backward_is_bit_for_bit(name, policy):
    param, feeds = _net(name)
    net = Network(param, Phase.TRAIN, device="cpu")
    variables = net.init(torch.Generator().manual_seed(0))
    loss0, g0, s0 = _grads(net, variables, feeds, "")
    loss1, g1, s1 = _grads(net, variables, feeds, policy)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    for ln in s0:
        for k in s0[ln]:
            assert torch.equal(s0[ln][k], s1[ln][k]), (ln, k)


def test_remat_draws_the_forward_masks():
    """The dropout step under remat is not the no-remat step by chance:
    another generator seed gives another gradient, so the masks matter,
    and the recompute reproduces them."""
    param, feeds = _net("random_layers")
    net = Network(param, Phase.TRAIN, device="cpu")
    variables = net.init(torch.Generator().manual_seed(0))
    _, g_a, _ = _grads(net, variables, feeds, "full", seed=3)
    _, g_b, _ = _grads(net, variables, feeds, "full", seed=4)
    _, g_ref, _ = _grads(net, variables, feeds, "", seed=3)
    assert not all(torch.equal(a, b) for a, b in zip(g_a, g_b))
    assert all(torch.equal(a, b) for a, b in zip(g_a, g_ref))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", ["full", "dots", "blocks"])
@pytest.mark.parametrize("name", ["random_layers", "bn"])
def test_remat_solver_steps_are_bit_for_bit(name, policy, fused):
    """Three Solver steps (momentum, weight decay) under each policy: the
    losses, params, history and BatchNorm state equal the no-remat run's."""
    param, feeds = _net(name)
    cfg = SolverConfig(base_lr=0.05, momentum=0.9, weight_decay=1e-3)
    runs = []
    for p in ("", policy):
        with _config(remat=p, fused_update=fused):
            s = Solver(cfg, param, device="cpu")
            losses = []
            s.step(3, lambda it: feeds, callback=lambda it, l: losses.append(l))
        runs.append((s, losses))
    (a, la), (b, lb) = runs
    assert la == lb
    for ln, pl in a.variables.params.items():
        for x, y in zip(pl, b.variables.params[ln]):
            assert torch.equal(x, y), ln
    for ln, sl in a.slots.items():
        for hx, hy in zip(sl, b.slots[ln]):
            assert all(torch.equal(u, v) for u, v in zip(hx, hy)), ln
    for ln, st in a.variables.state.items():
        for k, v in st.items():
            assert torch.equal(v, b.variables.state[ln][k]), (ln, k)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", ["full", "dots", "blocks"])
def test_remat_iter_size_steps_are_bit_for_bit(policy, fused):
    """iter_size 2: the micro-batches draw on from one generator, so the
    second micro-batch's Dropout and STOCHASTIC draws follow the first's.
    The recompute in each backward must leave the generator where the
    forward left it: two steps under each policy give the losses, params
    and history of the no-remat run bit for bit."""
    param, _ = _net("random_layers")
    rs = np.random.RandomState(11)
    feeds = {"data": rs.randn(2, 4, 3, 16, 16).astype(np.float32),
             "label": rs.randint(0, 5, (2, 4)).astype(np.int32)}
    cfg = SolverConfig(base_lr=0.05, momentum=0.9, weight_decay=1e-3, iter_size=2)
    runs = []
    for p in ("", policy):
        with _config(remat=p, fused_update=fused):
            s = Solver(cfg, param, device="cpu")
            losses = []
            s.step(2, lambda it: feeds, callback=lambda it, l: losses.append(l))
        runs.append((s, losses))
    (a, la), (b, lb) = runs
    assert la == lb
    for ln, pl in a.variables.params.items():
        for x, y in zip(pl, b.variables.params[ln]):
            assert torch.equal(x, y), ln
    for ln, sl in a.slots.items():
        for hx, hy in zip(sl, b.slots[ln]):
            assert all(torch.equal(u, v) for u, v in zip(hx, hy)), ln


def test_remat_leaves_the_generator_where_the_forward_left_it():
    """After a backward under each policy the step's generator holds the
    state the no-remat forward leaves it in, not a segment's entry state."""
    param, feeds = _net("random_layers")
    net = Network(param, Phase.TRAIN, device="cpu")
    variables = net.init(torch.Generator().manual_seed(0))
    states = {}
    for policy in ("", "full", "dots", "blocks"):
        leaves = {ln: [p.detach().clone().requires_grad_(True) for p in pl]
                  for ln, pl in variables.params.items()}
        gen = torch.Generator().manual_seed(3)
        _, _, loss = apply_remat(net, policy)(NetVars(leaves, variables.state), feeds, gen)
        torch.autograd.grad(loss, [p for pl in leaves.values() for p in pl])
        states[policy] = gen.get_state()
    assert not torch.equal(states[""], torch.Generator().manual_seed(3).get_state())
    for policy in ("full", "dots", "blocks"):
        assert torch.equal(states[policy], states[""]), policy


def test_prototxt_remat_means_full():
    assert remat_policy(SolverConfig(remat=True)) == "full"
    with _config(remat="blocks"):
        assert remat_policy(SolverConfig()) == "blocks"
        assert remat_policy(SolverConfig(remat=True)) == "full"
    with pytest.raises(ValueError, match="unknown remat policy"):
        apply_remat(None, "most")


def test_dots_policy_saves_matrix_products_only():
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default):
        assert _dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.convolution.default, aten.relu.default, aten.max_pool2d_with_indices.default):
        assert _dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_block_segments_end_at_pooling():
    """``blocks`` cuts the layer list after each Pooling layer (the JAX
    package's BLOCK_SAVE_NAME tags); a net without one is one segment, the
    ``full`` policy's save-nothing form."""
    net = Network(parse(RANDOM_NET), Phase.TRAIN, device="cpu")
    segs = [[l.name for _, l in s] for s in _pool_segments(list(enumerate(net.layers)))]
    assert [s[-1] for s in segs[:-1]] == ["pool1", "pool2"]
    assert segs[-1] == ["fc1", "relu3", "drop1", "fc2", "loss"]
    tnet = Network(models.transformer(**TRANSFORMER), Phase.TRAIN, device="cpu")
    assert len(_pool_segments(list(enumerate(tnet.layers)))) == 1


@pytest.mark.parametrize("policy", ["full", "dots", "blocks"])
def test_remat_step_matches_jax(policy):
    """One SGD step of ``cifar10_quick`` under each policy against the JAX
    Solver under the same policy, from the JAX init: loss and params
    within rtol/atol 1e-5 (float32 sums in another order)."""
    from sparknet_tpu.solvers.solver import Solver as JSolver
    from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig

    _, feeds = _net("cifar10_quick")
    jcommon.set_config(remat=policy)
    js = JSolver(JSolverConfig(base_lr=0.01, momentum=0.9), jax_models.cifar10_quick(2))
    with _config(remat=policy):
        s = Solver(SolverConfig(base_lr=0.01, momentum=0.9), models.cifar10_quick(2),
                   device="cpu")
    s.variables = interop.netvars_from_numpy(js.variables.params, js.variables.state,
                                             device="cpu")
    js.step(1, lambda it: feeds)
    with _config(remat=policy):
        s.step(1, lambda it: feeds)
    np.testing.assert_allclose(float(s._loss_window[-1]), float(js._loss_window[-1]),
                               rtol=1e-5)
    for ln, pl in js.variables.params.items():
        for i, p in enumerate(pl):
            np.testing.assert_allclose(s.variables.params[ln][i].numpy(), np.asarray(p),
                                       rtol=1e-5, atol=1e-5)
    assert jax.devices()[0].platform == "cpu"
