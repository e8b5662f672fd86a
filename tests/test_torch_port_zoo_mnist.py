"""The zoo's MNIST families ``mnist_siamese`` and ``mnist_autoencoder`` in
the port against the JAX package, at published width and batch 4 on the
CPU, with their published solver recipes (the siamese net: SGD, inv
policy, momentum 0.9; the autoencoder: SGD, step policy, weight decay
5e-4 with decay_mult 0 on the biases).

Each family builds with the JAX builder's blob shapes, then takes 3 steps
from the JAX ``init``'s weights, per blob and through the fused arena, on
seeded batches: the losses at rtol 1e-5, params and history after the
steps at rtol 1e-4 with 1e-5 of a blob's largest |value| (the zoo tests'
tolerances).  The autoencoder's ``l2_error`` monitor (``loss_weight: 0``)
produces its top, as JAX's does, and adds nothing to the loss.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase, get_config, set_config  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

B = 4
STEPS = 3


def family_feeds(name: str, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    if name == "mnist_siamese":
        return {"pair_data": rs.rand(B, 2, 28, 28).astype(np.float32),
                "sim": rs.randint(0, 2, B).astype(np.float32)}
    return {"data": rs.rand(B, 1, 28, 28).astype(np.float32)}  # pixels in [0, 1]


def close(got, ref, what, rtol=1e-4, arel=1e-5):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max(initial=0.0)) + 1e-30,
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            saved = jget_config()
            jset_config(fused_update=False, storage_dtype="f32")
            try:
                js = JSolver(getattr(jm, f"{name}_solver")(), getattr(jm, name)(batch=B))
                params0 = {ln: [np.array(p) for p in pl]
                           for ln, pl in js.variables.params.items()}
                losses = []
                js.step(STEPS, lambda it: family_feeds(name, it),
                        callback=lambda it, l: losses.append(float(l)))
                cache[name] = dict(
                    params0=params0, losses=losses,
                    params={ln: [np.array(p) for p in pl]
                            for ln, pl in js.variables.params.items()},
                    slots={ln: [[np.array(h) for h in hl] for hl in sl]
                           for ln, sl in js.slots.items()})
            finally:
                jset_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["mnist_siamese", "mnist_autoencoder"])
def test_builds_with_the_jax_shapes_and_recipe(name):
    jnet = JNetwork(getattr(jm, name)(batch=B), JPhase.TRAIN)
    jv = jnet.init(jax.random.PRNGKey(0))
    v = Network(getattr(models, name)(batch=B), Phase.TRAIN, device="cpu").init()
    assert {ln: [tuple(p.shape) for p in pl] for ln, pl in v.params.items()} == \
        {ln: [tuple(p.shape) for p in pl] for ln, pl in jv.params.items()}
    jcfg, cfg = getattr(jm, f"{name}_solver")(), getattr(models, f"{name}_solver")()
    for field in ("base_lr", "lr_policy", "gamma", "power", "stepsize", "momentum",
                  "weight_decay", "max_iter", "solver_type"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
@pytest.mark.parametrize("name", ["mnist_siamese", "mnist_autoencoder"])
def test_steps_from_jax_weights_match_jax(jax_runs, name, fused):
    run = jax_runs(name)
    saved = get_config()
    set_config(fused_update=fused, storage_dtype="f32")
    try:
        ps = Solver(getattr(models, f"{name}_solver")(), getattr(models, name)(batch=B),
                    device="cpu")
    finally:
        set_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)
    ps.variables = interop.netvars_from_numpy(run["params0"], device="cpu")
    losses = []
    ps.step(STEPS, lambda it: family_feeds(name, it),
            callback=lambda it, l: losses.append(l))
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    v, slots = ps.variables, ps.slots
    for ln, blobs in run["params"].items():
        for i, ref in enumerate(blobs):
            close(v.params[ln][i].detach().numpy(), ref, f"{name} param {ln}[{i}]")
            for j, h in enumerate(run["slots"][ln][i]):
                close(slots[ln][i][j].detach().numpy(), h, f"{name} history {ln}[{i}][{j}]")


def test_autoencoder_monitor_adds_no_gradient():
    """``l2_error`` (loss_weight 0) is computed, equal to JAX's, and the
    net's loss is the cross-entropy alone: the monitor adds no gradient."""
    jnet = JNetwork(jm.mnist_autoencoder(batch=B), JPhase.TRAIN)
    jv = jnet.init(jax.random.PRNGKey(0))
    feeds = family_feeds("mnist_autoencoder", 5)
    jblobs, _, jloss = jnet.apply(jv, feeds, rng=None)
    net = Network(models.mnist_autoencoder(batch=B), Phase.TRAIN, device="cpu")
    net.init()
    v = interop.netvars_from_numpy({ln: [np.asarray(p) for p in pl]
                                    for ln, pl in jv.params.items()}, device="cpu")
    params = [p.requires_grad_(True) for pl in v.params.values() for p in pl]
    blobs, _, loss = net.apply(v, feeds)
    close(blobs["l2_error"].detach().numpy(), jblobs["l2_error"], "l2_error", rtol=1e-5)
    close(loss.detach().numpy(), jloss, "loss", rtol=1e-5)
    assert float(loss) == float(blobs["cross_entropy_loss"])
    g_total = torch.autograd.grad(loss, params, retain_graph=True)
    g_xent = torch.autograd.grad(blobs["cross_entropy_loss"], params, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(g_total, g_xent))
