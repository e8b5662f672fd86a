"""The port's training path (``sparknet_tpu_torch/solvers/``) against the JAX
package's ``Solver``, on the CPU at a small size.

Every trajectory starts from one snapshot: the JAX ``Solver`` writes its
``.solverstate.npz`` and both solvers restore it, so filler randomness
never enters a comparison.  Inputs are numpy arrays at raw-pixel scale
(x50), as the zoo fillers expect; dropout runs at ratio 0 in trajectories
(the two packages draw different masks by design) and is tested on its own
below.

Tolerances, after 3 steps: the loss at rtol 1e-5, params and history at
rtol 1e-4 with an absolute 1e-5 of each blob's largest |value|.  The two
packages differentiate different but equal formulas in float32 — XLA's
reduce_window LRN with ``jnp.power`` against the port's shifted-add LRN
with the rsqrt form, XLA's and oneDNN's convolution and GEMM accumulation
orders — and three momentum steps carry those roundings into every blob.
The learning-rate policies are held to rtol 1e-6 (both packages compute
them in float32 through ``pow``, whose last bit may differ).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import layers_dsl as jdsl  # noqa: E402
from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402
from sparknet_tpu.solvers import lr_policy as jlr  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402
from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig  # noqa: E402

from sparknet_tpu_torch import interop, layers_dsl, models  # noqa: E402
from sparknet_tpu_torch.common import Phase, get_config, set_config  # noqa: E402
from sparknet_tpu_torch.ops import create_layer, kernels  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.proto.upgrade import upgrade_solver  # noqa: E402
from sparknet_tpu_torch.proto_loader import load_solver_prototxt_with_net  # noqa: E402
from sparknet_tpu_torch.solvers.lr_policy import learning_rate  # noqa: E402
from sparknet_tpu_torch.solvers.solver import (  # noqa: E402
    Solver,
    SolverConfig,
    load_solver_net,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
STEPS = 3


@pytest.fixture
def fused_config():
    """Set ``fused_update`` (and ``storage_dtype``) in both packages for
    one test, and put both back after."""
    saved = (jget_config(), get_config())

    def set_both(fused: bool, storage: str = "f32"):
        jset_config(fused_update=fused, storage_dtype=storage)
        set_config(fused_update=fused, storage_dtype=storage)

    yield set_both
    jset_config(fused_update=saved[0].fused_update,
                storage_dtype=saved[0].storage_dtype)
    set_config(fused_update=saved[1].fused_update,
               storage_dtype=saved[1].storage_dtype)


def narrow_alexnet(dsl, batch=B, crop=67, classes=10, drop=0.0):
    """AlexNet's layer types and order at widths <= 32: group-2 convs, both
    cross-channel LRNs, Dropout (at ratio 0 unless ``drop`` is given);
    biases take lr_mult 2 and no decay, as in the published net's
    prototxt."""

    def conv(name, bottom, k, n, stride=1, pad=0, group=1):
        m = dsl.ConvolutionLayer(name, [bottom], kernel=(k, k), num_output=n,
                                 stride=(stride, stride), pad=(pad, pad),
                                 group=group,
                                 weight_filler=dsl._filler("gaussian", std=0.05),
                                 bias_filler=dsl._filler("constant", value=0.1))
        return _mults(m)

    def ip(name, bottom, n):
        return _mults(dsl.InnerProductLayer(
            name, [bottom], num_output=n,
            weight_filler=dsl._filler("gaussian", std=0.05),
            bias_filler=dsl._filler("constant", value=0.1)))

    def _mults(m):
        m.add("param", type(m)().set("lr_mult", 1.0).set("decay_mult", 1.0))
        m.add("param", type(m)().set("lr_mult", 2.0).set("decay_mult", 0.0))
        return m

    pool = lambda name, bottom: dsl.PoolingLayer(  # noqa: E731
        name, [bottom], dsl.Pooling.Max, kernel=(3, 3), stride=(2, 2))
    relu = lambda name, bottom: dsl.ReLULayer(name, [bottom], in_place=True)  # noqa: E731
    return dsl.NetParam(
        "NarrowAlexNet",
        dsl.RDDLayer("data", shape=[batch, 3, crop, crop]),
        dsl.RDDLayer("label", shape=[batch]),
        conv("conv1", "data", 11, 16, stride=4), relu("relu1", "conv1"),
        dsl.LRNLayer("norm1", ["conv1"], local_size=5, alpha=1e-4, beta=0.75),
        pool("pool1", "norm1"),
        conv("conv2", "pool1", 5, 32, pad=2, group=2), relu("relu2", "conv2"),
        dsl.LRNLayer("norm2", ["conv2"], local_size=5, alpha=1e-4, beta=0.75),
        pool("pool2", "norm2"),
        conv("conv3", "pool2", 3, 32, pad=1), relu("relu3", "conv3"),
        conv("conv4", "conv3", 3, 32, pad=1, group=2), relu("relu4", "conv4"),
        conv("conv5", "conv4", 3, 32, pad=1, group=2), relu("relu5", "conv5"),
        pool("pool5", "conv5"),
        ip("fc6", "pool5", 32), relu("relu6", "fc6"),
        dsl.DropoutLayer("drop6", ["fc6"], ratio=drop, in_place=True),
        ip("fc7", "fc6", 32), relu("relu7", "fc7"),
        dsl.DropoutLayer("drop7", ["fc7"], ratio=drop, in_place=True),
        ip("fc8", "fc7", classes),
        dsl.SoftmaxWithLoss("loss", ["fc8", "label"]),
        dsl.AccuracyLayer("accuracy", ["fc8", "label"], phase="TEST"),
    )


NETS = {
    # name -> (JAX net, port net, input shape, classes)
    "cifar10_quick": (lambda: jm.cifar10_quick(B), lambda: models.cifar10_quick(B),
                      (B, 3, 32, 32), 10),
    "narrow_alexnet": (lambda: narrow_alexnet(jdsl), lambda: narrow_alexnet(layers_dsl),
                       (B, 3, 67, 67), 10),
}


def _feeds(shape, classes, n, seed=0, lead=()):
    rs = np.random.RandomState(seed)
    return [{"data": (rs.randn(*lead, *shape) * 50).astype(np.float32),
             "label": rs.randint(0, classes, (*lead, shape[0])).astype(np.int32)}
            for _ in range(n)]


def _pair(net_name, jcfg, tcfg, tmp_path):
    """A JAX and a port Solver restored from the JAX Solver's snapshot."""
    jnet, tnet, _, _ = NETS[net_name]
    js = JSolver(jcfg, jnet())
    path = js.save(str(tmp_path / "start"))
    js.restore(path)
    ps = Solver(tcfg, tnet(), device="cpu")
    ps.restore(path)
    return js, ps


def _assert_same_state(js, ps, rtol=1e-4, arel=1e-5, param_atol=0.0):
    jparams, jslots = js.variables.params, js.slots
    tv, tslots = ps.variables, ps.slots
    assert set(tv.params) == set(jparams)
    for ln, blobs in jparams.items():
        for i, b in enumerate(blobs):
            ref = np.asarray(b)
            np.testing.assert_allclose(
                tv.params[ln][i].detach().numpy(), ref, rtol=rtol,
                atol=arel * float(np.abs(ref).max()) + param_atol,
                err_msg=f"param {ln}[{i}]")
            for j, h in enumerate(jslots[ln][i]):
                href = np.asarray(h)
                np.testing.assert_allclose(
                    tslots[ln][i][j].detach().numpy(), href, rtol=rtol,
                    atol=arel * float(np.abs(href).max()) + 1e-30,
                    err_msg=f"history {ln}[{i}][{j}]")


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
@pytest.mark.parametrize("net_name", list(NETS))
def test_sgd_trajectory_matches_jax(net_name, fused, fused_config, tmp_path):
    fused_config(fused)
    _, _, shape, classes = NETS[net_name]
    cfg = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, lr_policy="step",
               gamma=0.5, stepsize=2)
    js, ps = _pair(net_name, JSolverConfig(**cfg), SolverConfig(**cfg), tmp_path)
    assert (ps.layout is not None) == fused
    feeds = _feeds(shape, classes, STEPS)
    jloss = js.step(STEPS, lambda it: feeds[it])
    before = (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
              kernels.FUSED_UPDATE_LAUNCHES)
    tloss = ps.step(STEPS, lambda it: feeds[it])
    assert (kernels.LRN_LAUNCHES, kernels.LRN_BACKWARD_LAUNCHES,
            kernels.FUSED_UPDATE_LAUNCHES) == before  # the CPU runs the plain versions
    assert ps.iter == js.iter == STEPS
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_same_state(js, ps)


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
def test_adam_step_matches_jax(fused, fused_config, tmp_path):
    """Adam's first step moves each weight by about base_lr * sign(g),
    except where |g| is near delta / sqrt(1 - beta2) (3e-7), where the step
    follows the gradient's last digits; params are held to 1 % of base_lr
    absolute besides the common tolerance."""
    fused_config(fused)
    cfg = dict(base_lr=1e-3, momentum=0.9, momentum2=0.999, delta=1e-8,
               weight_decay=5e-4, solver_type="Adam")
    js, ps = _pair("cifar10_quick", JSolverConfig(**cfg), SolverConfig(**cfg), tmp_path)
    feeds = _feeds((B, 3, 32, 32), 10, 1, seed=1)
    np.testing.assert_allclose(ps.step(1, lambda it: feeds[it]),
                               js.step(1, lambda it: feeds[it]), rtol=1e-5)
    _assert_same_state(js, ps, param_atol=1e-2 * cfg["base_lr"])


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
def test_iter_size_2_with_clip_matches_jax(fused, fused_config, tmp_path):
    """Two micro-batches accumulate (param dtype per blob, float32 on the
    fused path), the global-norm clip engages, then 1/iter_size."""
    fused_config(fused)
    cfg = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4, iter_size=2,
               clip_gradients=0.5)
    js, ps = _pair("narrow_alexnet", JSolverConfig(**cfg), SolverConfig(**cfg), tmp_path)
    feeds = _feeds((B, 3, 67, 67), 10, 1, seed=2, lead=(2,))
    jloss = js.step(1, lambda it: feeds[it])
    tloss = ps.step(1, lambda it: feeds[it])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_same_state(js, ps)


def test_bf16_storage_trains_and_matches_jax(fused_config, tmp_path):
    """bf16 arenas: the blobs and the snapshot stay float32; after one
    step params and history agree with the JAX package's bf16 arenas to
    one bf16 rounding (rtol 2^-7)."""
    fused_config(True, "bf16")
    cfg = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4)
    js, ps = _pair("cifar10_quick", JSolverConfig(**cfg), SolverConfig(**cfg), tmp_path)
    assert ps.layout.storage == torch.bfloat16
    feeds = _feeds((B, 3, 32, 32), 10, 1, seed=3)
    np.testing.assert_allclose(ps.step(1, lambda it: feeds[it]),
                               js.step(1, lambda it: feeds[it]), rtol=1e-4)
    assert all(p.dtype == torch.float32 for pl in ps.variables.params.values() for p in pl)
    _assert_same_state(js, ps, rtol=2 ** -7, arel=2 ** -7)


@pytest.mark.parametrize("policy", ["fixed", "step", "exp", "inv", "multistep",
                                    "poly", "sigmoid"])
def test_lr_policies_match_jax(policy):
    cfg = dict(base_lr=0.01, lr_policy=policy, gamma=0.9 if policy == "exp" else 1e-3
               if policy in ("inv", "sigmoid") else 0.1, power=0.75, stepsize=7,
               stepvalue=(3, 11, 40), max_iter=50)
    for it in (0, 1, 6, 7, 12, 39, 49):
        ref = float(jlr.learning_rate(JSolverConfig(**cfg), it))
        ours = learning_rate(SolverConfig(**cfg), it)
        assert ours.dtype == torch.float32 and ours.dim() == 0
        np.testing.assert_allclose(float(ours), ref, rtol=1e-6, err_msg=f"it {it}")


def test_snapshots_cross_load_both_ways(fused_config, tmp_path):
    """JAX save -> port restore -> step -> port snapshot -> JAX restore:
    the JAX solver then holds exactly the port's state."""
    fused_config(True)
    cfg = dict(base_lr=0.01, momentum=0.9, weight_decay=5e-4)
    js, ps = _pair("cifar10_quick", JSolverConfig(**cfg), SolverConfig(**cfg), tmp_path)
    feeds = _feeds((B, 3, 32, 32), 10, 2, seed=4)
    ps.step(2, lambda it: feeds[it])
    path = interop.solverstate_from_port(ps, tmp_path / "port.solverstate.npz")
    with np.load(path) as z:
        assert json.loads(bytes(z["__meta__"]).decode())["solver_type"] == "SGD"
        assert int(z["__iter__"]) == 2
    js.restore(path)
    assert js.iter == ps.iter == 2
    for ln, blobs in ps.variables.params.items():
        for i, p in enumerate(blobs):
            np.testing.assert_array_equal(np.asarray(js.variables.params[ln][i]),
                                          p.detach().numpy())
            np.testing.assert_array_equal(np.asarray(js.slots[ln][i][0]),
                                          ps.slots[ln][i][0].detach().numpy())
    # and back: the JAX snapshot of that state restores into a per-blob port solver
    set_config(fused_update=False)
    ps2 = Solver(SolverConfig(**cfg), models.cifar10_quick(B), device="cpu")
    ps2.restore(js.save(str(tmp_path / "jax2")))
    assert ps2.iter == 2
    for ln, blobs in ps.variables.params.items():
        for i, p in enumerate(blobs):
            assert torch.equal(ps2.variables.params[ln][i], p)
            assert torch.equal(ps2.slots[ln][i][0], ps.slots[ln][i][0])


def test_port_save_restore_round_trip_and_type_check(tmp_path):
    cfg = SolverConfig(base_lr=0.01, momentum=0.9)
    ps = Solver(cfg, models.lenet(2), device="cpu")
    feeds = _feeds((2, 1, 28, 28), 10, 1, seed=5)
    ps.step(1, lambda it: feeds[0])
    path = ps.save(str(tmp_path / "lenet"))
    assert path.endswith(".solverstate.npz") and os.path.exists(path)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    other = Solver(cfg, models.lenet(2), device="cpu")
    other.restore(path)
    assert other.iter == 1
    for ln, blobs in ps.variables.params.items():
        for a, b in zip(blobs, other.variables.params[ln]):
            assert torch.equal(a, b)
    adam = Solver(SolverConfig(solver_type="Adam"), models.lenet(2), device="cpu")
    with pytest.raises(ValueError, match="solver_type='SGD'"):
        adam.restore(path)


def test_test_phase_matches_jax(tmp_path):
    js, ps = _pair("cifar10_quick", JSolverConfig(), SolverConfig(), tmp_path)
    feeds = _feeds((B, 3, 32, 32), 10, 2, seed=6)
    jres = js.test(2, lambda b: feeds[b])
    tres = ps.test(2, lambda b: feeds[b])
    assert set(tres) == set(jres) == {"accuracy", "loss"}
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-5)
    # test_all runs test_iter batches of each test net (1 when unset)
    assert ps.test_all([lambda b: feeds[b]]) == [ps.test(1, lambda b: feeds[b])]


@pytest.mark.parametrize("name", ["lenet", "cifar10_quick", "cifar10_full",
                                  "alexnet", "caffenet"])
def test_zoo_solver_recipes_match_jax(name):
    ours = dataclasses.asdict(getattr(models, f"{name}_solver")())
    ref = dataclasses.asdict(getattr(jm, f"{name}_solver")())
    assert ours == ref


SOLVER_TEXT = """base_lr: 0.01 lr_policy: "step" gamma: 0.1 stepsize: 100
momentum: 0.9 weight_decay: 0.0005 max_iter: 300 solver_mode: GPU
test_iter: 2 test_interval: 10 {type_field}
net: "train_val.prototxt"
"""


@pytest.mark.parametrize("type_field,want", [
    ("solver_type: NESTEROV", "Nesterov"), ("solver_type: 5", "Adam"),
    ('type: "AdaGrad"', "AdaGrad"), ("", "SGD")])
def test_solver_prototxt_upgrades_and_loads_like_jax(type_field, want, tmp_path):
    from sparknet_tpu.proto.upgrade import upgrade_solver as jupgrade

    text = SOLVER_TEXT.format(type_field=type_field)
    (tmp_path / "solver.prototxt").write_text(text)
    net_text = "name: 'n' layer { name: 'ip' type: 'InnerProduct' }"
    (tmp_path / "train_val.prototxt").write_text(net_text)
    m = upgrade_solver(parse(text))
    assert not m.has("solver_type")
    cfg = SolverConfig.from_proto(m)
    assert cfg.solver_type == want
    ref = JSolverConfig.from_proto(jupgrade(jax_parse(text)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert load_solver_net(m, str(tmp_path)).get_str("name") == "n"
    embedded = load_solver_prototxt_with_net(str(tmp_path / "solver.prototxt"),
                                             models.lenet(2))
    assert not embedded.has("net")
    assert load_solver_net(embedded).get_str("name") == "LeNet"
    with pytest.raises(ValueError, match="Unknown solver_type"):
        upgrade_solver(parse("solver_type: 9"))


# ---------------------------------------------------------------------------
# Dropout, TRAIN phase
# ---------------------------------------------------------------------------

DROP = """layer {{ name: "d" type: "Dropout" bottom: "x" top: "x"
  dropout_param {{ dropout_ratio: {ratio} }} }}"""


def _dropout(ratio, phase=Phase.TRAIN):
    return create_layer(parse(DROP.format(ratio=ratio)).get_all("layer")[0], phase)


def test_dropout_keeps_the_right_fraction_scaled():
    ratio, n = 0.3, 200_000
    x = torch.rand(n) + 0.5
    y = _dropout(ratio).apply([], {}, [x], train=True,
                              gen=torch.Generator().manual_seed(0)).outputs[0]
    kept = y != 0
    keep = 1 - ratio
    sigma = (keep * ratio / n) ** 0.5
    assert abs(float(kept.float().mean()) - keep) < 4 * sigma
    assert torch.equal(y[kept], x[kept] / keep)


def test_dropout_mask_follows_the_generator_and_grad_is_masked():
    layer = _dropout(0.5)
    x = torch.randn(4, 64).requires_grad_(True)
    y1 = layer.apply([], {}, [x], train=True, gen=torch.Generator().manual_seed(7)).outputs[0]
    y2 = layer.apply([], {}, [x], train=True, gen=torch.Generator().manual_seed(7)).outputs[0]
    y3 = layer.apply([], {}, [x], train=True, gen=torch.Generator().manual_seed(8)).outputs[0]
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    (g,) = torch.autograd.grad(y1.sum(), x)
    dropped = y1.detach() == 0
    assert not g[dropped].any()
    assert torch.equal(g[~dropped], torch.full_like(g[~dropped], 2.0))


def test_dropout_raises_without_generator_and_is_identity_otherwise():
    x = torch.randn(3, 5)
    with pytest.raises(ValueError, match="needs a generator"):
        _dropout(0.5).apply([], {}, [x], train=True)
    assert _dropout(0.5, Phase.TEST).apply([], {}, [x], train=False).outputs[0] is x
    assert _dropout(0.0).apply([], {}, [x], train=True).outputs[0] is x


def test_dropout_masks_follow_seed_and_iteration(tmp_path):
    """With dropout on, the masks are a function of (random_seed, iter): two
    solvers from one seed take the same steps, and a run restored at
    iteration 1 takes the step an uninterrupted run takes there."""
    cfg = SolverConfig(base_lr=0.01, momentum=0.9, random_seed=5)
    net = narrow_alexnet(layers_dsl, drop=0.5)
    feeds = _feeds((B, 3, 67, 67), 10, 2, seed=8)
    a = Solver(cfg, net, device="cpu")
    b = Solver(cfg, net, device="cpu")
    a.step(1, lambda it: feeds[it])
    path = a.save(str(tmp_path / "a1"))
    la = a.step(1, lambda it: feeds[it])
    b.restore(path)
    lb = b.step(1, lambda it: feeds[it])
    assert la == lb
    for ln, blobs in a.variables.params.items():
        for p, q in zip(blobs, b.variables.params[ln]):
            assert torch.equal(p, q)
    other = Solver(dataclasses.replace(cfg, random_seed=6), net, device="cpu")
    other.restore(path)
    assert other.step(1, lambda it: feeds[it]) != la


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_config_knobs_validate_and_read_the_environment(fused_config):
    fused_config(False)
    assert set_config(storage_dtype="bfloat16").storage_dtype == "bf16"
    assert set_config(storage_dtype="F32").storage_dtype == "f32"
    with pytest.raises(ValueError, match="storage_dtype"):
        set_config(storage_dtype="fp8")
    env = dict(os.environ, SPARKNET_FUSED_UPDATE="1", SPARKNET_STORAGE_DTYPE="BF16")
    out = subprocess.run(
        [sys.executable, "-c", "from sparknet_tpu_torch.common import get_config as g;"
         " c = g(); print(c.fused_update, c.storage_dtype)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "bf16"], out.stderr


def test_solver_rejects_unported_knobs():
    # remat and debug_info are ported (the prototxt's remat bool is the
    # "full" policy); an unknown snapshot format is still refused
    from sparknet_tpu_torch.solvers.solver import remat_policy

    s = Solver(SolverConfig(remat=True, debug_info=True), models.lenet(2), device="cpu")
    assert remat_policy(s.config) == "full" and s.layout is None
    with pytest.raises(ValueError, match="snapshot_format"):
        Solver(SolverConfig(snapshot_format="PNG"), models.lenet(2), device="cpu")
