"""The ImageNet zoo families GoogLeNet, VGG-16 and SqueezeNet in the port
against the JAX package, on the CPU at crop 64, batch 4.

One JAX run a family (a module-scoped fixture): ``Solver`` with the
published recipe, dropout at ratio 0 in both packages' nets, one SGD step
on a seeded raw-pixel-scale batch (x40), then the TEST forward on a
second batch.  The port starts from the JAX ``init``'s weights
(``interop.netvars_from_numpy``) and takes the same step per blob and
fused.  The port's TEST forward runs at the JAX run's weights after the
step.  Tolerances are ``test_torch_port_solver``'s: the loss at rtol
1e-5; params, history and state at rtol 1e-4 with an absolute 1e-5 of
each blob's largest |value|; the TEST scores the same.

Param counts at full width are pinned to JAX's from shapes alone: the
JAX side through ``jax.eval_shape``, the port's by walking the layers'
``init`` on the meta device.  ``test_torch_port_zoo_bn.py`` holds ResNet-50
and MobileNet, which carry BatchNorm state, and imports the helpers here.
VGG-16 steps with ``msra_init``, and one ReLU kink widens its lower
layers' tolerance (``STEP_AREL``, measured and explained there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.ops.data_layers import InputLayer as JInputLayer  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase, get_config, set_config  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.ops.data_layers import InputLayer  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

B = 4
CROP = 64
CLASSES = 10

# name -> (builder kwargs at the test size, the score blob)
FAMILIES = {
    "googlenet": (dict(num_classes=CLASSES, crop=CROP), "loss3/classifier"),
    # msra fillers: the published gaussian 0.01 shrinks the signal layer by
    # layer (conv1_1's gradient ~1e-7), so VGG-16 steps with the builder's
    # from-scratch option
    "vgg16": (dict(num_classes=CLASSES, crop=CROP, msra_init=True), "fc8"),
    "squeezenet": (dict(num_classes=CLASSES, crop=CROP), "flat10"),
    "resnet50": (dict(num_classes=CLASSES, crop=CROP), "fc1000"),
    "mobilenet": (dict(num_classes=CLASSES, crop=CROP), "flat7"),
}

# VGG-16 below conv3_2: one of conv3_2's pre-ReLU values in this
# step is -1.8e-4 in the port and +2.2e-5 in JAX (its map's largest |value|
# is 534, so they differ by 4e-7 of it, a rounding), and the ReLU passes
# its gradient in one package only.  Every weight and bias gradient below
# that layer then differs by up to 1.5e-3 of its largest |value|
# (measured), and so do the biases, which start at 0; the other layers
# and the scores hold the common tolerance.  ResNet-50 and MobileNet hold
# their histories otherwise (``history_rel_l2``, see
# ``test_torch_port_zoo_bn.py``).
STEP_AREL = {("vgg16", ln): 2e-3 for ln in (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2")}

# the published widths' param counts at 1000 classes
FULL_WIDTH_PARAMS = {
    "googlenet": 13_378_280,
    "resnet50": 25_557_032,
    "vgg16": 138_357_544,
    "squeezenet": 1_235_496,
    "mobilenet": 4_231_976,
}


def no_dropout(net):
    """``net`` with every Dropout at ratio 0 (either package's Message)."""
    for lp in net.get_all("layer"):
        if lp.get_str("type") == "Dropout":
            lp.get_msg("dropout_param").set("dropout_ratio", 0.0)
    return net


def feeds(seed: int, batch: int = B, crop: int = CROP, classes: int = CLASSES) -> dict:
    rs = np.random.RandomState(seed)
    return {"data": (rs.randn(batch, 3, crop, crop) * 40).astype(np.float32),
            "label": rs.randint(0, classes, batch).astype(np.int32)}


def _np_vars(variables) -> tuple[dict, dict]:
    params = {ln: [np.array(p) for p in pl] for ln, pl in variables.params.items()}
    state = {ln: {k: np.array(v) for k, v in s.items()}
             for ln, s in variables.state.items()}
    return params, state


@dataclasses.dataclass
class JaxRun:
    """What the JAX oracle leaves: the weights it started from, and after
    one step the loss, params, state, history and the TEST scores."""

    params0: dict
    state0: dict
    loss: float
    params: dict
    state: dict
    slots: dict
    scores: np.ndarray
    step_feeds: dict
    test_feeds: dict


def jax_run(name: str, **over) -> JaxRun:
    kwargs, blob = FAMILIES[name]
    kwargs = {**kwargs, **over}
    saved = jget_config()
    jset_config(fused_update=False, storage_dtype="f32")
    try:
        net = no_dropout(getattr(jm, name)(batch=B, **kwargs))
        js = JSolver(getattr(jm, f"{name}_solver")(), net)
        params0, state0 = _np_vars(js.variables)
        step_feeds, test_feeds = feeds(1), feeds(2)
        loss = js.step(1, lambda it: step_feeds)
        params, state = _np_vars(js.variables)
        slots = {ln: [[np.array(h) for h in hl] for hl in sl]
                 for ln, sl in js.slots.items()}
        test_net = JNetwork(net, JPhase.TEST)
        blobs, _, _ = test_net.apply(js.variables, test_feeds, rng=None, train=False)
        scores = np.array(blobs[blob])
    finally:
        jset_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)
    return JaxRun(params0, state0, float(loss), params, state, slots, scores,
                  step_feeds, test_feeds)


def close(got, ref, what, rtol=1e-4, arel=1e-5, extra=0.0):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=arel * float(np.abs(ref).max()) + extra + 1e-30,
                               err_msg=what)


def rel_l2(got, ref) -> float:
    """The relative L2 error ||got - ref|| / ||ref||."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def port_step_matches(name: str, run: JaxRun, fused: bool, loss_rtol=1e-5,
                      state_arel=1e-5, history_rel_l2=None, **over) -> Solver:
    """The port's step from the JAX run's starting weights, held against
    it, and the port's TEST forward at the JAX run's weights after the
    step against JAX's; returns the port Solver after the step.
    ``state_arel`` widens the state's tolerance; ``history_rel_l2``, when
    given, holds each blob's history (the step's update) by its relative L2
    error instead of params and history at the common tolerance, and
    prints the worst (see ``test_torch_port_zoo_bn.py``)."""
    kwargs, blob = FAMILIES[name]
    kwargs = {**kwargs, **over}
    saved = get_config()
    set_config(fused_update=fused, storage_dtype="f32")
    try:
        ps = Solver(getattr(models, f"{name}_solver")(),
                    no_dropout(getattr(models, name)(batch=B, **kwargs)), device="cpu")
        assert (ps.layout is not None) == fused
        ps.variables = interop.netvars_from_numpy(run.params0, run.state0, device="cpu")
        before = kernels.FUSED_UPDATE_LAUNCHES
        loss = ps.step(1, lambda it: run.step_feeds)
        assert kernels.FUSED_UPDATE_LAUNCHES == before  # the CPU runs the plain version
    finally:
        set_config(fused_update=saved.fused_update, storage_dtype=saved.storage_dtype)
    np.testing.assert_allclose(loss, run.loss, rtol=loss_rtol)
    v, slots = ps.variables, ps.slots
    assert set(v.params) == set(run.params) and set(v.state) == set(run.state)
    worst = (0.0, "-")
    for ln, blobs in run.params.items():
        for i, ref in enumerate(blobs):
            got = v.params[ln][i].detach().numpy()
            if history_rel_l2 is not None:
                for j, h in enumerate(run.slots[ln][i]):
                    err = rel_l2(slots[ln][i][j].detach().numpy(), h)
                    worst = max(worst, (err, f"{ln}[{i}][{j}]"))
                    assert err <= history_rel_l2, f"history {ln}[{i}][{j}]: {err:.3g}"
                continue
            arel = STEP_AREL.get((name, ln), 1e-5)
            close(got, ref, f"param {ln}[{i}]", arel=arel)
            for j, h in enumerate(run.slots[ln][i]):
                close(slots[ln][i][j].detach().numpy(), h, f"history {ln}[{i}][{j}]",
                      arel=arel)
    state_worst = 0.0
    for ln, s in run.state.items():
        for k, ref in s.items():
            got = v.state[ln][k].detach().numpy()
            assert got.dtype == np.float32
            close(got, ref, f"state {ln}/{k}", arel=state_arel)
            excess = np.abs(got - ref) - 1e-4 * np.abs(ref)
            state_worst = max(state_worst, float(excess.max()) / (float(np.abs(ref).max()) or 1.0))
    if history_rel_l2 is not None:
        print(f"{name} {'fused' if fused else 'per-blob'} step against JAX: loss rel "
              f"{abs(loss - run.loss) / abs(run.loss):.3g}, worst history relative L2 "
              f"error {worst[0]:.3g} ({worst[1]}), state {state_worst:.3g} of a blob's "
              f"largest |value| beyond rtol 1e-4")
    test_net = Network(ps.net_param, Phase.TEST, device="cpu")
    with torch.no_grad():
        blobs, _, _ = test_net.apply(
            interop.netvars_from_numpy(run.params, run.state, device="cpu"),
            run.test_feeds, train=False)
    close(blobs[blob].numpy(), run.scores, "TEST scores")
    return ps


def layers_in_context_match(name: str, seed: int = 1) -> int:
    """Each layer of ``name``'s TRAIN net alone, on the JAX forward's own
    blobs at the JAX ``init``'s weights and the batch ``feeds(seed)``: the
    port layer's outputs, state, and VJP (seeded cotangents) against the
    JAX layer's (``jax.vjp``) at the common tolerance.  Both layers see the
    same inputs, so no rounding upstream decides a ReLU or a max otherwise.
    Returns the number of layers held."""
    kwargs, _ = FAMILIES[name]
    jnet = JNetwork(no_dropout(getattr(jm, name)(batch=B, **kwargs)), JPhase.TRAIN)
    pnet = Network(no_dropout(getattr(models, name)(batch=B, **kwargs)), Phase.TRAIN,
                   device="cpu")
    params0, state0 = _np_vars(jnet.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(9)
    blob = feeds(seed)
    held = 0
    for jl, pl in zip(jnet.layers, pnet.layers, strict=True):
        assert (jl.name, jl.type) == (pl.name, pl.type)
        if isinstance(jl, JInputLayer):
            continue
        ins = [np.asarray(blob[b]) for b in jl.bottoms]
        fl = [i for i, x in enumerate(ins) if np.issubdtype(x.dtype, np.floating)]
        p0, s0 = params0.get(jl.name, []), state0.get(jl.name, {})

        def jf(p, xs, jl=jl, ins=ins, fl=fl, s0=s0):
            full = [jnp.asarray(x) for x in ins]
            for i, x in zip(fl, xs):
                full[i] = x
            out = jl.apply(p, s0, full, train=True, rng=None)
            return out.outputs, out.state

        outs, vjp, jstate = jax.vjp(jf, [jnp.asarray(p) for p in p0],
                                    [jnp.asarray(ins[i]) for i in fl], has_aux=True)
        cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
        jgp, jgx = vjp([jnp.asarray(c) for c in cots])
        tp = [torch.tensor(p, requires_grad=True) for p in p0]
        tx = [torch.tensor(x) for x in ins]
        for i in fl:
            tx[i].requires_grad_(True)
        out = pl.apply(tp, {k: torch.tensor(v) for k, v in s0.items()}, tx, train=True)
        wrt = tp + [tx[i] for i in fl]
        grads = torch.autograd.grad(out.outputs, wrt, [torch.tensor(c) for c in cots],
                                    allow_unused=True)
        what = f"{name} {jl.name}"
        jgrads = [np.array(g) for g in list(jgp) + list(jgx)]
        if jl.type == "ReLU":
            # at an input of exactly 0 the port passes no gradient, as
            # Caffe's relu_layer.cpp (bottom_data > 0) and torch.relu do;
            # the JAX layer's jnp.maximum passes half of it (measured: one
            # such element in ResNet-50's res4e_relu on this batch)
            tie = ins[0] == 0
            assert tie.sum() <= 4, what
            assert np.all(grads[0].numpy()[tie] == 0), what
            np.testing.assert_allclose(jgrads[0][tie], 0.5 * cots[0][tie], rtol=1e-6)
            jgrads[0][tie] = 0.0
        for k, (o, jo) in enumerate(zip(out.outputs, outs, strict=True)):
            close(o.detach().numpy(), jo, f"{what} output {k}")
        assert set(out.state) == set(jstate), what
        for k, t in out.state.items():
            close(t.detach().numpy(), jstate[k], f"{what} state {k}")
        for k, (g, jg) in enumerate(zip(grads, jgrads, strict=True)):
            got = np.zeros(np.shape(jg), np.float32) if g is None else g.numpy()
            close(got, jg, f"{what} grad {k}")
        blob.update(zip(jl.tops, outs))
        held += 1
    return held


def port_param_count(net_param) -> int:
    """Learnable params of ``net_param`` from shapes alone: each layer's
    ``init`` and ``apply`` on the meta device, which holds no values."""
    net = Network(net_param, Phase.TRAIN, device="cpu")
    blob = {n: torch.empty(s, device="meta") for n, s in net.feed_shapes().items()}
    gen = torch.Generator()
    total = 0
    for layer in net.layers:
        if isinstance(layer, InputLayer):
            continue
        with torch.device("meta"):
            p, s = layer.init(gen, [tuple(blob[b].shape) for b in layer.bottoms])
        total += sum(t.numel() for t in p)
        outs = layer.apply(p, s, [blob[b] for b in layer.bottoms], train=True).outputs
        blob.update(zip(layer.tops, outs))
    return total


def jax_param_count(net_param) -> int:
    net = JNetwork(net_param, JPhase.TRAIN)
    shapes = jax.eval_shape(lambda k: net.init(k), jax.random.key(0))
    return sum(int(np.prod(p.shape)) for pl in shapes.params.values() for p in pl)


@pytest.fixture(scope="module")
def runs():
    """One JAX run a family of this file, made on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_run(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["googlenet", "vgg16", "squeezenet"])
def test_full_width_param_count(name):
    got = port_param_count(getattr(models, name)(batch=1))
    assert got == FULL_WIDTH_PARAMS[name]
    assert got == jax_param_count(getattr(jm, name)(batch=1))


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
@pytest.mark.parametrize("name", ["googlenet", "vgg16", "squeezenet"])
def test_sgd_step_and_test_forward_match_jax(name, fused, runs):
    port_step_matches(name, runs(name), fused)


def test_googlenet_crop_must_be_a_multiple_of_32():
    with pytest.raises(ValueError, match="multiple of 32"):
        models.googlenet(batch=1, crop=200)
    net = models.googlenet(batch=1, crop=96)
    pool5 = next(lp for lp in net.get_all("layer") if lp.get_str("name") == "pool5/7x7_s1")
    assert pool5.get_msg("pooling_param").get_int("kernel_h") == 3


def test_layer_names_with_slashes_survive_a_snapshot(tmp_path):
    """GoogLeNet's ``inception_3a/1x1`` and friends: the port's snapshot
    keys split at the last ``/``, so save, restore and
    ``netvars_from_solverstate`` keep every blob under its own name."""
    s = Solver(models.googlenet_solver(), models.googlenet(batch=2, crop=CROP,
                                                           num_classes=CLASSES),
               device="cpu")
    path = s.save(str(tmp_path / "g"))
    names = [ln for ln in s.variables.params if "/" in ln]
    assert "inception_3a/1x1" in names and "loss1/classifier" in names
    back = interop.netvars_from_solverstate(path, device="cpu")
    assert set(back.params) == set(s.variables.params)
    for ln in names:
        for a, b in zip(back.params[ln], s.variables.params[ln]):
            assert torch.equal(a, b)
    s2 = Solver(models.googlenet_solver(), models.googlenet(batch=2, crop=CROP,
                                                            num_classes=CLASSES),
                device="cpu")
    s2.variables = interop.netvars_from_numpy(
        {ln: [p.numpy() * 0 for p in pl] for ln, pl in s.variables.params.items()},
        device="cpu")
    s2.restore(path)
    for ln in names:
        for a, b in zip(s2.variables.params[ln], s.variables.params[ln]):
            assert torch.equal(a, b)


def test_bench_crops_are_the_jax_packages():
    assert models.BENCH_CROPS == jm.BENCH_CROPS
