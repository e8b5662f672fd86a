"""Reduced precision in the port against the JAX package: bf16 compute
(``Config.compute_dtype``), bf16 params (``param_dtype``), the activation
storage policies (``activation_dtype``), ``debug_info``, the bf16 weights
bridge and the ``.caffemodel`` of bf16 params.

Small nets: ``cifar10_quick``, ``lenet``, a narrow CaffeNet-shaped net with
two LRNs and a grouped convolution, a narrow BatchNorm+Scale net, and a
2-block narrow ``transformer``.  Weights are the JAX package's init,
crossed through ``interop``; inputs come from numpy seeds.  Both packages
run under the same settings (``set_config`` on each), and the Config is
restored after every test.

The bf16 gate (every output blob, the loss, every gradient on the float32
masters): the port's bf16 error against the JAX float32 result is at most
twice the JAX bf16 error against the same result, plus one bf16 ulp of
max|ref| (2^(floor(log2 max|ref|) - 7)).  The port computes the LRN and
attention in float32 inside bf16 nets (JAX's default LRN and attention
work in bf16), so its error is smaller there.  The bf16-param solver steps
are held to one bf16 ulp of each JAX element.
"""

import contextlib
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sparknet_tpu.common as jcommon  # noqa: E402
from sparknet_tpu import models as jax_models  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.compiler.graph import NetVars as JNetVars  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402

import sparknet_tpu_torch.common as tcommon  # noqa: E402
from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network, NetVars  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

CAFFENET_NARROW = """
name: "CaffeNetNarrow"
layer { name: "data" type: "Input" top: "data" input_param { shape { dim: 2 dim: 3 dim: 35 dim: 35 } } }
layer { name: "label" type: "Input" top: "label" input_param { shape { dim: 2 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 16 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.05 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
  convolution_param { num_output: 16 kernel_size: 3 pad: 1 group: 2
    weight_filler { type: "gaussian" std: 0.05 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm2" type: "LRN" bottom: "pool2" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "fc6" type: "InnerProduct" bottom: "norm2" top: "fc6"
  inner_product_param { num_output: 32 weight_filler { type: "gaussian" std: 0.05 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "fc8" type: "InnerProduct" bottom: "fc6" top: "fc8"
  inner_product_param { num_output: 10 weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" bottom: "label" top: "loss" }
"""

BN_NARROW = """
name: "BNNarrow"
layer { name: "data" type: "Input" top: "data" input_param { shape { dim: 4 dim: 3 dim: 12 dim: 12 } } }
layer { name: "label" type: "Input" top: "label" input_param { shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1 bias_term: false
    weight_filler { type: "msra" } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" }
layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1"
  scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool1" top: "fc"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label" top: "loss" }
"""

TRANSFORMER = dict(batch=2, seq_len=8, vocab=16, embed_dim=16, heads=2, ffn_dim=16,
                   blocks=2, num_classes=4)


def _nets(name):
    """(JAX net param, port net param, feeds)."""
    rs = np.random.RandomState(11)
    if name == "cifar10_quick":
        feeds = {"data": (rs.randn(2, 3, 32, 32) * 40).astype(np.float32),
                 "label": rs.randint(0, 10, 2).astype(np.int32)}
        return jax_models.cifar10_quick(2), models.cifar10_quick(2), feeds
    if name == "lenet":
        feeds = {"data": rs.rand(2, 1, 28, 28).astype(np.float32),
                 "label": rs.randint(0, 10, 2).astype(np.int32)}
        return jax_models.lenet(2), models.lenet(2), feeds
    if name == "caffenet_narrow":
        feeds = {"data": (rs.randn(2, 3, 35, 35) * 40).astype(np.float32),
                 "label": rs.randint(0, 10, 2).astype(np.int32)}
        return jax_parse(CAFFENET_NARROW), parse(CAFFENET_NARROW), feeds
    if name == "bn_narrow":
        feeds = {"data": (rs.randn(4, 3, 12, 12) * 3 + 1).astype(np.float32),
                 "label": rs.randint(0, 5, 4).astype(np.int32)}
        return jax_parse(BN_NARROW), parse(BN_NARROW), feeds
    if name == "transformer":
        feeds = {"data": rs.randint(0, 16, (2, 8)).astype(np.int32),
                 "label": rs.randint(0, 4, 2).astype(np.int32)}
        return (jax_models.transformer(**TRANSFORMER), models.transformer(**TRANSFORMER),
                feeds)
    raise KeyError(name)


NAMES = ["cifar10_quick", "lenet", "caffenet_narrow", "bn_narrow", "transformer"]


@pytest.fixture(autouse=True)
def _restore_configs():
    jprev, tprev = jcommon.get_config(), tcommon.get_config()
    yield
    jcommon._config = jprev
    tcommon._config = tprev


@contextlib.contextmanager
def _both(**kw):
    """The same settings on both packages' Config for the block (dtypes
    given as "bf16"/"f32")."""
    jkw = {k: (jnp.bfloat16 if v == "bf16" else jnp.float32) if k.endswith("_dtype")
           and k not in ("activation_dtype", "storage_dtype") else v for k, v in kw.items()}
    jprev, tprev = jcommon.get_config(), tcommon.get_config()
    jcommon.set_config(**jkw)
    tcommon.set_config(**kw)
    try:
        yield
    finally:
        jcommon._config = jprev
        tcommon._config = tprev


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def bf16_gate(port, jbf, ref, what: str) -> None:
    """The port's bf16 error against ``ref`` (JAX float32) within twice the
    JAX bf16 error plus one bf16 ulp of max|ref|."""
    port, jbf, ref = (np.asarray(a, np.float64) for a in (port, jbf, ref))
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err_p = float(np.abs(port - ref).max()) if ref.size else 0.0
    err_j = float(np.abs(jbf - ref).max()) if ref.size else 0.0
    bound = 2 * err_j + _bf16_ulp(float(np.abs(ref).max()) if ref.size else 0.0)
    assert err_p <= bound, f"{what}: port error {err_p:.3g} > {bound:.3g} (JAX bf16 {err_j:.3g})"


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


_JAX_CACHE: dict = {}


def jax_run(name, phase="TRAIN", **cfg):
    """JAX init (key 7, float32 params), then the forward's blobs, loss and
    gradients under ``cfg``."""
    key = (name, phase, tuple(sorted(cfg.items())))
    if key not in _JAX_CACHE:
        jparam, _, feeds = _nets(name)
        jnet0 = JNetwork(jparam, getattr(jcommon.Phase, phase))
        variables = jnet0.init(jax.random.key(7))
        with _both(**cfg):
            jnet = JNetwork(jparam, getattr(jcommon.Phase, phase))

            def loss_fn(params):
                blobs, _, loss = jnet.apply(JNetVars(params, variables.state), feeds,
                                            rng=jax.random.key(0))
                return loss, blobs

            (loss, blobs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                variables.params)
        _JAX_CACHE[key] = (variables, feeds, {k: np.asarray(v) for k, v in blobs.items()},
                           float(loss), jax.tree_util.tree_map(np.asarray, grads))
    return _JAX_CACHE[key]


def port_run(name, variables, feeds, phase="TRAIN", **cfg):
    """The port's forward and gradients from the JAX variables under
    ``cfg``."""
    _, tparam, _ = _nets(name)
    with _both(**cfg):
        net = Network(tparam, getattr(Phase, phase), device="cpu")
        v = interop.netvars_from_numpy(variables.params, variables.state, device="cpu")
        leaves = {ln: [p.requires_grad_(True) for p in pl] for ln, pl in v.params.items()}
        blobs, state, loss = net.apply(NetVars(leaves, v.state), feeds,
                                       gen=torch.Generator().manual_seed(0))
        flat = [p for pl in leaves.values() for p in pl]
        g = torch.autograd.grad(loss, flat, allow_unused=True)
    grads, k = {}, 0
    for ln, pl in leaves.items():
        grads[ln] = [torch.zeros_like(p) if x is None else x for p, x in zip(pl, g[k:k + len(pl)])]
        k += len(pl)
    return blobs, state, loss, grads


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("remat", "bogus"), ("remat", "dot"), ("activation_dtype", "int8"),
    ("activation_dtype", "half"), ("storage_dtype", "fp8"),
])
def test_set_config_refuses_as_jax_does(field, value):
    with pytest.raises(ValueError) as jerr:
        jcommon.set_config(**{field: value})
    with pytest.raises(ValueError) as terr:
        tcommon.set_config(**{field: value})
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("field,value", [
    ("remat", "NONE"), ("remat", "off"), ("remat", "Dots"), ("remat", "blocks"),
    ("activation_dtype", "bf16"), ("activation_dtype", "bfloat16"),
    ("activation_dtype", "F32"), ("activation_dtype", "io"), ("activation_dtype", "full"),
])
def test_set_config_normalizes_as_jax_does(field, value):
    got = getattr(tcommon.set_config(**{field: value}), field)
    assert got == getattr(jcommon.set_config(**{field: value}), field)
    assert tcommon.act_storage_policy(value if field == "activation_dtype" else "") == (
        jcommon.act_storage_policy(value if field == "activation_dtype" else ""))


def test_compute_and_param_dtypes():
    c = tcommon.set_config(compute_dtype="bf16", param_dtype=torch.float32)
    assert c.compute_dtype == torch.bfloat16 and c.param_dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        tcommon.set_config(compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="unknown activation_dtype"):
        tcommon.act_storage_policy("half")
    with pytest.raises(ValueError, match="activation_dtype must be one of"):
        tcommon.set_config(activation_dtype="half")


def test_env_seeds_the_policies():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SPARKNET_ACT_DTYPE="bf16", SPARKNET_REMAT="Dots")
    out = subprocess.run(
        [sys.executable, "-c", "from sparknet_tpu_torch.common import get_config as g, "
         "act_storage_policy as a; c = g(); print(c.remat, a())"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["dots", "blocks"], out.stderr


# ---------------------------------------------------------------------------
# param_dtype at init; the f32 path takes no cast
# ---------------------------------------------------------------------------

def test_param_dtype_at_init_follows_jax():
    """Every blob the JAX init makes in ``param_dtype`` (Convolution,
    InnerProduct, Scale, BatchNorm's state, Embed, PReLU) is bf16 in the
    port too, and the attention weights stay float32 in both."""
    for name in ("bn_narrow", "transformer", "caffenet_narrow"):
        jparam, tparam, _ = _nets(name)
        with _both(param_dtype="bf16"):
            jv = JNetwork(jparam, jcommon.Phase.TRAIN).init(jax.random.key(0))
            tv = Network(tparam, Phase.TRAIN, device="cpu").init()
        for ln, pl in jv.params.items():
            assert [str(p.dtype) for p in pl] == [
                str(t.dtype).replace("torch.", "") for t in tv.params[ln]], ln
        for ln, s in jv.state.items():
            assert {k: str(v.dtype) for k, v in s.items()} == {
                k: str(v.dtype).replace("torch.", "") for k, v in tv.state[ln].items()}


def test_float32_path_takes_no_cast():
    """With float32 compute and no storage policy the feeds and the params
    reach the layers as they are (the JAX ``mixed``/``act_policy``
    guards): the data blob is the feed tensor itself."""
    _, tparam, feeds = _nets("lenet")
    net = Network(tparam, Phase.TEST, device="cpu")
    v = net.init()
    x = torch.from_numpy(feeds["data"])
    blobs, _, loss = net.apply(v, {"data": x, "label": feeds["label"]})
    assert blobs["data"] is x and loss.dtype == torch.float32
    assert all(b.dtype == torch.float32 for k, b in blobs.items() if k != "label")


# ---------------------------------------------------------------------------
# bf16 compute: forward, gradients, one SGD step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_bf16_forward_and_gradients_match_jax(name):
    variables, feeds, ref_blobs, ref_loss, ref_grads = jax_run(name)
    _, _, jbf_blobs, jbf_loss, jbf_grads = jax_run(name, compute_dtype="bf16")
    blobs, state, loss, grads = port_run(name, variables, feeds, compute_dtype="bf16")
    assert loss.dtype == torch.float32
    bf16_gate(float(loss.detach()), jbf_loss, ref_loss, "loss")
    for k, ref in ref_blobs.items():
        if k in ("label",) or not np.issubdtype(ref.dtype, np.floating):
            continue
        assert str(blobs[k].dtype).replace("torch.", "") == str(jbf_blobs[k].dtype), k
        bf16_gate(_f64(blobs[k]), jbf_blobs[k], ref, f"blob {k}")
    for ln, gl in ref_grads.items():
        for i, g in enumerate(gl):
            assert grads[ln][i].dtype == torch.float32  # on the float32 masters
            bf16_gate(_f64(grads[ln][i]), jbf_grads[ln][i], g, f"grad {ln}[{i}]")
    # returned state keeps its stored dtype (BatchNorm's float32 sums)
    for ln, s in state.items():
        assert all(v.dtype == torch.float32 for v in s.values()), ln


@pytest.mark.parametrize("name", ["cifar10_quick", "caffenet_narrow"])
def test_bf16_test_phase_forward_matches_jax(name):
    variables, feeds, ref_blobs, _, _ = jax_run(name, phase="TEST")
    _, _, jbf_blobs, _, _ = jax_run(name, phase="TEST", compute_dtype="bf16")
    _, tparam, _ = _nets(name)
    with _both(compute_dtype="bf16"), torch.no_grad():
        net = Network(tparam, Phase.TEST, device="cpu")
        v = interop.netvars_from_numpy(variables.params, variables.state, device="cpu")
        blobs, _, _ = net.apply(v, feeds)
    for k in ("fc8" if name == "caffenet_narrow" else "ip2",):
        bf16_gate(_f64(blobs[k]), jbf_blobs[k], ref_blobs[k], k)


def _jax_solver(jparam, solver, **cfg):
    from sparknet_tpu.solvers.solver import Solver as JSolver

    with _both(**cfg):
        return JSolver(solver, jparam)


def _port_solver(tparam, solver, jsolver, **cfg):
    from sparknet_tpu_torch.solvers.solver import Solver

    with _both(**cfg):
        s = Solver(solver, tparam, device="cpu")
    s.variables = interop.netvars_from_numpy(jsolver.variables.params,
                                             jsolver.variables.state, device="cpu")
    return s


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_compute_sgd_step_matches_jax(fused):
    """One SGD step (momentum, weight decay) at bf16 compute: params and
    history stay float32 masters, held to the bf16 gate against JAX's
    float32 step; the fused arena stays float32 (B2 runs its float32
    walk).  Every Solver starts from the same JAX init (seeded)."""
    from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig
    from sparknet_tpu_torch.solvers.solver import SolverConfig

    jparam, tparam, feeds = _nets("cifar10_quick")
    cfg = dict(base_lr=0.01, momentum=0.9, weight_decay=0.004)
    out = {}
    for tag, dt in (("ref", {}), ("jbf", {"compute_dtype": "bf16"})):
        js = _jax_solver(jparam, JSolverConfig(**cfg), fused_update=fused, **dt)
        with _both(fused_update=fused, **dt):
            js.step(1, lambda it: feeds)
        out[tag] = js
    port = _port_solver(tparam, SolverConfig(**cfg), _jax_solver(jparam, JSolverConfig(**cfg)),
                        compute_dtype="bf16", fused_update=fused)
    if fused:
        assert port.layout.storage_dtype == "f32"
    with _both(compute_dtype="bf16", fused_update=fused):
        port.step(1, lambda it: feeds)
    ref, jbf = out["ref"], out["jbf"]
    bf16_gate(float(port._loss_window[-1]), float(jbf._loss_window[-1]),
              float(ref._loss_window[-1]), "loss")
    for ln, pl in ref.variables.params.items():
        for i, p in enumerate(pl):
            assert port.variables.params[ln][i].dtype == torch.float32
            bf16_gate(_f64(port.variables.params[ln][i]), jbf.variables.params[ln][i], p,
                      f"param {ln}[{i}]")
            bf16_gate(_f64(port.slots[ln][i][0]), jbf.slots[ln][i][0], ref.slots[ln][i][0],
                      f"history {ln}[{i}]")


# ---------------------------------------------------------------------------
# bf16 params: the per-blob update and B2's plain version
# ---------------------------------------------------------------------------

def _bf16_ulp_each(a: np.ndarray) -> np.ndarray:
    m = np.abs(a.astype(np.float64))
    return np.where(m > 0, 2.0 ** (np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7), 2.0 ** -133)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_params_step_matches_jax(fused):
    """``param_dtype`` bf16: the JAX init crosses bit for bit (a uint16
    view), and one SGD step through the per-blob chain (bf16 arithmetic, as
    the JAX chain) or through B2's plain version (a bf16 arena, float32
    math, one rounding; JAX packs into a float32 arena and rounds at
    unpack) passes the bf16 gate: the reference is JAX's step in float32
    params from the same (bf16-valued) weights.  The gradients reach the
    bf16 blobs rounded from float32 sums taken in another order, so a
    bf16 element may land an ulp of the gradient away; where the update
    cancels the weight, that is many ulps of the result, hence the gate
    and not an ulp count, except for B2's params, which stay within one
    bf16 ulp of each JAX element."""
    from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig
    from sparknet_tpu_torch.solvers.solver import SolverConfig

    jparam, tparam, feeds = _nets("cifar10_quick")
    cfg = dict(base_lr=0.01, momentum=0.9, weight_decay=0.004)
    js = _jax_solver(jparam, JSolverConfig(**cfg), param_dtype="bf16", fused_update=fused)
    port = _port_solver(tparam, SolverConfig(**cfg), js, param_dtype="bf16",
                        fused_update=fused)
    jref = _jax_solver(jparam, JSolverConfig(**cfg), fused_update=fused)
    jref.variables = JNetVars(
        jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float32), js.variables.params),
        js.variables.state)
    for ln, pl in js.variables.params.items():
        for i, p in enumerate(pl):
            t = port.variables.params[ln][i]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(p).view(np.uint16))
    if fused:
        assert port.layout.storage_dtype == "bf16"
    with _both(fused_update=fused):
        jref.step(1, lambda it: feeds)
    with _both(param_dtype="bf16", fused_update=fused):
        js.step(1, lambda it: feeds)
        port.step(1, lambda it: feeds)
    np.testing.assert_allclose(float(port._loss_window[-1]), float(js._loss_window[-1]),
                               rtol=1e-5)
    for ln, pl in js.variables.params.items():
        for i, p in enumerate(pl):
            got = port.variables.params[ln][i]
            assert got.dtype == torch.bfloat16
            bf16_gate(_f64(got), p, jref.variables.params[ln][i], f"param {ln}[{i}]")
            bf16_gate(_f64(port.slots[ln][i][0]), js.slots[ln][i][0], jref.slots[ln][i][0],
                      f"history {ln}[{i}]")
            if fused:
                want = np.asarray(p).astype(np.float64)
                assert (np.abs(_f64(got) - want) <= _bf16_ulp_each(want)).all(), f"{ln}[{i}]"


def test_bf16_params_beside_float32_attention_weights():
    """``param_dtype`` bf16 on the transformer: its attention weights stay
    float32 (as in JAX), so the fused arena is float32 and the bf16 blobs'
    spans are rounded to bf16 after each update (``arena.round_to_blobs``),
    the JAX step's pack and unpack; the attention layer promotes its bf16
    input to its float32 weights, as JAX's einsum does.  Two fused SGD
    steps pass the bf16 gate against JAX's step in float32 params from the
    same weights (the bf16 step's gradients reach bf16 blobs through bf16
    sums taken in another order), and the arena's bf16 spans hold bf16
    values."""
    from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig
    from sparknet_tpu_torch.solvers.solver import SolverConfig

    jparam, tparam, feeds = _nets("transformer")
    cfg = dict(base_lr=0.1, momentum=0.9)
    js = _jax_solver(jparam, JSolverConfig(**cfg), param_dtype="bf16", fused_update=True)
    port = _port_solver(tparam, SolverConfig(**cfg), js, param_dtype="bf16",
                        fused_update=True)
    jref = _jax_solver(jparam, JSolverConfig(**cfg), fused_update=True)
    jref.variables = JNetVars(
        jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float32), js.variables.params),
        js.variables.state)
    assert port.layout.storage_dtype == "f32" and port.layout.mixed
    dtypes = {str(p.dtype) for pl in port.variables.params.values() for p in pl}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    with _both(fused_update=True):
        jref.step(2, lambda it: feeds)
    with _both(param_dtype="bf16", fused_update=True):
        js.step(2, lambda it: feeds)
        port.step(2, lambda it: feeds)
    for ln, pl in js.variables.params.items():
        for i, p in enumerate(pl):
            got = port.variables.params[ln][i]
            assert str(got.dtype).replace("torch.", "") == str(p.dtype), ln
            bf16_gate(_f64(got), p, jref.variables.params[ln][i], f"param {ln}[{i}]")
    arena = port._param_arena
    for e in port.layout.entries:
        if e.span and e.dtype == "bfloat16":
            seg = arena[e.offset:e.offset + e.size]
            assert torch.equal(seg, seg.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# activation storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["io", "blocks", "full"])
@pytest.mark.parametrize("name", ["cifar10_quick", "caffenet_narrow", "bn_narrow"])
def test_activation_storage_matches_jax(name, policy):
    """The dtype of every stored blob is JAX's under each policy (float32
    compute), and the values pass the bf16 gate against JAX's float32
    forward; so do the gradients."""
    variables, feeds, ref_blobs, ref_loss, ref_grads = jax_run(name)
    _, _, jbf_blobs, jbf_loss, jbf_grads = jax_run(name, activation_dtype=policy)
    blobs, _, loss, grads = port_run(name, variables, feeds, activation_dtype=policy)
    assert {k: str(b.dtype).replace("torch.", "") for k, b in blobs.items()} == {
        k: str(b.dtype) for k, b in jbf_blobs.items()}
    bf16_gate(float(loss.detach()), jbf_loss, ref_loss, "loss")
    for k, ref in ref_blobs.items():
        if np.issubdtype(ref.dtype, np.floating):
            bf16_gate(_f64(blobs[k]), jbf_blobs[k], ref, f"blob {k}")
    for ln, gl in ref_grads.items():
        for i, g in enumerate(gl):
            bf16_gate(_f64(grads[ln][i]), jbf_grads[ln][i], g, f"grad {ln}[{i}]")


@pytest.mark.parametrize("policy", ["blocks", "full"])
def test_stored_blobs_are_what_the_backward_keeps(policy, monkeypatch):
    """Under a storage policy the backward keeps the bf16 blob in place of
    the float32 upcast its consumer would save (``graph._saved_as_stored``),
    and upcasts it again: the gradients are bit for bit those of keeping
    the upcast, and the saved tensors hold the bf16 blobs."""
    from sparknet_tpu_torch.compiler import graph

    variables, feeds, *_ = jax_run("caffenet_narrow")
    _, _, loss, grads = port_run("caffenet_narrow", variables, feeds, activation_dtype=policy)
    packed = []
    real_hooks = torch.autograd.graph.saved_tensors_hooks

    def recording(pack, unpack):
        def rec(t):
            got = pack(t)
            packed.append(got)
            return got
        return real_hooks(rec, unpack)

    monkeypatch.setattr(torch.autograd.graph, "saved_tensors_hooks", recording)
    port_run("caffenet_narrow", variables, feeds, activation_dtype=policy)
    monkeypatch.setattr(torch.autograd.graph, "saved_tensors_hooks", real_hooks)
    monkeypatch.setattr(graph, "_saved_as_stored", lambda stored, ins: contextlib.nullcontext())
    _, _, loss0, grads0 = port_run("caffenet_narrow", variables, feeds, activation_dtype=policy)
    assert torch.equal(loss, loss0)
    for ln in grads:
        for a, b in zip(grads[ln], grads0[ln]):
            assert torch.equal(a, b), ln
    kept = [x for x in packed if isinstance(x, tuple)]
    assert kept and all(x[0].dtype == torch.bfloat16 for x in kept)


# ---------------------------------------------------------------------------
# debug_info
# ---------------------------------------------------------------------------

_LINE = re.compile(r"^\s+\[(Forward|Backward|Update)\] Layer (\S+), (.*): (\S+)$")


def _debug_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        m = _LINE.match(line)
        if m:
            out.append((m.group(1), m.group(2), m.group(3), float(m.group(4))))
    return out


def test_debug_info_prints_jaxs_lines(capsys):
    """``debug_info``: the same [Forward]/[Backward]/[Update] lines as the
    JAX Solver, each value within rtol 1e-4 (float32 sums in another
    order), on the per-blob path even with the fused update set (the JAX
    rule).  The port prints each kind in execution (Caffe's) order; the
    JAX stats come back from ``jit`` as dicts with sorted keys, so the
    lines are compared sorted."""
    from sparknet_tpu.solvers.solver import SolverConfig as JSolverConfig
    from sparknet_tpu_torch.solvers.solver import SolverConfig

    jparam, tparam, feeds = _nets("caffenet_narrow")
    cfg = dict(base_lr=0.01, momentum=0.9, debug_info=True)
    js = _jax_solver(jparam, JSolverConfig(**cfg), fused_update=True)
    port = _port_solver(tparam, SolverConfig(**cfg), js, fused_update=True)
    assert port.layout is None
    capsys.readouterr()
    js.step(1, lambda it: feeds)
    jlines = _debug_lines(capsys.readouterr().out)
    port.step(1, lambda it: feeds)
    tlines = _debug_lines(capsys.readouterr().out)
    assert len(jlines) > 20
    tlines, jlines = sorted(tlines), sorted(jlines)
    assert [l[:3] for l in tlines] == [l[:3] for l in jlines]
    np.testing.assert_allclose([l[3] for l in tlines], [l[3] for l in jlines], rtol=1e-4)


# ---------------------------------------------------------------------------
# bf16 across the weights bridge and into Caffe's file
# ---------------------------------------------------------------------------

def test_bf16_caffemodel_is_byte_equal_to_jaxs(tmp_path):
    from sparknet_tpu.net import export_caffemodel as jexport
    from sparknet_tpu_torch.net import TPUNet, export_caffemodel

    jparam, tparam, _ = _nets("bn_narrow")
    with _both(param_dtype="bf16"):
        jnet = JNetwork(jparam, jcommon.Phase.TRAIN)
        jv = jnet.init(jax.random.key(3))
        net = Network(tparam, Phase.TRAIN, device="cpu")
    v = interop.netvars_from_numpy(jv.params, jv.state, device="cpu")
    assert v.params["conv1"][0].dtype == torch.bfloat16
    jexport(jnet, jv.params, str(tmp_path / "j.caffemodel"), state=jv.state)
    export_caffemodel(net, v.params, str(tmp_path / "t.caffemodel"), state=v.state)
    assert (tmp_path / "j.caffemodel").read_bytes() == (tmp_path / "t.caffemodel").read_bytes()
    # TPUNet honours the dtype: its weights load back into bf16 blobs
    from sparknet_tpu_torch.solvers.solver import SolverConfig

    with _both(param_dtype="bf16"):
        handle = TPUNet(SolverConfig(), tparam, device="cpu")
    assert handle.load_caffemodel(str(tmp_path / "j.caffemodel"))
    got = handle.solver.variables.params["conv1"][0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, v.params["conv1"][0])
    wc = handle.get_weights()
    handle.set_weights(wc)
    assert handle.solver.variables.params["conv1"][0].dtype == torch.bfloat16


def test_bf16_snapshot_round_trip(tmp_path):
    """A bf16-param Solver's snapshot restores into bf16 blobs bit for
    bit (the npz holds float32, exact)."""
    from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig

    _, tparam, feeds = _nets("lenet")
    with _both(param_dtype="bf16"):
        s = Solver(SolverConfig(base_lr=0.01, momentum=0.9), tparam, device="cpu")
        s.step(1, lambda it: feeds)
        path = s.save(str(tmp_path / "s"))
        r = Solver(SolverConfig(base_lr=0.01, momentum=0.9), tparam, device="cpu")
        r.restore(path)
    for ln, pl in s.variables.params.items():
        for a, b in zip(pl, r.variables.params[ln]):
            assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    assert r.iter == 1


def test_dataclasses_field_names_follow_jax():
    """The port's Config names each precision field as the JAX Config."""
    jfields = {f.name for f in dataclasses.fields(jcommon.Config)}
    for name in ("compute_dtype", "param_dtype", "remat", "activation_dtype",
                 "storage_dtype", "fused_update", "seed"):
        assert name in jfields
        assert name in {f.name for f in dataclasses.fields(tcommon.Config)}
