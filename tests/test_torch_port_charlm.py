"""The sequence models on the CPU, against the JAX package.

``charlm`` and ``transformer`` TEST forwards (loss and ``fc``), and the
cached decode builders: ``build_prefill`` and ``build_decode_step``
against the JAX builders on the same pools, tables, positions and
weights (JAX ``init`` through ``interop``).  Tolerances: 1e-4 on the
forwards (float32 sums in another order through two attention blocks),
1e-5 on the prefill and decode step's logits and written pool lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jax_models  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JaxNetwork  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase, get_config, set_config  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network, NetVars  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
CHARLM = dict(batch=3, seq_len=16, vocab=32, embed_dim=32, heads=4, ffn_dim=32, blocks=2)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    kernels.reset_launch_counts()
    yield
    assert kernels.FLASH_LAUNCHES == 0 and kernels.PAGED_LAUNCHES == 0


@pytest.fixture(scope="module")
def charlm_pair():
    """(JAX net, JAX variables, port net, port variables) of one charlm."""
    jnet = JaxNetwork(jax_models.charlm(**CHARLM), JPhase.TEST)
    jvars = jnet.init(jax.random.key(11))
    net = Network(models.charlm(**CHARLM), Phase.TEST, device="cpu")
    return jnet, jvars, net, interop.netvars_from_numpy(jvars.params, jvars.state,
                                                        device="cpu")


@pytest.mark.parametrize("name", ["charlm", "transformer"])
def test_sequence_model_forward_matches_jax(name):
    kw = (dict(CHARLM) if name == "charlm" else
          dict(batch=3, seq_len=12, vocab=20, embed_dim=16, heads=2, ffn_dim=24))
    jnet = JaxNetwork(getattr(jax_models, name)(**kw), JPhase.TEST)
    jvars = jnet.init(jax.random.key(3))
    rs = np.random.RandomState(4)
    data = rs.randint(0, kw["vocab"], (3, kw["seq_len"])).astype(np.int32)
    label = (rs.randint(0, kw["vocab"], (3, kw["seq_len"])) if name == "charlm"
             else rs.randint(0, 10, (3,))).astype(np.int32)
    feeds = {"data": data, "label": label}
    jblobs, _, jloss = jnet.apply(jvars, feeds, rng=None, train=False)
    net = Network(getattr(models, name)(**kw), Phase.TEST, device="cpu")
    variables = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    blobs, _, loss = net.apply(variables, feeds)
    np.testing.assert_allclose(blobs["fc"].numpy(), np.asarray(jblobs["fc"]), **FWD_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **FWD_TOL)
    np.testing.assert_allclose(float(blobs["accuracy"]), float(jblobs["accuracy"]))


def test_port_init_matches_jax_param_shapes():
    jvars = JaxNetwork(jax_models.charlm(**CHARLM), JPhase.TEST).init(jax.random.key(0))
    net = Network(models.charlm(**CHARLM), Phase.TEST, device="cpu")
    variables = net.init(torch.Generator().manual_seed(0))
    assert {k: [tuple(t.shape) for t in v] for k, v in variables.params.items()} == {
        k: [tuple(np.shape(t)) for t in v] for k, v in jvars.params.items()}
    assert net.blob_info()["fc"].shape == (3, 16, 32)


def _pools(seed, a=2, nb=13, t=4, h=4, d=8):
    """Pools of finite garbage, the same for both packages."""
    rs = np.random.RandomState(seed)
    k = rs.randn(a, nb, t, h, d).astype(np.float32)
    v = rs.randn(a, nb, t, h, d).astype(np.float32)
    return k, v


def test_prefill_matches_jax(charlm_pair):
    from sparknet_tpu.models.zoo import build_prefill as jax_build_prefill

    jnet, jvars, net, variables = charlm_pair
    rs = np.random.RandomState(5)
    tokens = rs.randint(0, 32, (3, 16)).astype(np.int32)
    lengths = np.array([5, 16, 1], np.int32)
    # every row owns 4 blocks of 4 tokens: no two rows write one line
    tables = (1 + np.arange(12).reshape(3, 4)).astype(np.int32)
    k0, v0 = _pools(6)
    jk, jv, jlast = jax_build_prefill(jnet)(jvars, tokens, lengths, jnp.asarray(k0),
                                             jnp.asarray(v0), tables)
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    last = models.build_prefill(net)(variables, torch.from_numpy(tokens),
                                     torch.from_numpy(lengths), kp, vp,
                                     torch.from_numpy(tables))
    assert tuple(last.shape) == (3, 32)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **STEP_TOL)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jk), **STEP_TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(jv), **STEP_TOL)
    assert not np.array_equal(kp.numpy(), k0)  # written in place
    np.testing.assert_array_equal(kp[:, 0].numpy(), k0[:, 0])  # null block untouched


def test_decode_step_matches_jax(charlm_pair):
    from sparknet_tpu.models.zoo import build_decode_step as jax_build_decode_step

    jnet, jvars, net, variables = charlm_pair
    tokens = np.array([[3], [31], [0]], np.int32)
    positions = np.array([4, 15, 0], np.int32)
    tables = (1 + np.arange(12).reshape(3, 4)).astype(np.int32)
    k0, v0 = _pools(7)
    jk, jv, jlogits = jax_build_decode_step(jnet)(
        jvars, jnp.asarray(k0), jnp.asarray(v0), tokens, positions, tables)
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    logits = models.build_decode_step(net)(
        variables, kp, vp, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables))
    assert tuple(logits.shape) == (3, 1, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **STEP_TOL)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jk), **STEP_TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(jv), **STEP_TOL)
    # exactly one line a row and layer was written, at (table[pos // T], pos % T)
    changed = (kp.numpy() != k0).any(axis=(3, 4))
    want = np.zeros_like(changed)
    for row, p in enumerate(positions):
        want[:, tables[row, p // 4], p % 4] = True
    np.testing.assert_array_equal(changed, want)


def test_prefill_then_decode_equals_full_window(charlm_pair):
    """The cached path reproduces the full-window forward: prefill a prompt,
    decode the next tokens, and each step's logits match the forward's at
    that position."""
    _, _, net, variables = charlm_pair
    rs = np.random.RandomState(8)
    seq = rs.randint(0, 32, (3, 16)).astype(np.int32)
    full = net.apply(variables, {"data": seq, "label": np.zeros_like(seq)})[0]["fc"]
    tables = torch.from_numpy((1 + np.arange(12).reshape(3, 4)).astype(np.int32))
    kp = torch.zeros(2, 13, 4, 4, 8)
    vp = torch.zeros_like(kp)
    n_prompt = 6
    last = models.build_prefill(net)(variables, torch.from_numpy(seq),
                                     torch.full((3,), n_prompt, dtype=torch.int32),
                                     kp, vp, tables)
    np.testing.assert_allclose(last.numpy(), full[:, n_prompt - 1].numpy(), **STEP_TOL)
    step = models.build_decode_step(net)
    for p in range(n_prompt, 16):
        logits = step(variables, kp, vp, torch.from_numpy(seq[:, p:p + 1]),
                      torch.full((3,), p, dtype=torch.int32), tables)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, p].numpy(), **STEP_TOL)


def test_decode_spec_geometry_and_refusals(charlm_pair):
    _, _, net, _ = charlm_pair
    spec = models.decode_spec(net)
    assert (spec.vocab, spec.embed_dim, spec.heads, spec.head_dim, spec.seq_len) == (
        32, 32, 4, 8, 16)
    assert spec.attn_layers == ("attn1", "attn2") and spec.end == "fc"
    clf = Network(models.transformer(batch=2, seq_len=8, vocab=10, embed_dim=8,
                                     heads=2, ffn_dim=8), Phase.TEST, device="cpu")
    with pytest.raises(ValueError, match="per-token InnerProduct"):
        models.decode_spec(clf)
    with pytest.raises(ValueError, match="per-token InnerProduct"):
        models.build_decode_step(clf)


@pytest.mark.parametrize("fused", [False, True])
def test_training_through_the_cuda_flash_route_trains(fused, monkeypatch):
    """A charlm TRAIN step whose attention cores take the CUDA route
    (``FlashAttentionFunction``: the forward kernel with its lse, the
    backward kernel under autograd) trains, on the per-blob and the fused
    update path: 2 forward and 2 backward launches a step, and the params
    after 2 steps equal those of the plain route's Solver from the same
    weights (rtol 1e-5, atol 1e-6: the backward's formula against
    autograd's, float32 sums in another order).  The CPU stands in for the
    card: the two launchers are the plain versions."""
    from sparknet_tpu_torch.ops import attention
    from sparknet_tpu_torch.solvers.solver import Solver

    launches = []

    def forward(q, k, v, causal, scale, with_lse):
        launches.append("forward")
        o, lse = kernels.flash_attention_forward_lse_torch(q, k, v, causal, scale)
        return o, lse if with_lse else None

    def backward(*args):
        launches.append("backward")
        return kernels.flash_attention_backward_torch(*args)

    rs = np.random.RandomState(9)
    feeds = [{"data": rs.randint(0, 32, (3, 16)).astype(np.int32),
              "label": rs.randint(0, 32, (3, 16)).astype(np.int32)} for _ in range(2)]
    saved = get_config().fused_update
    set_config(fused_update=fused)
    try:
        plain = Solver(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
        v = plain.variables  # views of the arena on the fused path: copy
        start = NetVars({ln: [p.clone() for p in pl] for ln, pl in v.params.items()},
                        v.state)
        plain.step(2, lambda it: feeds[it])
        solver = Solver(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
        solver.variables = start
        monkeypatch.setattr(kernels, "_flash_forward_launch", forward)
        monkeypatch.setattr(kernels, "_flash_backward_launch", backward)
        monkeypatch.setattr(attention, "flash_attention", kernels._flash_attention_route)
        solver.step(2, lambda it: feeds[it])
    finally:
        set_config(fused_update=saved)
    assert launches == ["forward", "forward", "backward", "backward"] * 2
    assert np.isfinite(solver.smoothed_loss)
    got, want = solver.variables.params, plain.variables.params
    moved = 0
    for ln in want:
        for a, b, s0 in zip(got[ln], want[ln], start.params[ln]):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=ln)
            moved += int(not torch.equal(a, s0))
    assert moved == sum(len(pl) for pl in want.values())  # every blob trained


def test_solver_recipes():
    for name in ("charlm_solver", "transformer_solver"):
        ours, ref = getattr(models, name)(), getattr(jax_models, name)()
        for field in ("base_lr", "lr_policy", "momentum", "weight_decay",
                      "max_iter", "solver_type"):
            assert getattr(ours, field) == getattr(ref, field)
