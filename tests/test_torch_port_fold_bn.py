"""BatchNorm folding in the port (``models/fold_bn.py``,
``DeployNet.fold_batchnorm``, the serving engine's ``fold_bn`` arm)
against the JAX package, on the CPU.

A small ResNet-50 (crop 64, batch 4, 5 classes, bn_fraction 0.9) trained
3 steps by the port gives BatchNorm state real statistics, as the JAX
package's ``trained_resnet`` fixture does.  Both packages fold the same
variables: the folded layer lists and the weights are equal (both fold in
float64 from the same float32 blobs, so bit for bit).  Folded scores are
within rtol 2e-4 / atol 2e-4 of the unfolded TEST forward (the JAX test's
gate).  Every skip rule of the fold is run on a small hand-written net in
both packages.  The engine's ``fold_bn`` arm serves ``mobilenet`` at
buckets (1, 8) (the JAX engine raises there, as its refold of the second
bucket finds no BatchNorm state), and the BN-free families' ``fold_bn``
programs give the ``f32`` arm's bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.models.fold_bn import fold_batchnorm as jax_fold  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network, NetVars  # noqa: E402
from sparknet_tpu_torch.models.deploy import DeployNet  # noqa: E402
from sparknet_tpu_torch.models.fold_bn import fold_batchnorm  # noqa: E402
from sparknet_tpu_torch.models.zoo import GRAPH_SWEEP_FAMILIES  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.proto.text_format import serialize  # noqa: E402
from sparknet_tpu_torch.serve import ServeEngine  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

CPU = dict(device="cpu", hbm_bytes=16 << 30)
GATE = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def one_thread():
    """One intra-op thread for the engine's bit-for-bit checks (ROADMAP
    Queue C item 7)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(seed, batch=4, crop=64, classes=5):
    rs = np.random.RandomState(seed)
    return {"data": (rs.randn(batch, 3, crop, crop) * 40).astype(np.float32),
            "label": rs.randint(0, classes, batch).astype(np.int32)}


def _train(net_param, cfg, steps=3, batch=4, crop=64, classes=5):
    s = Solver(cfg, net_param, device="cpu")
    feeds = [_feed(10 + i, batch, crop, classes) for i in range(steps)]
    s.step(steps, lambda it: feeds[it])
    return s


@pytest.fixture(scope="module")
def trained_resnet():
    cfg = dataclasses.replace(models.resnet50_solver(), base_lr=1e-3)
    return _train(models.resnet50(batch=4, num_classes=5, crop=64, bn_fraction=0.9), cfg)


def _np(v):
    return ({ln: [p.detach().numpy() for p in pl] for ln, pl in v.params.items()},
            {ln: {k: t.detach().numpy() for k, t in s.items()} for ln, s in v.state.items()})


def _both(text, params, state):
    """(JAX fold, port fold) of the net ``text`` over numpy params/state."""
    jout = jax_fold(jax_parse(text), params, state)
    tparams = {ln: [torch.from_numpy(np.array(p)) for p in pl] for ln, pl in params.items()}
    tstate = {ln: {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
              for ln, s in state.items()}
    tout = fold_batchnorm(parse(text), tparams, tstate)
    return jout, tout


def _assert_same_fold(jout, tout):
    jnet, jparams, jstate, jlabels = jout
    tnet, tparams, tstate, tlabels = tout
    assert tlabels == jlabels
    assert serialize(tnet) == serialize(parse(str_of(jnet)))
    assert set(tparams) == set(jparams) and set(tstate) == set(jstate)
    for ln, pl in jparams.items():
        assert len(tparams[ln]) == len(pl)
        for a, b in zip(tparams[ln], pl):
            assert a.dtype == torch.float32
            assert np.array_equal(a.numpy(), np.asarray(b)), ln


def str_of(jmsg) -> str:
    """A JAX-package Message as prototxt text."""
    from sparknet_tpu.proto.text_format import serialize as jserialize

    return jserialize(jmsg)


def test_fold_matches_jax_on_a_trained_resnet(trained_resnet):
    net_param = trained_resnet.train_net.net_param
    params, state = _np(trained_resnet.variables)
    assert all(float(s["scale_factor"][0]) > 1.0 for s in state.values())
    jout, tout = _both(serialize(net_param), params, state)
    assert len(tout[3]) == 53
    _assert_same_fold(jout, tout)


def test_folded_resnet_scores_as_the_unfolded(trained_resnet):
    net_param = trained_resnet.train_net.net_param
    v = trained_resnet.variables
    feeds = _feed(1)
    test_net = Network(net_param, Phase.TEST, device="cpu")
    with torch.no_grad():
        ref = test_net.apply(v, feeds, train=False)[0]["fc1000"]
    net2, params2, state2, folded = fold_batchnorm(net_param, v.params, v.state)
    assert len(folded) == 53
    types = {lp.get_str("type") for lp in net2.get_all("layer")}
    assert "BatchNorm" not in types and "Scale" not in types
    with torch.no_grad():
        out = Network(net2, Phase.TEST, device="cpu").apply(
            NetVars(params2, state2), feeds, train=False)[0]["fc1000"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **GATE)
    # the same through the deploy handle, on the net without its label
    # input and the layers that read it
    deploy = parse("")
    for lp in net_param.get_all("layer"):
        if "label" not in [str(b) for b in lp.get_all("bottom")] + [lp.get_str("name")]:
            deploy.add("layer", lp)
    d = DeployNet(deploy, device="cpu")
    d.variables = NetVars({ln: list(pl) for ln, pl in v.params.items()},
                          {ln: dict(s) for ln, s in v.state.items()})
    before = d.forward_all("data", feeds["data"])["fc1000"]
    assert d.fold_batchnorm() == folded
    after = d.forward_all("data", feeds["data"])["fc1000"]
    np.testing.assert_allclose(before, ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(after, ref.numpy(), **GATE)
    assert d.fold_batchnorm() == []  # nothing left to fold


def test_fold_is_a_noop_on_a_bn_free_net():
    net = models.cifar10_quick(2)
    v = Network(net, Phase.TRAIN, device="cpu").init()
    net2, params2, _, folded = fold_batchnorm(net, v.params, v.state)
    assert folded == []
    assert serialize(net2) == serialize(net)
    for ln, pl in v.params.items():
        assert all(a is b for a, b in zip(params2[ln], pl))


# -- the skip rules, each on a small hand-written net ------------------------

_HEAD = 'input: "data" input_shape { dim: 2 dim: 3 dim: 6 dim: 6 }\n'


def _conv(name, bottom, top, n=4, extra=""):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
            f'top: "{top}" {extra} convolution_param {{ num_output: {n} '
            f'kernel_size: 3 bias_term: false }} }}\n')


def _bn(name, blob, extra="", bottom=None):
    return (f'layer {{ name: "{name}" type: "BatchNorm" bottom: "{bottom or blob}" '
            f'top: "{blob}" {extra} }}\n')


def _sc(name, blob, extra=""):
    return (f'layer {{ name: "{name}" type: "Scale" bottom: "{blob}" top: "{blob}" '
            f'{extra} scale_param {{ bias_term: true }} }}\n')


SKIP_CASES = {
    # name -> (net text, chains folded)
    "folds": (_conv("c", "data", "c") + _bn("bn", "c") + _sc("sc", "c"), 1),
    "not_in_place": (_conv("c", "data", "c") + _bn("bn", "n", bottom="c")
                     + _sc("sc", "n"), 0),
    "use_global_stats_false": (_conv("c", "data", "c")
                               + _bn("bn", "c", "batch_norm_param { use_global_stats: false }")
                               + _sc("sc", "c"), 0),
    "producer_not_last_writer": (
        _conv("c", "data", "c")
        + 'layer { name: "r" type: "ReLU" bottom: "c" top: "c" }\n'
        + _bn("bn", "c") + _sc("sc", "c"), 0),
    "intermediate_raw_reader": (
        _conv("c", "data", "c")
        + 'layer { name: "peek" type: "Pooling" bottom: "c" top: "p" '
          'pooling_param { pool: MAX kernel_size: 2 } }\n'
        + _bn("bn", "c") + _sc("sc", "c"), 0),
    "shared_params": (
        _conv("c", "data", "c", extra='param { name: "w" }')
        + _conv("c2", "data", "c2", extra='param { name: "w" }')
        + _bn("bn", "c") + _sc("sc", "c"), 0),
    "channel_mismatch": (_conv("c", "data", "c") + _bn("bn", "c") + _sc("sc", "c"), 0),
    "no_state": (_conv("c", "data", "c") + _bn("bn", "c") + _sc("sc", "c"), 0),
}


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_skip_rules_match_jax(case, rng):
    body, n_folded = SKIP_CASES[case]
    text = _HEAD + body
    ch = 4
    params = {"c": [rng.randn(ch, 3, 3, 3).astype(np.float32)],
              "c2": [rng.randn(ch, 3, 3, 3).astype(np.float32)],
              "sc": [(rng.rand(ch) + 0.5).astype(np.float32),
                     rng.randn(ch).astype(np.float32)]}
    bn_ch = ch + 1 if case == "channel_mismatch" else ch
    state = {} if case == "no_state" else {"bn": {
        "mean": rng.randn(bn_ch).astype(np.float32) * 3,
        "variance": (rng.rand(bn_ch) * 4 + 0.1).astype(np.float32) * 3,
        "scale_factor": np.array([3.0], np.float32)}}
    if "c2" not in body:
        params.pop("c2")
    jout, tout = _both(text, params, state)
    assert len(tout[3]) == n_folded
    _assert_same_fold(jout, tout)
    types = [lp.get_str("type") for lp in tout[0].get_all("layer")]
    assert ("BatchNorm" in types) == (n_folded == 0)


# -- the engine's fold_bn arm ------------------------------------------------


@pytest.fixture(scope="module")
def trained_mobilenet():
    """The engine's mobilenet configuration after 3 steps, 4 images each."""
    fam = GRAPH_SWEEP_FAMILIES["mobilenet"]
    s = _train(fam.net(4), fam.solver(), classes=fam.num_classes)
    return s.variables


def test_fold_bn_arm_serves_mobilenet_at_two_buckets(trained_mobilenet, one_thread):
    engine = ServeEngine(buckets=(1, 8), **CPU)
    try:
        f32 = engine.load_model("f32", family="mobilenet", variables=trained_mobilenet)
        fold = engine.load_model("fold", family="mobilenet", arm="fold_bn",
                                 variables=trained_mobilenet)
        assert len(fold.folded) == 27 and f32.folded == []
        assert fold.variables.state == {} and len(fold.source_variables.state) == 27
        assert f32.source_variables is f32.variables
        assert {t.device.type for s in fold.source_variables.state.values()
                for t in s.values()} == {"cpu"}
        rs = np.random.RandomState(2)
        items = [(rs.randn(3, 64, 64) * 40).astype(np.float32) for _ in range(8)]
        a, b = engine.infer("f32", items[0]), engine.infer("fold", items[0])
        assert np.isfinite(a).all()
        np.testing.assert_allclose(b, a, **GATE)
        for name in ("f32", "fold"):
            engine.submit_many(name, items)
        tickets = {n: [engine.submit(n, it) for it in items] for n in ("f32", "fold")}
        engine.pump(force=True)
        for t32, tf in zip(tickets["f32"], tickets["fold"]):
            assert t32.bucket == tf.bucket == 8
            np.testing.assert_allclose(tf.result, t32.result, **GATE)
    finally:
        engine.shutdown()


def test_jax_engine_refold_fails_for_mobilenet_at_two_buckets(trained_mobilenet):
    """The reference's defect the port does not copy: the JAX engine folds
    again for bucket 8 from the already-folded variables."""
    from sparknet_tpu.compiler.graph import NetVars as JNetVars
    from sparknet_tpu.serve import ServeEngine as JaxEngine

    params, state = _np(trained_mobilenet)
    jax_engine = JaxEngine(buckets=(1, 8))
    try:
        with pytest.raises(KeyError, match="scale_factor"):
            jax_engine.load_model("m", family="mobilenet", arm="fold_bn",
                                  variables=JNetVars(params=params, state=state))
    finally:
        jax_engine.shutdown()


@pytest.mark.parametrize("family", ["lenet", "cifar10_quick"])
def test_fold_bn_arm_of_a_bn_free_family_is_the_f32_arm(family, one_thread):
    engine = ServeEngine(buckets=(1, 8), **CPU)
    try:
        engine.load_model("f32", family=family)
        model = engine.load_model("fold", family=family, arm="fold_bn")
        assert model.folded == []
        rs = np.random.RandomState(4)
        shape = GRAPH_SWEEP_FAMILIES[family].image_shape
        items = [(rs.randn(*shape) * 10).astype(np.float32) for _ in range(5)]
        for it in items[:2]:
            assert np.array_equal(engine.infer("fold", it), engine.infer("f32", it))
        tickets = {n: [engine.submit(n, it) for it in items] for n in ("f32", "fold")}
        engine.pump(force=True)
        for a, b in zip(tickets["f32"], tickets["fold"]):
            assert np.array_equal(a.result, b.result)
    finally:
        engine.shutdown()


def test_a_replica_joining_a_fold_bn_pool_folds_the_loaded_weights(one_thread):
    """A join copies a serving replica's weights as they were loaded, so
    the new replica folds them once, as the first did."""
    from sparknet_tpu_torch.serve import ReplicaRouter

    pod = ReplicaRouter(replicas=1, family="mobilenet", arm="fold_bn", buckets=(1, 8),
                        devices=["cpu"] * 2, hbm_bytes=16 << 30)
    try:
        rid = pod.join_replica()
        first, joined = [rep.model for rep in pod._replicas.values()]
        assert len(joined.folded) == len(first.folded) == 27
        for ln, pl in first.variables.params.items():
            for a, b in zip(pl, joined.variables.params[ln]):
                assert torch.equal(a, b), ln
        assert rid in pod._replicas
    finally:
        pod.shutdown()
