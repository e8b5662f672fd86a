"""The char LM's training slice on the CPU, against the JAX package.

A ``charlm`` Adam trajectory (per-blob and fused), the ``TPUNet`` handle
(full and sub-range ``forward``, ``backward`` w.r.t. params and inputs,
weight exchange), the char-text feed (``data/text.py``) and
``generate_chars``, each against its JAX counterpart on the same weights
(the JAX side's, crossed through a ``.solverstate.npz`` or a
``WeightCollection``) and the same seeded inputs.  The attention core runs
the flash kernels' plain versions here (CPU tensors).

Tolerances: the trajectory uses ``test_torch_port_solver.py``'s Adam ones
(loss rtol 1e-5; params and history rtol 1e-4 with an absolute 1e-5 of
each blob's largest |value|, params also 1 % of base_lr absolute, where
Adam's step follows the gradient's last digits); forwards and gradients
1e-4 (float32 sums in another order through two attention blocks, as
``test_torch_port_charlm.py``); the feed is bit for bit, greedy sampling
equal char for char.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jax_models  # noqa: E402
from sparknet_tpu.common import get_config as jget_config  # noqa: E402
from sparknet_tpu.common import set_config as jset_config  # noqa: E402
from sparknet_tpu.data import text as jtext  # noqa: E402
from sparknet_tpu.models.generate import generate_chars as jgenerate_chars  # noqa: E402
from sparknet_tpu.net import TPUNet as JTPUNet  # noqa: E402
from sparknet_tpu.solvers.solver import Solver as JSolver  # noqa: E402

from sparknet_tpu_torch import data, models  # noqa: E402
from sparknet_tpu_torch.common import get_config, set_config  # noqa: E402
from sparknet_tpu_torch.net import TPUNet, WeightCollection  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.solvers.solver import Solver  # noqa: E402

CHARLM = dict(batch=3, seq_len=16, vocab=32, embed_dim=32, heads=4, ffn_dim=32, blocks=2)
TOL = dict(rtol=1e-4, atol=1e-4)
TEXT = ("SparkNet trains deep networks on Spark: tau local steps a worker, then "
        "the average of the weights. " * 4)


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    kernels.reset_launch_counts()
    yield
    assert (kernels.FLASH_LAUNCHES, kernels.FLASH_BACKWARD_LAUNCHES,
            kernels.PAGED_LAUNCHES, kernels.FUSED_UPDATE_LAUNCHES) == (0, 0, 0, 0)


@pytest.fixture
def fused_config():
    saved = (jget_config().fused_update, get_config().fused_update)

    def set_both(fused: bool):
        jset_config(fused_update=fused)
        set_config(fused_update=fused)

    yield set_both
    jset_config(fused_update=saved[0])
    set_config(fused_update=saved[1])


def _feeds(n, seed=0, batch=3, seq_len=16):
    """Seeded char-LM batches of TEXT (ids below CHARLM's vocab)."""
    vocab = data.CharVocab.from_text(TEXT)
    assert vocab.size <= CHARLM["vocab"]
    it = data.char_lm_batches(TEXT, vocab, batch, seq_len, seed=seed)
    return [next(it) for _ in range(n)]


# -- the char LM's Solver trajectory --------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["per_blob", "fused"])
def test_charlm_adam_trajectory_matches_jax(fused, fused_config, tmp_path):
    """``charlm_solver`` (Adam, base_lr 2e-3), 4 steps from the JAX
    Solver's snapshot, on the char-text feed."""
    fused_config(fused)
    js = JSolver(jax_models.charlm_solver(), jax_models.charlm(**CHARLM))
    path = js.save(str(tmp_path / "start"))
    js.restore(path)
    ps = Solver(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
    ps.restore(path)
    assert (ps.layout is not None) == fused
    feeds = _feeds(4)
    jloss = js.step(4, lambda it: feeds[it])
    tloss = ps.step(4, lambda it: feeds[it])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    base_lr = models.charlm_solver().base_lr
    jslots, tv, tslots = js.slots, ps.variables, ps.slots
    for ln, blobs in js.variables.params.items():
        for i, b in enumerate(blobs):
            ref = np.asarray(b)
            np.testing.assert_allclose(
                tv.params[ln][i].detach().numpy(), ref, rtol=1e-4,
                atol=1e-5 * float(np.abs(ref).max()) + 1e-2 * base_lr,
                err_msg=f"param {ln}[{i}]")
            for j, h in enumerate(jslots[ln][i]):
                href = np.asarray(h)
                np.testing.assert_allclose(
                    tslots[ln][i][j].detach().numpy(), href, rtol=1e-4,
                    atol=1e-5 * float(np.abs(href).max()) + 1e-30,
                    err_msg=f"history {ln}[{i}][{j}]")


# -- the TPUNet handle ----------------------------------------------------------


@pytest.fixture(scope="module")
def handles():
    """A JAX TPUNet and a port TPUNet (CPU) holding the JAX one's weights."""
    jnet = JTPUNet(jax_models.charlm_solver(), jax_models.charlm(**CHARLM))
    net = TPUNet(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
    net.set_weights(WeightCollection(jnet.get_weights().weights))
    return jnet, net


def test_tpunet_forward_full_and_sub_range_match_jax(handles):
    jnet, net = handles
    feeds = _feeds(1, seed=3)[0]
    jblobs = jnet.forward(feeds)
    blobs = net.forward(feeds)
    assert set(blobs) == set(jblobs)
    for name in ("fc", "blk1", "attn2"):
        np.testing.assert_allclose(blobs[name].numpy(), np.asarray(jblobs[name]), **TOL)
    # the second block alone, fed the first's output
    mid = {"blk1": np.asarray(jblobs["blk1"]), "label": feeds["label"]}
    jpart = jnet.forward(mid, start="attn2", end="blk2")
    part = net.forward(mid, start="attn2", end="blk2")
    assert "fc" not in part and "embed" not in part
    np.testing.assert_allclose(part["blk2"].numpy(), np.asarray(jpart["blk2"]), **TOL)
    head = net.forward(feeds, end="blk1")
    assert "attn2" not in head
    assert torch.equal(head["blk1"], blobs["blk1"])


def _assert_grads_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()) + 1e-12)


def test_tpunet_backward_params_matches_jax(handles):
    jnet, net = handles
    feeds = _feeds(1, seed=4)[0]
    jg = jnet.backward(feeds)
    g = net.backward(feeds)
    assert set(g) == set(jg)
    for ln in jg:
        assert len(g[ln]) == len(jg[ln])
        for a, b in zip(g[ln], jg[ln]):
            _assert_grads_close(a, b)
    assert all(float(a.abs().max()) > 0 for a in g["attn1"])  # through attention
    # a sub-range: blocks outside it get zero gradients, as in JAX
    mid = {"blk1": np.asarray(jnet.forward(feeds)["blk1"]), "label": feeds["label"]}
    jg = jnet.backward(mid, start="attn2")
    g = net.backward(mid, start="attn2")
    assert not any(a.any() for a in g["attn1"])
    for ln in ("attn2", "ffn2b", "fc"):
        for a, b in zip(g[ln], jg[ln]):
            _assert_grads_close(a, b)


def test_tpunet_backward_inputs_matches_jax(handles):
    jnet, net = handles
    feeds = _feeds(1, seed=5)[0]
    mid = {"blk1": np.asarray(jnet.forward(feeds)["blk1"]), "label": feeds["label"]}
    jg = jnet.backward(mid, start="attn2", wrt="inputs")
    g = net.backward(mid, start="attn2", wrt="inputs")
    assert set(g) == set(jg) == {"blk1"}
    _assert_grads_close(g["blk1"], jg["blk1"])
    with pytest.raises(ValueError, match="floating-point feed"):
        net.backward(feeds, wrt="inputs")
    with pytest.raises(ValueError, match="wrt must be"):
        net.backward(feeds, wrt="weights")


def test_tpunet_trains_through_its_feed_and_tests():
    net = TPUNet(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
    with pytest.raises(RuntimeError, match="set_train_data"):
        net.train(1)
    vocab = data.CharVocab.from_text(TEXT)
    net.set_train_data(data.char_lm_batches(TEXT, vocab, 3, 16, seed=0))
    before = [p.clone() for p in net.solver.variables.params["attn1"]]
    loss = net.train(3)
    assert np.isfinite(loss) and net.solver.iter == 3
    assert not any(torch.equal(a, b) for a, b in
                   zip(before, net.solver.variables.params["attn1"]))
    net.set_test_data(data.char_lm_batches(TEXT, vocab, 3, 16, seed=1), length=2)
    out = net.test()
    assert set(out) >= {"loss", "accuracy"} and 0.0 <= out["accuracy"] <= 1.0


def test_weights_round_trip_and_collection_arithmetic(handles):
    jnet, net = handles
    wc = net.get_weights()
    jwc = jnet.get_weights()
    assert wc.layers() == jwc.layers()
    twice = wc.add(wc).scalar_divide(2.0)
    jtwice = jwc.add(jwc).scalar_divide(2.0)
    for ln in wc.layers():
        for a, b, c in zip(wc[ln], twice[ln], jtwice[ln]):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, np.asarray(c))
    with pytest.raises(ValueError, match="layer sets differ"):
        wc.add(WeightCollection({"fc": wc["fc"]}))
    other = TPUNet(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
    other.set_weights(twice)
    for ln in wc.layers():
        for a, b in zip(other.get_weights()[ln], wc[ln]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call", ["save_caffemodel", "load_caffemodel", "save_hdf5",
                                  "load_hdf5"])
def test_caffemodel_and_hdf5_are_not_ported(handles, call, tmp_path):
    """HDF5 weights still raise, naming h5py and Queue A4; the char LM's
    ``.caffemodel`` saves and loads back bit for bit."""
    _, net = handles
    if call.endswith("hdf5"):
        with pytest.raises(NotImplementedError, match="Queue A4"):
            getattr(net, call)(str(tmp_path / "w"))
        return
    path = str(tmp_path / "w.caffemodel")
    net.save_caffemodel(path)
    other = TPUNet(models.charlm_solver(), models.charlm(**CHARLM), device="cpu")
    if call == "load_caffemodel":
        assert set(other.load_caffemodel(path)) == set(net.get_weights().layers())
        for ln in net.get_weights().layers():
            for a, b in zip(other.get_weights()[ln], net.get_weights()[ln]):
                np.testing.assert_array_equal(a, b)


# -- the char-text feed -----------------------------------------------------------


def test_char_vocab_matches_jax_and_round_trips():
    vocab, jvocab = data.CharVocab.from_text(TEXT), jtext.CharVocab.from_text(TEXT)
    assert vocab.chars == jvocab.chars and vocab.size == jvocab.size
    ids = vocab.encode("tau steps; Ω")
    np.testing.assert_array_equal(ids, jvocab.encode("tau steps; Ω"))
    assert ids.dtype == np.int32 and ids[-1] == data.CharVocab.UNK
    assert vocab.decode(vocab.encode("tau steps")) == "tau steps"
    assert data.CharVocab.from_lines(vocab.to_lines()).chars == vocab.chars
    assert vocab.to_lines() == jvocab.to_lines()


def test_char_lm_batches_are_bit_for_bit_jax_s(tmp_path):
    (tmp_path / "a.md").write_text("# heading\n" + TEXT)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.txt").write_text("second file\n")
    (tmp_path / "skip.bin").write_text("not text")
    corpus = data.load_corpus(str(tmp_path))
    assert corpus == jtext.load_corpus(str(tmp_path)) and "not text" not in corpus
    vocab, jvocab = data.CharVocab.from_text(corpus), jtext.CharVocab.from_text(corpus)
    ours = data.char_lm_batches(corpus, vocab, 4, 24, seed=7)
    theirs = jtext.char_lm_batches(corpus, jvocab, 4, 24, seed=7)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for key in ("data", "label"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a["data"][:, 1:], a["label"][:, :-1])


def test_char_lm_batches_refuse_a_short_corpus_as_jax_does():
    vocab = data.CharVocab.from_text("abc")
    with pytest.raises(ValueError) as ours:
        next(data.char_lm_batches("abcabc", vocab, 2, 8))
    with pytest.raises(ValueError) as theirs:
        next(jtext.char_lm_batches("abcabc", jtext.CharVocab.from_text("abc"), 2, 8))
    assert str(ours.value) == str(theirs.value)


# -- sampling ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def samplers():
    """JAX and port TPUNets over a 1-block char LM of batch 1, seq_len 16,
    on the same weights, and the vocab."""
    vocab = jtext.CharVocab("abcdefgh")
    kw = dict(batch=1, seq_len=16, vocab=vocab.size, embed_dim=32, heads=4,
              ffn_dim=32, blocks=1)
    jnet = JTPUNet(jax_models.charlm_solver(), jax_models.charlm(**kw))
    net = TPUNet(models.charlm_solver(), models.charlm(**kw), device="cpu")
    net.set_weights(WeightCollection(jnet.get_weights().weights))
    return jnet, net, data.CharVocab("abcdefgh"), vocab


@pytest.mark.parametrize("prompt,n", [("abac", 8), ("h", 12), ("abcdefgh", 5)])
def test_greedy_generation_matches_jax_and_the_sliding_path(samplers, prompt, n):
    jnet, net, vocab, jvocab = samplers
    got = models.generate_chars(net, vocab, prompt, n, 16, temperature=0.0)
    assert got == jgenerate_chars(jnet, jvocab, prompt, n, 16, temperature=0.0)
    assert len(got) == n
    # the cached path against the sliding full forward: a window one char
    # short of the request sends the same call down the sliding path
    sliding = []
    ids = list(vocab.encode(prompt))
    for _ in range(n):
        x = np.zeros((1, 16), np.int32)
        x[0, :len(ids)] = ids
        logits = net.forward({"data": x, "label": np.zeros_like(x)})["fc"]
        ids.append(int(logits[0, len(ids) - 1].argmax()))
    assert got == vocab.decode(ids[len(prompt):])
    assert list(net._decode_cache) == [(16, "fc")]  # built once, reused


def test_generation_past_the_window_slides_like_jax(samplers):
    jnet, net, vocab, jvocab = samplers
    got = models.generate_chars(net, vocab, "abac", 20, 16, temperature=0.0)
    assert got == jgenerate_chars(jnet, jvocab, "abac", 20, 16, temperature=0.0)


def test_seeded_top_k_sampling_repeats(samplers):
    _, net, vocab, _ = samplers
    a = models.generate_chars(net, vocab, "ab", 10, 16, top_k=3, seed=5)
    assert a == models.generate_chars(net, vocab, "ab", 10, 16, top_k=3, seed=5)
    assert set(a) <= set(vocab.chars) | {"�"}


def test_generation_refusals_match_jax(samplers):
    jnet, net, vocab, jvocab = samplers
    with pytest.raises(ValueError, match="prompt must be non-empty"):
        models.generate_chars(net, vocab, "", 3, 16)
    with pytest.raises(ValueError, match="prompt must be non-empty"):
        jgenerate_chars(jnet, jvocab, "", 3, 16)
    assert models.generate_chars(net, vocab, "ab", 0, 16) == "" == \
        jgenerate_chars(jnet, jvocab, "ab", 0, 16)
