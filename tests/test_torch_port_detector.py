"""The port's R-CNN ``Detector`` (``sparknet_tpu_torch/models/detector.py``)
against the JAX package's, on shared weights.

A deploy prototxt with an LRN layer (``tests/test_torch_port_classifier.py``'s
at a 16x16 input) is loaded by both packages, the JAX detector's weights
cross into the port through ``interop``.  Windows of seeded images, inside
and across the border, with and without ``context_pad`` and with the
Transformer's mean, raw scale and channel swap: every crop and net input is
bit for bit the JAX detector's, and the scores agree at
``test_torch_port_classifier.py``'s atol 1e-5.  The int8 and BatchNorm-fold
arms come from ``DeployNet``: the int8 scores within rtol/atol 1e-5 of the
JAX detector's int8 scores (ROADMAP Queue C item 11), the fold the same
chains as JAX's and the folded scores within atol 1e-5 of the unfolded.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

from sparknet_tpu.models.detector import Detector as JDetector  # noqa: E402
from sparknet_tpu.proto import parse as jparse  # noqa: E402

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.models import Detector  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

DEPLOY = """
name: "tiny_rcnn"
input: "data"
input_dim: 4 input_dim: 3 input_dim: 16 input_dim: 16
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 stride: 1 pad: 1
    weight_filler { type: "gaussian" std: 0.01 } } }
%(bn)s
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "fc-rcnn" type: "InnerProduct" bottom: "norm1" top: "fc-rcnn"
  inner_product_param { num_output: 7 weight_filler { type: "gaussian" std: 0.01 } } }
"""
BN = ('layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1" '
      "batch_norm_param { use_global_stats: true } } "
      'layer { name: "scale1" type: "Scale" bottom: "conv1" top: "conv1" '
      "scale_param { bias_term: true } }")

OPTS = {
    "plain": {},
    "pad": dict(context_pad=2, mean=np.array([104.0, 117.0, 123.0], np.float32),
                raw_scale=255.0, channel_swap=(2, 1, 0)),
    "pad_no_mean": dict(context_pad=3, raw_scale=255.0),
}
WINDOWS = [(0, 0, 12, 10), (5, 7, 30, 27), (20, 25, 35, 39), (3, 3, 9, 33)]


def _pair(opts, bn=False):
    text = DEPLOY % {"bn": BN if bn else ""}
    jdet = JDetector(jparse(text), **opts)
    det = Detector(parse(text), device="cpu", **opts)
    params = {ln: [np.asarray(b) for b in bl] for ln, bl in jdet.variables.params.items()}
    state = {ln: {k: np.asarray(v) for k, v in s.items()}
             for ln, s in jdet.variables.state.items()}
    if bn:  # real statistics, so the fold has something to fold
        rs = np.random.RandomState(3)
        state["bn1"] = {k: (rs.rand(*np.shape(v)) + 0.5).astype(np.float32)
                        for k, v in state["bn1"].items()}
        jdet.variables = type(jdet.variables)(params=jdet.variables.params, state=state)
    det.variables = interop.netvars_from_numpy(params, state, device="cpu")
    return jdet, det


def _images(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    arrays = [rs.rand(36, 40, 3).astype(np.float32), rs.rand(34, 38, 3).astype(np.float32)]
    path = str(tmp_path / "im.png")
    Image.fromarray(rs.randint(0, 256, (40, 34, 3)).astype(np.uint8)).save(path)
    return arrays, path


@pytest.mark.parametrize("name", sorted(OPTS))
def test_crops_and_inputs_are_jax_bit_for_bit(name, tmp_path):
    jdet, det = _pair(OPTS[name])
    arrays, path = _images(tmp_path)
    if name != "plain":
        np.testing.assert_array_equal(det.crop_mean, jdet.crop_mean)
    np.testing.assert_array_equal(det.crop_dims, jdet.crop_dims)
    for im in arrays + [det._load(path)]:
        np.testing.assert_array_equal(det._load(path), jdet._load(path))
        for w in WINDOWS:
            w = np.asarray(w)
            ours, theirs = det.crop(im, w), jdet.crop(im, w)
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
            np.testing.assert_array_equal(det.transformer.preprocess("data", ours),
                                          jdet.transformer.preprocess("data", theirs))


@pytest.mark.parametrize("name", sorted(OPTS))
def test_detect_windows_scores_match_jax(name, tmp_path):
    """Two images (an array and a file) x 4 windows on a batch-4 net (two
    full chunks): the JAX detector's windows, file names and scores."""
    jdet, det = _pair(OPTS[name])
    arrays, path = _images(tmp_path)
    pairs = [(arrays[0], WINDOWS), (path, WINDOWS[:3])]
    ours, theirs = det.detect_windows(pairs), jdet.detect_windows(pairs)
    assert len(ours) == len(theirs) == 7
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["window"], b["window"])
        assert a["filename"] == b["filename"]
        assert a["prediction"].shape == (7,)
        np.testing.assert_allclose(a["prediction"], np.asarray(b["prediction"]), atol=1e-5)


def test_window_off_the_image_raises_as_jax():
    jdet, det = _pair(OPTS["pad"])
    im = np.zeros((20, 20, 3), np.float32)
    for d in (det, jdet):
        with pytest.raises(ValueError, match="lies outside the image"):
            d.crop(im, np.array([30, 30, 40, 40]))


def test_detector_inherits_int8_and_fold():
    """``quantize_int8`` and ``fold_batchnorm`` come from ``DeployNet``:
    the same int8 layers as JAX's, scores within rtol/atol 1e-5 of the JAX
    int8 detector's; the same folded chains, scores within atol 1e-5 of
    the unfolded forward."""
    rs = np.random.RandomState(1)
    feeds = {"data": rs.uniform(-50, 50, (4, 3, 16, 16)).astype(np.float32)}
    jdet, det = _pair(OPTS["plain"])
    qstate = det.quantize_int8([feeds])
    jq = jdet.quantize_int8([feeds])
    assert set(qstate) == set(jq) == {"conv1", "fc-rcnn"}
    ours = det.forward_all("data", feeds["data"])["fc-rcnn"]
    theirs = np.asarray(jdet.forward_all("data", feeds["data"])["fc-rcnn"])
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)

    jdet, det = _pair(OPTS["plain"], bn=True)
    before = det.forward_all("data", feeds["data"])["fc-rcnn"]
    folded, jfolded = det.fold_batchnorm(), jdet.fold_batchnorm()
    assert folded == jfolded and len(folded) == 1
    types = [lp.get_str("type") for lp in det.network.net_param.get_all("layer")]
    assert "BatchNorm" not in types and "Scale" not in types
    np.testing.assert_allclose(det.forward_all("data", feeds["data"])["fc-rcnn"], before,
                               atol=1e-5)
