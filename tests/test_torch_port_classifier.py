"""The port's ``Classifier`` against the JAX package's, on shared weights.

A tiny deploy prototxt with an LRN layer (the deploy net of
``tests/test_classifier_detector.py`` plus cross-channel LRN) is loaded by
both packages; the JAX classifier's variables cross into the port through
``sparknet_tpu_torch.interop``.  ``predict`` on the same raw-pixel images
must agree at atol 1e-5, center-crop and 10-crop.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu.models.classifier import Classifier as JaxClassifier  # noqa: E402
from sparknet_tpu.proto import parse as jax_parse  # noqa: E402

from sparknet_tpu_torch import interop  # noqa: E402
from sparknet_tpu_torch.models import Classifier  # noqa: E402
from sparknet_tpu_torch.ops import kernels  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402

DEPLOY = """
name: "tiny_deploy"
input: "data"
input_dim: 4 input_dim: 3 input_dim: 8 input_dim: 8
layer {
  name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 stride: 1 pad: 1
    weight_filler { type: "gaussian" std: 0.01 } }
}
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer {
  name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 }
}
layer {
  name: "ip1" type: "InnerProduct" bottom: "norm1" top: "ip1"
  inner_product_param { num_output: 5
    weight_filler { type: "gaussian" std: 0.01 } }
}
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""

OPTS = dict(image_dims=(12, 12), mean=np.array([104.0, 117.0, 123.0], np.float32),
            raw_scale=255.0, channel_swap=(2, 1, 0))


@pytest.fixture(scope="module")
def pair():
    jclf = JaxClassifier(jax_parse(DEPLOY), **OPTS)
    clf = Classifier(parse(DEPLOY), device="cpu", **OPTS)
    clf.variables = interop.netvars_from_numpy(jclf.variables.params,
                                               jclf.variables.state, device="cpu")
    return jclf, clf


def _images(n, seed, hw=(20, 24)):
    rs = np.random.RandomState(seed)
    return [rs.rand(*hw, 3).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("oversample", [False, True])
def test_predict_matches_jax(pair, oversample):
    jclf, clf = pair
    images = _images(3, seed=0)
    before = kernels.LRN_LAUNCHES
    ours = clf.predict(images, oversample=oversample)
    assert kernels.LRN_LAUNCHES == before
    theirs = np.asarray(jclf.predict(images, oversample=oversample))
    assert ours.shape == theirs.shape == (3, 5)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    np.testing.assert_allclose(ours.sum(1), 1.0, atol=1e-5)


def test_preprocessing_matches_jax(pair):
    jclf, clf = pair
    images = _images(2, seed=1, hw=(17, 31))
    for oversample in (False, True):
        np.testing.assert_array_equal(clf.preprocess_images(images, oversample),
                                      jclf.preprocess_images(images, oversample))


def test_forward_all_ragged_tail(pair):
    """7 samples on a batch-4 net: the tail is padded, run, then trimmed,
    and every row equals the sample run alone."""
    jclf, clf = pair
    blobs = clf.preprocess_images(_images(7, seed=2), oversample=False)
    out = clf.forward_all("data", blobs)["prob"]
    assert out.shape == (7, 5)
    alone = np.concatenate([clf.forward_all("data", blobs[i:i + 1])["prob"]
                            for i in range(7)])
    np.testing.assert_allclose(out, alone, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jclf.forward_all("data", blobs)["prob"]),
                               atol=1e-5)


def test_classifier_surface(pair):
    jclf, clf = pair
    assert clf.inputs == jclf.inputs == ["data"]
    assert clf.outputs == jclf.outputs == ["prob"]
    assert clf.feed_shapes == jclf.feed_shapes
    assert tuple(clf.crop_dims) == tuple(jclf.crop_dims) == (8, 8)
    assert clf.device.type == "cpu"


def test_pretrained_file_is_not_ported():
    """HDF5 weights are not ported (Queue A4); ``.caffemodel`` files load
    (``tests/test_torch_port_caffemodel.py``)."""
    with pytest.raises(NotImplementedError, match="Queue A4"):
        Classifier(parse(DEPLOY), "weights.caffemodel.h5", device="cpu")


def test_prototxt_path(tmp_path):
    p = tmp_path / "deploy.prototxt"
    p.write_text(DEPLOY)
    clf = Classifier(str(p), device="cpu")
    assert clf.predict(_images(1, seed=3), oversample=False).shape == (1, 5)
