"""The port's ``.caffemodel`` files against the JAX package's, on the CPU.

``proto/binary.py`` is the JAX codec's copy; ``net.export_caffemodel`` and
``net.copy_caffemodel_params`` carry the JAX functions' semantics.  From
the same weights (drawn with numpy from a seed; the port's tensors cross
through ``interop``) the port
writes the JAX package's bytes for LeNet, CIFAR-10 quick, GoogLeNet (whose
layer names hold ``/``) and ResNet-50 with non-zero BatchNorm state, both
at published width; each package loads the other's file bit for bit.  The
wire-level cases mirror ``tests/test_caffemodel.py``.  ``Classifier`` with
``pretrained_file`` predicts within atol 1e-5 of JAX's on the same file.
"""

import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparknet_tpu import models as jm  # noqa: E402
from sparknet_tpu.common import Phase as JPhase  # noqa: E402
from sparknet_tpu.compiler.graph import Network as JNetwork  # noqa: E402
from sparknet_tpu.models.classifier import Classifier as JClassifier  # noqa: E402
from sparknet_tpu.net import copy_caffemodel_params as jcopy  # noqa: E402
from sparknet_tpu.net import export_caffemodel as jexport  # noqa: E402
from sparknet_tpu.proto.binary import dumps_caffemodel as jdumps  # noqa: E402

from sparknet_tpu_torch import interop, models  # noqa: E402
from sparknet_tpu_torch.common import Phase  # noqa: E402
from sparknet_tpu_torch.compiler.graph import Network  # noqa: E402
from sparknet_tpu_torch.models import Classifier, DeployNet  # noqa: E402
from sparknet_tpu_torch.net import TPUNet, copy_caffemodel_params, export_caffemodel  # noqa: E402
from sparknet_tpu_torch.proto import parse  # noqa: E402
from sparknet_tpu_torch.proto.binary import (  # noqa: E402
    _I32,
    _LEN,
    _VARINT,
    CaffeModel,
    CaffeModelLayer,
    _len_field,
    _tag,
    _varint,
    dumps_caffemodel,
    load_caffemodel,
    loads_caffemodel,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NETS = {  # name -> builder kwargs (published widths; small batch and crop)
    "lenet": dict(batch=2),
    "cifar10_quick": dict(batch=2),
    "googlenet": dict(batch=1, crop=96),
    "resnet50": dict(batch=1, crop=32),
}


def _jax_vars(name):
    """A JAX TRAIN net, and weights for it drawn with numpy from seed 5 at
    the blob shapes of the port's net; BatchNorm state is non-zero (as
    after some steps)."""
    jnet = JNetwork(getattr(jm, name)(**NETS[name]), JPhase.TRAIN)
    pv = Network(getattr(models, name)(**NETS[name]), Phase.TRAIN, device="cpu").init()
    rs = np.random.RandomState(5)
    params = {ln: [rs.randn(*p.shape).astype(np.float32) for p in pl]
              for ln, pl in pv.params.items()}
    state = {ln: {k: (rs.rand(*v.shape) + 0.5).astype(np.float32) for k, v in s.items()}
             for ln, s in pv.state.items()}
    return jnet, params, state


@pytest.mark.parametrize("name", list(NETS))
def test_files_byte_equal_and_cross_load(name, tmp_path):
    jnet, params, state = _jax_vars(name)
    pnet = Network(getattr(models, name)(**NETS[name]), Phase.TRAIN, device="cpu")
    pv = interop.netvars_from_numpy(params, state, device="cpu")
    jpath, ppath = str(tmp_path / "jax.caffemodel"), str(tmp_path / "port.caffemodel")
    jexport(jnet, params, jpath, state=state)
    assert export_caffemodel(pnet, pv.params, ppath, state=pv.state) == ppath
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    if name == "googlenet":
        assert any("/" in ln for ln in params)
    if name == "resnet50":
        assert state and all(len(s) == 3 for s in state.values())
    # each package loads the other's file bit for bit
    zeros = {ln: [torch.zeros_like(p) for p in pl] for ln, pl in pv.params.items()}
    zstate = {ln: {k: torch.zeros_like(v) for k, v in s.items()} for ln, s in pv.state.items()}
    got_p, got_s, loaded = copy_caffemodel_params(zeros, jpath, state=zstate)
    assert set(loaded) == set(params) | set(state)
    for ln, pl in params.items():
        for a, b in zip(pl, got_p[ln]):
            np.testing.assert_array_equal(a, b.numpy())
    for ln, s in state.items():
        for k, v in s.items():
            np.testing.assert_array_equal(v, got_s[ln][k].numpy())
    jp, js, jloaded = jcopy({ln: [np.zeros_like(p) for p in pl] for ln, pl in params.items()},
                            ppath, state={ln: {k: np.zeros_like(v) for k, v in s.items()}
                                          for ln, s in state.items()})
    assert jloaded == loaded
    for ln, pl in params.items():
        for a, b in zip(pl, jp[ln]):
            np.testing.assert_array_equal(a, np.asarray(b))
    for ln, s in state.items():
        for k, v in s.items():
            np.testing.assert_array_equal(v, np.asarray(js[ln][k]))


def test_tpunet_round_trip_and_weights_files(tmp_path):
    """``TPUNet.save_caffemodel``/``load_caffemodel`` and the weights-file
    pair (``.caffemodel`` and npz) round trip bit for bit; the file is the
    JAX ``TPUNet``'s on the same weights; HDF5 names h5py and A4."""
    from sparknet_tpu.net import TPUNet as JTPUNet

    jnet = JTPUNet(jm.lenet_solver(), jm.lenet(4))
    net = TPUNet(models.lenet_solver(), models.lenet(4), device="cpu")
    jvars = jnet.solver.variables
    net.solver.variables = interop.netvars_from_numpy(jvars.params, jvars.state, device="cpu")
    jnet.save_caffemodel(str(tmp_path / "j.caffemodel"))
    net.save_caffemodel(str(tmp_path / "p.caffemodel"))
    assert (tmp_path / "j.caffemodel").read_bytes() == (tmp_path / "p.caffemodel").read_bytes()
    for path in ("w.caffemodel", "w.npz"):
        other = TPUNet(models.lenet_solver(), models.lenet(4), device="cpu")
        net.save_weights_to_file(str(tmp_path / path))
        other.load_weights_from_file(str(tmp_path / path))
        for ln in net.get_weights().layers():
            for a, b in zip(net.get_weights()[ln], other.get_weights()[ln]):
                np.testing.assert_array_equal(a, b)
    for call in ("save_hdf5", "load_hdf5"):
        with pytest.raises(NotImplementedError, match="h5py.*A4"):
            getattr(net, call)(str(tmp_path / "w.h5"))
    with pytest.raises(NotImplementedError, match="A4"):
        net.load_weights_from_file(str(tmp_path / "w.caffemodel.h5"))


# ---------------------------------------------------------------- wire level
def test_round_trip_and_golden_wire_bytes():
    """Round trip; a hand-encoded NetParameter decodes as caffe.proto says
    (``tests/test_caffemodel.py``'s bytes); both codecs write equal bytes."""
    rs = np.random.RandomState(0)
    model = CaffeModel("m", [
        CaffeModelLayer("conv1", "Convolution", [rs.randn(4, 3, 5, 5).astype(np.float32),
                                                 rs.randn(4).astype(np.float32)]),
        CaffeModelLayer("relu1", "ReLU", []),
        CaffeModelLayer("ip1", "InnerProduct", [rs.randn(10, 64).astype(np.float32)]),
    ])
    buf = dumps_caffemodel(model)
    assert buf == jdumps(model)
    out = loads_caffemodel(buf)
    assert out.name == "m" and [l.name for l in out.layers] == ["conv1", "relu1", "ip1"]
    for a, b in zip(model.layers[0].blobs, out.layers[0].blobs):
        np.testing.assert_array_equal(a, b)
    shape_msg = _len_field(1, _varint(2) + _varint(1))
    blob = _len_field(7, shape_msg) + _len_field(5, struct.pack("<2f", 1.5, -2.0))
    layer = _len_field(1, b"ip") + _len_field(2, b"InnerProduct") + _len_field(7, blob)
    m = loads_caffemodel(_len_field(1, b"g") + _len_field(100, layer))
    assert m.name == "g" and (m.layers[0].name, m.layers[0].type) == ("ip", "InnerProduct")
    np.testing.assert_array_equal(m.layers[0].blobs[0], [[1.5], [-2.0]])


def test_v1_layers_legacy_dims_unpacked_and_split_chunks(tmp_path):
    """V1 ``layers`` (name 4, enum type 5, blobs 6) with legacy num/
    channels/height/width; unpacked float_data; a packed field split over
    two chunks; a file read through ``load_caffemodel`` gives views."""
    legacy = (_tag(1, _VARINT) + _varint(1) + _tag(2, _VARINT) + _varint(1)
              + _tag(3, _VARINT) + _varint(2) + _tag(4, _VARINT) + _varint(2)
              + _len_field(5, struct.pack("<4f", 1, 2, 3, 4)))
    v1 = _len_field(4, b"ip1") + _tag(5, _VARINT) + _varint(14) + _len_field(6, legacy)
    m = loads_caffemodel(_len_field(1, b"old") + _len_field(2, v1))
    assert (m.layers[0].name, m.layers[0].type) == ("ip1", "InnerProduct")
    assert m.layers[0].blobs[0].shape == (1, 1, 2, 2)
    np.testing.assert_array_equal(m.layers[0].blobs[0].reshape(-1), [1, 2, 3, 4])

    def f32(v):
        return _tag(5, _I32) + struct.pack("<f", v)

    unpacked = f32(7.0) + f32(8.0)
    split = _len_field(5, struct.pack("<2f", 1, 2)) + _len_field(5, struct.pack("<f", 3))
    for blob, want in ((unpacked, [7.0, 8.0]), (split, [1.0, 2.0, 3.0])):
        layer = _len_field(1, b"b") + _len_field(2, b"Bias") + _len_field(7, blob)
        m = loads_caffemodel(_len_field(100, layer))
        np.testing.assert_array_equal(m.layers[0].blobs[0], want)
    p = tmp_path / "v.caffemodel"
    rs = np.random.RandomState(1)
    w = rs.randn(6, 5).astype(np.float32)
    p.write_bytes(dumps_caffemodel(CaffeModel("v", [CaffeModelLayer("ip", "InnerProduct", [w])])))
    got = load_caffemodel(str(p)).layers[0].blobs[0]
    np.testing.assert_array_equal(got, w)
    assert got.base is not None  # a view of the file's buffer, not a copy


def _layer_file(path, layers):
    path.write_bytes(dumps_caffemodel(CaffeModel("x", [
        CaffeModelLayer(n, t, [np.asarray(b, np.float32) for b in bl]) for n, t, bl in layers])))
    return str(path)


def test_load_semantics_match_jax(tmp_path):
    """Unknown layers are ignored, legacy (1, 1, N, K) fc blobs reshape, a
    blob count or size mismatch raises strictly and skips the layer
    permissively, in both packages alike."""
    jnet, params, state = _jax_vars("lenet")
    rs = np.random.RandomState(2)
    ip2 = [rs.randn(*p.shape).astype(np.float32) for p in params["ip2"]]
    good = _layer_file(tmp_path / "good.caffemodel", [
        ("ghost", "Convolution", [rs.randn(3, 3)]),
        ("ip2", "InnerProduct", [ip2[0].reshape(1, 1, *ip2[0].shape), ip2[1]]),
    ])
    bad_shape = _layer_file(tmp_path / "shape.caffemodel", [
        ("conv1", "Convolution", [rs.randn(5, 1, 5, 5), rs.randn(5)]),
        ("ip2", "InnerProduct", ip2),
    ])
    bad_count = _layer_file(tmp_path / "count.caffemodel", [
        ("conv1", "Convolution", [params["conv1"][0]]), ("ip2", "InnerProduct", ip2)])
    pv = interop.netvars_from_numpy(params, device="cpu")
    got, loaded = copy_caffemodel_params(pv.params, good)
    want, jloaded = jcopy(params, good)
    assert loaded == jloaded == ["ip2"]
    for a, b, c in zip(got["ip2"], want["ip2"], ip2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c)
    np.testing.assert_array_equal(got["conv1"][0].numpy(), params["conv1"][0])
    for path, msg in ((bad_shape, "blob shape"), (bad_count, "blobs, net expects")):
        with pytest.raises(ValueError, match=msg):
            copy_caffemodel_params(pv.params, path)
        with pytest.raises(ValueError, match=msg):
            jcopy(params, path)
        got, loaded = copy_caffemodel_params(pv.params, path, strict_shapes=False)
        _, jloaded = jcopy(params, path, strict_shapes=False)
        assert loaded == jloaded == ["ip2"]
        np.testing.assert_array_equal(got["conv1"][0].numpy(), params["conv1"][0])


DEPLOY = """
name: "tiny_deploy"
input: "data"
input_dim: 4 input_dim: 3 input_dim: 8 input_dim: 8
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 } bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "ip1" type: "InnerProduct" bottom: "norm1" top: "ip1"
  inner_product_param { num_output: 5 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""


def test_classifier_pretrained_file_matches_jax(tmp_path):
    """A ``.caffemodel`` written from seeded weights: the port's
    ``Classifier`` and ``DeployNet`` load it and predict within atol 1e-5
    of the JAX ``Classifier`` loading the same file."""
    from sparknet_tpu.proto import parse as jparse

    rs = np.random.RandomState(4)
    path = _layer_file(tmp_path / "d.caffemodel", [
        ("conv1", "Convolution", [rs.randn(6, 3, 3, 3) * 0.3, rs.randn(6)]),
        ("ip1", "InnerProduct", [rs.randn(5, 384) * 0.1, rs.randn(5)]),
    ])
    opts = dict(image_dims=(12, 12), mean=np.array([104.0, 117.0, 123.0], np.float32),
                raw_scale=255.0, channel_swap=(2, 1, 0))
    jclf = JClassifier(jparse(DEPLOY), path, **opts)
    clf = Classifier(parse(DEPLOY), path, device="cpu", **opts)
    images = [rs.rand(20, 24, 3).astype(np.float32) for _ in range(3)]
    for over in (False, True):
        np.testing.assert_allclose(clf.predict(images, oversample=over),
                                   np.asarray(jclf.predict(images, oversample=over)),
                                   atol=1e-5, rtol=0)
    d = DeployNet(parse(DEPLOY), path, device="cpu")
    np.testing.assert_array_equal(d.variables.params["ip1"][0].numpy(),
                                  clf.variables.params["ip1"][0].numpy())


def test_loading_keeps_one_host_copy(tmp_path):
    """Loading builds the decoded file once: every blob handed to the
    device copy is a view of the one buffer ``load_caffemodel`` read."""
    src = (
        "import sys; sys.path.insert(0, {repo!r})\n"
        "import numpy as np, torch\n"
        "from sparknet_tpu_torch import models, net as net_mod\n"
        "from sparknet_tpu_torch.proto import binary\n"
        "t = net_mod.TPUNet(models.lenet_solver(), models.lenet(2), device='cpu')\n"
        "t.save_caffemodel({path!r})\n"
        "seen = []\n"
        "orig = net_mod._on_device\n"
        "def spy(a, like):\n"
        "    seen.append(a.base is not None or not a.flags.owndata)\n"
        "    return orig(a, like)\n"
        "net_mod._on_device = spy\n"
        "t.load_caffemodel({path!r})\n"
        "print(len(seen), all(seen))\n"
    ).format(repo=REPO, path=str(tmp_path / "l.caffemodel"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["8", "True"]
