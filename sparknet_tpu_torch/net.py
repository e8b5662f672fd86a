"""The framework's net-handle API.

Counterpart of ``sparknet_tpu/net.py``: the ``TPUNet`` handle (ref:
src/main/scala/libs/Net.scala:49-65: setTrainData/setTestData/train/test/
forward/backward/setWeights/getWeights) over the port's ``Solver``, and
``WeightCollection`` (ref: Net.scala:14-47, the object the reference
broadcasts to and collects from its workers) with the two conversions
between it and a ``NetVars``.  The collection holds numpy arrays on the
host; ``collection_to_variables`` puts them on the template's device.

``forward`` and ``backward`` run eagerly on the handle's device;
``backward`` differentiates with ``torch.autograd`` (through the kernels'
backwards on the card: the LRN's and flash attention's).

Weights files: ``.caffemodel`` (``export_caffemodel`` and
``copy_caffemodel_params``, through the proto2 codec of
``proto/binary.py``; files byte-equal to the JAX package's) and the npz
collection of Net.scala:234-240 (``save_weights_to_file``/
``load_weights_from_file``).  HDF5 weights wait for ``h5py`` on the card's
machine (ROADMAP Queue A4): ``save_hdf5``/``load_hdf5`` raise.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from sparknet_tpu_torch.common import host_array, tensor_from_numpy
from sparknet_tpu_torch.compiler.graph import Network, NetVars, is_placeholder
from sparknet_tpu_torch.proto.text_format import Message
from sparknet_tpu_torch.solvers.solver import Solver, SolverConfig


class WeightCollection:
    """Serializable {layer -> [arrays]} weight container, non-learnable
    state blobs (BatchNorm's statistics) appended after a layer's params,
    as Caffe's ``blobs_`` holds them."""

    def __init__(self, weights: dict[str, list[np.ndarray]]):
        self.weights = weights

    def scalar_divide(self, v: float) -> "WeightCollection":
        """ref: Net.scala:17-25 (in place in the reference; a new collection
        here, as in the JAX package)."""
        return WeightCollection(
            {k: [a / v for a in arrs] for k, arrs in self.weights.items()})

    def add(self, other: "WeightCollection") -> "WeightCollection":
        """Elementwise sum of two collections of one structure (ref:
        Net.scala:27-46); raises if their layers or blob counts differ."""
        if set(self.weights) != set(other.weights):
            raise ValueError("WeightCollection.add: the layer sets differ")
        out = {}
        for k, arrs in self.weights.items():
            if len(arrs) != len(other.weights[k]):
                raise ValueError(f"WeightCollection.add: blob count differs at {k}")
            out[k] = [a + b for a, b in zip(arrs, other.weights[k])]
        return WeightCollection(out)

    def __getitem__(self, layer: str) -> list[np.ndarray]:
        return self.weights[layer]

    def layers(self) -> list[str]:
        return list(self.weights)


_BN_BLOB_ORDER = ("mean", "variance", "scale_factor")


def state_items(s: dict) -> list[tuple[str, Any]]:
    """A layer's state blobs in wire order: Caffe's BatchNorm order
    [mean, variance, scale_factor] (ref: batch_norm_layer.cpp:30-38),
    sorted keys for any other state."""
    if set(s) == set(_BN_BLOB_ORDER):
        return [(k, s[k]) for k in _BN_BLOB_ORDER]
    return sorted(s.items())


def _host(t) -> np.ndarray:
    # bf16 blobs widen to float32 (exact): the .caffemodel wire is float32,
    # and the JAX package writes np.asarray(blob, np.float32)
    return host_array(t)


def variables_to_collection(variables: NetVars) -> WeightCollection:
    """NetVars (on any device) -> WeightCollection of host arrays."""
    out: dict[str, list[np.ndarray]] = {}
    for lname, plist in variables.params.items():
        out[lname] = [_host(p) for p in plist]
    for lname, s in variables.state.items():
        out.setdefault(lname, []).extend(_host(v) for _, v in state_items(s))
    return WeightCollection(out)


def collection_to_variables(wc: WeightCollection, template: NetVars) -> NetVars:
    """WeightCollection -> NetVars shaped, typed and placed like
    ``template``."""
    def put(a, like: torch.Tensor) -> torch.Tensor:
        return tensor_from_numpy(a).to(like.device, like.dtype).reshape(like.shape)

    params = {lname: [put(a, p) for a, p in zip(wc[lname], plist)]
              for lname, plist in template.params.items()}
    state = {}
    for lname, s in template.state.items():
        arrs = wc[lname][len(template.params.get(lname, [])):]
        state[lname] = {k: put(a, v) for (k, v), a in zip(state_items(s), arrs)}
    return NetVars(params=params, state=state)


def copy_caffemodel_params(
    params: dict[str, list], path: str, strict_shapes: bool = True,
    state: dict[str, dict] | None = None,
):
    """Copy a ``.caffemodel``'s blobs into a params dict by layer name
    (CopyTrainedLayersFrom semantics, ref: net.cpp:737-805).  Returns
    (new params, loaded layer names), or (new params, new state, loaded)
    when ``state`` is given.  Source layers absent from the net are
    ignored; a blob count or shape mismatch raises under
    ``strict_shapes`` and skips the layer otherwise; a blob of another
    shape but the same size (Caffe's legacy 4-D fc blobs, (1, 1, N, K))
    is reshaped.

    ``state``: the non-learnable blobs (BatchNorm's mean/variance/
    scale_factor), which Caffe keeps in the same ``blobs_`` vector after
    the learnable ones, in :func:`state_items` order.  Each loaded blob
    lands on its target's device in its target's dtype, one blob at a
    time; the decoded file is the only host copy.  A shared param's 0-size
    placeholder (``compiler.graph.is_placeholder``) stays as it is: the owner layer's
    record loads the one tensor (Caffe files hold a shared blob at every
    layer that names it; the owner's copy wins)."""
    from sparknet_tpu_torch.proto.binary import load_caffemodel

    model = load_caffemodel(path)
    params = {k: list(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in (state or {}).items()}
    loaded = []
    for layer in model.layers:
        t_params = params.get(layer.name)
        t_state = new_state.get(layer.name) if state is not None else None
        if (t_params is None and not t_state) or not layer.blobs:
            continue
        s_items = state_items(t_state) if t_state else []
        target = list(t_params or []) + [v for _, v in s_items]
        if len(layer.blobs) != len(target):
            if strict_shapes:
                raise ValueError(
                    f"layer {layer.name!r}: snapshot has {len(layer.blobs)} "
                    f"blobs, net expects {len(target)}")
            continue  # permissive: e.g. the donor changed bias_term
        shapes = []
        for src, dst in zip(layer.blobs, target):
            if is_placeholder(dst):  # a shared param's placeholder, kept
                shapes.append(None)
                continue
            if tuple(src.shape) != tuple(dst.shape) and src.size != dst.numel():
                if strict_shapes:
                    raise ValueError(
                        f"layer {layer.name!r}: blob shape {src.shape} "
                        f"!= net {tuple(dst.shape)}")
                break  # permissive: skip the incompatible layer
            shapes.append(tuple(dst.shape))
        else:
            new = [dst if shape is None else _on_device(src.reshape(shape), dst)
                   for src, dst, shape in zip(layer.blobs, target, shapes)]
            n_p = len(t_params or [])
            if t_params is not None:
                params[layer.name] = new[:n_p]
            if t_state:
                new_state[layer.name] = dict(zip((k for k, _ in s_items), new[n_p:]))
            loaded.append(layer.name)
    if state is not None:
        return params, new_state, loaded
    return params, loaded


def _on_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A decoded blob (a view of the file's buffer) on ``like``'s device in
    ``like``'s dtype."""
    return torch.from_numpy(a).to(like.device, like.dtype)


def export_caffemodel(network: Network, params: dict[str, list], path: str,
                      state: dict[str, dict] | None = None) -> str:
    """Write params (and ``state``, BatchNorm's statistics, after each
    layer's params in :func:`state_items` order, as Caffe's ``blobs_``
    holds them) as a wire-compatible binary NetParameter (ref:
    Net::ToProto net.cpp:911 + Solver::SnapshotToBinaryProto): one layer
    record a param-owning or stateful layer, in ``params`` order and then
    the state-only layers, the bytes the JAX package's
    ``export_caffemodel`` writes for the same arrays.  A shared param's
    placeholder writes its owner's blob, as Caffe duplicates a shared blob
    at every layer that names it.  Returns ``path``."""
    from sparknet_tpu_torch.proto.binary import (
        CaffeModel,
        CaffeModelLayer,
        save_caffemodel,
    )

    type_by_name = {l.name: l.TYPE for l in network.layers}
    names = list(params)
    names += [n for n in (state or {}) if n not in params]

    def layers():
        # one layer's blobs on the host at a time
        for lname in names:
            blobs = [_host(p) for p in network.layer_params(lname, params)]
            blobs += [_host(v) for _, v in state_items((state or {}).get(lname, {}))]
            yield CaffeModelLayer(lname, type_by_name.get(lname, ""), blobs)

    save_caffemodel(path, CaffeModel(network.net_param.get_str("name", ""), layers()))
    return path


_NO_HDF5 = ("{}: HDF5 weights need h5py, which the card's machine lacks "
            "(ROADMAP Queue A4); use .caffemodel (save_caffemodel/"
            "load_caffemodel) or the npz collection")


class TPUNet:
    """The CaffeNet-equivalent handle (ref: Net.scala:67-250): owns the
    solver (its TRAIN and TEST nets and the training state) and the data
    hookups.  ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(
        self,
        solver_param: Message | SolverConfig,
        net_param: Message,
        feed_shapes: dict[str, tuple] | None = None,
        device: str | torch.device | None = None,
    ):
        self.solver = Solver(solver_param, net_param, feed_shapes, device=device)
        self.device = self.solver.device
        self.train_net = self.solver.train_net
        self.test_net = self.solver.test_net
        self._train_iter: Iterator[dict] | Callable[[int], dict] | None = None
        self._test_iter: Iterator[dict] | None = None
        self._test_len = 0

    # -- data hookup (ref: Net.scala setTrainData/setTestData :78-100) ----
    def set_train_data(self, batches: Iterator[dict] | Callable[[int], dict]):
        """``batches``: an iterator of feed dicts, or fn(iteration) -> feed
        dict."""
        self._train_iter = batches

    def set_test_data(self, batches: Iterator[dict], length: int):
        self._test_iter = batches
        self._test_len = length

    @staticmethod
    def _data_fn(src) -> Callable[[int], dict]:
        return src if callable(src) else (lambda it: next(src))

    # -- training/eval (ref: Net.scala train :102-105, test :107-119) -----
    def train(self, num_steps: int) -> float:
        """``num_steps`` solver iterations; returns the smoothed loss."""
        if self._train_iter is None:
            raise RuntimeError("call set_train_data first")
        return self.solver.step(num_steps, self._data_fn(self._train_iter))

    def test(self) -> dict[str, float]:
        if self._test_iter is None:
            raise RuntimeError("call set_test_data first")
        return self.solver.test(self._test_len, self._data_fn(self._test_iter))

    # -- inference (ref: Net.scala forward :121-123 + getData :173-191) ---
    def forward(self, feeds: dict[str, Any], start: str | None = None,
                end: str | None = None) -> dict[str, torch.Tensor]:
        """Forward on the TEST-phase graph; returns ALL blobs (the getData
        dump the Featurizer uses, ref: FeaturizerApp.scala:88-102).

        ``start``/``end`` run a sub-range of layers (ref:
        Net::ForwardFromTo net.cpp:565-583; pycaffe ``net.forward(start=...,
        end=...)``): feed the start layer's bottom blobs, read any blob the
        range produces."""
        with torch.no_grad():
            return self.test_net.apply(self.solver.variables, feeds, train=False,
                                       start=start, end=end)[0]

    def backward(self, feeds: dict[str, Any], start: str | None = None,
                 end: str | None = None, wrt: str = "params") -> dict[str, Any]:
        """Gradient of the executed range's loss on the TRAIN graph (ref:
        Net.scala backward :125-127), by ``torch.autograd``.

        ``start``/``end`` restrict the differentiated range (ref:
        Net::BackwardFromTo net.cpp:635-646).  ``wrt="params"`` (default)
        returns {layer: [d(loss)/d(blob)]} over every param blob (zeros for
        blobs outside the range); ``wrt="inputs"`` returns d(loss)/d(each
        floating-point fed blob), the bottom diffs a mid-graph
        BackwardFromTo hands back.  Random layers draw from a generator
        seeded with 0."""
        if wrt not in ("params", "inputs"):
            raise ValueError(f"wrt must be 'params' or 'inputs', got {wrt!r}")
        net = self.train_net
        variables = self.solver.variables
        arrs = {k: torch.as_tensor(v, device=self.device) for k, v in feeds.items()}
        gen = torch.Generator(device=self.device).manual_seed(0)
        if wrt == "params":
            leaves = {ln: [p.detach().requires_grad_(True) for p in pl]
                      for ln, pl in variables.params.items()}
            wanted = [p for pl in leaves.values() for p in pl]
            _, _, loss = net.apply(NetVars(leaves, variables.state), arrs, gen=gen,
                                   start=start, end=end)
        else:
            diff = {k: v.detach().requires_grad_(True) for k, v in arrs.items()
                    if v.is_floating_point()}
            if not diff:
                raise ValueError(
                    "wrt='inputs' needs at least one floating-point feed to "
                    f"differentiate; got {list(arrs)} (cast integer image blobs "
                    "to float first)")
            wanted = list(diff.values())
            _, _, loss = net.apply(variables, {**arrs, **diff}, gen=gen,
                                   start=start, end=end)
        grads = torch.autograd.grad(loss, wanted, allow_unused=True) \
            if loss.requires_grad else [None] * len(wanted)
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wanted, grads)]
        if wrt == "inputs":
            return dict(zip(diff, grads))
        out, k = {}, 0
        for ln, pl in leaves.items():
            out[ln] = grads[k:k + len(pl)]
            k += len(pl)
        return out

    # -- weight exchange (ref: Net.scala:131-171) --------------------------
    def get_weights(self) -> WeightCollection:
        return variables_to_collection(self.solver.variables)

    def set_weights(self, wc: WeightCollection) -> None:
        self.solver.variables = collection_to_variables(wc, self.solver.variables)

    # -- zoo interchange (ref: Net::ToProto net.cpp:911 + Snapshot; shim
    # save/load_weights_to/from_file ccaffe.cpp:261-269) -------------------
    def save_caffemodel(self, path: str) -> str:
        """Write params and state blobs (BatchNorm's statistics) as a
        binary NetParameter; returns ``path``."""
        variables = self.solver.variables
        return export_caffemodel(self.train_net, variables.params, path,
                                 state=variables.state)

    def load_caffemodel(self, path: str, strict_shapes: bool = True) -> list[str]:
        """Copy params and state by layer name (:func:`copy_caffemodel_params`);
        returns the loaded layer names."""
        variables = self.solver.variables
        params, state, loaded = copy_caffemodel_params(
            variables.params, path, strict_shapes, state=variables.state)
        self.solver.variables = NetVars(params=params, state=state)
        return loaded

    def save_hdf5(self, path: str) -> None:
        raise NotImplementedError(_NO_HDF5.format("save_hdf5"))

    def load_hdf5(self, path: str) -> list[str]:
        raise NotImplementedError(_NO_HDF5.format("load_hdf5"))

    # -- persistence (ref: Net.scala:234-240) ------------------------------
    def save_weights_to_file(self, path: str) -> None:
        """``.caffemodel``: a binary NetParameter; HDF5 names raise (no
        ``h5py``); anything else: the collection as ``<layer>/<i>`` arrays
        of an ``.npz``."""
        if path.endswith(".caffemodel"):
            self.save_caffemodel(path)
            return
        if path.endswith((".h5", ".hdf5", ".caffemodel.h5")):
            self.save_hdf5(path)
        flat = {f"{lname}/{i}": a
                for lname, arrs in self.get_weights().weights.items()
                for i, a in enumerate(arrs)}
        np.savez(path if path.endswith(".npz") else path + ".npz", **flat)

    def load_weights_from_file(self, path: str) -> None:
        """The counterpart of :meth:`save_weights_to_file` (a ``.caffemodel``
        loads by layer name, strict shapes)."""
        if path.endswith(".caffemodel"):
            self.load_caffemodel(path)
            return
        if path.endswith((".h5", ".hdf5", ".caffemodel.h5")):
            self.load_hdf5(path)
        if not path.endswith(".npz"):
            path = path + ".npz"
        weights: dict[str, dict[int, np.ndarray]] = {}
        with np.load(path) as data:
            for key in data.files:
                lname, i = key.rsplit("/", 1)
                weights.setdefault(lname, {})[int(i)] = data[key]
        self.set_weights(WeightCollection(
            {lname: [blobs[i] for i in sorted(blobs)] for lname, blobs in weights.items()}))
