"""The weight exchange object of SparkNet's outer loop, on the host.

Counterpart of the host-only part of ``sparknet_tpu/net.py``:
``WeightCollection`` (ref: src/main/scala/libs/Net.scala:14-47, the object
the reference broadcasts to and collects from its workers) and the two
conversions between it and a ``NetVars``.  The collection holds numpy
arrays on the host; ``collection_to_variables`` puts them on the
template's device.  The rest of ``net.py`` (the Net handle, caffemodel
and HDF5 I/O) is not ported yet (ROADMAP Queue A, A9).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sparknet_tpu_torch.compiler.graph import NetVars


class WeightCollection:
    """Serializable {layer -> [arrays]} weight container, non-learnable
    state blobs (BatchNorm's statistics) appended after a layer's params,
    as Caffe's ``blobs_`` holds them."""

    def __init__(self, weights: dict[str, list[np.ndarray]]):
        self.weights = weights

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
    return t.detach().to("cpu").numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


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
        return torch.as_tensor(np.asarray(a)).to(like.device, like.dtype).reshape(like.shape)

    params = {lname: [put(a, p) for a, p in zip(wc[lname], plist)]
              for lname, plist in template.params.items()}
    state = {}
    for lname, s in template.state.items():
        arrs = wc[lname][len(template.params.get(lname, [])):]
        state[lname] = {k: put(a, v) for (k, v), a in zip(state_items(s), arrs)}
    return NetVars(params=params, state=state)
