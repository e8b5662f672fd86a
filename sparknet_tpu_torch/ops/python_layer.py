"""The ``Python`` layer type: user-defined layers loaded from a module.

Counterpart of ``sparknet_tpu/ops/python_layer.py`` (ref:
caffe/src/caffe/layer_factory.cpp:199-214 GetPythonLayer, and pycaffe's
PythonLayer).  A prototxt declares
``python_param { module: "m" layer: "Cls" param_str: "..." }``; the module
must be importable, as in the reference.

Two styles of class run in the port:

- **Torch-native:** ``apply(self, *inputs)`` on tensors, returning one
  tensor or a list of them; autograd differentiates it, on the net's
  device.
- **Caffe-compat:** ``setup``/``reshape``/``forward``/``backward`` over
  numpy blob wrappers (``PyBlob``: ``.data``/``.diff``/``.num``/
  ``.count``), as every pycaffe layer is written; the same class runs
  unchanged in the JAX package.  It runs on the host through a
  ``torch.autograd.Function`` whose backward calls the class's own
  ``backward``: its inputs cross to the host and its outputs back every
  step (the reference's Python layers force the CPU too,
  layer_factory.cpp:203-207).  A CUDA graph cannot hold that round trip,
  so the layer raises inside a capture.  As in the JAX package, the
  backward runs ``forward`` again before ``backward``, so per-object
  scratch state (pyloss's ``self.diff``) is always that of its inputs.

A JAX-native class, whose ``apply`` returns a JAX array, is refused with a
``TypeError`` at its first call.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Sequence

import numpy as np
import torch

from sparknet_tpu_torch.ops.base import Layer, LayerOutput, Shape
from sparknet_tpu_torch.ops.registry import register


_STYLES = ("the port runs torch-native classes (apply on tensors) and "
           "Caffe-compat ones (setup/reshape/forward/backward on blobs), not "
           "JAX-native ones")


class PyBlob:
    """Mutable numpy blob with the pycaffe surface (data/diff/num/count)."""

    def __init__(self, shape: Sequence[int]):
        self.data = np.zeros(tuple(shape), np.float32)
        self.diff = np.zeros(tuple(shape), np.float32)

    @property
    def num(self) -> int:
        return self.data.shape[0] if self.data.ndim else 1

    @property
    def count(self) -> int:
        return int(self.data.size)

    @property
    def shape(self):
        return self.data.shape

    def reshape(self, *shape: int) -> None:
        self.data = np.zeros(shape, np.float32)
        self.diff = np.zeros(shape, np.float32)


def _needs_init_args(cls) -> bool:
    """True when ``cls.__init__`` REQUIRES arguments (pycaffe builds its
    layers without any); a TypeError raised inside a zero-argument
    ``__init__`` must propagate, so only the signature decides."""
    if cls.__init__ is object.__init__:
        return False
    try:
        sig = inspect.signature(cls.__init__)
    except (ValueError, TypeError):
        return False
    return any(
        p.default is inspect.Parameter.empty
        and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
        for name, p in sig.parameters.items() if name != "self")


class _HostLayer(torch.autograd.Function):
    """A Caffe-compat object's forward on the host; its backward runs the
    object's ``forward`` again, then its ``backward``."""

    @staticmethod
    def forward(ctx, layer, *xs):
        ctx.layer = layer
        ctx.save_for_backward(*xs)
        outs = layer.host_forward([x.detach().cpu().numpy() for x in xs])[1]
        return tuple(torch.from_numpy(t.data.copy()).to(xs[0].device) for t in outs)

    @staticmethod
    def backward(ctx, *gs):
        layer = ctx.layer
        xs = ctx.saved_tensors
        if not hasattr(layer.obj, "backward"):
            raise NotImplementedError(f"Python layer {layer.name!r} has no backward()")
        bottoms, tops = layer.host_forward([x.detach().cpu().numpy() for x in xs])
        for t, g in zip(tops, gs):
            t.diff[...] = 0.0 if g is None else g.detach().cpu().numpy()
        layer.obj.backward(tops, [True] * len(xs), bottoms)
        return (None, *(torch.from_numpy(np.array(b.diff, np.float32)).to(x.device)
                        for b, x in zip(bottoms, xs)))


@register
class PythonLayer(Layer):
    TYPE = "Python"

    def __init__(self, lp, phase):
        super().__init__(lp, phase)
        pp = lp.get_msg("python_param")
        module, cls_name = pp.get_str("module"), pp.get_str("layer")
        if not module or not cls_name:
            raise ValueError(f"Python layer {self.name!r} needs python_param "
                             "{ module: ... layer: ... }")
        cls = getattr(importlib.import_module(module), cls_name)
        self.obj = cls.__new__(cls) if _needs_init_args(cls) else cls()
        self.obj.param_str = pp.get_str("param_str", "")
        # pycaffe hands the phase over as an int (TRAIN=0 / TEST=1)
        self.obj.phase = phase.value
        self._native = hasattr(self.obj, "apply")
        if not self._native and not (hasattr(self.obj, "forward")
                                     and hasattr(self.obj, "setup")):
            raise ValueError(
                f"Python layer class {module}.{cls_name} must define either "
                "apply(self, *inputs) [torch-native] or "
                "setup/reshape/forward[/backward] [Caffe-compat]")
        self._top_shapes: dict[tuple, list[tuple]] = {}

    def top_shapes(self, in_shapes: Sequence[Shape]) -> list[tuple]:
        """The compat object's top shapes from ``setup`` and ``reshape`` on
        zero blobs (the role of Layer::SetUp, layer.hpp:71-96), once a set
        of bottom shapes."""
        key = tuple(tuple(s) for s in in_shapes)
        if key not in self._top_shapes:
            bottoms = [PyBlob(s) for s in in_shapes]
            tops = [PyBlob((1,)) for _ in self.tops]
            self.obj.setup(bottoms, tops)
            if hasattr(self.obj, "reshape"):
                self.obj.reshape(bottoms, tops)
            self._top_shapes[key] = [t.data.shape for t in tops]
        return self._top_shapes[key]

    def host_forward(self, xs: list) -> tuple[list, list]:
        """The compat object's ``reshape`` and ``forward`` on float32 numpy
        bottoms; returns (bottoms, tops) as blobs."""
        in_shapes = [x.shape for x in xs]
        bottoms = [PyBlob(s) for s in in_shapes]
        tops = [PyBlob(s) for s in self.top_shapes(in_shapes)]
        for b, x in zip(bottoms, xs):
            b.data[...] = x
        if hasattr(self.obj, "reshape"):
            self.obj.reshape(bottoms, tops)
        self.obj.forward(bottoms, tops)
        return bottoms, tops

    def apply(self, params, state, inputs, *, train) -> LayerOutput:
        if self._native:
            try:
                out = self.obj.apply(*inputs)
            except TypeError as e:
                raise TypeError(f"Python layer {self.name!r}: apply() failed on torch "
                                f"tensors ({e}); {_STYLES}") from e
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            bad = [type(o).__name__ for o in outs if not isinstance(o, torch.Tensor)]
            if bad:
                raise TypeError(f"Python layer {self.name!r}: apply() returned {bad}, "
                                f"not torch tensors; {_STYLES}")
            return LayerOutput(outs)
        xs = [x.to(torch.float32) for x in inputs]
        if xs[0].device.type == "meta":  # shape inference in Network.init
            return LayerOutput([torch.empty(s, device="meta")
                                for s in self.top_shapes([tuple(x.shape) for x in xs])])
        if xs[0].is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"Python layer {self.name!r} runs on the host every step and "
                "cannot be captured into a CUDA graph")
        return LayerOutput(list(_HostLayer.apply(self, *xs)))
