"""Layer protocol.

Counterpart of ``sparknet_tpu/ops/base.py`` (ref:
caffe/include/caffe/layer.hpp:335-351).  A layer is a plain object whose
``apply(params, state, inputs)`` is a function on tensors returning
``LayerOutput``; ``init`` makes its learnable blobs with a
``torch.Generator``.  Params are a list of tensors per layer in Caffe's
``blobs_`` order (Convolution = [weight, bias]), the same order as the JAX
package, so the weights bridge (``interop.py``) maps them one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from sparknet_tpu_torch.common import Phase
from sparknet_tpu_torch.proto.text_format import Message

Shape = tuple[int, ...]


@dataclasses.dataclass
class ParamSpec:
    """Per-blob learning-rate / decay multipliers
    (ref: caffe.proto ParamSpec; net.cpp:470+ AppendParam)."""

    lr_mult: float = 1.0
    decay_mult: float = 1.0
    name: str = ""  # for cross-layer weight sharing (share_mode)


@dataclasses.dataclass
class LayerOutput:
    outputs: list[Any]
    state: dict[str, Any] = dataclasses.field(default_factory=dict)


class Layer:
    """Base class. Subclasses set ``TYPE`` and implement init/apply."""

    TYPE: str = ""
    # Layers whose type name ends in "Loss" produce a loss top with default
    # weight 1 (ref: layer.hpp SetLossWeights / caffe.proto loss_weight).
    IS_LOSS: bool = False
    # Layers that draw random numbers take ``gen`` (a torch.Generator) in
    # ``apply``; Network.apply passes it to them alone.
    NEEDS_GEN: bool = False

    def __init__(self, lp: Message, phase: Phase):
        self.lp = lp
        self.phase = phase
        self.name = lp.get_str("name")
        self.type = lp.get_str("type")
        self.bottoms: list[str] = [str(b) for b in lp.get_all("bottom")]
        self.tops: list[str] = [str(t) for t in lp.get_all("top")]

    # ---- learnable params -------------------------------------------------
    def init(self, gen: torch.Generator,
             in_shapes: Sequence[Shape]) -> tuple[list[torch.Tensor], dict]:
        """Returns (params, state) on the CPU. Default: stateless, param-free."""
        return [], {}

    def param_specs(self, num_params: int) -> list[ParamSpec]:
        """ParamSpecs for each blob, honoring repeated ``param {}`` messages."""
        msgs = self.lp.get_all("param")
        specs = []
        for i in range(num_params):
            if i < len(msgs):
                m = msgs[i]
                specs.append(
                    ParamSpec(
                        lr_mult=m.get_float("lr_mult", 1.0),
                        decay_mult=m.get_float("decay_mult", 1.0),
                        name=m.get_str("name", ""),
                    )
                )
            else:
                specs.append(ParamSpec())
        return specs

    # ---- forward ----------------------------------------------------------
    def apply(
        self,
        params: list[torch.Tensor],
        state: dict,
        inputs: list[torch.Tensor],
        *,
        train: bool,
    ) -> LayerOutput:
        raise NotImplementedError(self.type)

    # ---- loss weights -----------------------------------------------------
    def loss_weights(self) -> list[float]:
        explicit = [float(w) for w in self.lp.get_all("loss_weight")]
        n_tops = max(len(self.tops), 1)
        if explicit:
            return explicit + [0.0] * (n_tops - len(explicit))
        return [1.0 if (self.IS_LOSS and i == 0) else 0.0 for i in range(n_tops)]

    def __repr__(self):
        return f"<{self.type} {self.name!r} {self.bottoms}->{self.tops}>"


# ---------------------------------------------------------------------------
# Shared helpers for prototxt conv/pool-style size fields
# ---------------------------------------------------------------------------


def hw_param(m: Message, base: str, default: int | None = None) -> tuple[int, int]:
    """Resolve Caffe's `kernel_size`-or-`kernel_h/kernel_w` field trio."""
    h_key, w_key = f"{base}_h", f"{base}_w"
    if m.has(h_key) or m.has(w_key):
        if not (m.has(h_key) and m.has(w_key)):
            raise ValueError(f"{h_key}/{w_key} must both be set when either is")
        return m.get_int(h_key), m.get_int(w_key)
    vals = m.get_all(f"{base}_size" if base == "kernel" else base)
    if vals:
        if len(vals) == 1:
            return int(vals[0]), int(vals[0])
        return int(vals[0]), int(vals[1])
    if default is None:
        raise ValueError(f"missing required {base} param")
    return default, default


def conv_out_dim(size: int, kernel: int, pad: int, stride: int, dilation: int = 1) -> int:
    """A convolution's output size; raises when the kernel leaves none."""
    ke = dilation * (kernel - 1) + 1
    out = (size + 2 * pad - ke) // stride + 1
    if out <= 0:
        raise ValueError(
            f"conv kernel {kernel} (stride {stride}, pad {pad}, dilation "
            f"{dilation}) produces no output for input size {size}"
        )
    return out


def pool_out_dim(size: int, kernel: int, pad: int, stride: int) -> int:
    """Caffe's ceil-mode pooling shape rule (ref:
    caffe/src/caffe/layers/pooling_layer.cpp Reshape: ceil((H+2p-k)/s)+1,
    then shrink if the last window would start in the padding)."""
    out = int(np.ceil((size + 2 * pad - kernel) / float(stride))) + 1
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    if out <= 0:
        raise ValueError(
            f"pooling kernel {kernel} (stride {stride}, pad {pad}) "
            f"produces no output for input size {size}"
        )
    return out
