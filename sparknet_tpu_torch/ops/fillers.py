"""Weight fillers (ref: caffe/include/caffe/filler.hpp).

Counterpart of ``sparknet_tpu/ops/fillers.py``.  Each filler takes a
prototxt ``FillerParameter`` message, a ``torch.Generator`` and the blob
shape, and returns a tensor on the generator's device (the CPU in
``Network.init``, which then moves the blobs to the net's device), drawn in
float32 and cast to ``dtype`` (a layer passes ``Config.param_dtype`` where
the JAX layer fills in it).  The
draws differ from ``jax.random``'s for the same seed; parity tests start
from the JAX package's weights (``interop.py``) for that reason.
Fan-in follows Caffe: ``fan_in = count / num``.
"""

from __future__ import annotations

import numpy as np
import torch

from sparknet_tpu_torch.proto.text_format import Message


def _fans(shape) -> tuple[int, int]:
    count = int(np.prod(shape))
    num = shape[0] if shape else 1
    fan_in = count // max(num, 1)
    # fan_out = count / channels for conv (ref filler.hpp MSRAFiller)
    fan_out = count // max(shape[1], 1) if len(shape) > 1 else count
    return fan_in, fan_out


def _uniform(gen, shape, lo, hi):
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return lo + (hi - lo) * u


def fill(filler: Message, gen: torch.Generator, shape,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _fill(filler, gen, tuple(int(d) for d in shape)).to(dtype)


def _fill(filler: Message, gen: torch.Generator, shape: tuple) -> torch.Tensor:
    ftype = filler.get_str("type", "constant")
    if ftype == "constant":
        return torch.full(shape, filler.get_float("value", 0.0), dtype=torch.float32)
    if ftype == "uniform":
        return _uniform(gen, shape, filler.get_float("min", 0.0),
                        filler.get_float("max", 1.0))
    if ftype == "gaussian":
        mean, std = filler.get_float("mean", 0.0), filler.get_float("std", 1.0)
        out = mean + std * torch.randn(shape, generator=gen, dtype=torch.float32)
        sparse = filler.get_int("sparse", -1)
        if sparse >= 0:
            # ref filler.hpp GaussianFiller: bernoulli mask with
            # p = sparse / num_outputs, num_outputs = blob shape[0]
            num_outputs = shape[0] if shape else 1
            prob = min(1.0, sparse / max(num_outputs, 1))
            keep = torch.rand(shape, generator=gen) < prob
            out = out * keep.to(torch.float32)
        return out
    if ftype == "positive_unitball":
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
        flat = x.reshape(shape[0], -1)
        return (flat / flat.sum(dim=1, keepdim=True)).reshape(shape)
    if ftype == "xavier":
        fan_in, fan_out = _fans(shape)
        scale = float(np.sqrt(3.0 / _variance_norm_n(filler, fan_in, fan_out)))
        return _uniform(gen, shape, -scale, scale)
    if ftype == "msra":
        fan_in, fan_out = _fans(shape)
        std = float(np.sqrt(2.0 / _variance_norm_n(filler, fan_in, fan_out)))
        return std * torch.randn(shape, generator=gen, dtype=torch.float32)
    if ftype == "bilinear":
        return torch.from_numpy(_bilinear_kernel(shape))
    raise ValueError(f"unknown filler type {ftype!r}")


def _variance_norm_n(filler: Message, fan_in: int, fan_out: int) -> float:
    norm = filler.get_str("variance_norm", "FAN_IN")
    if norm == "FAN_OUT":
        return float(fan_out)
    if norm == "AVERAGE":
        return (fan_in + fan_out) / 2.0
    return float(fan_in)


def _bilinear_kernel(shape) -> np.ndarray:
    """Upsampling kernel for Deconvolution (ref: filler.hpp BilinearFiller)."""
    if len(shape) != 4 or shape[2] != shape[3]:
        raise ValueError(f"bilinear filler needs a square 4D blob, got {shape}")
    k = shape[3]
    f = int(np.ceil(k / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    out = np.zeros(shape, np.float32)
    kern1d = 1 - np.abs(np.arange(k) / f - c)
    out[...] = np.outer(kern1d, kern1d)  # broadcast over leading dims
    return out
