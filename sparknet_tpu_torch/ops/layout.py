"""Internal tensor layout of rank-4 image blobs — NCHW only.

Counterpart of ``sparknet_tpu/ops/layout.py``.  The JAX package makes the
orientation a config knob (``Config.layout``: nchw or nhwc); the port runs
Caffe's NCHW blob order only (channels-last is ROADMAP Queue A6), so each
helper here is the nchw branch of its JAX twin.  Prototxt axes are
canonical NCHW axes, which under NCHW are the internal axes as well.
"""

from __future__ import annotations


def channel_axis(ndim: int = 4) -> int:
    """Channel axis of an internal activation."""
    return 1


def channel_bshape(ndim: int) -> tuple:
    """Broadcast shape for a per-channel vector (bias, BN stats, scale)."""
    return (1, -1) + (1,) * (ndim - 2)


def spatial_axes() -> tuple[int, int]:
    """(H, W) axes of an internal rank-4 activation."""
    return (2, 3)


def internal_axis(canon_axis: int, ndim: int) -> int:
    """Map a canonical (NCHW blob-order) axis to its internal position."""
    return canon_axis


def internal_shape(shape) -> tuple:
    """Map a canonical (N, C, H, W) declared shape to the internal one."""
    return tuple(shape)
