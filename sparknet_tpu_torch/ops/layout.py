"""Internal tensor layout of rank-4 image blobs: nchw or nhwc.

Counterpart of ``sparknet_tpu/ops/layout.py``.  ``Config.layout`` picks
the orientation: ``"nchw"`` (default, Caffe's blob order) or ``"nhwc"``
(channels-last).  The contract is the JAX package's:

* **Activations move.**  Rank-4 blobs run (N, H, W, C) under nhwc; every
  other rank is layout-invariant.  Feed shapes follow
  (:func:`internal_shape`): image bytes arrive HWC off the wire, so the
  nhwc feed ships its natural order with no entry transpose.
* **Params do not move.**  Convolution weights stay OIHW and InnerProduct
  weights stay (num_output, C*H*W) in Caffe's wire order in both layouts,
  so ``.caffemodel``, ``.solverstate.npz``, the fused update's arenas and
  int8 scales never convert.
* **Prototxt axes stay canonical.**  ``axis: 1`` means channels in every
  layer parameter; :func:`internal_axis` maps a canonical axis to its
  internal position.

Where the JAX package hands ``conv_dimnums`` and ``pool_window`` to XLA,
the port runs each Convolution, Deconvolution and Pooling on
:func:`nchw_view` of its input: ``x.permute(0, 3, 1, 2)``, an NCHW-shaped
view with channels-last strides (no copy), on which cuDNN and ATen pick
their NHWC kernels; :func:`internal_view` turns the channels-last result
back into (N, H, W, C), again a view.  Under nchw both are the identity,
so the default path runs exactly the operations it ran before layouts.
"""

from __future__ import annotations

from sparknet_tpu_torch.common import get_config

LAYOUTS = ("nchw", "nhwc")

# canonical NCHW axis -> internal axis for rank-4 blobs under nhwc
_NHWC_OF_CANON = {0: 0, 1: 3, 2: 1, 3: 2}


def normalize(layout: str) -> str:
    lay = str(layout).lower()
    if lay not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (nchw|nhwc)")
    return lay


def active_layout() -> str:
    """The internal layout the next forward runs in (``Config.layout``)."""
    return normalize(get_config().layout)


def is_nhwc(layout: str | None = None) -> bool:
    return (normalize(layout) if layout else active_layout()) == "nhwc"


def channel_axis(layout: str | None = None, ndim: int = 4) -> int:
    """Channel axis of an internal activation (rank 4 only moves)."""
    if ndim == 4 and is_nhwc(layout):
        return 3
    return 1


def spatial_axes(layout: str | None = None) -> tuple[int, int]:
    """(H, W) axes of an internal rank-4 activation."""
    return (1, 2) if is_nhwc(layout) else (2, 3)


def channel_bshape(ndim: int, layout: str | None = None) -> tuple:
    """Broadcast shape for a per-channel vector (bias, BN stats, scale)."""
    if ndim == 4 and is_nhwc(layout):
        return (1, 1, 1, -1)
    return (1, -1) + (1,) * (ndim - 2)


def internal_axis(canon_axis: int, ndim: int, layout: str | None = None) -> int:
    """Map a canonical (NCHW blob-order) axis to its internal position.
    Identity for nchw and for every rank but 4."""
    if ndim == 4 and is_nhwc(layout):
        return _NHWC_OF_CANON[canon_axis]
    return canon_axis


def internal_shape(shape, layout: str | None = None) -> tuple:
    """Map a canonical (N, C, H, W) declared shape to the internal one.
    Shapes of other ranks pass through (only image blobs reorient)."""
    shape = tuple(shape)
    if len(shape) == 4 and is_nhwc(layout):
        n, c, h, w = shape
        return (n, h, w, c)
    return shape


def canonical_shape(shape, layout: str | None = None) -> tuple:
    """Inverse of :func:`internal_shape`: the canonical (N, C, H, W) view
    of an internal shape."""
    shape = tuple(shape)
    if len(shape) == 4 and is_nhwc(layout):
        n, h, w, c = shape
        return (n, c, h, w)
    return shape


def _permuted(x, order):
    # a torch tensor permutes (a view); a numpy array transposes (a view)
    return x.permute(*order) if hasattr(x, "permute") else x.transpose(order)


def to_internal(x, layout: str | None = None):
    """Canonical NCHW array or tensor -> the internal orientation (a view)."""
    if getattr(x, "ndim", 0) == 4 and is_nhwc(layout):
        return _permuted(x, (0, 2, 3, 1))
    return x


def from_internal(x, layout: str | None = None):
    """Internal array or tensor -> canonical NCHW orientation (a view)."""
    if getattr(x, "ndim", 0) == 4 and is_nhwc(layout):
        return _permuted(x, (0, 3, 1, 2))
    return x


def feeds_to_internal(feeds: dict, layout: str | None = None) -> dict:
    """Host-side adapter for canonical-NCHW data planes (DB cursors, CIFAR
    readers, the minibatch packers emit blob order): rank-4 arrays to the
    internal layout, made contiguous so the copy to the card is one dense
    block.  The dict itself under nchw."""
    if not is_nhwc(layout):
        return feeds
    out = {}
    for k, v in feeds.items():
        if getattr(v, "ndim", 0) == 4:
            v = to_internal(v, "nhwc")
            v = v.contiguous() if hasattr(v, "contiguous") else v.copy()
        out[k] = v
    return out


def nchw_view(x, layout: str | None = None):
    """An internal rank-4 activation as the NCHW-shaped tensor that
    ``F.conv2d``, ``F.conv_transpose2d`` and the pools take: under nhwc
    ``x.permute(0, 3, 1, 2)``, a view with ``torch.channels_last``
    strides, so the library picks its NHWC kernel; ``x`` itself under
    nchw.  Takes the place of the JAX package's ``conv_dimnums`` and
    ``pool_window``."""
    return from_internal(x, layout)


def internal_view(y, layout: str | None = None):
    """Inverse of :func:`nchw_view`: an NCHW-shaped result back in the
    internal orientation, ``y.permute(0, 2, 3, 1)`` under nhwc (dense when
    ``y`` has channels-last strides, as the library's NHWC kernels write
    it)."""
    return to_internal(y, layout)
