"""On-device augmentation: ship uint8, crop/mirror/mean-subtract on the card.

Counterpart of ``sparknet_tpu/data/device_transform.py``, the device-side
redesign of the host ``DataTransformer`` (ref:
caffe/src/caffe/util/data_transformer.cpp:19-119 runs the augment per
sample on the host and ships f32 crops).  The host→card link carries
full-size **uint8** instead of cropped **f32** — 3.2× fewer bytes for the
ImageNet recipe (256²×3 u8 = 196 KB/img against 227²×3 f32 = 618 KB/img).

Semantics follow ``DataTransformer`` exactly: the host's order (mean, then
crop, then mirror, then scale), each a separate float32 op (no fused
multiply-add, no ``torch.compile``), and the per-sample windows gathered
by one advanced-indexing gather built by index arithmetic, as the host
does (``transform.py`` ``_crop``).  TEST (center crop) is bit for bit the
host's; TRAIN with the same offsets and flips is bit for bit the host
formula with those draws.

Draws.  The JAX package folds ``it`` and the slot ``t`` into
``jax.random.key(1234 + pid + seed)``; torch cannot reproduce those bits.
Here each call draws from one ``torch.Generator`` on the card seeded by
:func:`draw_seed` from ``(pid, seed, it, t)`` — no global RNG state — so a
replayed round draws the same windows.  ``__call__`` also takes the draws
themselves (``offsets``, ``flips``), which is how parity tests inject the
JAX package's.

Layout.  The batch arrives and leaves in the internal layout
(``Config.layout``): (N, C, H, W) -> (N, C, crop, crop) under nchw, (N, H,
W, C) -> (N, crop, crop, C) under nhwc.  Image bytes come HWC off the wire
(decoders, the record DB, ``data/minibatch.py``'s packers), so the nhwc
arm ships them as they are, with no entry transpose.  Both arms draw the
same offsets and flips from one generator and do the same per-element
arithmetic, so the nhwc output is the nchw output permuted, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sparknet_tpu_torch.common import resolve_device
from sparknet_tpu_torch.data.transform import TransformConfig
from sparknet_tpu_torch.ops.layout import active_layout, normalize

_SLOT_BITS = 16  # slots a round (t + 1 < 2^16; 0 is a rank-4 feed)
_IT_BITS = 32  # iterations (it < 2^32)


def draw_seed(pid: int, seed: int | None, it: int, t: int | None = None) -> int:
    """The generator seed of one augment call:
    ``(1234 + pid + seed) << 48 | it << 16 | slot``, modulo 2^63, with
    ``slot = 0`` for a rank-4 feed and ``t + 1`` for slot ``t`` of a rank-5
    ``[tau, B, ...]`` feed.  The base is the JAX package's
    ``1234 + pid + seed``; ``it`` and the slot take its ``fold_in``'s
    place, so a slot draws apart from every other slot and from any rank-4
    call."""
    slot = 0 if t is None else int(t) + 1
    if not (0 <= it < 1 << _IT_BITS and 0 <= slot < 1 << _SLOT_BITS):
        raise ValueError(f"draw_seed: it {it} or slot {t} out of range")
    base = 1234 + int(pid) + int(seed or 0)
    return ((base << (_IT_BITS + _SLOT_BITS)) | (int(it) << _SLOT_BITS) | slot) \
        % (1 << 63)


class DeviceAugment:
    """Batch transform on the card: uint8/float ``[N, C, H, W]`` tensor ->
    float32 ``[N, C, crop, crop]`` under nchw, ``[N, H, W, C]`` ->
    ``[N, crop, crop, C]`` under nhwc (``layout``, default
    ``Config.layout`` when the augment is made).

    Use as the ``device_fn`` of a
    :class:`~sparknet_tpu_torch.data.prefetch.DevicePrefetcher` or of
    :func:`~sparknet_tpu_torch.data.pipeline.device_feed` (:meth:`device_fn`),
    or as the trainers' ``feed_device_fn`` (:meth:`trainer_device_fn`).
    ``device`` (default CUDA) holds the mean image; the images may be on
    any device and the output is on theirs.
    """

    def __init__(self, config: TransformConfig, layout: str | None = None,
                 device: str | torch.device | None = None):
        if config.mean_image is not None and config.mean_value:
            raise ValueError("specify mean_image or mean_value, not both")
        if config.backend != "numpy":
            raise ValueError(
                "DeviceAugment is its own backend; build the config with "
                "backend='numpy' (the default) and wrap it here")
        self.config = config
        self.layout = normalize(layout) if layout else active_layout()
        nhwc = self.layout == "nhwc"
        self.device = resolve_device(device)
        mean = None
        if config.mean_image is not None:
            mean = np.asarray(config.mean_image, np.float32)  # canonical (C, H, W)
            if nhwc:  # once, here
                mean = np.ascontiguousarray(mean.transpose(1, 2, 0))
            mean = torch.as_tensor(mean, device=self.device)[None]
        elif config.mean_value:
            mean = torch.as_tensor(np.asarray(config.mean_value, np.float32),
                                   device=self.device).reshape(
                                       (1, 1, 1, -1) if nhwc else (1, -1, 1, 1))
        self._mean = mean
        # the scale as the float32 the host multiplies by
        self._scale = float(np.float32(config.scale))

    def generator(self, pid: int = 0, seed: int | None = None, it: int = 0,
                  t: int | None = None, device=None) -> torch.Generator:
        """A generator on ``device`` (default: this augment's) seeded by
        :func:`draw_seed`."""
        g = torch.Generator(device=device or self.device)
        g.manual_seed(draw_seed(pid, seed, it, t))
        return g

    def draw(self, n: int, h: int, w: int, generator: torch.Generator):
        """TRAIN's draws for ``n`` images of ``h`` x ``w``: ``(hos, wos)``
        crop offsets, uniform over the valid range (None without a crop),
        and ``flips`` (None without mirror), in that order from
        ``generator``, on the generator's device."""
        cfg, c = self.config, self.config.crop_size
        dev = generator.device
        offsets = flips = None
        if c:
            if h < c or w < c:
                raise ValueError(f"crop {c} larger than image {h}x{w}")
            offsets = (torch.randint(0, h - c + 1, (n,), generator=generator, device=dev),
                       torch.randint(0, w - c + 1, (n,), generator=generator, device=dev))
        if cfg.mirror:
            flips = torch.rand((n,), generator=generator, device=dev) < 0.5
        return offsets, flips

    def __call__(self, images: torch.Tensor, train: bool = True, *,
                 generator: torch.Generator | None = None,
                 offsets=None, flips=None) -> torch.Tensor:
        """``images`` [N, C, H, W] (nchw) or [N, H, W, C] (nhwc) -> float32
        crops in the same layout.  TRAIN draws from ``generator``
        (:meth:`draw`) unless ``offsets`` ``(hos, wos)`` and ``flips``
        (bool [N]) are given; TEST crops the center and never mirrors."""
        cfg, c = self.config, self.config.crop_size
        nhwc = self.layout == "nhwc"
        x = images.to(torch.float32)
        if nhwc:
            n, h, w, ch = x.shape
        else:
            n, ch, h, w = x.shape
        if self._mean is not None:
            x = x - self._mean.to(x.device)
        if train and (offsets is None and c or flips is None and cfg.mirror):
            if generator is None:
                raise ValueError("DeviceAugment TRAIN needs a generator or "
                                 "the draws (offsets, flips)")
            drawn = self.draw(n, h, w, generator)
            offsets = drawn[0] if offsets is None else offsets
            flips = drawn[1] if flips is None else flips
        if c:
            if h < c or w < c:
                raise ValueError(f"crop {c} larger than image {h}x{w}")
            if train:
                hos, wos = (torch.as_tensor(o, device=x.device).long() for o in offsets)
            else:
                hos = torch.full((n,), (h - c) // 2, device=x.device)
                wos = torch.full((n,), (w - c) // 2, device=x.device)
            # one gather by index arithmetic: x[n, ch, ho + i, wo + j]
            # (nchw) or x[n, ho + i, wo + j, ch] (nhwc)
            ar = torch.arange(c, device=x.device)
            rows = hos[:, None] + ar[None]  # (N, c)
            cols = wos[:, None] + ar[None]
            imgs = torch.arange(n, device=x.device)[:, None, None, None]
            if nhwc:
                x = x[imgs, rows[:, :, None, None], cols[:, None, :, None],
                      torch.arange(ch, device=x.device)[None, None, None, :]]
            else:
                x = x[imgs, torch.arange(ch, device=x.device)[None, :, None, None],
                      rows[:, None, :, None], cols[:, None, None, :]]
        if train and cfg.mirror:
            flip = torch.as_tensor(flips, device=x.device).bool()
            x = torch.where(flip[:, None, None, None], x.flip(2 if nhwc else 3), x)
        if cfg.scale != 1.0:
            x = x * self._scale
        return x

    def device_fn(self, pid: int = 0, seed: int | None = None, key_name: str = "data"):
        """The async-feed adapter: ``fn(feeds, it)`` for the prefetcher or
        ``device_feed``, drawing from ``generator(pid, seed, it)``
        (deterministic per process, as the JAX package's ``1234 + pid``
        key; ``seed`` offsets the whole family)."""

        def fn(feeds, it):
            x = feeds[key_name]
            g = self.generator(pid, seed, it, device=x.device)
            return {**feeds, key_name: self(x, True, generator=g)}

        return fn

    def trainer_device_fn(self, pid: int = 0, seed: int | None = None,
                          key_name: str = "data"):
        """The distributed-feed adapter: ``fn(feeds, it)`` that
        ``ParallelTrainer``/``ElasticTrainer`` apply after their own feed
        placement and before the round.  A rank-4 feed draws as
        :meth:`device_fn`; a rank-5 ``[tau, B, ...]`` feed draws slot ``t``
        from ``generator(pid, seed, it, t)``, so each slot of a round
        draws apart from the others and from any rank-4 call."""

        def fn(feeds, it):
            x = feeds[key_name]
            if x.dim() == 5:
                out = torch.stack([
                    self(x[t], True, generator=self.generator(pid, seed, it, t,
                                                              device=x.device))
                    for t in range(x.shape[0])])
            else:
                out = self(x, True, generator=self.generator(pid, seed, it,
                                                             device=x.device))
            return {**feeds, key_name: out}

        return fn
