"""Host readers for the data layers that name their own sources.

Counterpart of ``sparknet_tpu/data/listfile.py``.  They give ``Data``
(record DB, LMDB or LevelDB), ``ImageData`` and ``WindowData`` prototxts a
feed (the layers stay feed declarations in the graph: the host makes numpy
batches, and ``cli train --data proto`` or a ``DevicePrefetcher`` moves them
to the card, where Caffe's layers ran prefetch threads of their own).

- ImageData (ref: caffe/src/caffe/layers/image_data_layer.cpp:1-167):
  ``"<path> <label>"`` lines; an optional force-resize to
  new_height/new_width; an optional seeded shuffle, redone every epoch;
  ``rand_skip``; it loops forever; the TransformationParameter's
  crop/mirror/mean/scale on each batch.
- WindowData (ref: caffe/src/caffe/layers/window_data_layer.cpp:1-470):
  the R-CNN window file (``# idx / path / c h w / n / label overlap x1 y1
  x2 y2``); windows split into a foreground pool (overlap >= fg_threshold,
  label > 0) and a background pool (overlap < bg_threshold, label 0); a
  batch draws ``batch * fg_fraction`` fg windows and bg for the rest, bg
  first, as the reference's is_fg 0/1 loop; each window is cropped with
  its context_pad and ``square`` geometry, warped to crop_size, mirrored
  at random, and has mean_value/mean_file and scale applied.
- Data: a DB read in a loop through ``createdb.db_minibatches``.

Every draw comes from a numpy ``RandomState`` seeded as in the JAX package,
so the same seed gives the same batches bit for bit.  HDF5Data waits for
``h5py`` on the card's machine (ROADMAP Queue A9): a net that declares it
exits naming the item.

An ``ImageDataSource`` decodes through a pool of ``decode_*`` threads:
close it (``close()``, or use it as a context manager) when done.
"""

from __future__ import annotations

import os
import weakref

import numpy as np

from sparknet_tpu_torch.proto.text_format import Message

HDF5_ITEM = "Queue A9 (HDF5 waits for h5py on the card's machine)"


def _read_image(path: str, color: bool, new_h: int = 0, new_w: int = 0) -> np.ndarray:
    """uint8 CHW; force-resized (no aspect kept) when new_h/new_w are set,
    as cv::imread + cv::resize (image_data_layer.cpp ReadImageToCVMat)."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("RGB" if color else "L")
    if new_h and new_w:
        # BILINEAR is cv::resize's default INTER_LINEAR
        img = img.resize((new_w, new_h), Image.BILINEAR)
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr.transpose(2, 0, 1)


def _transformer(lp: Message, seed: int | None, anchor: str = ""):
    """The DataTransformer of a layer's transform_param.  ``anchor`` (the
    solver or net file that declared the layer) lets a relative mean_file
    resolve by walking up from it when it is not CWD-relative."""
    from sparknet_tpu_torch.data.transform import (
        DataTransformer,
        TransformConfig,
        load_mean_file,
        resolve_mean_file,
    )

    tp = lp.get_msg("transform_param")
    mean_image = None
    mean_file = tp.get_str("mean_file", "")
    if mean_file:
        mean_image = load_mean_file(resolve_mean_file(mean_file, anchor))
    return DataTransformer(TransformConfig(
        scale=tp.get_float("scale", 1.0),
        mirror=tp.get_bool("mirror", False),
        crop_size=tp.get_int("crop_size", 0),
        mean_value=tuple(float(v) for v in tp.get_all("mean_value")),
        mean_image=mean_image,
        seed=seed,
    ))


class ImageDataSource:
    """Endless minibatch stream of one ImageData layer.

    A batch's images decode through a thread pool (PIL leaves the GIL in
    its decode and resize); ``SPARKNET_DECODE_WORKERS`` sets its size, 1
    decodes in the caller.  The pool's threads are not daemons: ``close()``
    ends them."""

    def __init__(self, layer_param: Message, *, train: bool, seed: int = 0,
                 anchor: str = ""):
        self.lp = layer_param
        p = layer_param.get_msg("image_data_param")
        self.batch = p.get_int("batch_size", 0)
        if self.batch <= 0:
            raise ValueError("image_data_param.batch_size must be set")
        self.new_h = p.get_int("new_height", 0)
        self.new_w = p.get_int("new_width", 0)
        if bool(self.new_h) != bool(self.new_w):
            # the reference CHECKs both or neither (image_data_layer.cpp:31)
            raise ValueError("new_height and new_width must be set together")
        self.color = p.get_bool("is_color", True)
        self.root = p.get_str("root_folder", "")
        self.shuffle = p.get_bool("shuffle", False)
        self.train = train
        self.tops = list(layer_param.get_all("top"))
        self._rs = np.random.RandomState(seed)
        source = p.get_str("source", "")
        self.lines: list[tuple[str, int]] = []
        with open(source) as f:
            for lineno, line in enumerate(f, 1):
                parts = line.split()
                if not parts:
                    continue
                if len(parts) < 2:
                    raise ValueError(f"{source}:{lineno}: expected '<path> <label>', "
                                     f"got {line.strip()!r}")
                self.lines.append((parts[0], int(parts[1])))
        if not self.lines:
            raise ValueError(f"{source}: empty image list")
        if self.shuffle:
            self._rs.shuffle(self.lines)
        skip = p.get_int("rand_skip", 0)
        self._pos = int(self._rs.randint(0, skip)) if skip > 1 else 0
        self.xform = _transformer(layer_param, seed, anchor)
        from sparknet_tpu_torch.data.minibatch import decode_workers

        # resolved here, so a bad setting fails at construction
        self.workers = decode_workers()
        self._pool = None
        self._finalizer = None

    def _decode_pool(self):
        if self._pool is None and self.workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self.workers, thread_name_prefix="decode")
            # a backstop only: callers close the source
            self._finalizer = weakref.finalize(self, self._pool.shutdown, wait=False)
        return self._pool

    def close(self) -> None:
        """End the decode threads (joins them); a later call decodes anew."""
        if self._pool is not None:
            self._finalizer.detach()
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __call__(self, _it: int) -> dict[str, np.ndarray]:
        paths, labels = [], []
        while len(paths) < self.batch:
            if self._pos >= len(self.lines):
                self._pos = 0
                if self.shuffle:  # reshuffle each epoch (image_data_layer.cpp:143)
                    self._rs.shuffle(self.lines)
            rel, label = self.lines[self._pos]
            self._pos += 1
            paths.append(os.path.join(self.root, rel))
            labels.append(label)

        def read(path):
            return _read_image(path, self.color, self.new_h, self.new_w)

        pool = self._decode_pool()
        imgs = list(pool.map(read, paths)) if pool else [read(p) for p in paths]
        data = self.xform(np.stack(imgs), self.train)
        return {self.tops[0]: data, self.tops[1]: np.asarray(labels, np.int32)}


class WindowDataSource:
    """Endless fg/bg-sampled window stream of one WindowData layer."""

    def __init__(self, layer_param: Message, *, train: bool, seed: int = 0,
                 anchor: str = ""):
        self.lp = layer_param
        p = layer_param.get_msg("window_data_param")
        self.batch = p.get_int("batch_size", 0)
        if self.batch <= 0:
            raise ValueError("window_data_param.batch_size must be set")
        self.fg_threshold = p.get_float("fg_threshold", 0.5)
        self.bg_threshold = p.get_float("bg_threshold", 0.5)
        self.fg_fraction = p.get_float("fg_fraction", 0.25)
        self.context_pad = p.get_int("context_pad", 0)
        self.crop_mode = p.get_str("crop_mode", "warp")
        self.root = p.get_str("root_folder", "")
        tp = layer_param.get_msg("transform_param")
        self.crop_size = tp.get_int("crop_size", 0)
        if self.crop_size <= 0:
            raise ValueError("WindowData needs transform_param.crop_size")
        if 2 * self.context_pad >= self.crop_size:
            # the context scale divides by crop - 2 * pad: the padding
            # would leave no room for the window itself
            raise ValueError(f"window_data_param.context_pad {self.context_pad} "
                             f"must be < crop_size/2 ({self.crop_size}/2)")
        self.scale = tp.get_float("scale", 1.0)
        self.mirror = tp.get_bool("mirror", False)
        self.mean_values = tuple(float(v) for v in tp.get_all("mean_value"))
        self.mean_image = None
        if tp.get_str("mean_file", ""):
            from sparknet_tpu_torch.data.transform import load_mean_file, resolve_mean_file

            self.mean_image = load_mean_file(resolve_mean_file(tp.get_str("mean_file"),
                                                               anchor))
        self.train = train
        self.tops = list(layer_param.get_all("top"))
        self._rs = np.random.RandomState(seed)

        # the window file: an image table and the fg/bg pools of
        # (image index, label, x1, y1, x2, y2)
        self.images: list[str] = []
        self.fg: list[tuple[int, int, int, int, int, int]] = []
        self.bg: list[tuple[int, int, int, int, int, int]] = []
        source = p.get_str("source", "")
        with open(source) as f:
            tokens = f.read().split()
        i = 0
        while i < len(tokens):
            if tokens[i] != "#":
                raise ValueError(f"{source}: expected '#', got {tokens[i]!r}")
            i += 2  # "#", image_index
            path = tokens[i]
            i += 4  # the path; channels, height, width (the decode gives them)
            num_windows = int(tokens[i])
            i += 1
            img_idx = len(self.images)
            self.images.append(os.path.join(self.root, path))
            for _ in range(num_windows):
                label, overlap = int(tokens[i]), float(tokens[i + 1])
                x1, y1, x2, y2 = (int(t) for t in tokens[i + 2:i + 6])
                i += 6
                if overlap >= self.fg_threshold:
                    if label <= 0:
                        raise ValueError(f"{source}: fg window with label {label}")
                    self.fg.append((img_idx, label, x1, y1, x2, y2))
                elif overlap < self.bg_threshold:
                    self.bg.append((img_idx, 0, x1, y1, x2, y2))
                # windows between the thresholds are dropped, as in the reference
        if not self.fg or not self.bg:
            raise ValueError(f"{source}: need at least one fg and one bg window")
        self._cache: dict[int, np.ndarray] = {}

    def close(self) -> None:
        """Nothing to end (no threads); for a uniform source interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- window geometry ---------------------------------------------------
    def _warp(self, img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              do_mirror: bool) -> np.ndarray:
        """Crop, context-pad and warp one window to (C, crop, crop), float32
        with the mean and scale applied (window_data_layer.cpp:297-420)."""
        from PIL import Image

        c, ih, iw = img.shape
        cs = self.crop_size
        out = np.zeros((c, cs, cs), np.float32)
        pad_x1 = pad_y1 = pad_x2 = pad_y2 = 0
        crop_w = crop_h = cs
        if self.context_pad > 0 or self.crop_mode == "square":
            context_scale = cs / (cs - 2.0 * self.context_pad)
            half_h = (y2 - y1 + 1) / 2.0
            half_w = (x2 - x1 + 1) / 2.0
            cx, cy = x1 + half_w, y1 + half_h
            if self.crop_mode == "square":
                half_h = half_w = max(half_h, half_w)
            x1 = int(round(cx - half_w * context_scale))
            x2 = int(round(cx + half_w * context_scale))
            y1 = int(round(cy - half_h * context_scale))
            y2 = int(round(cy + half_h * context_scale))
            unclipped_h, unclipped_w = y2 - y1 + 1, x2 - x1 + 1
            pad_x1, pad_y1 = max(0, -x1), max(0, -y1)
            pad_x2, pad_y2 = max(0, x2 - iw + 1), max(0, y2 - ih + 1)
            x1, x2 = x1 + pad_x1, x2 - pad_x2
            y1, y2 = y1 + pad_y1, y2 - pad_y2
            scale_x = cs / unclipped_w
            scale_y = cs / unclipped_h
            crop_w = int(round((x2 - x1 + 1) * scale_x))
            crop_h = int(round((y2 - y1 + 1) * scale_y))
            pad_x1 = int(round(pad_x1 * scale_x))
            pad_x2 = int(round(pad_x2 * scale_x))
            pad_y1 = int(round(pad_y1 * scale_y))
            pad_y2 = int(round(pad_y2 * scale_y))

        pad_h = pad_y1
        pad_w = pad_x2 if do_mirror else pad_x1
        crop_h = min(crop_h, cs - pad_h)
        crop_w = min(crop_w, cs - pad_w)

        # a plain-warp window is taken as the file gives it, but a stray
        # out-of-range coordinate clamps instead of wrapping through
        # negative indexing
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(iw - 1, x2), min(ih - 1, y2)
        patch = img[:, y1:y2 + 1, x1:x2 + 1]
        pil = Image.fromarray(patch.transpose(1, 2, 0).squeeze()
                              if c == 1 else patch.transpose(1, 2, 0))
        pil = pil.resize((max(crop_w, 1), max(crop_h, 1)), Image.BILINEAR)
        warped = np.asarray(pil, np.float32)
        if warped.ndim == 2:
            warped = warped[:, :, None]
        warped = warped.transpose(2, 0, 1)
        if do_mirror:
            warped = warped[:, :, ::-1]

        # a mean image is read at the center offset shifted by the padding
        # (window_data_layer.cpp:404-411)
        if self.mean_image is not None:
            off = (self.mean_image.shape[2] - cs) // 2
            m = self.mean_image[:, off + pad_h:off + pad_h + warped.shape[1],
                                off + pad_w:off + pad_w + warped.shape[2]]
            warped = warped - m
        elif self.mean_values:
            warped = warped - np.asarray(self.mean_values, np.float32).reshape(-1, 1, 1)
        out[:, pad_h:pad_h + warped.shape[1], pad_w:pad_w + warped.shape[2]] = warped
        return out * self.scale

    def _image(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            if len(self._cache) > 256:  # bound the host memory
                self._cache.clear()
            self._cache[idx] = _read_image(self.images[idx], color=True)
        return self._cache[idx]

    def __call__(self, _it: int) -> dict[str, np.ndarray]:
        num_fg = int(self.batch * self.fg_fraction)
        data = np.zeros((self.batch, 3, self.crop_size, self.crop_size), np.float32)
        labels = np.zeros(self.batch, np.int32)
        item = 0
        for is_fg, count in ((0, self.batch - num_fg), (1, num_fg)):
            pool = self.fg if is_fg else self.bg
            for _ in range(count):
                img_idx, label, x1, y1, x2, y2 = pool[self._rs.randint(len(pool))]
                do_mirror = bool(self.mirror and self._rs.randint(2) and self.train)
                data[item] = self._warp(self._image(img_idx), x1, y1, x2, y2, do_mirror)
                labels[item] = label
                item += 1
        return {self.tops[0]: data, self.tops[1]: labels}


class DataDbSource:
    """Endless minibatch stream of one DB-backed ``Data`` layer (ref:
    data_layer.cpp: a DataReader walks the DB cursor forever and the
    DataTransformer crops, mirrors and subtracts the mean of each datum).
    The prototxt's ``data_param.source`` must exist on this host; the
    CLI's ``--data db:<path>`` covers a DB that lives elsewhere."""

    def __init__(self, layer_param: Message, *, train: bool, seed: int = 0,
                 anchor: str = ""):
        self.lp = layer_param
        p = layer_param.get_msg("data_param")
        self.batch = p.get_int("batch_size", 0)
        if self.batch <= 0:
            raise ValueError("data_param.batch_size must be set")
        self.source = p.get_str("source", "")
        if not self.source:
            raise ValueError("data_param.source must be set")
        if not os.path.exists(self.source):
            raise ValueError(f"data_param.source {self.source!r} not found on this host "
                             "(stream a local DB with --data db:<path> instead)")
        self.train = train
        self.tops = list(layer_param.get_all("top"))
        self.xform = _transformer(layer_param, seed, anchor)
        # rand_skip decorrelates workers (data_layer.cpp:23-31), here in
        # whole batches
        skip = p.get_int("rand_skip", 0)
        self._skip_batches = (int(np.random.RandomState(seed).randint(0, skip)) // self.batch
                              if skip > 1 else 0)
        self._iter = None

    def close(self) -> None:
        """Close the DB cursor (a later call reopens it at the start)."""
        if self._iter is not None:
            self._iter.close()
            self._iter = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __call__(self, _it: int) -> dict[str, np.ndarray]:
        if self._iter is None:
            from sparknet_tpu_torch.data.createdb import db_minibatches

            # uint8: the transformer casts to float32 anyway
            self._iter = db_minibatches(self.source, self.batch, loop=True, dtype=np.uint8)
            for _ in range(self._skip_batches):
                next(self._iter)
        b = next(self._iter)
        out = {self.tops[0]: self.xform(b["data"], self.train)}
        if len(self.tops) > 1:
            out[self.tops[1]] = b["label"]
        return out


_SOURCES = {
    "Data": DataDbSource,
    "ImageData": ImageDataSource,
    "WindowData": WindowDataSource,
}
# data layers that name a source the port cannot stream yet
_UNPORTED_SOURCES = {"HDF5Data": HDF5_ITEM}


def source_from_net(net, *, seed: int = 0, anchor: str = ""):
    """The host stream of the first data layer in a ``Network`` that names
    its own source (its phase decides the train-time augmentation).
    ``anchor``: the solver or net prototxt path, for the mean_file walk-up.
    Raises ``LookupError`` when the net has no such layer (a capability
    probe: a train-only prototxt's TEST view falls back), ``SystemExit``
    for HDF5Data."""
    from sparknet_tpu_torch.common import Phase

    for layer in net.input_layers:
        if layer.type in _UNPORTED_SOURCES:
            raise SystemExit(f"{layer.type} layer {layer.name!r}: not ported to "
                             f"sparknet_tpu_torch yet (ROADMAP {_UNPORTED_SOURCES[layer.type]})")
        cls = _SOURCES.get(layer.type)
        if cls is not None:
            return cls(layer.lp, train=net.phase == Phase.TRAIN, seed=seed, anchor=anchor)
    raise LookupError("net has no Data/ImageData/WindowData/HDF5Data layer in this phase "
                      f"(input layers: {[l.type for l in net.input_layers]})")
