"""Offline dataset resizing — resize-shorter-side + center crop.

Copy of ``sparknet_tpu/data/resize_images.py`` (host only).

Equivalent of caffe/tools/extra/resize_and_crop_images.py (there a
mincepie/OpenCV map-reduce; here a multiprocessing.Pool over PIL),
preserving the input tree's relative structure, as the ImageNet
preprocessing convention expects (shorter side to S, center S x S
crop).
"""

from __future__ import annotations

import os
from multiprocessing import get_context

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def resize_and_crop_image(args: tuple[str, str, int]) -> tuple[str, str]:
    """(input, output, side) -> (input path, 'ok'|'error: ...')."""
    src, dst, side = args
    try:
        from PIL import Image

        with Image.open(src) as img:
            img = img.convert("RGB")
            w, h = img.size
            if w < h:
                new_w, new_h = side, max(side, round(h * side / w))
            else:
                new_w, new_h = max(side, round(w * side / h)), side
            img = img.resize((new_w, new_h), Image.BILINEAR)
            left = (new_w - side) // 2
            top = (new_h - side) // 2
            img = img.crop((left, top, left + side, top + side))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            img.save(dst)
        return src, "ok"
    except Exception as e:  # a broken image must not kill the sweep
        return src, f"error: {e}"


def resize_tree(
    input_folder: str,
    output_folder: str,
    side: int = 256,
    workers: int = 0,
) -> tuple[int, list[tuple[str, str]]]:
    """Resize every image under ``input_folder`` into ``output_folder``
    (same relative paths).  Returns (ok_count, [(path, error), ...])."""
    jobs = []
    for root, _, files in os.walk(input_folder):
        for name in files:
            if not name.lower().endswith(_EXTS):
                continue
            src = os.path.join(root, name)
            rel = os.path.relpath(src, input_folder)
            jobs.append((src, os.path.join(output_folder, rel), side))
    if not jobs:
        raise ValueError(f"no images under {input_folder!r} (extensions {_EXTS})")
    workers = workers or os.cpu_count() or 1
    if workers == 1:
        results = [resize_and_crop_image(j) for j in jobs]
    else:
        # spawn, not fork: the caller may hold torch or CUDA threads that
        # fork() would copy into a deadlock-prone child
        with get_context("spawn").Pool(workers) as pool:
            results = pool.map(resize_and_crop_image, jobs)
    errors = [(p, msg) for p, msg in results if msg != "ok"]
    return len(results) - len(errors), errors
