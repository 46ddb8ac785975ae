"""Procedural domain-pair data: RGB tiles, DAAM heatmap stacks and COCO
ground truth from known boxes.

Counterpart of ``agenda_tpu/io/procedural.py``. ``make_heatmap_domain``
writes ``images/``, ``daam_stack_heatmaps/`` (R = object word, G = fg
token, B = inverted bg token, ``cli/postprocess_heatmap.py``'s layout) and
``ann.json`` under a root, with controlled corruption (gain/bias shift,
noise, dimmed and spurious blobs), so the annotation half can be trained and
gated on known boxes. The bench's stage-3 labeler trains on it
(``detect/bench_labeler.py``).

Every draw comes from one ``np.random.RandomState`` in the JAX package's
order, so the stacks and ``ann.json`` are the JAX package's to the bit. The
RGB tiles need Pillow there; here each Pillow call has its own numpy copy:

- the 14 -> 112 ``BILINEAR`` upscale is ``detect/augment.py::resize_pil``;
- the distractor discs are Pillow's ellipse rasterizer (``_ellipse_spans``,
  a port of ``libImaging/Draw.c``'s ``quarter_*``/``ellipse_*``, filled);
- the cars are Pillow's ``rectangle`` fill, whose float corners are cut to
  ``int`` (towards zero) and whose spans include both ends.

PNGs are written with the port's ``utils/png.py``, so compare decoded
pixels with the JAX package's files, not their bytes.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Tuple

import numpy as np

from agenda_tpu_torch.detect.augment import resize_pil
from agenda_tpu_torch.utils.png import write_png

SIZE = 112
BOX = 42.36


def _blob(canvas: np.ndarray, cx: float, cy: float, sigma: float, peak: float):
    """Additive gaussian blob, clipped into the canvas."""
    h, w = canvas.shape
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    canvas += peak * np.exp(-(((x - cx) ** 2) + ((y - cy) ** 2)) / (2 * sigma**2))


def _quarter(a: int, b: int) -> Iterator[Tuple[int, int]]:
    """The points of Pillow's ``quarter_next`` for semi-axes (a, b) on the
    grid of step 2: from (a, b % 2) to (a % 2, b), each step to whichever of
    up, up-left and left deviates least from the ellipse (ties keep the
    first)."""
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2b2)

    cx, cy, ex, ey = a, b % 2, a % 2, b
    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            d = delta(cx - 2, cy)
            if nd > d:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


def _ellipse_spans(a: int, b: int) -> Iterator[Tuple[int, int, int]]:
    """(x0, y, x1) spans of Pillow's filled ``ellipse_next`` on the doubled
    grid, for a box of width a and height b (pixels ``x1 - x0``, ``y1 - y0``)."""
    if a < 0 or b < 0 or a + b < 1:  # filled: the width a + b, and none under 1
        return
    leftmost = a % 2
    outer = _quarter(a, b)
    pr, py = next(outer)
    finished = False
    while not finished:
        y, l, r = py, leftmost, pr  # filled: the inner quarter is empty
        for cx, cy in outer:
            if cy > y:
                pr, py = cx, cy
                break
        else:
            finished = True
        spans = []
        if (l > 0 or l < r) and y > 0:
            spans.append((2 if l == 0 else l, y, r))
        if y > 0:
            spans.append((-r, y, -l))
        if l > 0 or l < r:
            spans.append((2 if l == 0 else l, -y, r))
        spans.append((-r, -y, -l))
        yield from reversed(spans)  # Pillow pops its buffer from the end


def fill_ellipse(img: np.ndarray, box, color) -> None:
    """Pillow's ``ImageDraw.ellipse(box, fill=color)`` on an RGB array, in
    place, for integer corners (x0, y0, x1, y1): each span is an ``hline``
    from ``x0 + (X0 + a) // 2`` to ``x0 + (X1 + a) // 2``, both included,
    clipped to the image."""
    x0, y0, x1, y1 = (int(v) for v in box)
    a, b = x1 - x0, y1 - y0
    h, w = img.shape[:2]
    for sx0, sy, sx1 in _ellipse_spans(a, b):
        y = y0 + (sy + b) // 2
        lo, hi = sorted((x0 + (sx0 + a) // 2, x0 + (sx1 + a) // 2))
        if 0 <= y < h and hi >= 0 and lo < w:
            img[y, max(lo, 0):min(hi, w - 1) + 1] = color


def fill_rectangle(img: np.ndarray, box, color) -> None:
    """Pillow's ``ImageDraw.rectangle(box, fill=color)`` on an RGB array, in
    place: each corner cut to ``int`` (towards zero), both ends included."""
    x0, y0, x1, y1 = (int(v) for v in box)
    h, w = img.shape[:2]
    img[max(y0, 0):max(min(y1, h - 1) + 1, 0), max(x0, 0):max(min(x1, w - 1) + 1, 0)] = color


def make_heatmap_domain(
    root: str,
    n_images: int,
    seed: int = 0,
    *,
    noise: float = 12.0,
    gain: float = 1.0,
    bias: float = 0.0,
    p_dim: float = 0.0,       # prob an object blob is dimmed into dim_range
    dim_range=(55.0, 95.0),   # straddles the score transition band
    p_spurious: float = 0.0,  # prob of an extra object-free blob per image
    spur_range=(55.0, 95.0),
) -> str:
    """Write images/ + daam_stack_heatmaps/ + ann.json under root
    (``agenda_tpu/io/procedural.py:38-134``); returns the ann.json path.
    Image ids follow the numeric file names."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    stack_dir = os.path.join(root, "daam_stack_heatmaps")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(stack_dir, exist_ok=True)

    images, annotations = [], []
    for i in range(n_images):
        # ---- GT: 1-3 cars, 42.36px fake boxes, loosely non-overlapping ----
        centers = []
        for _ in range(rng.randint(1, 4)):
            for _attempt in range(8):
                cx = rng.uniform(10, SIZE - 10)
                cy = rng.uniform(10, SIZE - 10)
                if all((cx - a) ** 2 + (cy - b) ** 2 > 34**2 for a, b in centers):
                    centers.append((cx, cy))
                    break

        # ---- RGB image: textured bg + distractors + red-ish cars ---------
        base = rng.rand(SIZE // 8, SIZE // 8, 3) * 90
        bg = resize_pil(base.astype(np.uint8), SIZE, SIZE).astype(np.float32)
        bg += rng.rand(SIZE, SIZE, 3) * 40
        im = np.clip(bg, 0, 255).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):  # distractor circles (not cars)
            dx, dy, r = rng.randint(0, SIZE), rng.randint(0, SIZE), rng.randint(5, 12)
            col = tuple(int(c) for c in rng.randint(90, 180, 3))
            fill_ellipse(im, [dx - r, dy - r, dx + r, dy + r], col)
        for cx, cy in centers:
            w = rng.randint(26, 36)
            h = int(w * rng.uniform(0.85, 1.2))
            col = (int(rng.randint(190, 255)), int(rng.randint(20, 70)),
                   int(rng.randint(20, 70)))
            fill_rectangle(im, [cx - w // 2, cy - h // 2, cx + w // 2, cy + h // 2], col)
        write_png(os.path.join(img_dir, f"{i}.png"), im)

        # ---- heatmap stack ------------------------------------------------
        obj = np.zeros((SIZE, SIZE), np.float32)
        fg = np.zeros((SIZE, SIZE), np.float32)
        for cx, cy in centers:
            peak = 200.0 * rng.uniform(0.85, 1.15)
            if rng.rand() < p_dim:
                peak = rng.uniform(*dim_range)
            _blob(obj, cx + rng.normal(0, 1.5), cy + rng.normal(0, 1.5),
                  sigma=9.0 * rng.uniform(0.8, 1.2), peak=peak)
            _blob(fg, cx, cy, sigma=13.0, peak=peak * 0.9)
        if rng.rand() < p_spurious:
            _blob(obj, rng.uniform(8, SIZE - 8), rng.uniform(8, SIZE - 8),
                  sigma=8.0, peak=rng.uniform(*spur_range))
        bg_map = 220.0 - np.maximum(obj, fg)  # bg token fires away from cars
        stack = np.stack([obj, fg, 255.0 - bg_map], axis=-1)
        stack = stack * gain + bias + rng.normal(0, noise, stack.shape)
        write_png(os.path.join(stack_dir, f"{i}.png"), np.clip(stack, 0, 255).astype(np.uint8))

        # ---- COCO GT (42.36px fake boxes) ----------------------------------
        images.append({"id": i, "file_name": f"{i}.png", "width": SIZE, "height": SIZE})
        for cx, cy in centers:
            x = float(np.clip(cx - BOX / 2, 0, SIZE - 1))
            y = float(np.clip(cy - BOX / 2, 0, SIZE - 1))
            w = float(min(BOX, SIZE - x))
            h = float(min(BOX, SIZE - y))
            annotations.append({"id": len(annotations), "image_id": i,
                                "category_id": 1, "bbox": [x, y, w, h],
                                "area": w * h, "iscrowd": 0})

    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "small"}],
                   "images": images, "annotations": annotations}, f)
    return ann
