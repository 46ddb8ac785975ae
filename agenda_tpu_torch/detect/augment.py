"""Detection train-time augmentation on the host, in numpy, without Pillow.

Counterpart of ``agenda_tpu/detect/augment.py``: ``AugConfig`` and the
mix, plain, LSJ and stage-2 recipes; the HSV
pair and ``hsv_jitter``; ``to_gray``, ``box_blur_k``/``blur``,
``median_blur_k``/``median_blur`` (in uint8) and ``clahe``;
``random_affine`` with ``affine_matrix``, ``affine_inverse`` and
``affine_boxes``; ``mosaic`` and its regions; ``mixup``/``mixup_boxes``;
``flip_horizontal``; large-scale jitter (``lsj``, ``lsj_params``,
``lsj_boxes``), the ViTDet heatmap stage's recipe, which a YOLOv8 config
may name too. Every random draw is taken in the reference's order
from the caller's ``numpy.random.Generator``, so the same seed gives the
same boxes.

The reference warps and resizes with Pillow and runs its HSV pass and its
median in a native library. The machine that runs the port has neither, so:

- ``warp_affine_u8`` is Pillow's ``Image.transform(AFFINE, BILINEAR,
  fillcolor)``: the sample point at the output pixel's centre in double,
  a pixel outside the source (before the half-pixel shift) takes the fill,
  neighbours clamped to the edge, the lerps in double, then truncation to
  8 bits;
- ``resize_bilinear_pil`` is Pillow's 8-bit ``Image.resize(BILINEAR)``
  (the mixup and LSJ resizes), and ``resize_pil`` that or its BICUBIC over
  a batch of images (the refine classifier's crops): the filter
  coefficients in 22-bit fixed point, horizontal pass then vertical, each
  rounded half up to a level;
- ``hsv_apply`` and ``median_blur_k`` are the numpy formulas the reference
  keeps beside its native calls (``agenda_tpu/detect/augment.py:144-153,
  203-210``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np

PAD_VAL = 114.0
_PREC = 22  # Pillow's fixed-point bits for 8-bit resampling (32 - 8 - 2)


@dataclasses.dataclass
class AugConfig:
    """One stage's train-time augmentation recipe (serializes via asdict)."""

    # mosaic + affine + mixup block
    mosaic: bool = False
    affine_scale: float = 0.9        # scaling_ratio_range = 1 +- affine_scale
    max_rotate_degree: float = 0.0
    max_shear_degree: float = 0.0
    max_translate_ratio: float = 0.1
    mixup_prob: float = 0.0           # yolo: 0.1
    mixup_mosaic_pre: bool = False    # YOLOv5MixUp mixes in a mosaic'd sample
    # photometric block (Albu Blur / MedianBlur / ToGray / CLAHE, each p=0.01)
    blur_prob: float = 0.0
    median_blur_prob: float = 0.0
    to_gray_prob: float = 0.0
    clahe_prob: float = 0.0
    hsv: bool = False                 # no prob gate
    hue_delta: int = 5
    saturation_delta: int = 30
    value_delta: int = 30
    # geometric tail
    flip_prob: float = 0.5
    # LSJ (the ViTDet heatmap stage): flip, keep-ratio resize, crop, pad
    lsj: bool = False
    lsj_ratio_range: Tuple[float, float] = (0.1, 2.0)
    # stage 2 ("close mosaic"): RandomAffine on the single resized image
    standalone_affine: bool = False


def mix_stage_aug(mixup_prob: float = 1.0, mixup_mosaic_pre: bool = False) -> AugConfig:
    """The heavy mosaic pipeline (the yolo families' recipe in every stage)."""
    return AugConfig(
        mosaic=True, affine_scale=0.9, mixup_prob=mixup_prob,
        mixup_mosaic_pre=mixup_mosaic_pre,
        blur_prob=0.01, median_blur_prob=0.01, to_gray_prob=0.01,
        clahe_prob=0.01, hsv=True, flip_prob=0.5,
    )


def plain_aug() -> AugConfig:
    """resize + flip only."""
    return AugConfig(flip_prob=0.5)


def lsj_aug() -> AugConfig:
    """Large-scale jitter (the ViTDet heatmap stage's base recipe)."""
    return AugConfig(lsj=True, flip_prob=0.5)


def stage2_aug(a: AugConfig) -> AugConfig:
    """The mosaic-close recipe of a mix recipe: Mosaic and MixUp drop out,
    the RandomAffine stays on the single image, the photometric tail is
    unchanged."""
    return dataclasses.replace(a, mosaic=False, mixup_prob=0.0, lsj=False,
                               standalone_affine=True)


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------


def _rgb_to_hsv_cv(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RGB (0..255 float) -> OpenCV-convention HSV: h in [0,180), s/v in [0,255]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    diff = mx - mn
    safe = np.where(diff > 0, diff, 1.0)
    h = np.zeros_like(mx)
    h = np.where(mx == r, (g - b) / safe % 6.0, h)
    h = np.where(mx == g, (b - r) / safe + 2.0, h)
    h = np.where(mx == b, (r - g) / safe + 4.0, h)
    h = (h * 30.0) % 180.0
    s = np.where(mx > 0, diff / np.maximum(mx, 1e-9) * 255.0, 0.0)
    return h, s, mx


# channel order of (c, x, 0) in each of the six hue sectors
_SECTORS = np.array([[0, 1, 2], [1, 0, 2], [2, 0, 1], [2, 1, 0], [1, 2, 0], [0, 2, 1]])


def _hsv_cv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    h6 = (h / 30.0) % 6.0
    s1 = s / 255.0
    c = v * s1
    x = c * (1.0 - np.abs(h6 % 2.0 - 1.0))
    m = v - c
    sector = np.minimum(h6.astype(np.int32), 5)
    cx0 = np.stack([c, x, np.zeros_like(c)], axis=-1)
    return np.take_along_axis(cx0, _SECTORS[sector], axis=-1) + m[..., None]


def hsv_apply(img: np.ndarray, gains) -> np.ndarray:
    """Apply fixed HSV gains: h wraps mod 180, s and v clip to 0..255."""
    h, s, v = _rgb_to_hsv_cv(img)
    h = (h + gains[0]) % 180.0
    s = np.clip(s + gains[1], 0, 255)
    v = np.clip(v + gains[2], 0, 255)
    return np.clip(_hsv_cv_to_rgb(h, s, v), 0, 255).astype(np.float32)


def hsv_jitter(img: np.ndarray, rng: np.random.Generator,
               hue_delta: int = 5, saturation_delta: int = 30,
               value_delta: int = 30) -> np.ndarray:
    """YOLOXHSVRandomAug: uniform gains on the cv2-convention HSV channels."""
    gains = rng.uniform(-1, 1, 3) * np.array(
        [hue_delta, saturation_delta, value_delta], np.float32
    )
    return hsv_apply(img, gains)


def to_gray(img: np.ndarray) -> np.ndarray:
    """Albu ToGray: ITU-R 601 luma replicated to 3 channels."""
    y = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.repeat(y[..., None], 3, axis=-1).astype(np.float32)


def _odd_kernel(rng: np.random.Generator, lo: int = 3, hi: int = 7) -> int:
    return int(rng.integers(lo // 2, hi // 2 + 1)) * 2 + 1


def box_blur_k(img: np.ndarray, k: int) -> np.ndarray:
    """Box filter with a fixed odd kernel, reflect borders."""
    p = k // 2
    padded = np.pad(img, ((p, p), (p, p), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            out += padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return (out / (k * k)).astype(np.float32)


def median_blur_k(img: np.ndarray, k: int) -> np.ndarray:
    """Median filter with a fixed odd kernel, reflect borders, over the image
    quantized to uint8 (Albu's MedianBlur runs cv2 on the uint8 image)."""
    q = np.clip(np.rint(np.asarray(img, np.float32)), 0, 255).astype(np.uint8)
    p = k // 2
    padded = np.pad(q, ((p, p), (p, p), (0, 0)), mode="reflect")
    windows = np.stack(
        [padded[dy : dy + img.shape[0], dx : dx + img.shape[1]]
         for dy in range(k) for dx in range(k)],
        axis=0,
    )
    return np.median(windows, axis=0).astype(np.float32)


def blur(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Albu Blur: box filter, odd kernel in [3,7]."""
    return box_blur_k(img, _odd_kernel(rng))


def median_blur(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Albu MedianBlur: odd kernel in [3,7]."""
    return median_blur_k(img, _odd_kernel(rng))


def clahe(img: np.ndarray, clip_limit: float = 4.0,
          grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """CLAHE on the luma channel, RGB rescaled by the luma gain (the
    reference's approximation of Albu's LAB-L CLAHE)."""
    h, w = img.shape[:2]
    y = np.clip(0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2], 0, 255)
    yi = y.astype(np.uint8)
    gh, gw = grid
    ys = np.linspace(0, h, gh + 1).astype(int)
    xs = np.linspace(0, w, gw + 1).astype(int)
    luts = np.zeros((gh, gw, 256), np.float32)
    for i in range(gh):
        for j in range(gw):
            tile = yi[ys[i] : ys[i + 1], xs[j] : xs[j + 1]]
            hist = np.bincount(tile.ravel(), minlength=256).astype(np.float32)
            n = tile.size
            clip = max(1.0, clip_limit * n / 256.0)
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = np.cumsum(hist)
            luts[i, j] = cdf / max(cdf[-1], 1.0) * 255.0
    # bilinear interpolation between the 4 surrounding tile LUTs
    cy = (ys[:-1] + ys[1:]) / 2.0
    cx = (xs[:-1] + xs[1:]) / 2.0
    py = np.interp(np.arange(h), cy, np.arange(gh))
    px = np.interp(np.arange(w), cx, np.arange(gw))
    y0 = np.floor(py).astype(int)
    x0 = np.floor(px).astype(int)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (py - y0)[:, None]
    fx = (px - x0)[None, :]
    idx = yi
    v00 = luts[y0[:, None], x0[None, :], idx]
    v01 = luts[y0[:, None], x1[None, :], idx]
    v10 = luts[y1[:, None], x0[None, :], idx]
    v11 = luts[y1[:, None], x1[None, :], idx]
    y_eq = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)
    gain = y_eq / np.maximum(y, 1e-3)
    return np.clip(img * gain[..., None], 0, 255).astype(np.float32)


# ---------------------------------------------------------------------------
# Pillow's 8-bit geometry
# ---------------------------------------------------------------------------


def warp_affine_u8(img: np.ndarray, inv: np.ndarray, out_size: Tuple[int, int],
                   fill: int = int(PAD_VAL)) -> np.ndarray:
    """uint8 (h, w, 3) through the output->input affine ``inv`` (3x3) ->
    uint8 (out_h, out_w, 3), as Pillow's ``transform(AFFINE, BILINEAR,
    fillcolor=(fill,) * 3)``.

    Without rotation or shear (the recipes' default) the source x of an
    output pixel depends on its column only and y on its row only, so the
    row lerps are taken once a row: the same double operations in the same
    order as the general path, a third of its gathers.
    """
    out_w, out_h = out_size
    h, w = img.shape[:2]
    a0, a1, a2 = (float(v) for v in inv[0])
    a3, a4, a5 = (float(v) for v in inv[1])
    xs = np.arange(out_w, dtype=np.float64)[None, :] + 0.5
    ys = np.arange(out_h, dtype=np.float64)[:, None] + 0.5
    separable = a1 == 0.0 and a3 == 0.0
    if separable:  # a1 * y and a3 * x are +-0, which leave the sums exact
        sx, sy = a0 * xs + a2, a4 * ys + a5
    else:
        sx, sy = a0 * xs + a1 * ys + a2, a3 * xs + a4 * ys + a5
    inside = (sx >= 0.0) & (sx < w) & (sy >= 0.0) & (sy < h)
    sx, sy = sx - 0.5, sy - 0.5
    fx, fy = np.floor(sx), np.floor(sy)
    dx, dy = (sx - fx)[..., None], (sy - fy)[..., None]
    x0 = np.clip(fx, -1, w).astype(np.int64)  # clipped first: far-off points are huge
    y0 = np.clip(fy, -1, h).astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    src = img.astype(np.float64)
    if separable:
        xa, xb, dx = xa[0], xb[0], dx[0]

        def lerp_x(rows):  # rows (out_h, 1) -> (out_h, out_w, 3)
            s = src[rows[:, 0]]
            left = s[:, xa]
            return left + (s[:, xb] - left) * dx
    else:
        def lerp_x(rows):
            left = src[rows, xa]
            return left + (src[rows, xb] - left) * dx
    top = lerp_x(ya)
    # Pillow reuses the top row when the row below lies outside the image
    bottom = np.where(((y0 + 1 >= 0) & (y0 + 1 < h))[..., None], lerp_x(yb), top)
    out = (top + (bottom - top) * dy).astype(np.uint8)  # in [0, 255]: Pillow's truncation
    out[~np.broadcast_to(inside, (out_h, out_w))] = fill
    return out


def _triangle(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def _keys_cubic(x: float) -> float:
    """Pillow's ``bicubic_filter`` (a = -0.5), in its order of operations."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_PIL_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_keys_cubic, 2.0)}


def _pil_coeffs(in_size: int, out_size: int,
                filt: str = "bilinear") -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``filt`` filter (bilinear or bicubic) as (starts (out,), int64
    coefficients (out, ksize)) in 22-bit fixed point (``precompute_coeffs`` +
    ``normalize_coeffs_8bpc``: each coefficient rounded half away from 0)."""
    fn, filter_support = _PIL_FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    starts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(n)]
        total = 0.0
        for v in ws:
            total += v
        for x, v in enumerate(ws):
            k = v / total if total != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << _PREC)) if k < 0 else int(0.5 + k * (1 << _PREC))
        starts[xx] = xmin
    return starts, kk


@functools.lru_cache(maxsize=256)
def _pil_matrix(in_size: int, out_size: int, filt: str) -> np.ndarray:
    """``_pil_coeffs`` as a dense (in_size, out_size) float64 matrix (read-only:
    the cache shares it)."""
    starts, kk = _pil_coeffs(in_size, out_size, filt)
    rows = starts[:, None] + np.arange(kk.shape[1])[None, :]
    cols = np.broadcast_to(np.arange(out_size)[:, None], rows.shape)
    used = kk != 0
    mat = np.zeros((in_size, out_size), np.float64)
    mat[rows[used], cols[used]] = kk[used]
    mat.flags.writeable = False
    return mat


def _pil_pass(x: np.ndarray, in_size: int, out_size: int, axis: int,
              filt: str = "bilinear") -> np.ndarray:
    """One of Pillow's passes along ``axis`` of ``x`` (integer levels, any
    dtype), rounded and clipped to [0, 255], as float64. The taps run as one
    float64 matrix product: every product and partial sum is an integer
    below 2^53, so the sums are exact in any order, and the rounding
    ``(acc + 2^21) >> 22`` is exact as a floor of a power-of-two scaling."""
    xm = np.moveaxis(x, axis, -1)
    acc = xm.reshape(-1, in_size).astype(np.float64) @ _pil_matrix(in_size, out_size, filt)
    acc += float(1 << (_PREC - 1))
    acc *= 1.0 / (1 << _PREC)
    np.floor(acc, out=acc)
    np.clip(acc, 0.0, 255.0, out=acc)
    return np.moveaxis(acc.reshape(xm.shape[:-1] + (out_size,)), -1, axis)


def resize_pil(img: np.ndarray, out_w: int, out_h: int, filt: str = "bilinear") -> np.ndarray:
    """uint8 (..., h, w, 3) -> uint8 (..., out_h, out_w, 3), as Pillow's
    ``Image.resize((out_w, out_h), filt)`` on each 8-bit RGB image
    (``filt`` "bilinear" or "bicubic", Pillow's default)."""
    h, w = img.shape[-3:-1]
    x = img
    if out_w != w:
        x = _pil_pass(x, w, out_w, x.ndim - 2, filt)
    if out_h != h:
        x = _pil_pass(x, h, out_h, x.ndim - 3, filt)
    return x.astype(np.uint8)


def resize_bilinear_pil(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 (h, w, 3) -> uint8 (out_h, out_w, 3), as Pillow's
    ``Image.resize((out_w, out_h), BILINEAR)`` on an 8-bit RGB image."""
    return resize_pil(img, out_w, out_h, "bilinear")


def _to_u8(img: np.ndarray) -> np.ndarray:
    """The reference's ``np.clip(img, 0, 255).astype(np.uint8)`` (truncation)."""
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def random_affine(
    img: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    out_size: Tuple[int, int],
    max_rotate_degree: float = 0.0,
    max_shear_degree: float = 0.0,
    scaling_ratio_range: Tuple[float, float] = (0.1, 1.9),
    max_translate_ratio: float = 0.1,
    border_val: float = PAD_VAL,
    min_bbox_size: float = 2.0,
    max_aspect_ratio: float = 20.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """mm RandomAffine: rotate/shear about the input centre, uniform scale,
    translation jitter; boxes projected by their 4 corners, clipped, then
    filtered by min size and aspect ratio."""
    in_h, in_w = img.shape[:2]
    m = affine_matrix(rng, (in_w, in_h), out_size,
                      max_rotate_degree=max_rotate_degree,
                      max_shear_degree=max_shear_degree,
                      scaling_ratio_range=scaling_ratio_range,
                      max_translate_ratio=max_translate_ratio)
    warped = warp_affine_u8(_to_u8(img), affine_inverse(m), out_size, int(border_val))
    return (warped.astype(np.float32),
            affine_boxes(boxes, m, out_size, min_bbox_size, max_aspect_ratio))


def affine_matrix(rng, in_size, out_size, max_rotate_degree=0.0,
                  max_shear_degree=0.0, scaling_ratio_range=(0.1, 1.9),
                  max_translate_ratio=0.1) -> np.ndarray:
    """Draw the mm RandomAffine input->output matrix (draws in the
    reference's order: rotate, scale, shear x/y, translate x/y)."""
    in_w, in_h = in_size
    out_w, out_h = out_size
    theta = math.radians(rng.uniform(-max_rotate_degree, max_rotate_degree))
    scale = rng.uniform(*scaling_ratio_range)
    shear_x = math.tan(math.radians(rng.uniform(-max_shear_degree, max_shear_degree)))
    shear_y = math.tan(math.radians(rng.uniform(-max_shear_degree, max_shear_degree)))
    tx = rng.uniform(-max_translate_ratio, max_translate_ratio) * out_w
    ty = rng.uniform(-max_translate_ratio, max_translate_ratio) * out_h
    # closed form of center_out @ shear @ rotate @ scale @ center_in
    ct, st = math.cos(theta) * scale, math.sin(theta) * scale
    b00, b01 = ct + shear_x * st, -st + shear_x * ct
    b10, b11 = shear_y * ct + st, -shear_y * st + ct
    cx_i, cy_i = in_w / 2.0, in_h / 2.0
    ox, oy = out_w / 2.0 + tx, out_h / 2.0 + ty
    return np.array([
        [b00, b01, -b00 * cx_i - b01 * cy_i + ox],
        [b10, b11, -b10 * cx_i - b11 * cy_i + oy],
        [0.0, 0.0, 1.0],
    ], np.float64)  # input -> output


def affine_inverse(m: np.ndarray) -> np.ndarray:
    """Closed-form inverse of a 2D affine [[a,b,c],[d,e,f],[0,0,1]]."""
    a, b, c = float(m[0, 0]), float(m[0, 1]), float(m[0, 2])
    d, e, f = float(m[1, 0]), float(m[1, 1]), float(m[1, 2])
    det = a * e - b * d
    return np.array([
        [e / det, -b / det, (b * f - c * e) / det],
        [-d / det, a / det, (c * d - a * f) / det],
        [0.0, 0.0, 1.0],
    ], np.float64)


def affine_boxes(boxes: np.ndarray, m: np.ndarray, out_size,
                 min_bbox_size: float = 2.0,
                 max_aspect_ratio: float = 20.0) -> np.ndarray:
    """Project boxes by their 4 corners through ``m``, clip to the output,
    filter by min size and aspect ratio."""
    out_w, out_h = out_size
    if len(boxes) == 0:
        return boxes
    corners = np.stack([
        boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]], boxes[:, [2, 3]]
    ], axis=1)  # (N, 4, 2)
    pts = corners @ m[:2, :2].T + m[:2, 2]
    new = np.concatenate([pts.min(axis=1), pts.max(axis=1)], axis=-1).astype(np.float32)
    new = new.clip(np.zeros(4, np.float32),
                   np.array([out_w, out_h, out_w, out_h], np.float32))
    w = new[:, 2] - new[:, 0]
    h = new[:, 3] - new[:, 1]
    ar = np.maximum(w / np.maximum(h, 1e-6), h / np.maximum(w, 1e-6))
    keep = (w > min_bbox_size) & (h > min_bbox_size) & (ar <= max_aspect_ratio)
    return new[keep]


def mosaic(
    load_fn,
    index: int,
    n_total: int,
    rng: np.random.Generator,
    img_scale: Tuple[int, int],
    pad_val: float = PAD_VAL,
) -> Tuple[np.ndarray, np.ndarray]:
    """mm Mosaic: 2x canvas filled with pad_val, random centre in
    [0.5, 1.5] x img_scale, 4 images packed against the centre.
    ``load_fn(i)`` -> (img, boxes) at img_scale."""
    out_w, out_h = img_scale
    canvas = np.full((out_h * 2, out_w * 2, 3), pad_val, np.float32)
    cx = int(rng.uniform(0.5 * out_w, 1.5 * out_w))
    cy = int(rng.uniform(0.5 * out_h, 1.5 * out_h))
    idxs = [index] + [int(rng.integers(n_total)) for _ in range(3)]
    regions, anchors = mosaic_regions(cx, cy, out_w, out_h)
    all_boxes = []
    for k, ((x1, y1, x2, y2), (ax, ay)) in enumerate(zip(regions, anchors)):
        img, boxes = load_fn(idxs[k])
        rw, rh = x2 - x1, y2 - y1
        if rw <= 0 or rh <= 0:
            continue
        # the image region adjacent to the centre
        sx = out_w - rw if ax else 0
        sy = out_h - rh if ay else 0
        canvas[y1:y2, x1:x2] = img[sy : sy + rh, sx : sx + rw]
        b = mosaic_region_boxes(boxes, (x1, y1, x2, y2), (sx, sy))
        if len(b):
            all_boxes.append(b)
    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    return canvas, boxes


def mosaic_regions(cx, cy, out_w, out_h):
    """Canvas extents and image-corner anchors of the 4 quadrants (TL, TR, BL, BR)."""
    regions = [
        (max(cx - out_w, 0), max(cy - out_h, 0), cx, cy),
        (cx, max(cy - out_h, 0), min(cx + out_w, out_w * 2), cy),
        (max(cx - out_w, 0), cy, cx, min(cy + out_h, out_h * 2)),
        (cx, cy, min(cx + out_w, out_w * 2), min(cy + out_h, out_h * 2)),
    ]
    anchors = [(1, 1), (0, 1), (1, 0), (0, 0)]
    return regions, anchors


def mosaic_region_boxes(boxes: np.ndarray, region, src_offset) -> np.ndarray:
    """Shift one tile's boxes onto the canvas, clip to the region, drop
    slivers (<= 1 px)."""
    if not len(boxes):
        return np.zeros((0, 4), np.float32)
    x1, y1, x2, y2 = region
    sx, sy = src_offset
    b = boxes + np.array([x1 - sx, y1 - sy, x1 - sx, y1 - sy], np.float32)
    b = b.clip(np.array([x1, y1, x1, y1], np.float32),
               np.array([x2, y2, x2, y2], np.float32))
    ok = (b[:, 2] - b[:, 0] > 1) & (b[:, 3] - b[:, 1] > 1)
    return b[ok]


def mixup(
    img: np.ndarray,
    boxes: np.ndarray,
    img2: np.ndarray,
    boxes2: np.ndarray,
    rng: np.random.Generator,
    ratio_range: Tuple[float, float] = (0.5, 1.5),
    flip_ratio: float = 0.5,
    pad_val: float = PAD_VAL,
) -> Tuple[np.ndarray, np.ndarray]:
    """YOLOX-style MixUp: the retrieved image jitter-resized, optionally
    flipped, pasted on a pad_val canvas of the primary size, blended
    0.5/0.5, and the GT sets concatenated."""
    h, w = img.shape[:2]
    jit = rng.uniform(*ratio_range)
    scale = min(h / img2.shape[0], w / img2.shape[1]) * jit
    nw, nh = max(1, int(img2.shape[1] * scale)), max(1, int(img2.shape[0] * scale))
    resized = resize_bilinear_pil(_to_u8(img2), nw, nh).astype(np.float32)
    flipped = rng.random() < flip_ratio
    if flipped:
        resized = resized[:, ::-1]
    canvas = np.full((h, w, 3), pad_val, np.float32)
    ch, cw = min(nh, h), min(nw, w)
    canvas[:ch, :cw] = resized[:ch, :cw]
    b2 = mixup_boxes(boxes2, scale, nw, flipped, cw, ch)
    mixed = (img * 0.5 + canvas * 0.5).astype(np.float32)
    out_boxes = np.concatenate([boxes, b2]) if len(b2) else boxes
    return mixed, out_boxes


def mixup_boxes(boxes2: np.ndarray, scale: float, nw: int, flipped: bool,
                cw: int, ch: int) -> np.ndarray:
    """The retrieved sample's boxes through MixUp: scale, optional flip
    within the resized width, clip to the pasted region, drop slivers."""
    if not len(boxes2):
        return np.zeros((0, 4), np.float32)
    b2 = boxes2 * scale
    if flipped:
        b2 = np.stack([nw - b2[:, 2], b2[:, 1], nw - b2[:, 0], b2[:, 3]], axis=1)
    b2 = b2.copy()
    b2[:, 0::2] = b2[:, 0::2].clip(0, cw)
    b2[:, 1::2] = b2[:, 1::2].clip(0, ch)
    ok = (b2[:, 2] - b2[:, 0] > 1) & (b2[:, 3] - b2[:, 1] > 1)
    return b2[ok]


def lsj_params(rng: np.random.Generator, in_hw: Tuple[int, int], out_size: Tuple[int, int],
               ratio_range: Tuple[float, float] = (0.1, 2.0)) -> Tuple[float, int, int, int, int]:
    """LSJ's draws and geometry -> (scale, nw, nh, x0, y0): the ratio, then
    the crop's x0 and y0 (the host render and the device planner share it)."""
    out_w, out_h = out_size
    h, w = in_hw
    ratio = rng.uniform(*ratio_range)
    scale = min(out_h / h, out_w / w) * ratio
    nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
    x0 = int(rng.integers(0, max(1, nw - out_w + 1)))
    y0 = int(rng.integers(0, max(1, nh - out_h + 1)))
    return scale, nw, nh, x0, y0


def lsj_boxes(boxes: np.ndarray, scale: float, nw: int, nh: int, x0: int, y0: int,
              out_size: Tuple[int, int]) -> np.ndarray:
    """LSJ's boxes: scale, shift by the crop, clip to the cropped extent,
    drop boxes of 1e-2 px or less (FilterAnnotations)."""
    out_w, out_h = out_size
    if not len(boxes):
        return boxes
    boxes = boxes * scale
    boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
    cw, ch = min(nw - x0, out_w), min(nh - y0, out_h)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
    keep = (boxes[:, 2] - boxes[:, 0] > 1e-2) & (boxes[:, 3] - boxes[:, 1] > 1e-2)
    return boxes[keep]


def lsj(img: np.ndarray, boxes: np.ndarray, rng: np.random.Generator,
        out_size: Tuple[int, int], ratio_range: Tuple[float, float] = (0.1, 2.0),
        pad_val: float = PAD_VAL) -> Tuple[np.ndarray, np.ndarray]:
    """Large-scale jitter: keep-ratio resize by a ratio in ``ratio_range``
    (Pillow's 8-bit BILINEAR), a crop of ``out_size`` at a random corner,
    the boxes filtered, pad_val padding on the bottom and right."""
    out_w, out_h = out_size
    scale, nw, nh, x0, y0 = lsj_params(rng, img.shape[:2], out_size, ratio_range)
    img = resize_bilinear_pil(_to_u8(img), nw, nh).astype(np.float32)
    boxes = lsj_boxes(boxes, scale, nw, nh, x0, y0, out_size)
    img = img[y0:y0 + out_h, x0:x0 + out_w]
    if img.shape[0] != out_h or img.shape[1] != out_w:
        canvas = np.full((out_h, out_w, 3), pad_val, np.float32)
        canvas[:img.shape[0], :img.shape[1]] = img
        img = canvas
    return img, boxes


def flip_horizontal(img: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    w = img.shape[1]
    img = img[:, ::-1]
    if len(boxes):
        boxes = np.stack([w - boxes[:, 2], boxes[:, 1], w - boxes[:, 0], boxes[:, 3]], axis=1)
    return np.ascontiguousarray(img), boxes
