"""Box math for the pseudo-annotation chain (vectorized numpy).

The reference's "fake box" convention: every vehicle is annotated with a
fixed 42.36-px square centered on the detection; boxes whose center falls
within ``margin = 42.36/2 - 1`` px of an image edge were trimmed by the crop,
so the full square is reconstructed by extending past the edge from the
intact side before re-centering and clipping ("edge completion").

Two clip variants exist in the reference and both are kept bit-exact:

- ``mode="extend"``: reconstruct the full square beyond the edge then clip to
  ``[0, size-1]`` — used by the label refiner (``refine_label.py:58-111``)
  and the pseudo-annotation notebook (ConvertPredToCOCOPseudoAnnotations
  cell 6).
- ``mode="clamp"``: snap the trimmed side to the image border (0 or size)
  then clip to ``[0, size]`` — used by ``Data/utils/ConvertPseudoAnn.py:36-63``.

The port's copy of ``agenda_tpu/annotate/boxes.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def complete_edge_boxes(
    boxes_xyxy: np.ndarray,  # (N, 4) l, t, r, b
    image_size: Tuple[int, int] = (112, 112),
    box_size: float = 42.36,
    mode: str = "extend",
) -> np.ndarray:
    """Edge-complete and square-ify boxes. Returns (N, 4) xyxy."""
    if len(boxes_xyxy) == 0:
        return np.zeros((0, 4), np.float64)
    b = np.asarray(boxes_xyxy, np.float64)
    l, t, r, bt = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    w, h = float(image_size[0]), float(image_size[1])
    margin = box_size / 2 - 1

    xc = (l + r) / 2
    yc = (t + bt) / 2

    left = xc < margin
    right = xc > w - margin
    top = yc < margin
    bottom = yc > h - margin

    if mode == "extend":
        l_full = np.where(left, r - box_size, l)
        r_full = np.where(left, r, np.where(right, l + box_size, r))
        t_full = np.where(top, bt - box_size, t)
        b_full = np.where(top, bt, np.where(bottom, t + box_size, bt))
        hi_x, hi_y = w - 1, h - 1
    elif mode == "clamp":
        l_full = np.where(left, 0.0, l)
        r_full = np.where(left, r, np.where(right, w, r))
        t_full = np.where(top, 0.0, t)
        b_full = np.where(top, bt, np.where(bottom, h, bt))
        hi_x, hi_y = w, h
    else:
        raise ValueError(f"Unknown mode {mode}")

    xcf = (l_full + r_full) / 2
    ycf = (t_full + b_full) / 2

    out = np.stack(
        [
            np.maximum(0.0, xcf - box_size / 2),
            np.maximum(0.0, ycf - box_size / 2),
            np.minimum(xcf + box_size / 2, hi_x),
            np.minimum(ycf + box_size / 2, hi_y),
        ],
        axis=1,
    )
    return out


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two [l,t,r,b] boxes (area = exact rectangle area, shapely-equal)."""
    xa, ya = max(a[0], b[0]), max(a[1], b[1])
    xb, yb = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def iou_xywh(a, b) -> float:
    """IoU of two [x,y,w,h] boxes (Data/utils/EvaluatePseudoAnn.py:49-61)."""
    ax2, ay2 = a[0] + a[2], a[1] + a[3]
    bx2, by2 = b[0] + b[2], b[1] + b[3]
    xa, ya = max(a[0], b[0]), max(a[1], b[1])
    xb, yb = min(ax2, bx2), min(ay2, by2)
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def iou_matrix_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) -> (N,M) IoU matrix, vectorized."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    a = np.asarray(a, np.float64)[:, None, :]
    b = np.asarray(b, np.float64)[None, :, :]
    xa = np.maximum(a[..., 0], b[..., 0])
    ya = np.maximum(a[..., 1], b[..., 1])
    xb = np.minimum(a[..., 2], b[..., 2])
    yb = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(xb - xa, 0, None) * np.clip(yb - ya, 0, None)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return np.where(union > 0, inter / union, 0.0)
