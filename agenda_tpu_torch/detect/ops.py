"""Detection ops on the device: IoU, greedy NMS batched over images, anchors.

Counterpart of ``agenda_tpu/detect/ops.py:29-89, 188-200``, with the same
static-shape semantics:

- ``nms_images`` runs greedy NMS for a whole batch of images at once: one
  stable descending sort, one (B, N, N) suppression mask, then one loop
  over the N ranks that carries every image's ``alive`` row (two kernels a
  rank, no host sync), and a static ``K = max_outputs`` output in which the
  invalid slots point at index 0 with ``valid=False``. The JAX package runs
  the same rank loop (a ``fori_loop``) under a ``vmap`` over the images.
- ``nms`` is one image of it; ``batched_nms`` is the per-class offset trick
  (torchvision's ``batched_nms``).
- ``anchor_points`` is the anchor-free grid of YOLOv8, in numpy as in JAX.

The box codecs, ``grid_anchors`` and ``roi_align`` serve Faster R-CNN and
are not ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_images(
    boxes: torch.Tensor,  # (B, N, 4) xyxy
    scores: torch.Tensor,  # (B, N)
    iou_threshold: float = 0.5,
    max_outputs: Optional[int] = None,
    score_threshold: float = -math.inf,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of every image of a batch -> (keep (B, K) int64, valid (B, K) bool).

    Rank r of an image kills every lower-ranked box whose IoU with it
    exceeds ``iou_threshold`` (strictly), if rank r is still alive. Ties in
    score keep their index order, as ``jnp.argsort`` does.
    """
    b, n = scores.shape
    k = max_outputs or n
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    scores_s = torch.gather(scores, 1, order)
    later = torch.ones(n, n, dtype=torch.bool, device=scores.device).triu_(1)
    # suppress[b, r] (as 0/1): the lower ranks that rank r kills if it lives
    suppress = ((box_iou(boxes_s, boxes_s) > iou_threshold) & later).to(scores.dtype)
    alive = (scores_s > score_threshold).to(scores.dtype)
    one = torch.ones((), dtype=alive.dtype, device=alive.device)
    for r in range(n):
        # alive *= 1 - suppress[:, r] * alive[:, r]; alive stays exactly 0 or 1
        alive.mul_(torch.addcmul(one, suppress[:, r], alive[:, r:r + 1], value=-1.0))
    rank_scores = torch.where(alive > 0, scores_s, torch.full_like(scores_s, -math.inf))
    top = torch.argsort(-rank_scores, dim=-1, stable=True)[:, :k]
    valid = torch.gather(rank_scores, 1, top) > -math.inf
    keep = torch.where(valid, torch.gather(order, 1, top), torch.zeros_like(top))
    return keep, valid


def nms(
    boxes: torch.Tensor,  # (N, 4) xyxy
    scores: torch.Tensor,  # (N,)
    iou_threshold: float = 0.5,
    max_outputs: Optional[int] = None,
    score_threshold: float = -math.inf,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of one image -> (keep (K,), valid (K,)); ``nms_images`` at B = 1."""
    keep, valid = nms_images(boxes[None], scores[None], iou_threshold, max_outputs,
                             score_threshold)
    return keep[0], valid[0]


def batched_nms(
    boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
    iou_threshold: float, max_outputs: int,
    score_threshold: float = -math.inf,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS via the coordinate-offset trick (torchvision batched_nms)."""
    offset = labels.to(boxes.dtype)[:, None] * (boxes.max() + 1.0)
    return nms(boxes + offset, scores, iou_threshold, max_outputs, score_threshold)


def anchor_points(feat_sizes: Sequence[Tuple[int, int]], strides: Sequence[int],
                  offset: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor-free center points: (sum(HW), 2) xy + (sum(HW),) strides."""
    pts, strs = [], []
    for (fh, fw), s in zip(feat_sizes, strides):
        xs = (np.arange(fw) + offset) * s
        ys = (np.arange(fh) + offset) * s
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.ravel(), gy.ravel()], axis=1))
        strs.append(np.full(fh * fw, s))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(strs).astype(np.float32))
