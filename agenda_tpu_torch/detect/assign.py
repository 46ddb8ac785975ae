"""YOLOv8's task-aligned assigner (TAL), batched over images.

Counterpart of ``agenda_tpu/detect/assign.py:113-177``: among the anchor
points inside a GT box, each GT takes its top-k points by the alignment
metric s^alpha * iou^beta; a point claimed by several GTs goes to the one
of highest IoU; target scores are the metric normalised per GT by its
largest IoU. GT arrives padded to a fixed ``max_gt`` with a validity mask.
The reference runs one image under ``vmap``; here every image of the batch
is one tensor op.

Ties follow the reference: ``jax.lax.top_k`` keeps the lower index among
equal values, and so does the stable descending sort that takes the top k
here (``torch.topk`` promises no order among ties, which are common: mirror
points about a box centre have equal IoU, and a fresh head scores every
point alike); ``argmax`` takes the first maximum in both.
``max_iou_assign`` and ``random_sample`` serve Faster R-CNN and are not
ported (ROADMAP.md §A).
"""

from __future__ import annotations

from typing import Tuple

import torch

from agenda_tpu_torch.detect.ops import box_iou


@torch.no_grad()
def task_aligned_assign(
    scores: torch.Tensor,  # (B, N, C) predicted class probabilities
    pred_boxes: torch.Tensor,  # (B, N, 4) decoded xyxy
    points: torch.Tensor,  # (N, 2) anchor centres
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_labels: torch.Tensor,  # (B, G) int64
    gt_valid: torch.Tensor,  # (B, G) bool
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (fg_mask (B, N) bool, assigned_gt (B, N) int64, target_scores
    (B, N), assigned_labels (B, N) int64, -1 off the foreground)."""
    px, py = points[None, :, None, 0], points[None, :, None, 1]
    inside = ((px >= gt_boxes[:, None, :, 0]) & (px <= gt_boxes[:, None, :, 2])
              & (py >= gt_boxes[:, None, :, 1]) & (py <= gt_boxes[:, None, :, 3])
              & gt_valid[:, None, :])  # (B, N, G)

    iou = box_iou(pred_boxes, gt_boxes)  # (B, N, G)
    # the score of each GT's class at each point
    cls_score = torch.gather(scores, 2, gt_labels[:, None, :].expand(-1, scores.shape[1], -1))
    metric = cls_score.pow(alpha) * iou.pow(beta)
    metric = torch.where(inside, metric, torch.zeros_like(metric))

    # per-GT top-k points, lower index first among equal metrics
    ranked, order = torch.sort(metric.transpose(1, 2), dim=-1, descending=True, stable=True)
    cand = torch.zeros_like(inside.transpose(1, 2))  # (B, G, N)
    cand.scatter_(2, order[..., :topk], ranked[..., :topk] > 0)
    cand = cand.transpose(1, 2) & inside

    # a point claimed by several GTs goes to the one of highest IoU
    claimed = cand.sum(dim=2)
    best_gt = torch.argmax(torch.where(cand, iou, torch.full_like(iou, -1.0)), dim=2)
    fg_mask = claimed > 0
    assigned_gt = torch.where(fg_mask, best_gt, torch.zeros_like(best_gt))

    pair_metric = torch.where(cand, metric, torch.zeros_like(metric))
    per_gt_max_metric = pair_metric.amax(dim=1) + 1e-9  # (B, G)
    per_gt_max_iou = torch.where(cand, iou, torch.zeros_like(iou)).amax(dim=1)
    norm_metric = pair_metric * (per_gt_max_iou / per_gt_max_metric)[:, None, :]
    target_scores = torch.gather(norm_metric, 2, assigned_gt[..., None])[..., 0]
    target_scores = torch.where(fg_mask, target_scores, torch.zeros_like(target_scores))
    picked = torch.gather(gt_labels, 1, assigned_gt)
    assigned_labels = torch.where(fg_mask, picked, torch.full_like(picked, -1))
    return fg_mask, assigned_gt, target_scores, assigned_labels
