"""Target assigners with static shapes, batched over images.

Counterpart of ``agenda_tpu/detect/assign.py``.

``max_iou_assign`` (``:25-66``) is mmdet's MaxIoUAssigner: background
below ``neg_thr``, foreground from ``pos_thr``, and each valid GT's best
anchor rescued to the foreground when its IoU reaches ``min_pos_iou``. The
reference rescues in GT order in a loop, so when two GTs share a best
anchor the later one keeps it; here the rescue is one max-scatter of the GT
indices, which keeps the same, the highest index.

``random_sample`` (``:69-110``) is mmdet's RandomSampler as a randomised
top-k: the caller passes the two uniform vectors the reference draws
(``u_pos``, ``u_neg``), and the ranks are sorted as ``jnp.argsort`` sorts
them, stably. ``draw_uniforms`` draws them from a ``torch.Generator``.

``task_aligned_assign`` (``:113-177``) is YOLOv8's TAL: among the anchor
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
"""

from __future__ import annotations

from typing import Tuple

import torch

from agenda_tpu_torch.detect.ops import box_iou


@torch.no_grad()
def max_iou_assign(
    anchors: torch.Tensor,  # (N, 4) shared, or (B, N, 4)
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_valid: torch.Tensor,  # (B, G) bool
    pos_thr: float,
    neg_thr: float,
    min_pos_iou: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (assigned_gt (B, N) int64, -1 off the foreground; labels (B, N)
    int64: 0 background, 1 foreground, -1 ignored between the thresholds)."""
    b = gt_boxes.shape[0]
    if anchors.dim() == 2:
        anchors = anchors[None].expand(b, -1, -1)
    iou = box_iou(anchors, gt_boxes)  # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=2)
    labels = torch.full_like(best_gt, -1)
    labels = torch.where(best_iou < neg_thr, torch.zeros_like(labels), labels)
    labels = torch.where(best_iou >= pos_thr, torch.ones_like(labels), labels)

    # each valid GT's best anchor; a later GT overwrites an earlier one
    gt_best_iou, gt_best_anchor = iou.max(dim=1)  # (B, G)
    rescue = gt_valid & (gt_best_iou >= min_pos_iou)
    g_idx = torch.arange(gt_boxes.shape[1], device=labels.device).expand(b, -1)
    rescue_gt = torch.full_like(labels, -1).scatter_reduce(
        1, gt_best_anchor, torch.where(rescue, g_idx, torch.full_like(g_idx, -1)), "amax")
    rescued = rescue_gt >= 0
    labels = torch.where(rescued, torch.ones_like(labels), labels)
    assigned = torch.where(rescued, rescue_gt, best_gt)
    assigned = torch.where(labels == 1, assigned, torch.full_like(assigned, -1))
    return assigned, labels


@torch.no_grad()
def random_sample(labels: torch.Tensor, u_pos: torch.Tensor, u_neg: torch.Tensor, num: int,
                  pos_fraction: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """labels (B, N) {0, 1, -1}, u_pos and u_neg (B, N) uniform in [0, 1) ->
    (indices (B, num), is_pos (B, num), valid (B, num)): up to
    ``num * pos_fraction`` positives in random order, negatives for the rest
    and for the positives' unfilled slots (RandomSampler's top-up)."""
    pos_quota = int(num * pos_fraction)
    neg_one = torch.full_like(u_pos, -1.0)
    pos_rank = torch.where(labels == 1, u_pos, neg_one)
    pos_take = torch.argsort(-pos_rank, dim=1, stable=True)[:, :pos_quota]
    pos_take_valid = torch.gather(pos_rank, 1, pos_take) >= 0
    neg_rank = torch.where(labels == 0, u_neg, neg_one)
    neg_take = torch.argsort(-neg_rank, dim=1, stable=True)[:, :num]  # enough to top up
    fill_neg = num - pos_quota
    extra_negs = neg_take[:, fill_neg:fill_neg + pos_quota]
    idx = torch.cat([torch.where(pos_take_valid, pos_take, extra_negs), neg_take[:, :fill_neg]],
                    dim=1)
    is_pos = torch.cat([pos_take_valid, torch.zeros_like(neg_take[:, :fill_neg], dtype=torch.bool)],
                       dim=1)
    valid = torch.cat([pos_take_valid | (torch.gather(neg_rank, 1, extra_negs) >= 0),
                       torch.gather(neg_rank, 1, neg_take[:, :fill_neg]) >= 0], dim=1)
    return idx, is_pos, valid


def draw_uniforms(generator: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    """Uniforms in [0, 1) from ``generator`` (on its own device), on ``device``."""
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


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
