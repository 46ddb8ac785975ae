"""Detection losses of the YOLOv8 head: BCE, the CIoU pieces and DFL.

Counterpart of ``agenda_tpu/detect/losses.py:29-101`` (``bce_with_logits``,
``pairwise_iou_terms``, ``ciou``, ``dfl_loss``), elementwise over any
leading shape, with the same formulas and epsilons. CIoU's ``alpha`` is
computed without gradient, as the reference's ``stop_gradient``.
``sigmoid_focal_loss``, ``smooth_l1`` and ``giou`` serve Faster R-CNN and
are not ported (ROADMAP.md §A).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _box_wh(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0), (b[..., 3] - b[..., 1]).clamp(min=0)


def pairwise_iou_terms(pred: torch.Tensor, target: torch.Tensor):
    """Elementwise (aligned) IoU pieces for boxes (..., 4) xyxy -> (iou, union)."""
    pw, ph = _box_wh(pred)
    tw, th = _box_wh(target)
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = pw * ph + tw * th - inter + 1e-7
    return inter / union, union


def ciou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Complete IoU of aligned boxes."""
    iou, _ = pairwise_iou_terms(pred, target)
    # enclosing box diagonal
    lt = torch.minimum(pred[..., :2], target[..., :2])
    rb = torch.maximum(pred[..., 2:], target[..., 2:])
    cwh = (rb - lt).clamp(min=0)
    c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + 1e-7
    # centre distance
    pc = (pred[..., :2] + pred[..., 2:]) / 2
    tc = (target[..., :2] + target[..., 2:]) / 2
    rho2 = torch.sum((pc - tc) ** 2, dim=-1)
    # aspect term
    pw, ph = _box_wh(pred)
    tw, th = _box_wh(target)
    v = (4 / math.pi**2) * (torch.atan(tw / (th + 1e-7)) - torch.atan(pw / (ph + 1e-7))) ** 2
    with torch.no_grad():
        alpha = v / (1 - iou + v + 1e-7)
    return iou - rho2 / c2 - alpha * v


def dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss over (..., reg_max+1) bin logits; target in
    [0, reg_max], continuous."""
    tl = torch.floor(target).clamp(0, reg_max - 1)
    tr = tl + 1
    wl = tr - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ll = torch.gather(logp, -1, tl.long()[..., None])[..., 0]
    lr = torch.gather(logp, -1, tr.long()[..., None])[..., 0]
    return -(ll * wl + lr * wr)
