"""Detection losses: focal and BCE, smooth L1, the IoU family, DFL.

Counterpart of ``agenda_tpu/detect/losses.py`` (``sigmoid_focal_loss``,
``bce_with_logits``, ``smooth_l1``, ``pairwise_iou_terms``, ``ciou``,
``giou``, ``dfl_loss``), elementwise over any leading shape, with the same
formulas and epsilons. CIoU's ``alpha`` is computed without gradient, as
the reference's ``stop_gradient``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss (RetinaNet form)."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


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


def giou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of aligned boxes."""
    iou, union = pairwise_iou_terms(pred, target)
    lt = torch.minimum(pred[..., :2], target[..., :2])
    rb = torch.maximum(pred[..., 2:], target[..., 2:])
    cwh = (rb - lt).clamp(min=0)
    area_c = cwh[..., 0] * cwh[..., 1] + 1e-7
    return iou - (area_c - union) / area_c


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
