"""YOLOv8-family detector as torch modules: prediction and the training loss.

Counterpart of ``agenda_tpu/detect/yolov8.py``: the same
modules under the same names, so a JAX checkpoint maps onto this
``state_dict`` name for name (``flax_to_state_dict``, shared by every
family in ``detect/flax_layout.py``). The layers run
NCHW; every ``concatenate(axis=-1)`` of the
reference is a ``cat(dim=1)`` in the same order, and the head outputs are
returned NHWC, as the reference's, so that ``_flatten_outputs`` reshapes
(B, h, w, C) -> (B, h*w, 4, reg_max) exactly as it does.

BatchNorm: eps 1e-3; eval reads the running statistics. In train mode it
is flax's ``nn.BatchNorm(momentum=0.97)``, not torch's: it normalises with
the biased batch variance and updates ``running_var`` with that biased
variance too (``0.97 old + 0.03 batch``), where ``nn.BatchNorm2d`` would
take the unbiased one. The neck's 2x nearest upsample equals
``jax.image.resize(..., "nearest")`` at 2x, and the SPPF max-pools pad with
-inf as flax's do. The detector runs in f32 on both devices.

``yolov8_loss`` is the reference's v8 loss (``:216-273``), batched over the
images: TAL assignment, BCE on the aligned score, (1 - CIoU) and DFL weighted
by it, each normalised by the weights' sum, times the batch size.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agenda_tpu_torch.detect.assign import task_aligned_assign
from agenda_tpu_torch.detect.losses import bce_with_logits, ciou, dfl_loss
from agenda_tpu_torch.detect.ops import anchor_points, nms_images
from agenda_tpu_torch.models.batch_norm import batch_norm_train
from agenda_tpu_torch.parallel.mesh import global_rows, global_sum


@dataclasses.dataclass(frozen=True)
class YOLOv8Config:
    num_classes: int = 1
    depth: float = 0.33  # n
    width: float = 0.25
    ratio: float = 2.0
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    img_size: int = 128
    max_gt: int = 64
    # loss weights (ultralytics defaults); read by the training path
    box_weight: float = 7.5
    cls_weight: float = 0.5
    dfl_weight: float = 1.5

    def ch(self, c: int) -> int:
        return max(8, int(round(c * self.width / 8)) * 8)

    def n(self, x: int) -> int:
        return max(1, round(x * self.depth))


BN_EPS = 1e-3


class ConvBNAct(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        # (k-1)//2: torch's symmetric padding, as the reference's
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=BN_EPS, momentum=0.03)

    def forward(self, x):
        x = self.conv(x)
        return F.silu(batch_norm_train(x, self.bn) if self.training else self.bn(x))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNAct(in_ch, out_ch, 3)
        self.cv2 = ConvBNAct(out_ch, out_ch, 3)
        self.add = shortcut and in_ch == out_ch

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.add else h


class C2f(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c = out_ch // 2
        self.n = n
        self.cv1 = ConvBNAct(in_ch, 2 * c, 1)
        for i in range(n):  # named m_0, m_1, ... as the reference's submodules
            setattr(self, f"m_{i}", Bottleneck(c, c, shortcut))
        self.cv2 = ConvBNAct((2 + n) * c, out_ch, 1)

    def forward(self, x):
        parts = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        c = in_ch // 2
        self.cv1 = ConvBNAct(in_ch, c, 1)
        self.cv2 = ConvBNAct(4 * c, out_ch, 1)

    def forward(self, x):
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], dim=1))


def _up(t: torch.Tensor) -> torch.Tensor:
    return F.interpolate(t, scale_factor=2, mode="nearest")


class YOLOv8(nn.Module):
    def __init__(self, config: YOLOv8Config):
        super().__init__()
        self.config = cfg = config
        c1 = cfg.ch(64)
        c2, c3, c4 = cfg.ch(128), cfg.ch(256), cfg.ch(512)
        c5 = cfg.ch(int(512 * cfg.ratio))

        self.stem = ConvBNAct(3, c1, 3, 2)
        self.down1 = ConvBNAct(c1, c2, 3, 2)
        self.c2f_1 = C2f(c2, c2, cfg.n(3))
        self.down2 = ConvBNAct(c2, c3, 3, 2)
        self.c2f_2 = C2f(c3, c3, cfg.n(6))
        self.down3 = ConvBNAct(c3, c4, 3, 2)
        self.c2f_3 = C2f(c4, c4, cfg.n(6))
        self.down4 = ConvBNAct(c4, c5, 3, 2)
        self.c2f_4 = C2f(c5, c5, cfg.n(3))
        self.sppf = SPPF(c5, c5)

        self.neck_p4 = C2f(c5 + c4, c4, cfg.n(3), shortcut=False)
        self.neck_p3 = C2f(c4 + c3, c3, cfg.n(3), shortcut=False)
        self.neck_down3 = ConvBNAct(c3, c3, 3, 2)
        self.neck_p4b = C2f(c3 + c4, c4, cfg.n(3), shortcut=False)
        self.neck_down4 = ConvBNAct(c4, c4, 3, 2)
        self.neck_p5 = C2f(c4 + c5, c5, cfg.n(3), shortcut=False)

        box_ch = max(16, c3 // 4, 4 * cfg.reg_max)
        cls_ch = max(c3, min(cfg.num_classes, 100))
        for li, feat_ch in enumerate((c3, c4, c5)):
            setattr(self, f"head_box1_{li}", ConvBNAct(feat_ch, box_ch, 3))
            setattr(self, f"head_box2_{li}", ConvBNAct(box_ch, box_ch, 3))
            setattr(self, f"head_box3_{li}", nn.Conv2d(box_ch, 4 * cfg.reg_max, 1))
            setattr(self, f"head_cls1_{li}", ConvBNAct(feat_ch, cls_ch, 3))
            setattr(self, f"head_cls2_{li}", ConvBNAct(cls_ch, cls_ch, 3))
            setattr(self, f"head_cls3_{li}", nn.Conv2d(cls_ch, cfg.num_classes, 1))

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """x (B, 3, H, W) in [0, 1] -> per level (cls (B, h, w, nc), box (B, h, w, 4*reg_max))."""
        x = self.down1(self.stem(x))
        x = self.c2f_1(x)
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        p5 = self.sppf(self.c2f_4(self.down4(p4)))

        h4 = self.neck_p4(torch.cat([_up(p5), p4], dim=1))
        h3 = self.neck_p3(torch.cat([_up(h4), p3], dim=1))
        h4b = self.neck_p4b(torch.cat([self.neck_down3(h3), h4], dim=1))
        h5 = self.neck_p5(torch.cat([self.neck_down4(h4b), p5], dim=1))

        outs = []
        for li, feat in enumerate((h3, h4b, h5)):
            b = getattr(self, f"head_box1_{li}")(feat)
            b = getattr(self, f"head_box3_{li}")(getattr(self, f"head_box2_{li}")(b))
            c = getattr(self, f"head_cls1_{li}")(feat)
            c = getattr(self, f"head_cls3_{li}")(getattr(self, f"head_cls2_{li}")(c))
            outs.append((c.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)))
        return outs


def init_yolov8_(model: YOLOv8, generator: torch.Generator) -> None:
    """Draw the weights as flax's defaults do, from ``generator`` (CPU).

    Conv kernels: lecun normal (truncated at 2 sigma, fan in); BatchNorm:
    scale 1, bias 0, mean 0, var 1; the head's last convs: bias
    -log(99) on the class logits (p = 0.01) and 1 on the box bins, as
    ultralytics' ``Detect.bias_init``.
    """
    cls_bias = -math.log((1 - 0.01) / 0.01)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(std)
                if mod.bias is not None:
                    mod.bias.fill_(cls_bias if name.startswith("head_cls3_") else 1.0)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()


# ---------------------------------------------------------------------------
# Decode / predict
# ---------------------------------------------------------------------------


def _flatten_outputs(outs, cfg: YOLOv8Config):
    """Per-level NHWC head outputs -> (cls (B,N,nc), dist (B,N,4,reg_max))."""
    cls_list, dist_list = [], []
    for (c, b) in outs:
        bs, h, w, _ = c.shape
        cls_list.append(c.reshape(bs, h * w, cfg.num_classes))
        dist_list.append(b.reshape(bs, h * w, 4, cfg.reg_max))
    return torch.cat(cls_list, dim=1), torch.cat(dist_list, dim=1)


def _feat_sizes(cfg: YOLOv8Config):
    return [(cfg.img_size // s, cfg.img_size // s) for s in cfg.strides]


@functools.lru_cache(maxsize=8)
def _anchors(cfg: YOLOv8Config, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor points and strides on ``device``, copied there once: a copy
    from pageable memory would wait for the card's queue at every batch."""
    pts_np, str_np = anchor_points(_feat_sizes(cfg), cfg.strides)
    return torch.from_numpy(pts_np).to(device), torch.from_numpy(str_np).to(device)


def decode_boxes(dist: torch.Tensor, points: torch.Tensor, strides: torch.Tensor,
                 cfg: YOLOv8Config) -> torch.Tensor:
    """DFL distributions (B,N,4,reg_max) -> xyxy boxes (B,N,4) in image coords."""
    proj = torch.arange(cfg.reg_max, dtype=torch.float32, device=dist.device)
    d = torch.sum(torch.softmax(dist, dim=-1) * proj, dim=-1)  # (B,N,4) l,t,r,b
    d = d * strides[None, :, None]
    x1 = points[None, :, 0] - d[..., 0]
    y1 = points[None, :, 1] - d[..., 1]
    x2 = points[None, :, 0] + d[..., 2]
    y2 = points[None, :, 1] + d[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def yolov8_predict(
    outs, cfg: YOLOv8Config,
    score_thr: float = 0.001, iou_thr: float = 0.7, max_dets: int = 300,
):
    """Decode + NMS. Returns (boxes (B,K,4), scores (B,K), valid (B,K))."""
    cls_logits, dist = _flatten_outputs(outs, cfg)
    points, strides = _anchors(cfg, cls_logits.device)
    boxes = decode_boxes(dist, points, strides, cfg)
    scores = torch.sigmoid(cls_logits)[..., 0]  # single class
    keep, valid = nms_images(boxes, scores, iou_thr, max_dets, score_thr)
    kept_boxes = torch.gather(boxes, 1, keep[..., None].expand(*keep.shape, 4))
    kept_scores = torch.gather(scores, 1, keep) * valid
    return kept_boxes, kept_scores, valid


def yolov8_loss(outs, batch: Dict[str, torch.Tensor], cfg: YOLOv8Config
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """TAL-assigned BCE + CIoU + DFL (the ultralytics v8 loss) over a batch:
    ``batch`` holds ``gt_boxes`` (B, G, 4) and ``gt_valid`` (B, G)."""
    cls_logits, dist = _flatten_outputs(outs, cfg)
    points, strides = _anchors(cfg, cls_logits.device)
    pred_boxes = decode_boxes(dist, points, strides, cfg)  # (B, N, 4)
    scores = torch.sigmoid(cls_logits)

    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
    gt_labels = torch.zeros(gt_boxes.shape[:2], dtype=torch.long, device=gt_boxes.device)
    fg, agt, tsc, _ = task_aligned_assign(scores.detach(), pred_boxes.detach(), points,
                                          gt_boxes, gt_labels, gt_valid)
    tgt_boxes = torch.gather(gt_boxes, 1, agt[..., None].expand(-1, -1, 4))
    w = tsc * fg
    # cls targets: the aligned score at the assigned class (single class 0)
    cls_tgt = torch.zeros_like(cls_logits)
    cls_tgt[..., 0] = w
    cls_l = bce_with_logits(cls_logits, cls_tgt).sum()
    iou_l = ((1.0 - ciou(pred_boxes, tgt_boxes)) * w).sum()
    # DFL targets: distances to the GT edges in stride units
    lt = (points - tgt_boxes[..., :2]) / strides[:, None]
    rb = (tgt_boxes[..., 2:] - points) / strides[:, None]
    tdist = torch.cat([lt, rb], dim=-1).clamp(0, cfg.reg_max - 1.01)
    dfl_l = (dfl_loss(dist, tdist, cfg.reg_max - 1).sum(dim=-1) * w).sum()

    # over several ranks the normalizer and the batch size are the global
    # batch's, and each rank's loss is its share of the global one
    denom = global_sum(w.sum()).clamp(min=1.0)
    total_cls, total_iou, total_dfl = cls_l / denom, iou_l / denom, dfl_l / denom
    loss = cfg.cls_weight * total_cls + cfg.box_weight * total_iou + cfg.dfl_weight * total_dfl
    # mmyolo/ultralytics scale the loss by the global batch size; the presets'
    # learning rates assume that gradient scale
    loss = loss * global_rows(scores.shape[0])[0]
    return loss, {"cls": total_cls, "iou": total_iou, "dfl": total_dfl}
