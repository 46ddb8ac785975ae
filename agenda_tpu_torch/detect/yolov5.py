"""YOLOv5-family detector as torch modules (anchor-based, v6.1 architecture).

Counterpart of ``agenda_tpu/detect/yolov5.py``, the reference's mmyolo
YOLOv5-m (deepen 0.67, widen 0.75, the ~27-49 px anchors tuned for its
42-px vehicles, 128 px): the CSPDarknet C3 backbone with SPPF, the PAN
neck and the coupled head (``na * (5 + nc)`` a cell), under the flax
module names (``stem``, ``c3_1.m_0_cv1``, ``neck_c3_4``, ``head_2``), so a
JAX checkpoint maps onto the ``state_dict`` through ``flax_layout``. The
layers run NCHW with YOLOv8's ``ConvBNAct`` (flax's batch norm); the head
outputs are returned (B, h, w, A, 5 + nc), as the reference's.

- The head's bias is ultralytics' ``Detect.bias_init``
  (``_head_bias_init``): objectness ``log(8 / cells)``, class
  ``log(0.6 / (nc - 0.99999))``.
- ``yolov5_loss``: the shape-ratio anchor match (max ratio < 4) into the
  own cell and the two nearest neighbours, scattered into per-level target
  grids with a max-scatter, so the highest GT index wins a cell as in the
  reference's ``.at[].max`` (``scatter_reduce(..., "amax")``;
  ``index_put_`` with repeated indices is undefined on CUDA); box loss
  ``1 - CIoU`` over the matches, objectness BCE on the detached CIoU with
  the per-level balance (4, 1, 0.4), no class loss for one class; the loss
  times the batch size.
- ``yolov5_predict``: the v5 decode, boxes clipped to the image, NMS at
  IoU 0.65.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from agenda_tpu_torch.detect.flax_layout import FamilyVariables, lecun_init_
from agenda_tpu_torch.detect.losses import bce_with_logits, ciou
from agenda_tpu_torch.detect.ops import device_constant, nested_tuple, nms_images
from agenda_tpu_torch.detect.yolov8 import ConvBNAct
from agenda_tpu_torch.parallel.mesh import batch_mean, global_rows

Tensors = Dict[str, torch.Tensor]

DEFAULT_ANCHORS = (  # the reference's Real_Source/yolov5.py:26 (42-px vehicles)
    ((31, 28), (32, 37), (27, 48)),
    ((48, 27), (47, 34), (34, 48)),
    ((41, 48), (49, 41), (48, 48)),
)


@dataclasses.dataclass(frozen=True)
class YOLOv5Config:
    num_classes: int = 1
    depth: float = 0.67  # m
    width: float = 0.75
    img_size: int = 128
    strides: Tuple[int, ...] = (8, 16, 32)
    anchors: Tuple = DEFAULT_ANCHORS
    max_gt: int = 64
    box_weight: float = 0.05
    obj_weight: float = 1.0
    cls_weight: float = 0.5
    obj_balance: Tuple[float, ...] = (4.0, 1.0, 0.4)
    anchor_ratio_thr: float = 4.0

    def ch(self, c: int) -> int:
        return max(8, int(round(c * self.width / 8)) * 8)

    def n(self, x: int) -> int:
        return max(1, round(x * self.depth))


class C3(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c = out_ch // 2
        self.n, self.shortcut = n, shortcut
        self.cv1 = ConvBNAct(in_ch, c, 1)
        self.cv2 = ConvBNAct(in_ch, c, 1)
        for i in range(n):
            setattr(self, f"m_{i}_cv1", ConvBNAct(c, c, 1))
            setattr(self, f"m_{i}_cv2", ConvBNAct(c, c, 3))
        self.cv3 = ConvBNAct(2 * c, out_ch, 1)

    def forward(self, x):
        a, b = self.cv1(x), self.cv2(x)
        for i in range(self.n):
            h = getattr(self, f"m_{i}_cv2")(getattr(self, f"m_{i}_cv1")(a))
            a = a + h if self.shortcut else h
        return self.cv3(torch.cat([a, b], dim=1))


class SPPFv5(nn.Module):
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


def head_bias(cfg: YOLOv5Config, level: int) -> torch.Tensor:
    """ultralytics ``Detect.bias_init`` (mmyolo's YOLOv5Head init): objectness
    ``log(8 objects / cells at this level)``, class ``log(0.6 / (nc - 0.99999))``;
    without the objectness prior the head spends its first epochs pushing
    objectness down on the ~99% negative cells."""
    na = len(cfg.anchors[0])
    obj_b = math.log(8.0 / (cfg.img_size / cfg.strides[level]) ** 2)
    cls_b = math.log(0.6 / (cfg.num_classes - 0.99999)) if cfg.num_classes > 1 \
        else math.log(0.6 / 1e-5)
    b = torch.zeros((na, 5 + cfg.num_classes), dtype=torch.float32)
    b[:, 4] = obj_b
    b[:, 5:] = cls_b
    return b.reshape(-1)


class YOLOv5(nn.Module):
    def __init__(self, config: YOLOv5Config):
        super().__init__()
        self.config = cfg = config
        self.na = len(cfg.anchors[0])
        no = self.na * (5 + cfg.num_classes)
        c1, c2, c3, c4, c5 = cfg.ch(64), cfg.ch(128), cfg.ch(256), cfg.ch(512), cfg.ch(1024)
        self.stem = ConvBNAct(3, c1, 6, 2)
        self.down1 = ConvBNAct(c1, c2, 3, 2)
        self.c3_1 = C3(c2, c2, cfg.n(3))
        self.down2 = ConvBNAct(c2, c3, 3, 2)
        self.c3_2 = C3(c3, c3, cfg.n(6))
        self.down3 = ConvBNAct(c3, c4, 3, 2)
        self.c3_3 = C3(c4, c4, cfg.n(9))
        self.down4 = ConvBNAct(c4, c5, 3, 2)
        self.c3_4 = C3(c5, c5, cfg.n(3))
        self.sppf = SPPFv5(c5, c5)
        self.reduce5 = ConvBNAct(c5, c4, 1)
        self.neck_c3_1 = C3(2 * c4, c4, cfg.n(3), shortcut=False)
        self.reduce4 = ConvBNAct(c4, c3, 1)
        self.neck_c3_2 = C3(2 * c3, c3, cfg.n(3), shortcut=False)
        self.neck_down3 = ConvBNAct(c3, c3, 3, 2)
        self.neck_c3_3 = C3(2 * c3, c4, cfg.n(3), shortcut=False)
        self.neck_down4 = ConvBNAct(c4, c4, 3, 2)
        self.neck_c3_4 = C3(2 * c4, c5, cfg.n(3), shortcut=False)
        for li, ch in enumerate((c3, c4, c5)):
            setattr(self, f"head_{li}", nn.Conv2d(ch, no, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 3, H, W) in [0, 1] -> per level (B, h, w, A, 5 + nc), f32."""
        x = self.c3_1(self.down1(self.stem(x)))
        p3 = self.c3_2(self.down2(x))
        p4 = self.c3_3(self.down3(p3))
        p5 = self.sppf(self.c3_4(self.down4(p4)))
        r5 = self.reduce5(p5)
        x4 = self.neck_c3_1(torch.cat([_up(r5), p4], dim=1))
        r4 = self.reduce4(x4)
        out3 = self.neck_c3_2(torch.cat([_up(r4), p3], dim=1))
        out4 = self.neck_c3_3(torch.cat([self.neck_down3(out3), r4], dim=1))
        out5 = self.neck_c3_4(torch.cat([self.neck_down4(out4), r5], dim=1))
        heads = []
        for li, f in enumerate((out3, out4, out5)):
            h = getattr(self, f"head_{li}")(f).permute(0, 2, 3, 1)
            heads.append(h.reshape(*h.shape[:3], self.na, 5 + self.config.num_classes).float())
        return heads


def init_yolov5_(model: YOLOv5, generator: torch.Generator) -> None:
    """flax's default init from ``generator``, then the heads' bias priors."""
    lecun_init_(model, generator)
    with torch.no_grad():
        for li in range(len(model.config.strides)):
            getattr(model, f"head_{li}").bias.copy_(head_bias(model.config, li))


# ---------------------------------------------------------------------------
# Targets / loss
# ---------------------------------------------------------------------------


@torch.no_grad()
def level_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors_lvl: torch.Tensor,
                  stride: int, fsize: int, ratio_thr: float) -> torch.Tensor:
    """The v5 assignment of every image at one level -> tgt_idx (B, H, W, A):
    the GT index a cell's anchor regresses to, -1 where none."""
    b, g = gt_boxes.shape[:2]
    a = anchors_lvl.shape[0]
    h = w = fsize
    cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2 / stride
    cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2 / stride
    gw = (gt_boxes[..., 2] - gt_boxes[..., 0]) / stride
    gh = (gt_boxes[..., 3] - gt_boxes[..., 1]) / stride
    r_w = gw[..., None] / (anchors_lvl[:, 0] / stride)
    r_h = gh[..., None] / (anchors_lvl[:, 1] / stride)
    ratio = torch.maximum(torch.maximum(r_w, 1.0 / r_w.clamp(min=1e-9)),
                          torch.maximum(r_h, 1.0 / r_h.clamp(min=1e-9)))
    match = (ratio < ratio_thr) & gt_valid[..., None] & (gw[..., None] > 1e-6)  # (B, G, A)

    # the own cell and up to two neighbours by the fractional offset (v5's 0.5 rule)
    fx, fy = torch.remainder(cx, 1.0), torch.remainder(cy, 1.0)
    c0x, c0y = torch.floor(cx), torch.floor(cy)
    offx = torch.where(fx < 0.5, -1.0, 1.0).to(cx.dtype)
    offy = torch.where(fy < 0.5, -1.0, 1.0).to(cy.dtype)
    cand_x = torch.stack([c0x, c0x + offx, c0x], dim=-1)  # (B, G, 3)
    cand_y = torch.stack([c0y, c0y, c0y + offy], dim=-1)
    cand_ok = torch.stack([torch.ones_like(cx, dtype=torch.bool),
                           (cand_x[..., 1] >= 0) & (cand_x[..., 1] < w),
                           (cand_y[..., 2] >= 0) & (cand_y[..., 2] < h)], dim=-1)
    cand_x = cand_x.clamp(0, w - 1).long()
    cand_y = cand_y.clamp(0, h - 1).long()

    upd_ok = match[:, :, None, :] & cand_ok[..., None]  # (B, G, 3, A)
    ai = torch.arange(a, device=gt_boxes.device)
    cell = ((cand_y * w + cand_x)[..., None] * a + ai).reshape(b, -1)  # (B, G*3*A)
    gi = torch.arange(g, device=gt_boxes.device)[:, None, None].expand(g, 3, a)
    src = torch.where(upd_ok, gi, -1).reshape(b, -1)
    tgt = torch.full((b, h * w * a), -1, dtype=torch.long, device=gt_boxes.device)
    return tgt.scatter_reduce(1, cell, src, "amax").reshape(b, h, w, a)


@functools.lru_cache(maxsize=16)
def _grid(h: int, w: int, device: torch.device):
    gx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    gy = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    return gx, gy


def decode_level(pred: torch.Tensor, anchors_lvl: torch.Tensor, stride: int):
    """pred (B, H, W, A, 5+nc) -> boxes (B, H, W, A, 4) xyxy, obj logits, cls logits."""
    gx, gy = _grid(pred.shape[1], pred.shape[2], pred.device)
    sxy = torch.sigmoid(pred[..., 0:2])
    swh = torch.sigmoid(pred[..., 2:4])
    px = (2 * sxy[..., 0] - 0.5 + gx) * stride
    py = (2 * sxy[..., 1] - 0.5 + gy) * stride
    pw = (2 * swh[..., 0]) ** 2 * anchors_lvl[:, 0]
    ph = (2 * swh[..., 1]) ** 2 * anchors_lvl[:, 1]
    boxes = torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2], dim=-1)
    return boxes, pred[..., 4], pred[..., 5:]


def _anchor_table(cfg: YOLOv5Config, ref: torch.Tensor) -> torch.Tensor:
    """(L, A, 2) anchor sizes on ``ref``'s device, copied there once."""
    return device_constant(nested_tuple(cfg.anchors), ref.device, ref.dtype)


def yolov5_loss(heads: List[torch.Tensor], batch: Tensors, cfg: YOLOv5Config
                ) -> Tuple[torch.Tensor, Tensors]:
    anchors = _anchor_table(cfg, heads[0])
    gtb, gtv = batch["gt_boxes"].to(heads[0].dtype), batch["gt_valid"]
    b = gtb.shape[0]
    lbox = heads[0].new_zeros(b)
    lobj = heads[0].new_zeros(b)
    n_match = heads[0].new_zeros(b)
    for li, pred in enumerate(heads):
        stride = cfg.strides[li]
        boxes, obj_logit, _ = decode_level(pred, anchors[li], stride)
        tgt_idx = level_targets(gtb, gtv, anchors[li], stride, cfg.img_size // stride,
                                cfg.anchor_ratio_thr)
        tmask = tgt_idx >= 0
        tgt_boxes = torch.gather(gtb, 1, tgt_idx.clamp(min=0).reshape(b, -1, 1).expand(-1, -1, 4))
        iou = ciou(boxes, tgt_boxes.reshape(boxes.shape))
        m = tmask.to(iou.dtype)
        lbox = lbox + ((1.0 - iou) * m).flatten(1).sum(1)
        n_match = n_match + m.flatten(1).sum(1)
        tobj = torch.where(tmask, iou.detach().clamp(0.0, 1.0), torch.zeros_like(iou))
        lobj = lobj + cfg.obj_balance[li] * bce_with_logits(obj_logit, tobj).flatten(1).mean(1)
    # over several ranks: this rank's shares of the global batch's means
    lbox = batch_mean(lbox / n_match.clamp(min=1.0))
    lobj = batch_mean(lobj)
    # mmyolo/ultralytics scale the loss by the global batch size; the presets'
    # learning rates assume that gradient scale
    loss = (cfg.box_weight * lbox + cfg.obj_weight * lobj) * global_rows(b)[0]
    return loss, {"box": lbox, "obj": lobj, "n_match": batch_mean(n_match)}


def yolov5_predict(heads: List[torch.Tensor], cfg: YOLOv5Config, score_thr: float = 0.001,
                   iou_thr: float = 0.65, max_dets: int = 300):
    anchors = _anchor_table(cfg, heads[0])
    all_boxes, all_scores = [], []
    for li, pred in enumerate(heads):
        boxes, obj_logit, cls_logit = decode_level(pred, anchors[li], cfg.strides[li])
        score = torch.sigmoid(obj_logit)
        if cfg.num_classes == 1:
            score = score * torch.sigmoid(cls_logit[..., 0])
        all_boxes.append(boxes.reshape(boxes.shape[0], -1, 4))
        all_scores.append(score.reshape(score.shape[0], -1))
    boxes = torch.cat(all_boxes, dim=1).clamp(0, cfg.img_size)
    scores = torch.cat(all_scores, dim=1)
    keep, valid = nms_images(boxes, scores, iou_thr, max_dets, score_thr)
    kept = torch.gather(boxes, 1, keep[..., None].expand(*keep.shape, 4))
    return kept, torch.gather(scores, 1, keep) * valid, valid


@dataclasses.dataclass
class YOLOv5Family(FamilyVariables):
    config: YOLOv5Config = dataclasses.field(default_factory=YOLOv5Config)
    score_thr: float = 0.001
    iou_thr: float = 0.65
    max_dets: int = 300

    def __post_init__(self):
        self.model = YOLOv5(self.config).eval()
        self._name_variables()

    def init_variables(self, generator: torch.Generator) -> Tensors:
        init_yolov5_(self.model, generator)
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def forward(self, variables: Tensors, images: torch.Tensor) -> List[torch.Tensor]:
        return functional_call(self.model, variables, (images.permute(0, 3, 1, 2).contiguous(),))

    def loss_fn(self, variables: Tensors, batch: Tensors, generator=None):
        """The train-mode forward and the v5 loss -> (loss, metrics,
        new_batch_stats); draws nothing (``generator`` is not read)."""
        stats = {k: variables[k].clone() for k in self.stat_names}
        x = batch["image"].permute(0, 3, 1, 2).contiguous()
        self.model.train()
        try:
            heads = functional_call(self.model, {**variables, **stats}, (x,))
        finally:
            self.model.eval()
        loss, metrics = yolov5_loss(heads, batch, self.config)
        return loss, metrics, stats

    @torch.no_grad()
    def predict_fn(self, variables: Tensors, images: torch.Tensor):
        return yolov5_predict(self.forward(variables, images), self.config, self.score_thr,
                              self.iou_thr, self.max_dets)
