"""Faster R-CNN (R50-FPN) as torch modules: two-stage training and prediction.

Counterpart of ``agenda_tpu/detect/faster_rcnn.py``, the reference's mmdet
Faster R-CNN (RPN scales [8], ratios [0.5, 1, 2] over strides 4-64,
DeltaXYWH coding with RCNN stds [0.1, 0.1, 0.2, 0.2], MaxIoU assignment and
random sampling, RPN nms_pre 1000 -> NMS 0.7, RCNN score 0.05 / NMS 0.5 /
100 a tile), with the same static shapes, batched over the images where the
reference runs one image under ``vmap``:

- the backbone is the port's ResNet-50 (``models/resnet.py``, torchvision's
  names, flax's batch norm) without its classifier; the FPN, the RPN head
  and the box head carry the flax module names (``fpn.lateral_0``,
  ``rpn.rpn_conv``, ``box_head.fc1``, ...), so a JAX checkpoint maps onto
  the ``state_dict`` through ``flax_layout`` (``flax_to_state_dict``);
- the layers run NCHW; the RPN's outputs are returned NHWC, as the
  reference's, so the anchor order of ``build_anchors`` holds, and the box
  head flattens each RoI NHWC, so the JAX ``fc1`` kernel fits as it is;
- the FPN's top-down upsample is nearest to the lateral's size
  (half-pixel, ``jax.image.resize``'s), P6 a stride-2 subsample of P5;
- the proposals take the top ``nms_pre`` scores by a stable descending sort
  (``jax.lax.top_k`` puts the lower index first among ties; ``torch.topk``
  promises no order), then ``nms_images``: one launch pair a rank, 1000
  ranks a train step;
- the samplers' uniforms come in as ``draws`` (``draw``, from a
  ``torch.Generator``), in the reference's order of use: RPN positives and
  negatives, then RCNN ones; RoIAlign samples P2 (the pipeline's 42-px boxes
  all map to the finest level).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from agenda_tpu_torch.detect.assign import draw_uniforms, max_iou_assign, random_sample
from agenda_tpu_torch.detect.flax_layout import (FamilyVariables, flax_to_state_dict, lecun_init_,
                                                state_dict_to_flax)
from agenda_tpu_torch.detect.losses import bce_with_logits, smooth_l1
from agenda_tpu_torch.detect.ops import (decode_deltas, encode_deltas, grid_anchors, nms_images,
                                         roi_align)
from agenda_tpu_torch.models.resnet import ResNet50, _module_from_flax, _module_to_flax
from agenda_tpu_torch.parallel.mesh import batch_mean, draw_rows, global_sum

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    num_classes: int = 1
    img_size: int = 128
    fpn_channels: int = 256
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    anchor_scales: Tuple[float, ...] = (8.0,)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # RPN train
    rpn_pos_thr: float = 0.7
    rpn_neg_thr: float = 0.3
    rpn_min_pos_iou: float = 0.3
    rpn_sample: int = 256
    rpn_pos_fraction: float = 0.5
    # proposals
    nms_pre: int = 1000
    num_proposals: int = 512
    proposal_nms_iou: float = 0.7
    # RCNN train
    rcnn_pos_thr: float = 0.5
    rcnn_neg_thr: float = 0.5
    rcnn_sample: int = 256
    rcnn_pos_fraction: float = 0.25
    rcnn_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    roi_size: int = 7
    # test
    score_thr: float = 0.05
    rcnn_nms_iou: float = 0.5
    max_per_img: int = 100
    max_gt: int = 64


def _up_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Nearest resize of ``x`` to ``ref``'s spatial size (half-pixel centres)."""
    return F.interpolate(x, size=ref.shape[-2:], mode="nearest-exact")


def subsample2(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((1, 1), strides=(2, 2))``: every other row and column."""
    return x[:, :, ::2, ::2]


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral_{i}", nn.Conv2d(c, channels, 1))
            setattr(self, f"fpn_{i}", nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, feats):
        """(C2..C5) -> (P2..P6), NCHW."""
        laterals = [getattr(self, f"lateral_{i}")(c) for i, c in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _up_to(laterals[i], laterals[i - 1])
        outs = [getattr(self, f"fpn_{i}")(lat) for i, lat in enumerate(laterals)]
        outs.append(subsample2(outs[-1]))  # P6 (mmdet FPN num_outs=5 on 4 inputs)
        return outs


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int, in_channels: int = 256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, 256, 3, padding=1)
        self.rpn_cls = nn.Conv2d(256, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(256, num_anchors * 4, 1)

    def forward(self, feats):
        """-> per level (cls (B, h, w, A), reg (B, h, w, 4A)), NHWC, in f32
        whatever the compute dtype, as the reference's."""
        outs = []
        for f in feats:
            h = F.relu(self.rpn_conv(f))
            outs.append((self.rpn_cls(h).permute(0, 2, 3, 1).float(),
                         self.rpn_reg(h).permute(0, 2, 3, 1).float()))
        return outs


class BoxHead(nn.Module):
    """mmdet Shared2FCBBoxHead: (R, 7, 7, C) NHWC RoIs -> (cls (R, nc+1), reg (R, 4 nc))."""

    def __init__(self, num_classes: int, in_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.cls = nn.Linear(1024, num_classes + 1)
        self.reg = nn.Linear(1024, 4 * num_classes)

    def forward(self, roi_feats):
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        return self.cls(x).float(), self.reg(x).float()


def roi_heads(box_head: nn.Module, p2: torch.Tensor, rois: torch.Tensor, stride: int,
              roi_size: int):
    """p2 (B, C, H, W), rois (B, R, 4) in image coordinates -> the box head's
    (cls (B, R, nc+1), reg (B, R, 4 nc))."""
    b, r = rois.shape[:2]
    feats = roi_align(p2.permute(0, 2, 3, 1), rois / stride, roi_size)
    cls, reg = box_head(feats.reshape(b * r, *feats.shape[2:]))
    return cls.reshape(b, r, -1), reg.reshape(b, r, -1)


class FasterRCNN(nn.Module):
    def __init__(self, config: FasterRCNNConfig):
        super().__init__()
        self.config = cfg = config
        self.backbone = ResNet50()
        del self.backbone.fc  # features only, as the reference's (no fc variables)
        self.fpn = FPN(channels=cfg.fpn_channels)
        self.rpn = RPNHead(len(cfg.anchor_scales) * len(cfg.anchor_ratios), cfg.fpn_channels)
        self.box_head = BoxHead(cfg.num_classes, cfg.roi_size ** 2 * cfg.fpn_channels)

    def forward(self, x: torch.Tensor, rois: Optional[torch.Tensor] = None):
        """x NCHW images -> (pyramid (NCHW P2..P6), rpn outputs); or, with
        ``rois``, x is P2 and the box head's outputs come back."""
        if rois is not None:
            return roi_heads(self.box_head, x, rois, self.config.strides[0], self.config.roi_size)
        pyramid = self.fpn(self.backbone(x, features=True))
        return pyramid, self.rpn(pyramid)


# ---------------------------------------------------------------------------
# Anchors / proposals
# ---------------------------------------------------------------------------


def build_anchors(cfg: FasterRCNNConfig) -> np.ndarray:
    per_level = []
    for s in cfg.strides:
        f = cfg.img_size // s
        per_level.append(grid_anchors((f, f), s, cfg.anchor_scales, cfg.anchor_ratios))
    return np.concatenate(per_level, axis=0)


def _flatten_rpn(rpn_outs) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores (B, A), deltas (B, A, 4)) in build_anchors' order."""
    scores, deltas = [], []
    for c, d in rpn_outs:
        b, h, w, na = c.shape
        scores.append(c.reshape(b, h * w * na))
        deltas.append(d.reshape(b, h * w * na, 4))
    return torch.cat(scores, dim=1), torch.cat(deltas, dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *[1] * (x.dim() - 2)).expand(
        *idx.shape, *x.shape[2:]))


@torch.no_grad()
def rpn_proposals(rpn_outs, anchors: torch.Tensor, cfg: FasterRCNNConfig, num_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (proposals (B, num_out, 4), scores (B, num_out)); invalid slots 0."""
    scores, deltas = _flatten_rpn(rpn_outs)
    probs = torch.sigmoid(scores)
    k = min(cfg.nms_pre, probs.shape[1])
    topv, topi = torch.sort(probs, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    boxes = decode_deltas(anchors[topi], _take(deltas, topi),
                          max_shape=(cfg.img_size, cfg.img_size))
    keep, valid = nms_images(boxes, topv, cfg.proposal_nms_iou, num_out)
    props = torch.where(valid[..., None], _take(boxes, keep), torch.zeros((), dtype=boxes.dtype,
                                                                          device=boxes.device))
    return props, torch.where(valid, torch.gather(topv, 1, keep), torch.zeros_like(topv[:, :1]))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def rpn_loss(rpn_outs, anchors: torch.Tensor, batch: Tensors, cfg: FasterRCNNConfig,
             u_pos: torch.Tensor, u_neg: torch.Tensor):
    scores, deltas = _flatten_rpn(rpn_outs)
    gtb, gtv = batch["gt_boxes"].to(scores.dtype), batch["gt_valid"]
    assigned, labels = max_iou_assign(anchors, gtb, gtv, cfg.rpn_pos_thr, cfg.rpn_neg_thr,
                                      cfg.rpn_min_pos_iou)
    idx, is_pos, valid = random_sample(labels, u_pos, u_neg, cfg.rpn_sample, cfg.rpn_pos_fraction)
    w = valid.to(scores.dtype)
    denom = w.sum(dim=1).clamp(min=1.0)
    cls_l = (bce_with_logits(torch.gather(scores, 1, idx), is_pos.to(scores.dtype)) * w
             ).sum(dim=1) / denom
    t = encode_deltas(anchors[idx], _take(gtb, torch.gather(assigned, 1, idx).clamp(min=0)))
    reg_w = (is_pos & valid).to(scores.dtype)
    reg_l = (smooth_l1(_take(deltas, idx), t, beta=1.0 / 9.0).sum(-1) * reg_w).sum(dim=1) / denom
    return batch_mean(cls_l), batch_mean(reg_l)


@torch.no_grad()
def rcnn_targets(proposals: torch.Tensor, batch: Tensors, cfg: FasterRCNNConfig,
                 u_pos: torch.Tensor, u_neg: torch.Tensor):
    """Assign and sample RoIs with the GT boxes appended (add_gt_as_proposals)
    -> (rois, is_pos, target deltas, valid), each (B, rcnn_sample, ...)."""
    gtb, gtv = batch["gt_boxes"].to(proposals.dtype), batch["gt_valid"]
    all_props = torch.cat([proposals, gtb], dim=1)
    assigned, labels = max_iou_assign(all_props, gtb, gtv, cfg.rcnn_pos_thr, cfg.rcnn_neg_thr,
                                      min_pos_iou=1.1)
    # zero-size proposals and padded GT are never sampled
    prop_valid = torch.cat([proposals[..., 2] > proposals[..., 0], gtv], dim=1)
    labels = torch.where(prop_valid, labels, torch.full_like(labels, -1))
    idx, is_pos, valid = random_sample(labels, u_pos, u_neg, cfg.rcnn_sample,
                                       cfg.rcnn_pos_fraction)
    rois = _take(all_props, idx)
    gt_for_roi = _take(gtb, torch.gather(assigned, 1, idx).clamp(min=0))
    return rois, is_pos, encode_deltas(rois, gt_for_roi, stds=cfg.rcnn_stds), valid


def rcnn_loss(cls_logits: torch.Tensor, reg: torch.Tensor, targets, cfg: FasterRCNNConfig):
    _, is_pos, tgt_deltas, valid = targets
    w = valid.to(cls_logits.dtype)
    fg = (is_pos & valid).to(cls_logits.dtype)
    denom = global_sum(w.sum()).clamp(min=1.0)  # over every RoI of the global batch
    # softmax CE over (num_classes + 1); one class: fg label 0, bg label 1
    labels = torch.where(is_pos, 0, cfg.num_classes)
    ce = -torch.gather(F.log_softmax(cls_logits, dim=-1), -1, labels[..., None])[..., 0]
    reg4 = reg.reshape(*reg.shape[:-1], cfg.num_classes, 4)[..., 0, :]
    return (ce * w).sum() / denom, (smooth_l1(reg4, tgt_deltas, beta=1.0).sum(-1) * fg).sum() / denom


def rcnn_predict(cls_logits: torch.Tensor, reg: torch.Tensor, proposals: torch.Tensor,
                 cfg: FasterRCNNConfig):
    """The box head's outputs on the proposals -> (boxes, scores, valid), each
    (B, max_per_img, ...), after the class score threshold and NMS."""
    probs = torch.softmax(cls_logits, dim=-1)[..., 0]  # the foreground's
    reg4 = reg.reshape(*reg.shape[:-1], cfg.num_classes, 4)[..., 0, :]
    boxes = decode_deltas(proposals, reg4, stds=cfg.rcnn_stds,
                          max_shape=(cfg.img_size, cfg.img_size))
    scores = torch.where(proposals[..., 2] > proposals[..., 0], probs, torch.zeros_like(probs))
    keep, valid = nms_images(boxes, scores, cfg.rcnn_nms_iou, cfg.max_per_img,
                             score_threshold=cfg.score_thr)
    return _take(boxes, keep), torch.gather(scores, 1, keep) * valid, valid


# ---------------------------------------------------------------------------
# Family adapter
# ---------------------------------------------------------------------------


def _backbone_module(to_port: bool):
    """flax module paths <-> the port's: only the ResNet-50's names differ."""
    conv = _module_from_flax if to_port else _module_to_flax

    def fn(path: str) -> str:
        head, _, rest = path.partition(".")
        return f"{head}.{conv(rest)}" if head == "backbone" and rest else path

    return fn


class TwoStageFamily(FamilyVariables):
    """What Faster R-CNN and ViTDet share: the anchors, the RPN/RCNN loss and
    prediction on the model's (pyramid, rpn outputs) and box head."""

    config: FasterRCNNConfig

    def _setup(self) -> None:
        self.model.eval()
        self._name_variables()
        self.anchors_np = build_anchors(self.config)
        self._anchors: Dict[torch.device, torch.Tensor] = {}

    def anchors(self, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The anchor table on ``dev``, copied there once."""
        if dev not in self._anchors:
            self._anchors[dev] = torch.from_numpy(self.anchors_np).to(dev)
        return self._anchors[dev].to(dtype)

    def init_variables(self, generator: torch.Generator) -> Tensors:
        """Fresh weights drawn from ``generator`` (a CPU generator), as a state_dict."""
        lecun_init_(self.model, generator)
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def draw(self, generator: torch.Generator, batch: Tensors) -> Tensors:
        """The samplers' uniforms for one step, in the reference's order of use."""
        b, dev = batch["gt_boxes"].shape[0], batch["gt_boxes"].device
        n_anchors = self.anchors_np.shape[0]
        n_rois = self.config.num_proposals + batch["gt_boxes"].shape[1]

        def draw(n):  # this rank's rows of the global batch's draws
            return draw_rows(lambda g: draw_uniforms(generator, (g, n), dev), b)

        return {"rpn_pos": draw(n_anchors), "rpn_neg": draw(n_anchors),
                "rcnn_pos": draw(n_rois), "rcnn_neg": draw(n_rois)}

    def _extract(self, variables: Tensors, images: torch.Tensor, **kw):
        return functional_call(self.model, variables, (images.permute(0, 3, 1, 2).contiguous(),),
                               kw)

    def two_stage_loss(self, variables: Tensors, pyramid, rpn_outs, batch: Tensors,
                       draws: Tensors) -> Tuple[torch.Tensor, Tensors]:
        cfg = self.config
        anchors = self.anchors(rpn_outs[0][0].device, rpn_outs[0][0].dtype)
        rpn_cls, rpn_reg = rpn_loss(rpn_outs, anchors, batch, cfg, draws["rpn_pos"],
                                    draws["rpn_neg"])
        proposals, _ = rpn_proposals([(c.detach(), d.detach()) for c, d in rpn_outs], anchors,
                                     cfg, cfg.num_proposals)
        targets = rcnn_targets(proposals, batch, cfg, draws["rcnn_pos"], draws["rcnn_neg"])
        cls_logits, reg = functional_call(self.model, variables, (pyramid[0],),
                                          {"rois": targets[0]})
        rcnn_cls, rcnn_reg = rcnn_loss(cls_logits, reg, targets, cfg)
        loss = rpn_cls + rpn_reg + rcnn_cls + rcnn_reg
        return loss, {"rpn_cls": rpn_cls, "rpn_reg": rpn_reg, "rcnn_cls": rcnn_cls,
                      "rcnn_reg": rcnn_reg}

    def loss_fn(self, variables: Tensors, batch: Tensors, generator: torch.Generator):
        """The train-mode forward and both stages' losses -> (loss, metrics,
        new_batch_stats); the samplers draw from ``generator``."""
        return self.loss_with_draws(variables, batch, self.draw(generator, batch))

    @torch.no_grad()
    def predict_fn(self, variables: Tensors, images: torch.Tensor):
        """images (B, H, W, 3) in [0, 1] -> (boxes (B,K,4), scores (B,K), valid (B,K))."""
        cfg = self.config
        pyramid, rpn_outs = self._extract(variables, images)
        anchors = self.anchors(images.device, rpn_outs[0][0].dtype)
        proposals, _ = rpn_proposals(rpn_outs, anchors, cfg, cfg.nms_pre // 2)
        cls_logits, reg = functional_call(self.model, variables, (pyramid[0],),
                                          {"rois": proposals})
        return rcnn_predict(cls_logits, reg, proposals, cfg)


@dataclasses.dataclass
class FasterRCNNFamily(TwoStageFamily):
    config: FasterRCNNConfig = dataclasses.field(default_factory=FasterRCNNConfig)

    def __post_init__(self):
        self.model = FasterRCNN(self.config)
        self._setup()

    def from_flax(self, flat: Dict[str, np.ndarray]) -> Tensors:
        return flax_to_state_dict(flat, _backbone_module(to_port=True))

    def to_flax(self, state: Tensors) -> Dict[str, np.ndarray]:
        return state_dict_to_flax(state, _backbone_module(to_port=False))

    def loss_with_draws(self, variables: Tensors, batch: Tensors, draws: Tensors):
        """``loss_fn`` from given uniforms; batch-norm statistics as YOLOv8's
        family updates them (flax's, on clones returned as the third item)."""
        stats = {k: variables[k].clone() for k in self.stat_names}
        self.model.train()
        try:
            pyramid, rpn_outs = self._extract({**variables, **stats}, batch["image"])
        finally:
            self.model.eval()
        loss, metrics = self.two_stage_loss({**variables, **stats}, pyramid, rpn_outs, batch,
                                            draws)
        return loss, metrics, stats
