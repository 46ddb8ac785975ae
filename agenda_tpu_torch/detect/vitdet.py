"""ViTDet as torch modules: a ViT backbone, SimpleFPN and the two-stage heads.

Counterpart of ``agenda_tpu/detect/vitdet.py``, the reference's mmdet ViTDet
(ViT-B/16: 768 wide, 12 blocks, 12 heads, at 128 px; SimpleFPN; RPN and the
Shared4Conv1FC box head), under the flax module names
(``backbone.block_3.qkv``, ``fpn.ln_a_0``, ``box_head.conv2``), so a JAX
checkpoint maps onto the ``state_dict`` through ``flax_layout``:

- window attention (14) on blocks (0, 1, 3, 4, 6, 7, 9, 10), global on the
  rest; a window partition pads with zeros and applies no mask
  (detectron2's, ``:56-78``);
- the decomposed relative-position bias from the unscaled queries, added to
  the scaled f32 logits, as ``agenda_tpu/kernels/attention.py``'s
  ``attention_reference`` computes attention: plain PyTorch, as in the
  reference (no Pallas kernel lies on this path); the per-axis tables are
  resized to ``2 q - 1`` linearly (the identity for the model's own tables);
- stochastic depth at a rate rising linearly with depth (0.1 at the last
  block), a keep mask a sample drawn from the step's ``torch.Generator``;
- LayerNorm eps 1e-6 (flax's), exact GELU; the layers of the pyramid and
  the box head run NCHW with the norms over channels.

The family reuses Faster R-CNN's anchors, RPN/RCNN losses, proposals and
prediction (``faster_rcnn.TwoStageFamily``); it has no batch norm.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agenda_tpu_torch.detect.assign import draw_uniforms
from agenda_tpu_torch.detect.augment import pil_float_matrix
from agenda_tpu_torch.detect.faster_rcnn import (FasterRCNNConfig, RPNHead, TwoStageFamily,
                                                 roi_heads, subsample2)
from agenda_tpu_torch.detect.flax_layout import lecun_init_
from agenda_tpu_torch.parallel.mesh import draw_rows

Tensors = Dict[str, torch.Tensor]
LN_EPS = 1e-6  # flax nn.LayerNorm's


@dataclasses.dataclass(frozen=True)
class ViTDetConfig(FasterRCNNConfig):
    patch_size: int = 16
    embed_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    # the reference's Real_Source/vitdet.py:66-80
    window_size: int = 14
    window_block_indexes: Tuple[int, ...] = (0, 1, 3, 4, 6, 7, 9, 10)
    drop_path_rate: float = 0.1
    use_rel_pos: bool = True


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWh * nWw, ws, ws, C), zero-padded up (no mask)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


@functools.lru_cache(maxsize=16)
def _linear_resize(in_len: int, out_len: int) -> np.ndarray:
    return pil_float_matrix(in_len, out_len, "bilinear").T.copy()


def interp_rel_pos(table: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear resize of a (L, C) table to (target_len, C) (half-pixel,
    antialiased when shrinking: ``jax.image.resize``'s "linear")."""
    if table.shape[0] == target_len:
        return table
    m = torch.from_numpy(_linear_resize(table.shape[0], target_len)).to(table)
    return m @ table


def decomposed_rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                            qh: int, qw: int) -> torch.Tensor:
    """detectron2's add_decomposed_rel_pos as an additive (B, heads, N, N)
    bias; q (B, N, heads, hd) over a (qh, qw) query and key extent."""
    hd = q.shape[-1]
    rh = interp_rel_pos(rel_h, 2 * qh - 1)
    rw = interp_rel_pos(rel_w, 2 * qw - 1)
    ch = torch.arange(qh, device=q.device)
    cw = torch.arange(qw, device=q.device)
    big_rh = rh[ch[:, None] - ch[None, :] + (qh - 1)]  # (qh, qh, hd)
    big_rw = rw[cw[:, None] - cw[None, :] + (qw - 1)]  # (qw, qw, hd)
    b, heads = q.shape[0], q.shape[2]
    rq = q.reshape(b, qh, qw, heads, hd)
    rel_h_term = torch.einsum("bhwnc,hkc->bnhwk", rq, big_rh)
    rel_w_term = torch.einsum("bhwnc,wkc->bnhwk", rq, big_rw)
    bias = rel_h_term[..., :, None] + rel_w_term[..., None, :]  # (B, n, qh, qw, kh, kw)
    return bias.reshape(b, heads, qh * qw, qh * qw)


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def attention_reference(q, k, v, mask=None):
    """``agenda_tpu/kernels/attention.py``'s plain attention: q, k, v
    (B, S, H, D); f32 logits, scaled, then the additive ``mask``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(_at_least_f32(q.dtype)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def drop_path(t: torch.Tensor, rate: float, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
    """Stochastic depth: each sample's branch kept with probability 1 - rate
    and scaled by 1 / (1 - rate); the keep mask drawn from ``generator``."""
    if rate <= 0.0:
        return t
    if generator is None:
        raise ValueError("drop path in train mode needs the step's generator")
    keep = 1.0 - rate
    m = draw_rows(lambda n: draw_uniforms(generator, (n, 1, 1, 1), t.device), t.shape[0]) < keep
    return t * m.to(t.dtype) / keep


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window_size: int, grid: int, drop_path: float,
                 use_rel_pos: bool):
        super().__init__()
        self.heads, self.window_size, self.drop_path = heads, window_size, drop_path
        self.use_rel_pos = use_rel_pos
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            extent = window_size if window_size > 0 else grid
            hd = dim // heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * extent - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * extent - 1, hd))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (B, H, W, C)."""
        c = x.shape[-1]
        grid_hw = (x.shape[1], x.shape[2])
        rate = self.drop_path if self.training else 0.0
        h = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            h, pad_hw = window_partition(h, ws)
        qh, qw = h.shape[1], h.shape[2]
        n, bw, hd = qh * qw, h.shape[0], c // self.heads
        q, k, v = self.qkv(h.reshape(bw, n, c)).split(c, dim=-1)
        q = q.reshape(bw, n, self.heads, hd)
        k = k.reshape(bw, n, self.heads, hd)
        v = v.reshape(bw, n, self.heads, hd)
        mask = None
        if self.use_rel_pos:
            # from the unscaled queries, added after attention_reference's scale
            f = _at_least_f32(q.dtype)
            mask = decomposed_rel_pos_bias(q.to(f), self.rel_pos_h.to(f), self.rel_pos_w.to(f),
                                           qh, qw)
        out = self.proj(attention_reference(q, k, v, mask).reshape(bw, qh, qw, c))
        if ws > 0:
            out = window_unpartition(out, ws, pad_hw, grid_hw)
        x = x + drop_path(out, rate, generator)
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + drop_path(h, rate, generator)


class ViTBackbone(nn.Module):
    def __init__(self, cfg: ViTDetConfig):
        super().__init__()
        self.depth = cfg.vit_depth
        grid = cfg.img_size // cfg.patch_size
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, cfg.embed_dim))
        for i in range(cfg.vit_depth):
            # stochastic depth rising linearly with depth (detectron2)
            dpr = cfg.drop_path_rate * i / max(1, cfg.vit_depth - 1)
            ws = cfg.window_size if i in cfg.window_block_indexes else 0
            setattr(self, f"block_{i}", ViTBlock(cfg.embed_dim, cfg.vit_heads, ws, grid, dpr,
                                                 cfg.use_rel_pos))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (B, 3, H, W) -> (B, H/16, W/16, C)."""
        x = self.patch_embed(x).permute(0, 2, 3, 1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, generator)
        return self.norm(x)


class ChannelLayerNorm(nn.LayerNorm):
    """flax's LayerNorm over the channels of an NCHW map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _up2(t: torch.Tensor) -> torch.Tensor:
    return F.interpolate(t, scale_factor=2, mode="nearest")


class SimpleFPN(nn.Module):
    """The single-scale ViT map -> strides (4, 8, 16, 32, 64), NCHW."""

    def __init__(self, in_channels: int, channels: int = 256):
        super().__init__()
        for name in ("s4_lat", "s8_lat", "s16_lat", "s32_lat"):
            setattr(self, name, nn.Conv2d(in_channels, channels, 1))
        for i in range(4):
            setattr(self, f"ln_a_{i}", ChannelLayerNorm(channels, eps=LN_EPS))
            setattr(self, f"out_{i}", nn.Conv2d(channels, channels, 3, padding=1))
            setattr(self, f"ln_b_{i}", ChannelLayerNorm(channels, eps=LN_EPS))

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        levels = (self.s4_lat(_up2(_up2(x))), self.s8_lat(_up2(x)), self.s16_lat(x),
                  self.s32_lat(F.max_pool2d(x, 2, 2)))
        outs = []
        for i, f in enumerate(levels):
            f = getattr(self, f"out_{i}")(getattr(self, f"ln_a_{i}")(f))
            outs.append(getattr(self, f"ln_b_{i}")(f))
        outs.append(subsample2(outs[-1]))  # stride 64
        return outs


class Conv4FC1BoxHead(nn.Module):
    """mmdet Shared4Conv1FCBBoxHead: (R, 7, 7, C) NHWC RoIs -> (cls, reg)."""

    def __init__(self, num_classes: int, in_channels: int, roi_size: int):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i}", nn.Conv2d(in_channels if i == 0 else 256, 256, 3,
                                                padding=1))
            setattr(self, f"ln{i}", ChannelLayerNorm(256, eps=LN_EPS))
        self.fc = nn.Linear(roi_size ** 2 * 256, 1024)
        self.cls = nn.Linear(1024, num_classes + 1)
        self.reg = nn.Linear(1024, 4 * num_classes)

    def forward(self, roi_feats: torch.Tensor):
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"ln{i}")(getattr(self, f"conv{i}")(x)))
        x = F.relu(self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))
        return self.cls(x).float(), self.reg(x).float()


class ViTDet(nn.Module):
    def __init__(self, config: ViTDetConfig):
        super().__init__()
        self.config = cfg = config
        self.backbone = ViTBackbone(cfg)
        self.fpn = SimpleFPN(cfg.embed_dim, cfg.fpn_channels)
        self.rpn = RPNHead(len(cfg.anchor_scales) * len(cfg.anchor_ratios), cfg.fpn_channels)
        self.box_head = Conv4FC1BoxHead(cfg.num_classes, cfg.fpn_channels, cfg.roi_size)

    def forward(self, x: torch.Tensor, rois: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """As ``FasterRCNN.forward``; ``generator`` draws the drop path's masks."""
        if rois is not None:
            return roi_heads(self.box_head, x, rois, self.config.strides[0], self.config.roi_size)
        pyramid = self.fpn(self.backbone(x, generator))
        return pyramid, self.rpn(pyramid)


@dataclasses.dataclass
class ViTDetFamily(TwoStageFamily):
    config: ViTDetConfig = dataclasses.field(default_factory=ViTDetConfig)

    def __post_init__(self):
        self.model = ViTDet(self.config)
        self._setup()

    def init_variables(self, generator: torch.Generator) -> Tensors:
        """flax's default init; ``pos_embed`` normal(0.02), the rel-pos tables 0."""
        lecun_init_(self.model, generator)
        with torch.no_grad():
            bb = self.model.backbone
            bb.pos_embed.normal_(0.0, 0.02, generator=generator)
            for i in range(bb.depth):
                blk = getattr(bb, f"block_{i}")
                if blk.use_rel_pos:
                    blk.rel_pos_h.zero_()
                    blk.rel_pos_w.zero_()
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def loss_fn(self, variables: Tensors, batch: Tensors, generator: torch.Generator):
        """The samplers' uniforms, then the drop path's masks, from ``generator``."""
        return self.loss_with_draws(variables, batch, self.draw(generator, batch), generator)

    def loss_with_draws(self, variables: Tensors, batch: Tensors, draws: Tensors,
                        generator: Optional[torch.Generator] = None):
        """-> (loss, metrics, {}): no batch statistics."""
        self.model.train()
        try:
            pyramid, rpn_outs = self._extract(variables, batch["image"], generator=generator)
        finally:
            self.model.eval()
        loss, metrics = self.two_stage_loss(variables, pyramid, rpn_outs, batch, draws)
        return loss, metrics, {}
