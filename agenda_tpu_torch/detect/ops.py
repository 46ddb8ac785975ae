"""Detection ops on the device: IoU, greedy NMS batched over images, box
codecs, anchors, RoIAlign.

Counterpart of ``agenda_tpu/detect/ops.py``, with the same static-shape
semantics:

- ``nms_images`` runs greedy NMS for a whole batch of images at once: one
  stable descending sort, one (B, N, N) suppression mask, then one loop
  over the N ranks that carries every image's ``alive`` row (two kernels a
  rank, no host sync), and a static ``K = max_outputs`` output in which the
  invalid slots point at index 0 with ``valid=False``. The JAX package runs
  the same rank loop (a ``fori_loop``) under a ``vmap`` over the images.
- ``nms`` is one image of it; ``batched_nms`` is the per-class offset trick
  (torchvision's ``batched_nms``).
- ``anchor_points`` is the anchor-free grid of YOLOv8, ``grid_anchors``
  mmdet's AnchorGenerator, both in numpy as in JAX;
- ``encode_deltas``/``decode_deltas``: mmdet's DeltaXYWHBBoxCoder, with the
  reference's clamps (``1e-4`` on the widths, ``wh_ratio_clip``,
  ``max_shape``);
- ``roi_align``: the JAX function (``:207-264``), not mmcv's or
  torchvision's RoIAlign: ``sampling_ratio`` x ``sampling_ratio`` bilinear
  samples a bin at ``-0.5`` offset, each corner clamped into the map (no
  sample outside it is zeroed), averaged. Bilinear sampling on an
  axis-aligned grid is separable, so each RoI's output is ``Wy F Wx^T`` with
  two small weight matrices (every sample's two taps an axis, averaged over
  the bin's samples): the same weights on the same texels as the
  reference's four gathers, summed in another order. Gathers would hold
  four (B, R, 196, C) tensors, 13 GB each at the two-stage train step's
  batch 256; the matrices hold (B, R, 7, H) and the products run in chunks
  of images, forward and backward, so no intermediate outgrows about 1 GB.
"""

from __future__ import annotations

import functools
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


# ---------------------------------------------------------------------------
# Box codecs (mmdet DeltaXYWHBBoxCoder semantics)
# ---------------------------------------------------------------------------


def nested_tuple(values):
    """Lists (a config read from JSON) -> tuples, at every level."""
    return tuple(nested_tuple(v) for v in values) if isinstance(values, (list, tuple)) else values


@functools.lru_cache(maxsize=64)
def device_constant(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A constant (nested tuples of floats) on ``device``, copied there once:
    a copy from pageable memory would wait for the card's queue at every call."""
    return torch.tensor(values, dtype=torch.float32).to(device, dtype)


def _coder_consts(ref: torch.Tensor, values) -> torch.Tensor:
    return device_constant(nested_tuple(values), ref.device, ref.dtype)


def encode_deltas(anchors: torch.Tensor, gt: torch.Tensor,
                  means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    # clamped: a padded or degenerate box would give inf/NaN, which a 0 weight
    # downstream does not remove (0 * inf = NaN)
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=1e-4)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=1e-4)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-4)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-4)
    d = torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw), torch.log(gh / ah)],
                    dim=-1)
    return (d - _coder_consts(d, means)) / _coder_consts(d, stds)


def decode_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                  means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
                  max_shape: Optional[Tuple[int, int]] = None,
                  wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    d = deltas * _coder_consts(deltas, stds) + _coder_consts(deltas, means)
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    if max_shape is not None:
        hmax, wmax = max_shape
        out = torch.stack([out[..., 0].clamp(0, wmax), out[..., 1].clamp(0, hmax),
                           out[..., 2].clamp(0, wmax), out[..., 3].clamp(0, hmax)], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Anchors
# ---------------------------------------------------------------------------


def grid_anchors(feat_size: Tuple[int, int], stride: int, scales: Sequence[float],
                 ratios: Sequence[float], center_offset: float = 0.0,
                 base_size: Optional[float] = None) -> np.ndarray:
    """mmdet AnchorGenerator: (H*W*A, 4) xyxy anchors, row-major y,x grid."""
    base = base_size if base_size is not None else stride
    ws, hs = [], []
    for r in ratios:
        for s in scales:
            h_ratio = math.sqrt(r)
            w_ratio = 1.0 / h_ratio
            ws.append(base * s * w_ratio)
            hs.append(base * s * h_ratio)
    ws, hs = np.asarray(ws), np.asarray(hs)
    cx = cy = center_offset * stride
    base_anchors = np.stack([cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs], axis=1)
    fh, fw = feat_size
    sx, sy = np.meshgrid(np.arange(fw) * stride, np.arange(fh) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    out = (shifts[:, None, :] + base_anchors[None, :, :]).reshape(-1, 4)
    return out.astype(np.float32)


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


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------

ROI_CHUNK_ELEMENTS = 1 << 28  # the largest intermediate of a chunk of images (f32: 1 GiB)


def _axis_weights(lo: torch.Tensor, hi: torch.Tensor, size: int, out_size: int,
                  s: int) -> torch.Tensor:
    """(B, R) RoI extents along one axis -> (B, R, out_size, size): bin i's
    mean over its ``s`` samples of each sample's two clamped bilinear taps."""
    length = (hi - lo).clamp(min=1e-3)
    bin_len = length / out_size
    grid = (torch.arange(out_size, device=lo.device)[:, None]
            + (torch.arange(s, device=lo.device)[None, :] + 0.5) / s).reshape(-1).to(lo.dtype)
    pos = lo[..., None] + grid * bin_len[..., None] - 0.5  # (B, R, out*s)
    p0 = torch.floor(pos).clamp(0, size - 1)
    p1 = (p0 + 1).clamp(0, size - 1)
    w1 = (pos - p0).clamp(0.0, 1.0)
    idx = torch.arange(size, device=lo.device, dtype=lo.dtype)
    taps = ((idx == p0[..., None]) * (1 - w1)[..., None]
            + (idx == p1[..., None]) * w1[..., None])  # (B, R, out*s, size)
    return taps.reshape(*lo.shape, out_size, s, size).mean(dim=3)


def _chunks(b: int, per_image: int):
    step = max(1, ROI_CHUNK_ELEMENTS // max(1, per_image))
    return [(i, min(b, i + step)) for i in range(0, b, step)]


class _SeparableRoIAlign(torch.autograd.Function):
    """out[b, r, i, j] = sum_{y, x} wy[b, r, i, y] wx[b, r, j, x] f[b, y, x]
    for f (B, H, W, C); the gradient flows to f only (the RoIs are targets
    or detached proposals in the reference too)."""

    @staticmethod
    def forward(ctx, feats, wy, wx):
        ctx.save_for_backward(wy, wx)
        b, h, w, c = feats.shape
        r, o = wy.shape[1], wy.shape[2]
        out = feats.new_empty((b, r, o, o, c))
        for i, j in _chunks(b, r * o * w * c):
            # rows first: (n, R*o, H) @ (n, H, W*C) -> (n, R, o, W, C)
            t = torch.bmm(wy[i:j].reshape(j - i, r * o, h), feats[i:j].reshape(j - i, h, w * c))
            t = t.reshape(j - i, r, o, w, c)
            # then columns: (n, R, 1, o, W) @ (n, R, o, W, C) -> (n, R, o, o, C)
            out[i:j] = torch.matmul(wx[i:j, :, None], t)
        return out

    @staticmethod
    def backward(ctx, grad):
        wy, wx = ctx.saved_tensors
        b, r, o, _, c = grad.shape
        h, w = wy.shape[-1], wx.shape[-1]
        d = grad.new_empty((b, h, w, c))
        for i, j in _chunks(b, r * o * w * c):
            # (n, R, 1, W, o) @ (n, R, o, o, C) -> (n, R, o, W, C)
            g = torch.matmul(wx[i:j, :, None].transpose(-1, -2), grad[i:j])
            # (n, H, R*o) @ (n, R*o, W*C)
            d[i:j] = torch.bmm(wy[i:j].reshape(j - i, r * o, h).transpose(1, 2),
                               g.reshape(j - i, r * o, w * c)).reshape(j - i, h, w, c)
        return d, None, None


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign of every image's RoIs: features (B, H, W, C), rois (B, R, 4)
    xyxy already divided by the level's stride -> (B, R, out, out, C)."""
    _, h, w, _ = features.shape
    rois = rois.to(features.dtype)
    wy = _axis_weights(rois[..., 1], rois[..., 3], h, out_size, sampling_ratio)
    wx = _axis_weights(rois[..., 0], rois[..., 2], w, out_size, sampling_ratio)
    return _SeparableRoIAlign.apply(features, wy, wx)
