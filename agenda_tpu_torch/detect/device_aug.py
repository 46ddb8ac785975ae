"""Device-side detection augmentation: the host plans, the card renders.

Counterpart of ``agenda_tpu/detect/device_aug.py``. The host augmentation
(numpy, one thread) cannot feed the card at the detector presets' batches,
so the work is split:

- the decoded train set lives on the card once, as a uint8 tensor
  (``dataset_tensor``): no image crosses the bus per batch;
- the host draws the random numbers in the host pipeline's order and does
  the box math with the same helpers (``AugPlanner``, ``ConcatAugPlanner``,
  ``LSJPlanner``): a few hundred bytes a sample, packed by ``plan_batch``
  into the reference's keys, dtypes and shapes;
- the card renders the pixels from the plans (``render_batch``: mosaic,
  affine and mixup as separable triangle-weight matmuls or per-pixel
  bilinear gathers, then box blur, gray, HSV; ``render_lsj_batch``: LSJ's
  antialiased resize as two filter matmuls with PIL's per-pass 8-bit
  rounding). MedianBlur and CLAHE (p = 0.01 each) are rendered on the host
  (``render_host``, the render's oracle too) into a scratch slab that the
  render copies in.

The render reads the samples' tail choices (``mix``, ``blur_k``, ``gray``,
``hsv_on``, ``pass_slot``) on the host and runs each tail, and the mixup
branch, only on the samples that take it: the same values as the
reference's whole-batch ``where``, with less work. The runner keeps those
five on the host, so picking the rows does not wait for the card.

``PlanPrefetcher`` builds whole epochs of plans in ``spawn`` worker
processes, each epoch from its own generator, so the plans are the serial
ones to the bit; the workers read the tiles from a read-only memory map of
a file the pool's owner writes, and never touch CUDA.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agenda_tpu_torch.detect.augment import (
    PAD_VAL,
    _odd_kernel,
    affine_boxes,
    affine_inverse,
    affine_matrix,
    box_blur_k,
    clahe,
    flip_horizontal,
    hsv_apply,
    lsj_boxes,
    lsj_params,
    median_blur_k,
    mixup_boxes,
    mosaic_regions,
    resize_bilinear_pil,
    to_gray,
    warp_affine_u8,
)

# plan keys the render reads on the host to pick a tail's rows
SELECTORS = ("mix", "blur_k", "gray", "hsv_on", "pass_slot")
PLAN_SEED = 1_000_003  # an epoch's plans draw from default_rng((seed + 1) * PLAN_SEED + epoch)


@dataclasses.dataclass
class Branch:
    """One render branch: an affine gather over a mosaic canvas or a single
    tile. ``inv`` maps OUTPUT pixel-centre coords to canvas pixel-centre
    coords (Pillow's convention: sample at inv @ centre - 0.5)."""

    idxs: np.ndarray            # (4,) int32 tile indices (slot 0 used if single)
    center: Tuple[int, int]     # mosaic centre (cx, cy); ignored if single
    inv: np.ndarray             # (3, 3) float32
    use_mosaic: bool
    clip_wh: Tuple[float, float]  # valid OUTPUT region (cw, ch); pad outside


@dataclasses.dataclass
class Plan:
    branches: List[Branch]        # 2; the second is MixUp's, or an inactive slot
    mix: bool
    flip: bool
    hsv_gains: Optional[np.ndarray]   # (3,) or None
    gray: bool
    blur_k: int                   # 0 = off, else 3/5/7 box blur
    median_k: int                 # 0 = off (the host renders it)
    clahe: bool                   # the host renders it
    passthrough: bool             # rendered on the host (MedianBlur/CLAHE)
    boxes: np.ndarray             # final (N, 4) xyxy


def _identity_branch(index: int, tw: int, th: int) -> Branch:
    return Branch(np.array([index] * 4, np.int32), (0, 0),
                  np.eye(3, dtype=np.float32), False, (float(tw), float(th)))


class _TileView:
    """What plan building and the host render read of a train dataset, in a
    worker process: the recipe as it stood when the pool started, each
    tile's boxes at img_scale, and the uint8 tiles from a read-only memory
    map of ``tiles_path`` (rows ``offset`` on)."""

    def __init__(self, aug, img_scale, boxes: List[np.ndarray], tiles_path: str, offset: int):
        self.aug, self.img_scale, self.boxes = aug, img_scale, boxes
        self.tiles_path, self.offset = tiles_path, offset
        self._tiles = None

    def __getstate__(self):
        return {**self.__dict__, "_tiles": None}

    def __len__(self):
        return len(self.boxes)

    def scaled_boxes(self, index: int) -> np.ndarray:
        return self.boxes[index].copy()

    def scaled_u8(self, index: int) -> np.ndarray:
        if self._tiles is None:
            self._tiles = np.load(self.tiles_path, mmap_mode="r")
        return self._tiles[self.offset + index]


class AugPlanner:
    """Per-sample plans from a train-mode ``CocoDetDataset`` (its tile
    cache on): the draw order of ``CocoDetDataset.__getitem__``."""

    def __init__(self, dataset):
        if dataset._scaled_cache is None:
            raise ValueError("device aug needs the dataset tile cache "
                             "(AGENDA_TORCH_IMG_CACHE_MB must cover the train set)")
        self.ds = dataset
        self.tw, self.th = dataset.img_scale

    @property
    def separable(self) -> bool:
        """True when the recipe's affine is axis-aligned (rotate 0, shear 0:
        every reference YOLO config), so ``render_batch`` may take the
        matmul form."""
        a = self.ds.aug
        return a.max_rotate_degree == 0.0 and a.max_shear_degree == 0.0

    def dataset_tensor(self) -> np.ndarray:
        """(N, th, tw, 3) uint8: the train set as the tile cache holds it
        (fills the cache on first call)."""
        out = np.empty((len(self.ds), self.th, self.tw, 3), np.uint8)
        for i in range(len(out)):
            out[i] = self.ds.scaled_u8(i)
        return out

    def for_worker(self, tiles_path: str, offset: int = 0) -> "AugPlanner":
        """A copy that pickles small: the dataset replaced by a view of its
        recipe, boxes and the tiles written to ``tiles_path``."""
        view = _TileView(self.ds.aug, self.ds.img_scale,
                         [self.ds.scaled_boxes(i) for i in range(len(self.ds))],
                         tiles_path, offset)
        lite = copy.copy(self)
        lite.ds = view
        return lite

    def _tile_u8(self, index: int) -> np.ndarray:
        """A tile by its row of the dataset tensor (ConcatAugPlanner routes)."""
        return self.ds.scaled_u8(index)

    # -- plan building -------------------------------------------------------

    def _affine_draw(self, rng, in_size):
        a = self.ds.aug
        return affine_matrix(rng, in_size, (self.tw, self.th),
                             max_rotate_degree=a.max_rotate_degree,
                             max_shear_degree=a.max_shear_degree,
                             scaling_ratio_range=(1 - a.affine_scale, 1 + a.affine_scale),
                             max_translate_ratio=a.max_translate_ratio)

    def _plan_mosaic_affine(self, index: int, rng):
        """Mosaic + RandomAffine branch, in the draw order of ``mosaic`` and
        ``random_affine``."""
        tw, th = self.tw, self.th
        cx = int(rng.uniform(0.5 * tw, 1.5 * tw))
        cy = int(rng.uniform(0.5 * th, 1.5 * th))
        idxs = [index] + [int(rng.integers(len(self.ds))) for _ in range(3)]
        regions, anchors = mosaic_regions(cx, cy, tw, th)
        # mosaic_region_boxes over the four tiles at once: the same f32
        # shift, clip and sliver filter, in the same order
        parts, shift_rows, lo_rows, hi_rows, counts = [], [], [], [], []
        for k, ((x1, y1, x2, y2), (ax, ay)) in enumerate(zip(regions, anchors)):
            rw, rh = x2 - x1, y2 - y1
            if rw <= 0 or rh <= 0:
                continue
            sx = tw - rw if ax else 0
            sy = th - rh if ay else 0
            tb = self.ds.scaled_boxes(idxs[k])
            if not len(tb):
                continue
            parts.append(tb)
            counts.append(len(tb))
            shift_rows.append((x1 - sx, y1 - sy, x1 - sx, y1 - sy))
            lo_rows.append((x1, y1, x1, y1))
            hi_rows.append((x2, y2, x2, y2))
        if parts:
            b = np.concatenate(parts) + np.repeat(np.array(shift_rows, np.float32), counts, axis=0)
            b = b.clip(np.repeat(np.array(lo_rows, np.float32), counts, axis=0),
                       np.repeat(np.array(hi_rows, np.float32), counts, axis=0))
            boxes = b[(b[:, 2] - b[:, 0] > 1) & (b[:, 3] - b[:, 1] > 1)]
        else:
            boxes = np.zeros((0, 4), np.float32)
        m = self._affine_draw(rng, (2 * tw, 2 * th))
        boxes = affine_boxes(boxes, m, (tw, th), max_aspect_ratio=20.0)
        br = Branch(np.array(idxs, np.int32), (cx, cy), affine_inverse(m).astype(np.float32),
                    True, (float(tw), float(th)))
        return br, boxes

    def plan_item(self, index: int, rng) -> Plan:
        a = self.ds.aug
        tw, th = self.tw, self.th
        branches: List[Branch] = []
        mix = False
        if a.mosaic:
            br, boxes = self._plan_mosaic_affine(index, rng)
            branches.append(br)
            if rng.random() < a.mixup_prob:
                mix = True
                j = int(rng.integers(len(self.ds)))
                if a.mixup_mosaic_pre:
                    br2, boxes2 = self._plan_mosaic_affine(j, rng)
                else:
                    br2, boxes2 = _identity_branch(j, tw, th), self.ds.scaled_boxes(j)
                # mixup's draws: the jitter ratio, then the flip
                scale = rng.uniform(0.5, 1.5)  # both images are (th, tw)
                nw, nh = max(1, int(tw * scale)), max(1, int(th * scale))
                flipped = rng.random() < 0.5
                # the jitter resize (and the flip within nw) folded into the gather
                comb = br2.inv @ np.diag([1.0 / scale, 1.0 / scale, 1.0]).astype(np.float32)
                if flipped:
                    comb = comb @ np.array([[-1, 0, nw], [0, 1, 0], [0, 0, 1]], np.float32)
                cw, ch = min(nw, tw), min(nh, th)
                branches.append(dataclasses.replace(br2, inv=comb.astype(np.float32),
                                                    clip_wh=(float(cw), float(ch))))
                b2 = mixup_boxes(boxes2, scale, nw, flipped, cw, ch)
                if len(b2):
                    boxes = np.concatenate([boxes, b2])
        elif a.standalone_affine:
            m = self._affine_draw(rng, (tw, th))
            boxes = affine_boxes(self.ds.scaled_boxes(index), m, (tw, th), max_aspect_ratio=100.0)
            branches.append(Branch(np.array([index] * 4, np.int32), (0, 0),
                                   affine_inverse(m).astype(np.float32), False,
                                   (float(tw), float(th))))
        elif a.lsj:
            # LSJ renders raw tiles through an antialiased filter: LSJPlanner's job
            raise ValueError("LSJ recipes route to LSJPlanner (runner._make_planner does this)")
        else:
            branches.append(_identity_branch(index, tw, th))
            boxes = self.ds.scaled_boxes(index)

        # the photometric block, in CocoDetDataset.__getitem__'s draw order
        blur_k = median_k = 0
        clahe_on = passthrough = False
        if a.blur_prob > 0 and rng.random() < a.blur_prob:
            blur_k = _odd_kernel(rng)
        if a.median_blur_prob > 0 and rng.random() < a.median_blur_prob:
            median_k = _odd_kernel(rng)
            passthrough = True
        gray = bool(a.to_gray_prob > 0 and rng.random() < a.to_gray_prob)
        if a.clahe_prob > 0 and rng.random() < a.clahe_prob:
            clahe_on = passthrough = True
        hsv_gains = None
        if a.hsv:
            hsv_gains = (rng.uniform(-1, 1, 3) * np.array(
                [a.hue_delta, a.saturation_delta, a.value_delta], np.float32)).astype(np.float32)
        flip = rng.random() < a.flip_prob
        if flip and len(boxes):
            _, boxes = flip_horizontal(np.zeros((1, tw, 3), np.float32), boxes)
        if len(branches) == 1:
            branches.append(_identity_branch(index, tw, th))  # the inactive slot
        return Plan(branches, mix, flip, hsv_gains, gray, blur_k, median_k, clahe_on,
                    passthrough, boxes)

    def plan_batch(self, indices, rng, max_gt: int, scratch_slots: int):
        """-> (packed plan arrays, scratch f32 (K, th, tw, 3), plans).

        Passthrough samples (MedianBlur, CLAHE) are rendered on the host
        into the scratch slab; past the slab's K slots they take the device
        render without the rare op, as the reference does."""
        b = len(indices)
        scratch_slots = max(1, scratch_slots)  # keeps the render's gather well-formed
        plans = [self.plan_item(int(i), rng) for i in indices]
        packed = {
            "idx": np.zeros((b, 2, 4), np.int32),
            "center": np.zeros((b, 2, 2), np.float32),
            "inv": np.zeros((b, 2, 3, 3), np.float32),
            "use_mosaic": np.zeros((b, 2), bool),
            "clip": np.zeros((b, 2, 2), np.float32),
            "mix": np.zeros((b,), np.float32),
            "flip": np.zeros((b,), bool),
            "hsv_on": np.zeros((b,), bool),
            "hsv_gains": np.zeros((b, 3), np.float32),
            "gray": np.zeros((b,), bool),
            "blur_k": np.zeros((b,), np.int32),
            "pass_slot": np.full((b,), -1, np.int32),
            "gt_boxes": np.zeros((b, max_gt, 4), np.float32),
            "gt_valid": np.zeros((b, max_gt), bool),
        }
        scratch = np.zeros((scratch_slots, self.th, self.tw, 3), np.float32)
        slot = 0
        for i, p in enumerate(plans):
            for br_i, br in enumerate(p.branches):
                packed["idx"][i, br_i] = br.idxs
                packed["center"][i, br_i] = br.center
                packed["inv"][i, br_i] = br.inv
                packed["use_mosaic"][i, br_i] = br.use_mosaic
                packed["clip"][i, br_i] = br.clip_wh
            packed["mix"][i] = 0.5 if p.mix else 0.0
            packed["flip"][i] = p.flip
            packed["hsv_on"][i] = p.hsv_gains is not None
            if p.hsv_gains is not None:
                packed["hsv_gains"][i] = p.hsv_gains
            packed["gray"][i] = p.gray
            packed["blur_k"][i] = p.blur_k
            if p.passthrough and slot < scratch_slots:
                scratch[slot] = self.render_host(p)
                packed["pass_slot"][i] = slot
                slot += 1
            nb = min(len(p.boxes), max_gt)
            if nb:
                packed["gt_boxes"][i, :nb] = p.boxes[:nb]
                packed["gt_valid"][i, :nb] = True
        return packed, scratch, plans

    # -- the host render -----------------------------------------------------

    def render_host(self, plan: Plan) -> np.ndarray:
        """The plan rendered on the host (the device render's oracle, and
        the passthrough samples' path): the same matrices, Pillow's pixels,
        MedianBlur and CLAHE exact."""
        img = self._render_branch_host(plan.branches[0])
        if plan.mix:
            img = (0.5 * img + 0.5 * self._render_branch_host(plan.branches[1])).astype(np.float32)
        if plan.blur_k:
            img = box_blur_k(img, plan.blur_k)
        if plan.median_k:
            img = median_blur_k(img, plan.median_k)
        if plan.gray:
            img = to_gray(img)
        if plan.clahe:
            img = clahe(img)
        if plan.hsv_gains is not None:
            img = hsv_apply(img, plan.hsv_gains)
        if plan.flip:
            img = np.ascontiguousarray(img[:, ::-1])
        return img.astype(np.float32)

    def _render_branch_host(self, br: Branch) -> np.ndarray:
        """One branch: the mosaic canvas (or the tile), Pillow's affine warp,
        the clip to the valid region."""
        tw, th = self.tw, self.th
        if br.use_mosaic:
            canvas = np.full((2 * th, 2 * tw, 3), int(PAD_VAL), np.uint8)
            regions, anchors = mosaic_regions(int(br.center[0]), int(br.center[1]), tw, th)
            for k, ((x1, y1, x2, y2), (ax, ay)) in enumerate(zip(regions, anchors)):
                rw, rh = x2 - x1, y2 - y1
                if rw <= 0 or rh <= 0:
                    continue
                sx = tw - rw if ax else 0
                sy = th - rh if ay else 0
                canvas[y1:y2, x1:x2] = self._tile_u8(int(br.idxs[k]))[sy:sy + rh, sx:sx + rw]
        else:
            canvas = self._tile_u8(int(br.idxs[0]))
        out = warp_affine_u8(canvas, br.inv, (tw, th)).astype(np.float32)
        cw, ch = int(br.clip_wh[0]), int(br.clip_wh[1])
        if cw < tw or ch < th:
            clipped = np.full_like(out, PAD_VAL)
            clipped[:ch, :cw] = out[:ch, :cw]
            out = clipped
        return out


class ConcatAugPlanner(AugPlanner):
    """Device aug over a ``ConcatDataset`` (the synthetic_target stage's
    with-cars + without-cars sets): one tensor holds every part's tiles;
    each sample plans within its own part (mosaic and mixup retrieve from
    it, as the reference's per-part Mosaic does), its tile indices shifted
    into the combined tensor."""

    def __init__(self, concat):
        self.parts = [AugPlanner(d) for d in concat.datasets]
        scales = {p.ds.img_scale for p in self.parts}
        if len(scales) != 1:
            raise ValueError(f"parts disagree on img_scale: {scales}")
        self.tw, self.th = next(iter(scales))
        self._offsets = np.cumsum([0] + [len(p.ds) for p in self.parts])

    @property
    def separable(self) -> bool:
        return all(p.separable for p in self.parts)

    def dataset_tensor(self) -> np.ndarray:
        return np.concatenate([p.dataset_tensor() for p in self.parts])

    def for_worker(self, tiles_path: str, offset: int = 0) -> "ConcatAugPlanner":
        lite = copy.copy(self)
        lite.parts = [p.for_worker(tiles_path, offset + int(off))
                      for p, off in zip(self.parts, self._offsets)]
        return lite

    def _route(self, gindex: int):
        pi = int(np.searchsorted(self._offsets, gindex, side="right") - 1)
        return self.parts[pi], int(self._offsets[pi]), gindex - int(self._offsets[pi])

    def _tile_u8(self, index: int) -> np.ndarray:
        part, _, local = self._route(index)
        return part.ds.scaled_u8(local)

    def plan_item(self, gindex: int, rng) -> Plan:
        part, off, local = self._route(gindex)
        plan = part.plan_item(local, rng)
        if off:
            for br in plan.branches:
                br.idxs = br.idxs + np.int32(off)
        return plan


class LSJPlanner:
    """Device LSJ (the ViTDet heatmap stage's recipe): flip (p = 0.5), a
    keep-ratio resize by 0.1-2.0 with Pillow's antialiased BILINEAR, an
    absolute crop, Pad(114). The geometry is an axis-aligned map of the raw
    tile, so the render is two filter matmuls a sample, their weights built
    on the card from each sample's (scale, crop, flip). Plans run over the
    raw tiles, so every tile must have one source size."""

    separable = True  # the render is always the matmul form

    def __init__(self, dataset):
        if not dataset.aug.lsj:
            raise ValueError("LSJPlanner needs an LSJ recipe")
        src = dataset.source_size()
        if src is None:
            raise ValueError("device LSJ needs a uniform source tile size")
        self.ds = dataset
        self.sw, self.sh = src
        self.tw, self.th = dataset.img_scale

    def dataset_tensor(self) -> np.ndarray:
        """(N, sh, sw, 3) uint8: the tiles as decoded."""
        out = np.empty((len(self.ds), self.sh, self.sw, 3), np.uint8)
        for i in range(len(out)):
            img = self.ds._decode(i)
            if img.shape[:2] != (self.sh, self.sw):
                raise ValueError(f"tile {i} is {img.shape[:2]}, expected {(self.sh, self.sw)} "
                                 "(the COCO metadata is wrong)")
            out[i] = img
        return out

    def for_worker(self, tiles_path: str, offset: int = 0) -> "LSJPlanner":
        """LSJ renders nothing on the host, so a worker needs no tiles."""
        return self

    def plan_item(self, index: int, rng) -> dict:
        """``CocoDetDataset.__getitem__``'s LSJ draws: the flip, then the
        ratio and crop inside ``lsj``; no tail flip."""
        a = self.ds.aug
        boxes = self.ds._raw_boxes(index)
        flip = rng.random() < a.flip_prob
        if flip and len(boxes):
            _, boxes = flip_horizontal(np.zeros((1, self.sw, 3), np.float32), boxes)
        scale, nw, nh, x0, y0 = lsj_params(rng, (self.sh, self.sw), (self.tw, self.th),
                                           a.lsj_ratio_range)
        boxes = lsj_boxes(boxes, scale, nw, nh, x0, y0, (self.tw, self.th))
        return {"index": index, "flip": flip, "scale": scale, "nw": nw, "nh": nh,
                "x0": x0, "y0": y0, "boxes": boxes}

    def plan_batch(self, indices, rng, max_gt: int, scratch_slots: int):
        """``AugPlanner.plan_batch``'s contract; the scratch slab stays unused."""
        b = len(indices)
        plans = [self.plan_item(int(i), rng) for i in indices]
        packed = {
            "lsj_idx": np.zeros((b,), np.int32),
            "lsj_flip": np.zeros((b,), bool),
            "lsj_snwh": np.zeros((b, 3), np.float32),  # scale, nw, nh
            "lsj_xy0": np.zeros((b, 2), np.float32),
            "pass_slot": np.full((b,), -1, np.int32),
            "gt_boxes": np.zeros((b, max_gt, 4), np.float32),
            "gt_valid": np.zeros((b, max_gt), bool),
        }
        for i, p in enumerate(plans):
            packed["lsj_idx"][i] = p["index"]
            packed["lsj_flip"][i] = p["flip"]
            packed["lsj_snwh"][i] = (p["scale"], p["nw"], p["nh"])
            packed["lsj_xy0"][i] = (p["x0"], p["y0"])
            nb = min(len(p["boxes"]), max_gt)
            if nb:
                packed["gt_boxes"][i, :nb] = p["boxes"][:nb]
                packed["gt_valid"][i, :nb] = True
        scratch = np.zeros((max(1, scratch_slots), self.th, self.tw, 3), np.float32)
        return packed, scratch, plans

    def render_host(self, plan: dict) -> np.ndarray:
        """The plan's draws replayed through the dataset's LSJ pixels."""
        img = self.ds._decode(plan["index"])
        if plan["flip"]:
            img = np.ascontiguousarray(img[:, ::-1])
        resized = resize_bilinear_pil(img, plan["nw"], plan["nh"]).astype(np.float32)
        crop = resized[plan["y0"]:plan["y0"] + self.th, plan["x0"]:plan["x0"] + self.tw]
        canvas = np.full((self.th, self.tw, 3), PAD_VAL, np.float32)
        canvas[:crop.shape[0], :crop.shape[1]] = crop
        return canvas


def epoch_plans(planner, batches, rng, max_gt: int, slots: int):
    """-> (packed, scratch or None) for each index batch, in order: the
    scratch slab only when a passthrough sample uses it."""
    for idx_b in batches:
        packed, scratch, _ = planner.plan_batch(idx_b, rng, max_gt, scratch_slots=slots)
        yield packed, (scratch if (packed["pass_slot"] >= 0).any() else None)


# ---------------------------------------------------------------------------
# the render (tensors on the card, or on the CPU for the tests)
# ---------------------------------------------------------------------------


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor to ``dev``, from pinned memory without waiting."""
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _pil_bilinear_weights(out_len: int, src_len: int, nsz, off, flip=None) -> torch.Tensor:
    """(B, out_len, src_len) PIL-BILINEAR filter rows: row j maps output j
    to resized coordinate j + off of a src_len -> nsz resize (centre
    (j + off + 0.5) src / nsz, the window [int(c - fs + 0.5), int(c + fs +
    0.5)) clipped to the source, the triangle kernel, each row normalised).
    Rows at j + off >= nsz are zero (the caller pads them). ``flip``
    reverses the source axis (LSJ flips the raw tile before its resize)."""
    f32, dev = torch.float32, nsz.device
    j = torch.arange(out_len, dtype=f32, device=dev)[None, :]
    x = torch.arange(src_len, dtype=f32, device=dev)[None, None, :]
    ss = src_len / nsz[:, None]
    fs = torch.clamp(ss, min=1.0)
    center = (j + off[:, None] + 0.5) * ss
    xmin = torch.clamp(torch.floor(center - fs + 0.5), min=0.0)
    xmax = torch.clamp(torch.floor(center + fs + 0.5), max=float(src_len))
    w = torch.clamp(1.0 - torch.abs((x - center[..., None] + 0.5) / fs[..., None]), min=0.0)
    w = w * ((x >= xmin[..., None]) & (x < xmax[..., None]))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    w = w * ((j + off[:, None]) < nsz[:, None])[..., None]
    if flip is not None:
        w = torch.where(flip[:, None, None], w.flip(-1), w)
    return w


def render_lsj_batch(data_u8: torch.Tensor, plans: Dict[str, torch.Tensor],
                     out_hw: Tuple[int, int], src_hw: Tuple[int, int]) -> torch.Tensor:
    """A batch of LSJ plans from the raw-tile tensor: two filter matmuls a
    sample, each rounded to a level as Pillow's 8-bit passes are, then the
    Pad(114) beyond the resized extent. -> (B, th, tw, 3) f32 in 0..1."""
    oh, ow = out_hw
    sh, sw = src_hw
    snwh, xy0 = plans["lsj_snwh"], plans["lsj_xy0"]
    nw, nh, x0, y0 = snwh[:, 1], snwh[:, 2], xy0[:, 0], xy0[:, 1]
    tiles = data_u8[plans["lsj_idx"].long()].to(torch.float32)  # (B, sh, sw, 3)
    wx = _pil_bilinear_weights(ow, sw, nw, x0, flip=plans["lsj_flip"])
    wy = _pil_bilinear_weights(oh, sh, nh, y0)
    # Pillow's order: horizontal pass, quantize, vertical pass, quantize
    t = torch.round(torch.clamp(torch.einsum("bWw,bhwc->bhWc", wx, tiles), 0.0, 255.0))
    t = torch.round(torch.clamp(torch.einsum("bHh,bhWc->bHWc", wy, t), 0.0, 255.0))
    jj = torch.arange(ow, dtype=torch.float32, device=data_u8.device)
    ii = torch.arange(oh, dtype=torch.float32, device=data_u8.device)
    valid = (((jj[None, None, :] + x0[:, None, None]) < nw[:, None, None])
             & ((ii[None, :, None] + y0[:, None, None]) < nh[:, None, None]))
    return torch.where(valid[..., None], t, PAD_VAL) / 255.0


def _hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """YOLOXHSVRandomAug on (R, H, W, 3) f32 0..255 with gains (R, 3): the
    formulas of ``augment.hsv_apply``, the reference's order of operations."""
    r, g, b = img.unbind(-1)
    mx = img.amax(-1)
    diff = mx - img.amin(-1)
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.zeros_like(mx)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0), h)
    h = torch.where(mx == g, (b - r) / safe + 2.0, h)
    h = torch.where(mx == b, (r - g) / safe + 4.0, h)
    h = torch.remainder(h * 30.0, 180.0)
    s = torch.where(mx > 0, diff / torch.clamp(mx, min=1e-9) * 255.0, 0.0)
    h = torch.remainder(h + gains[:, 0:1, None], 180.0)
    s = torch.clamp(s + gains[:, 1:2, None], 0, 255)
    v = torch.clamp(mx + gains[:, 2:3, None], 0, 255)
    h6 = torch.remainder(h / 30.0, 6.0)
    c = v * (s / 255.0)
    x = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    m = v - c
    sector = h6.to(torch.int32)
    z = torch.zeros_like(c)

    def select(by_sector, default):  # jnp.select over sectors 0-4
        out = default
        for k in reversed(range(5)):
            out = torch.where(sector == k, by_sector[k], out)
        return out

    rr = select((c, x, z, z, x), c)
    gg = select((x, c, c, x, z), z)
    bb = select((z, z, x, c, c), x)
    return torch.clamp(torch.stack([rr + m, gg + m, bb + m], dim=-1), 0, 255)


def _box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """(R, H, W, 3) box blur with reflect borders, two separable passes."""
    p = k // 2
    h, w = img.shape[1:3]
    x = F.pad(img.permute(0, 3, 1, 2), (0, 0, p, p), mode="reflect")
    x = sum(x[:, :, d:d + h] for d in range(k)) / k
    x = F.pad(x, (p, p, 0, 0), mode="reflect")
    x = sum(x[:, :, :, d:d + w] for d in range(k)) / k
    return x.permute(0, 2, 3, 1)


def _geometry(plans, br: int, rows: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One branch's per-sample geometry, of the rows given or of all."""
    g = {k: plans[k][:, br] for k in ("inv", "center", "idx", "use_mosaic", "clip")}
    g["flip"] = plans["flip"]
    return g if rows is None else {k: v[rows] for k, v in g.items()}


def _branch_separable(data_u8, g, th: int, tw: int) -> torch.Tensor:
    """out[i, j] = sum_k Wy_k @ tile_k @ Wx_k^T + (1 - wsum) PAD.

    With an axis-aligned inverse map the two bilinear corner weights along
    each axis are the triangle kernel max(0, 1 - |s - x|), and each canvas
    corner lies in at most one mosaic tile's window (quadrant routing by
    ix >= cx coincides with the windows [cx - tw, cx) and [cx, cx + tw)),
    so the per-tile separable sums add up to the gather's bilinear value;
    corners outside every window contribute their weight x PAD through the
    (1 - wsum) complement."""
    f32, dev = torch.float32, data_u8.device
    inv, cxy, idxs, mos, clip = g["inv"], g["center"], g["idx"], g["use_mosaic"], g["clip"]
    r = inv.shape[0]
    jj = torch.arange(tw, dtype=f32, device=dev) + 0.5
    px = torch.where(g["flip"][:, None], tw - jj[None, :], jj[None, :])  # (R, tw)
    ii = torch.arange(th, dtype=f32, device=dev) + 0.5
    sx = inv[:, 0, 0, None] * px + inv[:, 0, 2, None] - 0.5
    sy = inv[:, 1, 1, None] * ii[None, :] + inv[:, 1, 2, None] - 0.5
    k = torch.arange(4, device=dev)
    kx, ky = (k % 2).to(f32), (k // 2).to(f32)  # right half, bottom half
    ox = torch.where(mos[:, None], cxy[:, 0:1] - tw + kx[None] * tw, 0.0)
    oy = torch.where(mos[:, None], cxy[:, 1:2] - th + ky[None] * th, 0.0)
    act = mos[:, None] | (k[None, :] == 0)
    cw = torch.where(mos, 2.0 * tw, 1.0 * tw)  # canvas bounds (R,)
    ch = torch.where(mos, 2.0 * th, 1.0 * th)
    x = torch.arange(tw, dtype=f32, device=dev)  # tile texel coords
    y = torch.arange(th, dtype=f32, device=dev)
    # Wx[b, k, j, x]: the triangle weight, masked to active tiles and to
    # texels whose canvas coordinate lies inside the canvas
    canv_x = x[None, None, :] + ox[:, :, None]
    in_cx = (canv_x >= 0) & (canv_x < cw[:, None, None])
    tx = sx[:, None, :, None] - ox[:, :, None, None] - x[None, None, None, :]
    wx = torch.clamp(1.0 - torch.abs(tx), min=0.0) * (act[:, :, None] & in_cx)[:, :, None, :]
    canv_y = y[None, None, :] + oy[:, :, None]
    in_cy = (canv_y >= 0) & (canv_y < ch[:, None, None])
    ty = sy[:, None, :, None] - oy[:, :, None, None] - y[None, None, None, :]
    wy = torch.clamp(1.0 - torch.abs(ty), min=0.0) * in_cy[:, :, None, :]
    tiles = data_u8[idxs.reshape(-1).long()].reshape(r, 4, th, tw, 3).to(f32)
    tmp = torch.einsum("bkiy,bkyxc->bkixc", wy, tiles)
    val = torch.einsum("bkjx,bkixc->bijc", wx, tmp)
    wsum = torch.einsum("bki,bkj->bij", wy.sum(-1), wx.sum(-1))
    v = val + (1.0 - wsum)[..., None] * PAD_VAL
    in_clip = ((px[:, None, :] < clip[:, 0, None, None])
               & (ii[None, :, None] < clip[:, 1, None, None]))
    return torch.where(in_clip[..., None], v, PAD_VAL)


def _branch_gather(data_u8, g, th: int, tw: int) -> torch.Tensor:
    """Per-pixel bilinear gather: every output pixel applies the inverse
    affine, resolves its mosaic quadrant and reads four texels (any affine)."""
    f32, dev = torch.float32, data_u8.device
    inv, cxy, idxs, clip = g["inv"], g["center"], g["idx"], g["clip"]
    mos = g["use_mosaic"][:, None, None]
    r = inv.shape[0]
    flat = data_u8.reshape(-1, 3)
    ys, xs = torch.meshgrid(torch.arange(th, device=dev), torch.arange(tw, device=dev),
                            indexing="ij")
    pcx = (xs.to(f32) + 0.5).expand(r, th, tw)
    pcy = (ys.to(f32) + 0.5).expand(r, th, tw)
    # the tail flip folded as an output-coordinate remap (blur, HSV and gray
    # commute with a horizontal flip)
    pcx = torch.where(g["flip"][:, None, None], tw - pcx, pcx)
    sx = (inv[:, 0, 0, None, None] * pcx + inv[:, 0, 1, None, None] * pcy
          + inv[:, 0, 2, None, None]) - 0.5
    sy = (inv[:, 1, 0, None, None] * pcx + inv[:, 1, 1, None, None] * pcy
          + inv[:, 1, 2, None, None]) - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0
    cx = cxy[:, 0, None, None].to(torch.int32)
    cy = cxy[:, 1, None, None].to(torch.int32)

    def canvas_at(iy, ix):
        iy, ix = iy.to(torch.int32), ix.to(torch.int32)
        right, bottom = ix >= cx, iy >= cy
        # mosaic: tile k = 2 bottom + right, source coords relative to the
        # centre (out of the tile -> pad, which realises the region clamping)
        msx = ix - cx + torch.where(right, 0, tw)
        msy = iy - cy + torch.where(bottom, 0, th)
        k = 2 * bottom.long() + right.long()
        tile_m = torch.gather(idxs, 1, k.reshape(r, -1)).reshape(k.shape)
        valid_m = ((msx >= 0) & (msx < tw) & (msy >= 0) & (msy < th)
                   & (ix >= 0) & (ix < 2 * tw) & (iy >= 0) & (iy < 2 * th))
        valid_s = (ix >= 0) & (ix < tw) & (iy >= 0) & (iy < th)  # the canvas is tile idxs[0]
        tile = torch.where(mos, tile_m, idxs[:, 0, None, None])
        vx = torch.where(mos, msx, ix)
        vy = torch.where(mos, msy, iy)
        valid = torch.where(mos, valid_m, valid_s)
        lin = (tile.long() * (th * tw) + torch.clamp(vy, 0, th - 1).long() * tw
               + torch.clamp(vx, 0, tw - 1).long())
        px = flat[lin.reshape(-1)].reshape(*lin.shape, 3).to(f32)
        return torch.where(valid[..., None], px, PAD_VAL)

    v = ((1 - wx)[..., None] * (1 - wy)[..., None] * canvas_at(y0, x0)
         + wx[..., None] * (1 - wy)[..., None] * canvas_at(y0, x0 + 1)
         + (1 - wx)[..., None] * wy[..., None] * canvas_at(y0 + 1, x0)
         + wx[..., None] * wy[..., None] * canvas_at(y0 + 1, x0 + 1))
    in_clip = (pcx < clip[:, 0, None, None]) & (pcy < clip[:, 1, None, None])
    return torch.where(in_clip[..., None], v, PAD_VAL)


def render_batch(data_u8: torch.Tensor, scratch: torch.Tensor, plans: Dict[str, torch.Tensor],
                 tile_hw: Tuple[int, int], separable: bool = True) -> torch.Tensor:
    """A batch of plans rendered from the dataset tensor.

    data_u8: (N, th, tw, 3) uint8; scratch: (K, th, tw, 3) f32 0..255;
    plans: ``AugPlanner.plan_batch``'s arrays as tensors, on data_u8's
    device except ``SELECTORS``, which are read on the host (a selector on
    the card is copied back first). ``separable`` takes the matmul form,
    which needs an axis-aligned affine (``AugPlanner.separable``); else the
    per-pixel gather. The mixup branch and each tail run on the samples
    that take them, in the reference's order: mixup blend, box blur 3/5/7,
    gray, HSV, then the passthrough samples' host renders.
    -> (B, th, tw, 3) f32 in 0..1 (the train step's ``image``)."""
    th, tw = tile_hw
    dev = data_u8.device
    sel = {k: plans[k].cpu() for k in SELECTORS}
    branch = _branch_separable if separable else _branch_gather

    def rows_where(mask):
        rows = torch.nonzero(mask).flatten()
        return rows, (_to(rows, dev) if len(rows) else None)

    out = branch(data_u8, _geometry(plans, 0), th, tw)
    rows, r = rows_where(sel["mix"] > 0)
    if r is not None:
        mix = _to(sel["mix"][rows], dev)[:, None, None, None]
        out[r] = (1 - mix) * out[r] + mix * branch(data_u8, _geometry(plans, 1, r), th, tw)
    for k in (3, 5, 7):
        _, r = rows_where(sel["blur_k"] == k)
        if r is not None:
            out[r] = _box_blur(out[r], k)
    _, r = rows_where(sel["gray"])
    if r is not None:
        o = out[r]
        luma = 0.299 * o[..., 0] + 0.587 * o[..., 1] + 0.114 * o[..., 2]
        out[r] = luma[..., None].expand(-1, -1, -1, 3)
    _, r = rows_where(sel["hsv_on"])
    if r is not None:
        out[r] = _hsv_jitter(out[r], plans["hsv_gains"][r])
    rows, r = rows_where(sel["pass_slot"] >= 0)
    if r is not None:
        out[r] = scratch[_to(sel["pass_slot"][rows].long(), dev)]
    return out / 255.0


# ---------------------------------------------------------------------------
# plan building in worker processes, an epoch a job
# ---------------------------------------------------------------------------


def _plan_epoch(job, epoch: int):
    """Worker body: every plan batch of one epoch, from its own generator."""
    planner, batches_fn, seed_base, max_gt, slots = job
    rng = np.random.default_rng(seed_base + epoch)
    return list(epoch_plans(planner, batches_fn(epoch), rng, max_gt, slots))


class PlanPrefetcher:
    """Device-aug plans built ahead in worker processes (the role of the
    reference's DataLoader ``num_workers``).

    An epoch's plans come from its own ``default_rng(seed_base + epoch)``
    and its batches are a pure function of (seed, epoch)
    (``DataLoader.batches_for_epoch``), so epochs are independent jobs:
    worker k plans epoch e + k while the trainer consumes epoch e, and the
    plans equal the serial path's to the bit.

    The workers are ``spawn``ed: the trainer's process may run CUDA, a
    checkpoint writer thread and torch's thread pool, whose locks a forked
    child would inherit. They get the planner's small state (recipe, boxes)
    pickled with each job, and read the tiles (for the passthrough
    renders) from a read-only memory map of ``tiles``, written to a
    temporary ``.npy`` file that ``close`` deletes. ``batches_fn`` must
    pickle small too (a ``DataLoader`` over ``range(n)``). Epochs at or past
    ``stop_epoch`` (the mosaic-close switch changes the recipe) are not
    prefetched: ``epoch_batches`` returns None for them. The pool starts
    with the first epoch it prefetches (none for a run resumed past
    ``stop_epoch``).
    """

    def __init__(self, planner, batches_fn, seed_base: int, max_gt: int, slots: int,
                 workers: int, tiles: np.ndarray, stop_epoch: Optional[int] = None):
        self._args = (planner, batches_fn, int(seed_base), int(max_gt), int(slots))
        self._tiles, self.workers = tiles, workers
        self.stop_epoch = stop_epoch
        self.depth = workers + 1  # epochs in flight: one a worker, and the one being read
        self._pool = self._path = None
        self._pending = {}

    def _start(self) -> None:
        import multiprocessing as mp

        fd, self._path = tempfile.mkstemp(prefix="agenda_tiles_", suffix=".npy")
        os.close(fd)
        np.save(self._path, self._tiles)
        planner, *rest = self._args
        self._job = (planner.for_worker(self._path), *rest)
        self._pool = mp.get_context("spawn").Pool(processes=self.workers)
        self._tiles = None

    def _submit(self, epoch: int) -> None:
        if epoch in self._pending or (self.stop_epoch is not None and epoch >= self.stop_epoch):
            return
        if self._pool is None:
            self._start()
        self._pending[epoch] = self._pool.apply_async(_plan_epoch, (self._job, epoch))

    def epoch_batches(self, epoch: int):
        """-> the epoch's [(packed, scratch or None), ...], or None past
        ``stop_epoch``; schedules the next ``depth`` epochs."""
        for e in range(epoch, epoch + self.depth):
            self._submit(e)
        res = self._pending.pop(epoch, None)
        return None if res is None else res.get()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        self._pending, self._tiles = {}, None
        if self._path is not None and os.path.exists(self._path):
            os.unlink(self._path)
