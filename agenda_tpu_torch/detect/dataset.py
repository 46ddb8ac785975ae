"""COCO detection dataset: the eval items and the train-time augmentation.

Counterpart of ``agenda_tpu/detect/dataset.py``:

- ``CocoDetDataset(train=False)``: ``__len__``, ``item_u8`` (the tile as
  decoded plus its boxes at ``img_scale``), ``source_size``,
  ``file_name``, the eval ``__getitem__`` and ``scale_back``;
- ``CocoDetDataset(train=True, aug=...)``: the tiles decoded and resized to
  ``img_scale`` once, into a uint8 cache (``_load_scaled``), and
  ``__getitem__``'s train recipes: mosaic + affine + mixup, the stage-2
  ``standalone_affine``, LSJ (on the tile as decoded, flipped before its
  resize), or plain, then the photometric tail (blur, median, gray, CLAHE,
  HSV, and the flip except after LSJ); ``scaled_boxes`` and
  ``scaled_u8`` (a tile's boxes, or its cached uint8 pixels, at
  ``img_scale`` without an f32 copy: what the device augmentation's
  planner reads). Each call draws from
  ``default_rng((calls * 2654435761 + index) mod 2**31)``, as the reference
  does, so a sample's draws depend on the order of the calls;
- GT padded to ``max_gt`` with a validity mask;
- ``ConcatDataset`` (the with-cars + without-cars set of the
  ``synthetic_target`` stage).

Tiles are decoded with the port's PNG reader (``utils/png.py``); other
formats raise. The host resize (``resize_u8_host``) is the arithmetic of the
JAX package's native bilinear resize (``native/image_ops.cc``), so a cached
tile is the reference's to the bit. The cache holds at most
``AGENDA_TORCH_IMG_CACHE_MB`` megabytes (default 2048; 0 turns it off).
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from agenda_tpu_torch.data.datasets import load_image_u8
from agenda_tpu_torch.data.device_resize import resize_weights
from agenda_tpu_torch.detect.augment import (
    AugConfig,
    blur,
    clahe,
    flip_horizontal,
    hsv_jitter,
    lsj,
    median_blur,
    mixup,
    mosaic,
    random_affine,
    to_gray,
)

CACHE_ENV = "AGENDA_TORCH_IMG_CACHE_MB"


@functools.lru_cache(maxsize=16)
def _pass_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(taps, weights) of one bilinear pass, each (out_size, window): the
    source index and ``resize_weights``' weight of each tap (read-only: a
    train set's tiles share a few sizes, and the weights cost more to build
    than the pass)."""
    w = resize_weights(in_size, out_size, "bilinear")
    starts = (w != 0).argmax(1)
    taps = starts[:, None] + np.arange(int(math.ceil(max(in_size / out_size, 1.0))) * 2 + 1)
    weights = np.take_along_axis(w, np.minimum(taps, in_size - 1), 1) * (taps < in_size)
    taps.setflags(write=False)
    weights.setflags(write=False)
    return taps, weights


def _sequential_pass(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One f32 bilinear pass along ``axis`` (``resize_weights``' filter), each
    output a left-to-right sum of weight x pixel over its window, as the
    native resize sums it (a tap past a window's end has weight 0 and adds
    exactly 0)."""
    in_size = x.shape[axis]
    taps, weights = _pass_taps(in_size, out_size)
    shape = list(x.shape)
    shape[axis] = out_size
    acc = np.zeros(shape, np.float32)
    for k in range(taps.shape[1]):
        idx = np.minimum(taps[:, k], in_size - 1)
        if axis == 1:
            acc += weights[None, :, k, None] * np.take(x, idx, axis=1)
        else:
            acc += weights[:, k, None, None] * np.take(x, idx, axis=0)
    return acc


def resize_u8_host(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 (h, w, 3) -> uint8 (out_h, out_w, 3), bilinear, on the CPU: a
    horizontal then a vertical pass in f32, one half-up rounding (the JAX
    package's native ``resize_bilinear_rgb8``, bit for bit)."""
    h, w = img.shape[:2]
    if (w, h) == (out_w, out_h):
        return img
    x = _sequential_pass(img.astype(np.float32), out_w, 1)
    x = _sequential_pass(x, out_h, 0)
    return np.clip(np.floor(x + np.float32(0.5)), 0, 255).astype(np.uint8)


class CocoDetDataset:
    def __init__(
        self,
        data_root: str,
        ann_file: str,
        data_prefix: str = "images/",
        img_scale: Tuple[int, int] = (128, 128),
        max_gt: int = 64,
        flip_prob: float = 0.5,
        train: bool = False,
        aug: Optional[AugConfig] = None,
    ):
        self.data_root = data_root
        self.img_dir = os.path.join(data_root, data_prefix)
        with open(ann_file if os.path.isabs(ann_file) else os.path.join(data_root, ann_file)) as f:
            coco = json.load(f)
        self.images = coco["images"]
        anns_by_img: Dict[int, List[dict]] = {im["id"]: [] for im in self.images}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.anns_by_img = anns_by_img
        self._file_names = {}
        for im in self.images:  # the first entry of an id wins, as in a linear search
            self._file_names.setdefault(im["id"], im["file_name"])
        self.img_scale = img_scale
        self.max_gt = max_gt
        self.train = train
        self.aug = (aug if aug is not None else AugConfig(flip_prob=flip_prob)) if train \
            else AugConfig(flip_prob=0.0)
        # a different draw for the same index at every call (train only)
        self._aug_calls = 0
        # decoded + resized tiles as uint8: mosaic and mixup read 4-8 tiles a
        # sample, so the cache takes the decode and resize out of every epoch
        # after the first
        cache_mb = float(os.environ.get(CACHE_ENV, "2048"))
        est_mb = len(self.images) * img_scale[0] * img_scale[1] * 3 / 1e6
        self._scaled_cache: Optional[Dict[int, tuple]] = (
            {} if train and 0 < est_mb <= cache_mb else None)

    def __len__(self):
        return len(self.images)

    def _decode(self, index: int) -> np.ndarray:
        return load_image_u8(os.path.join(self.img_dir, self.images[index]["file_name"]))

    def _raw_boxes(self, index: int) -> np.ndarray:
        """The COCO boxes (xyxy) as annotated, on the tile as decoded."""
        boxes = []
        for a in self.anns_by_img.get(self.images[index]["id"], []):
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw, y + bh])
        return np.asarray(boxes, np.float32).reshape(-1, 4)

    def _load_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """f32 tile as decoded and its boxes there (LSJ's input)."""
        return self._decode(index).astype(np.float32), self._raw_boxes(index)

    def _boxes(self, index: int, w: int, h: int) -> np.ndarray:
        """The COCO boxes (xyxy) scaled from the decoded (w, h) to img_scale."""
        boxes = self._raw_boxes(index)
        if len(boxes):
            out_w, out_h = self.img_scale
            boxes = boxes * np.array([out_w / w, out_h / h] * 2, np.float32)
        return boxes

    def _resized(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 tile at img_scale and its boxes scaled there."""
        img = self._decode(index)
        h, w = img.shape[:2]
        return resize_u8_host(img, *self.img_scale), self._boxes(index, w, h)

    def _cached(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """The uint8 tile at img_scale and its boxes, through the cache
        when it is on (the arrays are the cache's own: read them only)."""
        if self._scaled_cache is None:
            return self._resized(index)
        hit = self._scaled_cache.get(index)
        if hit is None:
            hit = self._scaled_cache[index] = self._resized(index)
        return hit

    def _load_scaled(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """f32 tile at img_scale (fresh arrays: augmentation never writes
        into the cache) and its boxes."""
        img, boxes = self._cached(index)
        return img.astype(np.float32), boxes.copy()

    def scaled_u8(self, index: int) -> np.ndarray:
        """The uint8 tile at img_scale (the cache's own array: read only)."""
        return self._cached(index)[0]

    def scaled_boxes(self, index: int) -> np.ndarray:
        """The tile's boxes at img_scale, without the tile's f32 copy."""
        return self._cached(index)[1].copy()

    def _affine(self, img, boxes, rng, **kw):
        a = self.aug
        return random_affine(
            img, boxes, rng, self.img_scale,
            max_rotate_degree=a.max_rotate_degree,
            max_shear_degree=a.max_shear_degree,
            scaling_ratio_range=(1 - a.affine_scale, 1 + a.affine_scale),
            max_translate_ratio=a.max_translate_ratio, **kw)

    def _mosaic_affine(self, index: int, rng) -> Tuple[np.ndarray, np.ndarray]:
        img, boxes = mosaic(self._load_scaled, index, len(self), rng, self.img_scale)
        return self._affine(img, boxes, rng)

    def _targets(self, index: int, boxes: np.ndarray) -> Dict[str, np.ndarray]:
        """Boxes at img_scale padded to max_gt, and the factors that scale
        predictions back to the COCO entry's size (mmdet rescale=True)."""
        info = self.images[index]
        out_w, out_h = self.img_scale
        gt = np.zeros((self.max_gt, 4), np.float32)
        valid = np.zeros(self.max_gt, bool)
        nb = min(len(boxes), self.max_gt)
        if nb:
            gt[:nb] = boxes[:nb]
            valid[:nb] = True
        sx = info.get("width", out_w) / out_w
        sy = info.get("height", out_h) / out_h
        return {
            "gt_boxes": gt,
            "gt_valid": valid,
            "image_id": np.int32(info["id"]),
            "scale_back": np.asarray([sx, sy, sx, sy], np.float32),
        }

    def skip_call(self, index: int) -> None:
        """Count a call for ``index`` that another rank serves: the next call
        draws what it draws in a single process (``DataLoader``'s ``rows``)."""
        if self.train:
            self._aug_calls += 1

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if not self.train:
            img, boxes = self._resized(index)
            return {"image": img.astype(np.float32) / np.float32(255.0),
                    **self._targets(index, boxes)}
        self._aug_calls += 1
        rng = np.random.default_rng((self._aug_calls * 2654435761 + index) % (2**31))
        a = self.aug
        tail_flip = True
        if a.mosaic:
            img, boxes = self._mosaic_affine(index, rng)
            if rng.random() < a.mixup_prob:
                j = int(rng.integers(len(self)))
                if a.mixup_mosaic_pre:  # YOLOv5MixUp: the retrieved sample is mosaic'd
                    img2, boxes2 = self._mosaic_affine(j, rng)
                else:  # mmdet MixUp: the raw retrieved sample
                    img2, boxes2 = self._load_scaled(j)
                img, boxes = mixup(img, boxes, img2, boxes2, rng)
        elif a.standalone_affine:
            # mosaic-close stage 2: affine on the single tile, no mosaic border
            # (max_aspect_ratio 100, as the reference's stage-2 pipeline)
            img, boxes = self._load_scaled(index)
            img, boxes = self._affine(img, boxes, rng, max_aspect_ratio=100.0)
        elif a.lsj:
            # the LSJ pipeline flips before its resize and crop, and not again
            img, boxes = self._load_raw(index)
            if rng.random() < a.flip_prob:
                img, boxes = flip_horizontal(img, boxes)
            img, boxes = lsj(img, boxes, rng, self.img_scale, ratio_range=a.lsj_ratio_range)
            tail_flip = False
        else:
            img, boxes = self._load_scaled(index)

        # the Albu photometric block, then HSV, then the flip
        if a.blur_prob > 0 and rng.random() < a.blur_prob:
            img = blur(img, rng)
        if a.median_blur_prob > 0 and rng.random() < a.median_blur_prob:
            img = median_blur(img, rng)
        if a.to_gray_prob > 0 and rng.random() < a.to_gray_prob:
            img = to_gray(img)
        if a.clahe_prob > 0 and rng.random() < a.clahe_prob:
            img = clahe(img)
        if a.hsv:
            img = hsv_jitter(img, rng, a.hue_delta, a.saturation_delta, a.value_delta)
        if tail_flip and rng.random() < a.flip_prob:
            img, boxes = flip_horizontal(img, boxes)
        return {"image": (np.ascontiguousarray(img) / 255.0).astype(np.float32),
                **self._targets(index, boxes)}

    def source_size(self) -> Optional[Tuple[int, int]]:
        """(w, h) when every image shares one size (COCO metadata), else
        None; gates the batched eval-time device resize."""
        if not self.images:
            return None
        w0 = self.images[0].get("width")
        h0 = self.images[0].get("height")
        if not w0 or not h0:
            return None
        for im in self.images:
            if im.get("width") != w0 or im.get("height") != h0:
                return None
        return int(w0), int(h0)

    def item_u8(self, index: int,
                expect_size: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        """The tile as decoded (uint8, source size) and its targets at img_scale.

        ``expect_size`` (w, h) guards against COCO metadata that lies about
        a file's size: such a tile is resized on the host to the expected
        size so the batch still stacks; boxes always scale by the decoded
        size, as on the host path.
        """
        img = self._decode(index)
        h, w = img.shape[:2]
        boxes = self._boxes(index, w, h)
        if expect_size is not None and (w, h) != tuple(expect_size):
            img = resize_u8_host(img, *expect_size)
        return {"image_u8": img, **self._targets(index, boxes)}

    def file_name(self, image_id: int) -> str:
        return self._file_names[image_id]


class ConcatDataset:
    """Concatenation of datasets with one output schema (the
    ``synthetic_target`` stage: with-cars + without-cars)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    @property
    def max_gt(self) -> int:
        return max(getattr(d, "max_gt", 0) for d in self.datasets)

    def __len__(self):
        return int(self._offsets[-1])

    def _part(self, index: int):
        di = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[di], index - int(self._offsets[di])

    def skip_call(self, index: int) -> None:
        part, i = self._part(index)
        part.skip_call(i)

    def __getitem__(self, index: int):
        part, i = self._part(index)
        return part[i]
