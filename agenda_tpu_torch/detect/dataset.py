"""COCO detection dataset, evaluation side.

Counterpart of the eval path of ``agenda_tpu/detect/dataset.py:43-98,
225-305``: ``CocoDetDataset(train=False)`` with ``__len__``, ``item_u8``
(the tile as decoded plus its boxes at ``img_scale``), ``source_size``,
``file_name``, the eval branch of ``__getitem__`` and ``scale_back``.
Tiles are decoded with the port's PNG reader (``utils/png.py``); other
formats raise. Where the JAX package resizes on the host (its native
resize, or Pillow), the port resizes with the same filter and one
half-up rounding (``data/device_resize.resize_levels``), within one level
of it. The training side (mosaic, mixup, affine, the tile cache) is not
ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch.data.datasets import load_image_u8
from agenda_tpu_torch.data.device_resize import resize_levels, resize_weights


def resize_u8_host(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """uint8 (h, w, 3) -> uint8 (out_h, out_w, 3) with the bilinear filter,
    rounded half up once, on the CPU."""
    h, w = img.shape[:2]
    if (w, h) == (out_w, out_h):
        return img
    wy = torch.from_numpy(resize_weights(h, out_h, "bilinear"))
    wx = torch.from_numpy(resize_weights(w, out_w, "bilinear"))
    return resize_levels(torch.from_numpy(img)[None], wy, wx, half_up=True)[0].to(
        torch.uint8).numpy()


class CocoDetDataset:
    def __init__(
        self,
        data_root: str,
        ann_file: str,
        data_prefix: str = "images/",
        img_scale: Tuple[int, int] = (128, 128),
        max_gt: int = 64,
        train: bool = False,
    ):
        if train:
            raise NotImplementedError(
                "the detector's training dataset (mosaic, mixup, affine) is not ported yet: "
                "ROADMAP.md §A, the YOLOv8 training item")
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

    def __len__(self):
        return len(self.images)

    def _decode(self, index: int) -> np.ndarray:
        return load_image_u8(os.path.join(self.img_dir, self.images[index]["file_name"]))

    def _targets(self, index: int, w: int, h: int) -> Dict[str, np.ndarray]:
        """GT boxes scaled from the decoded (w, h) to img_scale, padded to
        max_gt, and the factors that scale predictions back."""
        info = self.images[index]
        out_w, out_h = self.img_scale
        boxes = []
        for a in self.anns_by_img.get(info["id"], []):
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw, y + bh])
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if len(boxes):
            boxes = boxes * np.array([out_w / w, out_h / h] * 2, np.float32)
        gt = np.zeros((self.max_gt, 4), np.float32)
        valid = np.zeros(self.max_gt, bool)
        nb = min(len(boxes), self.max_gt)
        if nb:
            gt[:nb] = boxes[:nb]
            valid[:nb] = True
        # mmdet rescale=True: predictions go back to the COCO entry's size
        sx = info.get("width", out_w) / out_w
        sy = info.get("height", out_h) / out_h
        return {
            "gt_boxes": gt,
            "gt_valid": valid,
            "image_id": np.int32(info["id"]),
            "scale_back": np.asarray([sx, sy, sx, sy], np.float32),
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        """The eval item: the tile resized to img_scale on the host, in [0, 1]."""
        img = self._decode(index)
        h, w = img.shape[:2]
        out_w, out_h = self.img_scale
        img = resize_u8_host(img, out_w, out_h)
        return {"image": img.astype(np.float32) / np.float32(255.0), **self._targets(index, w, h)}

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
        if expect_size is not None and (w, h) != tuple(expect_size):
            img = resize_u8_host(img, *expect_size)
        return {"image_u8": img, **self._targets(index, w, h)}

    def file_name(self, image_id: int) -> str:
        return self._file_names[image_id]
