"""Pseudo-label refinement with a binary crop classifier: the host side.

Counterpart of ``agenda_tpu/annotate/refine.py`` (the reference's
``data_annotation/refine_label.py:17-159, 353-373``), without Pillow:

1. ``construct_data`` buckets each image's detections: its top-1 detection
   and any with score >= pos_thresh become positive training crops (and
   COCO annotations at once), score < neg_thresh negative crops, the band
   between them unlabeled test crops; score < hard_neg_thresh is dropped.
   The boxes are edge-completed 42.36-px squares. A crop is Pillow's
   ``Image.crop``: a box with right < left (or lower < upper) raises, each
   float coordinate is rounded half to even (Python's ``round``), then the
   pixels of that integer box are taken (0 outside the image).
2. ``resize_crops`` is Pillow's default ``Image.resize`` of each crop
   (BICUBIC, 8-bit fixed point; ``detect/augment.resize_pil``), all crops of
   one size in one call. The crops come in a few sizes only, because the
   edge boxes are clipped.
3. ``append_positive_test_annotations`` adds the classifier's positive
   test crops with label -1, then sorts by image_id and re-ids.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from agenda_tpu_torch.annotate.boxes import complete_edge_boxes
from agenda_tpu_torch.detect.augment import resize_pil
from agenda_tpu_torch.utils.png import read_rgb

DEFAULT_CATEGORIES = [{"id": 1, "name": "small"}]
RESIZE_CHUNK = 256  # crops a resize call takes at once (its f64 temporaries: 1.2 MB a crop at 224)


@dataclasses.dataclass
class RefineData:
    train_crops: List[np.ndarray]  # uint8 (h, w, 3)
    train_labels: List[int]
    test_crops: List[np.ndarray]
    test_anns: List[dict]  # COCO-style dicts for the unlabeled crops (id-indexed)
    annotations_coco: dict


def crop_pil(rgb: np.ndarray, box: Tuple[float, float, float, float]) -> np.ndarray:
    """Pillow's ``Image.crop((l, t, r, b))`` of a uint8 (H, W, 3) image: a
    box with r < l or b < t raises as Pillow's does; the coordinates are
    rounded half to even, pixels outside the image are 0, and the crop may
    be empty."""
    if box[2] < box[0]:
        raise ValueError("Coordinate 'right' is less than 'left'")
    if box[3] < box[1]:
        raise ValueError("Coordinate 'lower' is less than 'upper'")
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0), 3), np.uint8)
    h, w = rgb.shape[:2]
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = rgb[sy0:sy1, sx0:sx1]
    return out


def construct_data(
    detection_results: List[dict],
    pos_thresh: float,
    neg_thresh: float,
    hard_neg_thresh: float,
    bboxes_size_px: float = 42.36,
    rgb_image_base_path: Optional[str] = None,
) -> RefineData:
    categories = DEFAULT_CATEGORIES
    coco = {"categories": categories, "images": [], "annotations": []}
    train_crops: List[np.ndarray] = []
    train_labels: List[int] = []
    test_crops: List[np.ndarray] = []
    test_anns: List[dict] = []

    for i_im, rec in enumerate(detection_results):
        file_name = os.path.basename(rec["img_path"])
        rgb = read_rgb(os.path.join(rgb_image_base_path, file_name))
        height, width = rgb.shape[:2]
        coco["images"].append(
            {"id": i_im, "file_name": file_name, "width": width, "height": height})
        pred = rec.get("pred_instances")
        if pred is None or len(pred["scores"]) == 0:
            continue
        scores = np.asarray(pred["scores"], np.float64)
        labels = np.asarray(pred["labels"], np.int64)
        boxes = np.asarray(pred["bboxes"], np.float64).reshape(-1, 4)

        keep = scores >= hard_neg_thresh
        scores, labels, boxes = scores[keep], labels[keep], boxes[keep]
        full = complete_edge_boxes(boxes, (width, height), bboxes_size_px, mode="extend")
        for i in range(len(scores)):
            l, t, r, b = (float(v) for v in full[i])
            w_bbox, h_bbox = r - l, b - t
            crop = crop_pil(rgb, (l, t, r, b))
            ann = {
                "iscrowd": 0,
                "category_id": categories[int(labels[i])]["id"],
                "image_id": i_im,
                "bbox": [l, t, w_bbox, h_bbox],
                "area": w_bbox * h_bbox,
            }
            s = scores[i]
            if i == 0 or s >= pos_thresh:  # top-1 + confident -> positive
                train_crops.append(crop)
                train_labels.append(1)
                coco["annotations"].append({**ann, "label": 1})
            elif s < neg_thresh:
                train_crops.append(crop)
                train_labels.append(0)
            else:
                test_anns.append({**ann, "id": len(test_anns), "label": -1})
                test_crops.append(crop)

    return RefineData(train_crops, train_labels, test_crops, test_anns, coco)


def resize_crops(crops: List[np.ndarray], size: int = 224) -> np.ndarray:
    """Crops -> uint8 (N, size, size, 3), each as Pillow's default
    ``resize((size, size))`` (BICUBIC; an empty crop gives zeros); one call
    per crop size."""
    out = np.zeros((len(crops), size, size, 3), np.uint8)
    by_shape: Dict[Tuple[int, ...], List[int]] = {}
    for i, c in enumerate(crops):
        if c.size:
            by_shape.setdefault(c.shape, []).append(i)
    for idx in by_shape.values():
        for j in range(0, len(idx), RESIZE_CHUNK):
            part = idx[j : j + RESIZE_CHUNK]
            out[part] = resize_pil(np.stack([crops[i] for i in part]), size, size, "bicubic")
    return out


def crops_to_array(crops: List[np.ndarray], size: int = 224,
                   hflip_rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Crops -> (N, size, size, 3) f32 in [0, 1], each flipped left-right
    when its draw from ``hflip_rng`` (one ``random()`` a crop, in order) is
    below 0.5."""
    out = resize_crops(crops, size).astype(np.float32) / np.float32(255.0)
    if hflip_rng is not None:
        flip = hflip_rng.random(len(crops)) < 0.5
        out[flip] = out[flip, :, ::-1]
    return out


def macro_f1_binary(preds: np.ndarray, labels: np.ndarray) -> float:
    """Macro F1 over {0, 1} (torchmetrics F1Score(multiclass, 2, macro))."""
    f1s = []
    for cls in (0, 1):
        tp = np.sum((preds == cls) & (labels == cls))
        fp = np.sum((preds == cls) & (labels != cls))
        fn = np.sum((preds != cls) & (labels == cls))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(f1s))


def append_positive_test_annotations(coco: dict, test_anns: List[dict],
                                     pos_ids: List[int]) -> dict:
    """Append the classifier-positive unlabeled crops with label -1, sort by
    image_id (stable) and re-id."""
    by_id = {a["id"]: a for a in test_anns}
    for pid in pos_ids:
        a = by_id[pid]
        coco["annotations"].append({k: a[k] for k in
                                    ("iscrowd", "category_id", "image_id", "bbox", "area")}
                                   | {"label": -1})
    coco["annotations"] = sorted(coco["annotations"], key=lambda x: x["image_id"])
    for i, ann in enumerate(coco["annotations"]):
        ann["id"] = i
    return coco
