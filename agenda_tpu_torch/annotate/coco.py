"""COCO-JSON builders/parsers, bit-compatible with the reference's files.

Covers:
- empty annotation files for unlabeled synthetic sets
  (``data_annotation/build_empty_annotation.py``: images sorted by numeric
  stem, 112x112, categories copied from a template, indent=4);
- prediction records -> pseudo-label COCO with edge-completed fake boxes and
  the recipe-encoding filename
  (ConvertPredToCOCOPseudoAnnotations.ipynb cells 4-7);
- predicted-COCO -> canonical pseudo annotations (clamp variant, score=1.0,
  ``Data/utils/ConvertPseudoAnn.py``);
- greedy precision/recall evaluation at IoU 0.5
  (``Data/utils/EvaluatePseudoAnn.py`` — no pycocotools needed).

The port's copy of ``agenda_tpu/annotate/coco.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from agenda_tpu_torch.annotate.boxes import complete_edge_boxes, iou_xywh

DEFAULT_CATEGORIES = [{"id": 1, "name": "small"}]


def load_coco(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_coco(coco: dict, path: str, indent: Optional[int] = None) -> None:
    with open(path, "w") as f:
        json.dump(coco, f, indent=indent)


def build_empty_annotation(
    image_dir: str,
    template_coco_path: str,
) -> dict:
    """Images-only COCO for unlabeled data (build_empty_annotation.py:14-36):
    ids ordered by numeric filename, 112x112, categories + image-entry keys
    copied from the template's first image record."""
    all_images = sorted(os.listdir(image_dir), key=lambda x: int(x.split(".")[0]))
    template = load_coco(template_coco_path)
    out = {
        "categories": template["categories"],
        "images": [],
        "annotations": [],
    }
    item = dict(template["images"][0])
    for image_id, name in enumerate(all_images):
        entry = dict(item)
        entry["id"] = image_id
        entry["file_name"] = name
        entry["height"] = 112
        entry["width"] = 112
        out["images"].append(entry)
    return out


def predictions_to_pseudo_coco(
    records: List[dict],
    thresh_conf: float,
    box_size: float = 42.36,
    image_size: Tuple[int, int] = (112, 112),
    categories: Optional[List[dict]] = None,
) -> dict:
    """prediction records -> pseudo-label COCO (notebook cell 6 semantics):
    score filter, edge-completion (extend mode), fake-box annotations."""
    categories = categories or DEFAULT_CATEGORIES
    coco = {"categories": categories, "images": [], "annotations": []}
    for i_im, rec in enumerate(records):
        file_name = os.path.basename(rec["img_path"])
        coco["images"].append(
            {
                "id": i_im,
                "file_name": file_name,
                "width": image_size[0],
                "height": image_size[1],
            }
        )
        pred = rec.get("pred_instances")
        if pred is None or len(pred["scores"]) == 0:
            continue
        scores = np.asarray(pred["scores"])
        keep = scores >= thresh_conf
        boxes = np.asarray(pred["bboxes"]).reshape(-1, 4)[keep]
        full = complete_edge_boxes(boxes, image_size, box_size, mode="extend")
        for (l, t, r, b) in full:
            w, h = r - l, b - t
            coco["annotations"].append(
                {
                    "iscrowd": 0,
                    "category_id": categories[0]["id"],
                    "id": len(coco["annotations"]),
                    "image_id": i_im,
                    "bbox": [float(l), float(t), float(w), float(h)],
                    "area": float(w * h),
                }
            )
    return coco


def pseudo_coco_filename(
    detector: str,
    dataset_tag: str,
    thresh_conf: float,
    box_size: float = 42.36,
    iou_thresh: float = 0.5,
) -> str:
    """Recipe-encoding filename (notebook cell 7), e.g.
    annotations_coco_FakeBBoxes:42.36px_ForIoU:0.500_Pseudo-FasterRCNN-SynLINZ-STACKDAAMHeatMaps-ConfThresh:0.60.json
    """
    return (
        f"annotations_coco_FakeBBoxes:{box_size:.2f}px_ForIoU:{iou_thresh:.3f}"
        f"_Pseudo-{detector}-{dataset_tag}-ConfThresh:{thresh_conf:.2f}.json"
    )


def convert_pseudo_annotations(
    pred_coco: dict,
    box_size: float = 42.36,
    image_size: Tuple[int, int] = (112, 112),
) -> dict:
    """Snap predicted-COCO boxes to canonical fake boxes (clamp variant) and
    set score=1.0 (Data/utils/ConvertPseudoAnn.py:30-71)."""
    out = {
        "categories": pred_coco["categories"],
        "images": pred_coco["images"],
        "annotations": [],
    }
    for ann in pred_coco["annotations"]:
        l, t, w, h = ann["bbox"]
        full = complete_edge_boxes(
            np.array([[l, t, l + w, t + h]]), image_size, box_size, mode="clamp"
        )[0]
        nl, nt, nr, nb = (float(v) for v in full)
        new_ann = dict(ann)
        new_ann["bbox"] = [nl, nt, nr - nl, nb - nt]
        new_ann["area"] = (nr - nl) * (nb - nt)
        new_ann["score"] = 1.0
        out["annotations"].append(new_ann)
    return out


def coco_by_image(coco: dict) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {img["id"]: [] for img in coco["images"]}
    for ann in coco["annotations"]:
        out.setdefault(ann["image_id"], []).append(ann)
    return out


def evaluate_pseudo_annotations(
    gt_coco: dict, pred_coco: dict, iou_thresh: float = 0.5
) -> Tuple[float, float]:
    """Greedy per-image matching precision/recall at IoU>=thresh
    (EvaluatePseudoAnn.py:5-46: first-match greedy in annotation order)."""
    gt_by_img = coco_by_image(gt_coco)
    pred_by_img = coco_by_image(pred_coco)
    tp = fp = total_gt = 0
    for img_id in gt_by_img:
        gt_anns = gt_by_img.get(img_id, [])
        pred_anns = pred_by_img.get(img_id, [])
        used = set()
        for pred in pred_anns:
            matched = False
            for gi, gt in enumerate(gt_anns):
                if gi in used:
                    continue
                if iou_xywh(gt["bbox"], pred["bbox"]) >= iou_thresh:
                    tp += 1
                    used.add(gi)
                    matched = True
                    break
            if not matched:
                fp += 1
        total_gt += len(gt_anns)
    fn = total_gt - tp
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    return precision, recall
