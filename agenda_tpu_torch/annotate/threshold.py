"""Pseudo-label confidence-threshold selection (F1-max) + 101-pt AP.

Library form of the reference's VisualizeTestResults.ipynb analysis:
per-image greedy TP matching at IoU>=0.5 (cell 6), global cumulative
precision/recall/F1 over score-sorted predictions, 101-point interpolated AP
with the appended (p=0, r=1) terminal point, and the argmax-F1 confidence
threshold (cell 17) that gates the pseudo-labels.

The port's copy of ``agenda_tpu/annotate/threshold.py``. The greedy
matcher is ``detect/native.py::match_per_gt_greedy`` (C++), as the JAX
package's where its library loads; the numpy loop stays as its plain
version, ``match_per_gt_reference``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from agenda_tpu_torch.annotate.boxes import iou_matrix_xyxy


def match_predictions(
    records: List[dict],
    iou_thresh: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy per-image TP assignment.

    For each GT (in order), the highest-scoring unmatched prediction with
    IoU >= thresh becomes a TP (predictions pre-sorted by score descending,
    matching the pkl ordering assumed by the notebook's .iloc[0]).

    Returns (scores, is_tp, n_gt) flattened over all images.
    """
    from agenda_tpu_torch.detect import native

    all_scores, all_tp = [], []
    n_gt = 0
    for rec in records:
        gt = rec.get("gt_instances") or {"bboxes": np.zeros((0, 4))}
        pred = rec.get("pred_instances") or {
            "bboxes": np.zeros((0, 4)),
            "scores": np.zeros((0,)),
        }
        gt_boxes = np.asarray(gt["bboxes"], np.float64).reshape(-1, 4)
        boxes = np.asarray(pred["bboxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        n_gt += len(gt_boxes)
        if len(boxes) == 0:
            continue
        order = np.argsort(-scores, kind="stable")
        boxes, scores = boxes[order], scores[order]
        all_scores.append(scores)
        all_tp.append(native.match_per_gt_greedy(boxes, gt_boxes, iou_thresh))
    if not all_scores:
        return np.zeros((0,)), np.zeros((0,), bool), n_gt
    return np.concatenate(all_scores), np.concatenate(all_tp), n_gt


def match_per_gt_reference(boxes: np.ndarray, gt_boxes: np.ndarray,
                           iou_thresh: float) -> np.ndarray:
    """``native.match_per_gt_greedy`` in numpy: each GT in order takes the
    first unmatched prediction (score-sorted) with IoU >= ``iou_thresh``."""
    matched = np.zeros(len(boxes), bool)
    ious = iou_matrix_xyxy(np.asarray(gt_boxes, np.float64).reshape(-1, 4),
                           np.asarray(boxes, np.float64).reshape(-1, 4))  # (G, P)
    for gi in range(len(ious)):
        cand = (ious[gi] >= iou_thresh) & ~matched
        if cand.any():
            matched[int(np.argmax(cand))] = True
    return matched


def prediction_ious(records: List[dict]) -> np.ndarray:
    """Best IoU vs any same-image GT per prediction, aligned with
    :func:`match_predictions`'s flattened ordering (per-image score-desc).

    The notebook records each prediction's GT IoU for the distribution
    scatter (VisualizeTestResults.ipynb cell 20); images without GT yield
    IoU 0 for their predictions.
    """
    out = []
    for rec in records:
        gt = rec.get("gt_instances") or {"bboxes": np.zeros((0, 4))}
        pred = rec.get("pred_instances") or {
            "bboxes": np.zeros((0, 4)),
            "scores": np.zeros((0,)),
        }
        gt_boxes = np.asarray(gt["bboxes"], np.float64).reshape(-1, 4)
        boxes = np.asarray(pred["bboxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        if len(boxes) == 0:
            continue
        order = np.argsort(-scores, kind="stable")
        boxes = boxes[order]
        if len(gt_boxes) == 0:
            out.append(np.zeros(len(boxes)))
            continue
        out.append(iou_matrix_xyxy(gt_boxes, boxes).max(axis=0))
    if not out:
        return np.zeros((0,))
    return np.concatenate(out)


def pr_f1_table(
    scores: np.ndarray, is_tp: np.ndarray, n_gt: int
) -> Dict[str, np.ndarray]:
    """Cumulative P/R/F1 over predictions sorted by descending score."""
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    tp = is_tp[order].astype(np.float64)
    acc_tp = np.cumsum(tp)
    acc_fp = np.cumsum(1.0 - tp)
    precision = acc_tp / np.maximum(acc_tp + acc_fp, 1e-12)
    recall = acc_tp / max(n_gt, 1)
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    return {"score": s, "precision": precision, "recall": recall, "f1": f1}


def average_precision_101(precision: np.ndarray, recall: np.ndarray) -> float:
    """101-point interpolated AP with the (p=0, r=1) terminal point appended
    (notebook cell 17)."""
    p = np.concatenate([precision, [0.0]])
    r = np.concatenate([recall, [1.0]])
    total = 0.0
    for rv in np.linspace(0, 1, 101):
        mask = r >= rv
        total += float(np.max(p[mask])) if mask.any() else 0.0
    return total / 101.0


def select_f1_max_threshold(records: List[dict], iou_thresh: float = 0.5) -> Dict[str, float]:
    """Full analysis: returns {'ap', 'f1_max', 'threshold'}."""
    scores, is_tp, n_gt = match_predictions(records, iou_thresh)
    if len(scores) == 0:
        return {"ap": 0.0, "f1_max": 0.0, "threshold": 0.0}
    table = pr_f1_table(scores, is_tp, n_gt)
    ap = average_precision_101(table["precision"], table["recall"])
    i = int(np.argmax(table["f1"]))
    return {
        "ap": ap,
        "f1_max": float(table["f1"][i]),
        "threshold": float(table["score"][i]),
    }
