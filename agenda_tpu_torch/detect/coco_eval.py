"""COCO-style detection mAP (pycocotools-free numpy implementation).

Replaces mmengine's ``CocoMetric`` (bbox mAP / mAP50 — the validation and
save_best criterion of every detector config,
``configs/Real_Source/faster-rcnn.py:336-342, 392-397``): 10 IoU thresholds
0.50:0.95, 101-point interpolated precision, maxDets=100, all-area range,
greedy best-IoU matching per image in score order — the standard COCOeval
algorithm.

The port's copy of ``agenda_tpu/detect/coco_eval.py``, on its numpy
matcher (``_match_image``) only: the ctypes matcher of
``agenda_tpu/detect/native.py`` is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from agenda_tpu_torch.annotate.boxes import iou_matrix_xyxy

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)


def _match_image(
    det_boxes: np.ndarray, det_scores: np.ndarray, gt_boxes: np.ndarray,
    iou_thrs: np.ndarray, max_dets: int,
) -> np.ndarray:
    """Per-image matching. Returns tp (T, D) bool for the top max_dets dets
    (score-sorted)."""
    order = np.argsort(-det_scores, kind="mergesort")[:max_dets]
    det_boxes = det_boxes[order]
    t = len(iou_thrs)
    d = len(det_boxes)
    g = len(gt_boxes)
    tp = np.zeros((t, d), bool)
    if d == 0 or g == 0:
        return tp
    ious = iou_matrix_xyxy(det_boxes, gt_boxes)  # (D, G)
    for ti, thr in enumerate(iou_thrs):
        gt_used = np.zeros(g, bool)
        for di in range(d):
            best_iou = thr
            best_g = -1
            for gi in range(g):
                if gt_used[gi]:
                    continue
                if ious[di, gi] >= best_iou:
                    best_iou = ious[di, gi]
                    best_g = gi
            if best_g >= 0:
                gt_used[best_g] = True
                tp[ti, di] = True
    return tp


def coco_map(
    gt_per_image: List[np.ndarray],  # list of (Gi, 4) xyxy
    det_boxes_per_image: List[np.ndarray],  # list of (Di, 4) xyxy
    det_scores_per_image: List[np.ndarray],  # list of (Di,)
    max_dets: int = 100,
    iou_thrs: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """Single-category COCO AP. Returns bbox_mAP / bbox_mAP_50 / bbox_mAP_75."""
    iou_thrs = np.asarray(iou_thrs if iou_thrs is not None else IOU_THRS)
    t = len(iou_thrs)

    all_scores, all_tp = [], []
    n_gt = 0
    for gt, boxes, scores in zip(gt_per_image, det_boxes_per_image, det_scores_per_image):
        gt = np.asarray(gt, np.float64).reshape(-1, 4)
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        n_gt += len(gt)
        order = np.argsort(-scores, kind="mergesort")[:max_dets]
        tp = _match_image(boxes, scores, gt, iou_thrs, max_dets)
        all_scores.append(scores[order])
        all_tp.append(tp)

    if n_gt == 0 or not all_scores:
        return {"bbox_mAP": -1.0, "bbox_mAP_50": -1.0, "bbox_mAP_75": -1.0}

    scores = np.concatenate(all_scores)
    tp = np.concatenate(all_tp, axis=1) if all_tp else np.zeros((t, 0), bool)
    order = np.argsort(-scores, kind="mergesort")
    tp = tp[:, order]

    aps = np.zeros(t)
    for ti in range(t):
        tps = np.cumsum(tp[ti])
        fps = np.cumsum(~tp[ti])
        rc = tps / n_gt
        pr = tps / np.maximum(tps + fps, np.finfo(np.float64).eps)
        # Monotone non-increasing precision envelope (COCOeval accumulate).
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        # Sample at the 101 recall points.
        inds = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(len(REC_THRS))
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        aps[ti] = q.mean()

    def at(thr):
        i = int(np.argmin(np.abs(iou_thrs - thr)))
        return float(aps[i])

    return {
        "bbox_mAP": float(aps.mean()),
        "bbox_mAP_50": at(0.5),
        "bbox_mAP_75": at(0.75),
    }


def evaluate_records(records: List[dict], **kw) -> Dict[str, float]:
    """Convenience: coco_map over prediction records with gt_instances."""
    gts, boxes, scores = [], [], []
    for r in records:
        gt = r.get("gt_instances") or {"bboxes": np.zeros((0, 4))}
        pred = r.get("pred_instances") or {"bboxes": np.zeros((0, 4)), "scores": np.zeros((0,))}
        gts.append(np.asarray(gt["bboxes"]).reshape(-1, 4))
        boxes.append(np.asarray(pred["bboxes"]).reshape(-1, 4))
        scores.append(np.asarray(pred["scores"]).reshape(-1))
    return coco_map(gts, boxes, scores, **kw)
