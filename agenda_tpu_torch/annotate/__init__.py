"""Pseudo-annotation math: boxes, prediction records, COCO files, thresholds
(the port's own numpy copies of ``agenda_tpu/annotate``)."""

from agenda_tpu_torch.annotate.boxes import (
    complete_edge_boxes,
    iou_xyxy,
    iou_xywh,
    iou_matrix_xyxy,
)
from agenda_tpu_torch.annotate.records import load_predictions, save_predictions
from agenda_tpu_torch.annotate.threshold import (
    match_predictions,
    pr_f1_table,
    average_precision_101,
    select_f1_max_threshold,
)

__all__ = [
    "complete_edge_boxes",
    "iou_xyxy",
    "iou_xywh",
    "iou_matrix_xyxy",
    "load_predictions",
    "save_predictions",
    "match_predictions",
    "pr_f1_table",
    "average_precision_101",
    "select_f1_max_threshold",
]
