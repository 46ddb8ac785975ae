"""The greedy box matchers and NMS in C++, bound with ctypes.

Counterpart of ``agenda_tpu/detect/native.py``: ``match_image_greedy``
(COCOeval's per-image matching, ``detect/coco_eval.py::coco_map``),
``match_first_greedy`` (first unused GT in order), ``match_per_gt_greedy``
(``annotate/threshold.py::match_predictions``) and ``nms_sorted``, with the
JAX package's signatures, on the port's copy of ``native/coco_eval.cc``
(``csrc/coco_eval.cc``, in the ``host`` library of ``utils/host_build.py``,
which needs no library beyond the C++ compiler's). Boxes are xyxy float64.
Where the JAX package falls back to numpy, these raise when the library
cannot be built. The numpy loops stay as the plain versions the tests hold
the library to: ``coco_eval._match_image``,
``threshold.match_per_gt_reference`` and the two ``*_reference`` here.
"""

from __future__ import annotations

import ctypes

import numpy as np

from agenda_tpu_torch.annotate.boxes import iou_matrix_xyxy
from agenda_tpu_torch.utils import host_build

_DP = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64


def _fn(name: str, argtypes, restype):
    return host_build.load("host").function(name, argtypes, restype)


def _boxes(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64).reshape(-1, 4)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def _up(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def match_image_greedy(dets: np.ndarray, gts: np.ndarray, iou_thrs: np.ndarray) -> np.ndarray:
    """(D, 4), (G, 4), (T,) -> tp (T, D) bool: for each threshold, each
    detection in order takes the unused GT of highest IoU >= it. Dets come
    sorted by score, descending, and cut to max_dets by the caller."""
    fn = _fn("match_image_greedy", [_DP, _I64, _DP, _I64, _DP, _I64, _U8P], None)
    dets, gts = _boxes(dets), _boxes(gts)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64).reshape(-1)
    out = np.zeros((len(iou_thrs), len(dets)), np.uint8)
    fn(_dp(dets), len(dets), _dp(gts), len(gts), _dp(iou_thrs), len(iou_thrs), _up(out))
    return out.astype(bool)


def match_first_greedy(preds: np.ndarray, gts: np.ndarray, iou_thr: float) -> np.ndarray:
    """(P,) bool: each prediction in order takes the first unused GT with
    IoU >= ``iou_thr``."""
    fn = _fn("match_first_greedy", [_DP, _I64, _DP, _I64, ctypes.c_double, _U8P], _I64)
    preds, gts = _boxes(preds), _boxes(gts)
    out = np.zeros(len(preds), np.uint8)
    fn(_dp(preds), len(preds), _dp(gts), len(gts), float(iou_thr), _up(out))
    return out.astype(bool)


def match_per_gt_greedy(preds: np.ndarray, gts: np.ndarray, iou_thr: float) -> np.ndarray:
    """(P,) bool: each GT in order takes the first (highest-scoring: preds
    come sorted) unmatched prediction with IoU >= ``iou_thr``."""
    fn = _fn("match_per_gt_greedy", [_DP, _I64, _DP, _I64, ctypes.c_double, _U8P], None)
    preds, gts = _boxes(preds), _boxes(gts)
    out = np.zeros(len(preds), np.uint8)
    fn(_dp(preds), len(preds), _dp(gts), len(gts), float(iou_thr), _up(out))
    return out.astype(bool)


def nms_sorted(boxes: np.ndarray, iou_thr: float, max_keep: int) -> np.ndarray:
    """Score-sorted (N, 4) -> keep mask (N,) bool: a box is kept unless its
    IoU with a kept one exceeds ``iou_thr``, up to ``max_keep`` boxes."""
    fn = _fn("nms_sorted", [_DP, _I64, ctypes.c_double, _I64, _U8P], _I64)
    boxes = _boxes(boxes)
    out = np.zeros(len(boxes), np.uint8)
    fn(_dp(boxes), len(boxes), float(iou_thr), int(max_keep), _up(out))
    return out.astype(bool)


def match_first_greedy_reference(preds: np.ndarray, gts: np.ndarray,
                                 iou_thr: float) -> np.ndarray:
    """``match_first_greedy`` in numpy."""
    preds, gts = _boxes(preds), _boxes(gts)
    ious = iou_matrix_xyxy(preds, gts)
    used = np.zeros(len(gts), bool)
    out = np.zeros(len(preds), bool)
    for p in range(len(preds)):
        for g in range(len(gts)):
            if not used[g] and ious[p, g] >= iou_thr:
                used[g] = out[p] = True
                break
    return out


def nms_sorted_reference(boxes: np.ndarray, iou_thr: float, max_keep: int) -> np.ndarray:
    """``nms_sorted`` in numpy."""
    boxes = _boxes(boxes)
    ious = iou_matrix_xyxy(boxes, boxes)
    keep = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if keep.sum() >= max_keep:
            break
        if not (ious[i, keep] > iou_thr).any():
            keep[i] = True
    return keep
