"""Detection prediction records (the reference's ``prediction.pkl`` format).

mmdet's ``tools/test.py --out prediction.pkl`` writes a pickled list of
per-image dicts with ``img_path``, optional ``gt_instances`` and
``pred_instances`` holding ``bboxes`` (N,4 xyxy), ``scores`` (N,), ``labels``
(N,) (SURVEY.md §3.4). All downstream annotation tools consume that shape
(``refine_label.py:282-283``, both notebooks).

Our loader accepts torch-tensor or numpy payloads (so reference-produced
pickles load without mmdet installed) and normalizes everything to numpy;
the saver writes pure-numpy pickles our detectors produce.

The port's copy of ``agenda_tpu/annotate/records.py``.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np
import torch


def _to_numpy(x):
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _norm_instances(inst: Optional[dict]) -> Optional[Dict[str, np.ndarray]]:
    if inst is None:
        return None
    out = {}
    for k in ("bboxes", "scores", "labels"):
        if k in inst:
            out[k] = _to_numpy(inst[k])
    return out


def load_predictions(path: str) -> List[dict]:
    with open(path, "rb") as f:
        try:
            records = pickle.load(f)
        except Exception:
            # Torch-pickled tensors need torch's unpickler.
            f.seek(0)
            records = torch.load(f, map_location="cpu", weights_only=False)
    out = []
    for r in records:
        rec = {"img_path": r.get("img_path")}
        if "gt_instances" in r and r["gt_instances"] is not None:
            rec["gt_instances"] = _norm_instances(r["gt_instances"])
        if "pred_instances" in r and r["pred_instances"] is not None:
            rec["pred_instances"] = _norm_instances(r["pred_instances"])
        for k in ("ori_shape", "img_shape", "img_id"):
            if k in r:
                rec[k] = r[k]
        out.append(rec)
    return out


def save_predictions(records: List[dict], path: str) -> None:
    clean = []
    for r in records:
        rec = dict(r)
        for k in ("gt_instances", "pred_instances"):
            if rec.get(k) is not None:
                rec[k] = {kk: np.asarray(vv) for kk, vv in rec[k].items()}
        clean.append(rec)
    with open(path, "wb") as f:
        pickle.dump(clean, f)
