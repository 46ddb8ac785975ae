"""CLI: F1-max confidence-threshold selection + pseudo-COCO export.

Replaces the two reference notebooks with one scriptable tool:

- analysis mode (VisualizeTestResults.ipynb): greedy IoU>=0.5 matching,
  101-pt AP, argmax-F1 threshold, optional P/R/F1-vs-score table dump;
- conversion mode (ConvertPredToCOCOPseudoAnnotations.ipynb): with
  ``--emit-pseudo-coco``, writes the pseudo-label COCO at the chosen (or
  selected) threshold using the recipe-encoding filename;
- ``--plot`` and ``--visualize-samples`` (the notebook's figures) need
  matplotlib and Pillow, which the port does not use: here they raise
  (ROADMAP.md, "Left out").

The port's copy of ``agenda_tpu/cli/select_threshold.py``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from agenda_tpu_torch.annotate.coco import (
    predictions_to_pseudo_coco,
    pseudo_coco_filename,
    save_coco,
)
from agenda_tpu_torch.annotate.records import load_predictions
from agenda_tpu_torch.annotate.threshold import (
    average_precision_101,
    match_predictions,
    pr_f1_table,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Threshold selection / pseudo-COCO export.")
    p.add_argument("--prediction_pkl", type=str, required=True)
    p.add_argument("--iou-thresh", type=float, default=0.5)
    p.add_argument("--thresh-conf", type=float, default=None,
                   help="Use this confidence threshold instead of F1-max.")
    p.add_argument("--emit-pseudo-coco", action="store_true")
    p.add_argument("--out-dir", type=str, default=None,
                   help="Output dir for the pseudo COCO (default: alongside the pkl).")
    p.add_argument("--detector-tag", type=str, default="FasterRCNN")
    p.add_argument("--dataset-tag", type=str, default="SynLINZ-STACKDAAMHeatMaps")
    p.add_argument("--bboxes-size-px", type=float, default=42.36)
    p.add_argument("--image-size", type=int, default=112)
    p.add_argument("--table-out", type=str, default=None,
                   help="Write the P/R/F1-vs-score table as JSON here.")
    p.add_argument("--result-out", type=str, default=None,
                   help="Write the analysis result (ap, f1_max, threshold) as "
                        "JSON here — the pipeline orchestrator reads the "
                        "selected threshold from it.")
    p.add_argument("--plot", type=str, default=None,
                   help="Write the analysis figures (PR curve, P/R/F1 vs "
                        "confidence, per-image TP/FP/FN scatter) to this PNG.")
    p.add_argument("--visualize-samples", type=str, default=None, metavar="DIR",
                   help="Write sample_TP/FN/FP.png detection overlays (GT "
                        "dashed, preds colored by TP/FP at the selected "
                        "threshold) — VisualizeTestResults.ipynb cells 26-32.")
    p.add_argument("--sample-seed", type=int, default=0,
                   help="Seed for the random sample choice in "
                        "--visualize-samples (notebook: random.choice).")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, value in (("--plot", args.plot), ("--visualize-samples", args.visualize_samples)):
        if value:
            raise NotImplementedError(
                f"{flag} draws with matplotlib and Pillow, which the port does not use; "
                "run the JAX package's select_threshold for the figures")
    records = load_predictions(args.prediction_pkl)

    result = {}
    has_gt = any(r.get("gt_instances") for r in records)
    if has_gt:
        scores, is_tp, n_gt = match_predictions(records, args.iou_thresh)
        table = pr_f1_table(scores, is_tp, n_gt)
        ap = average_precision_101(table["precision"], table["recall"])
        i = int(np.argmax(table["f1"]))
        result = {"ap": ap, "f1_max": float(table["f1"][i]),
                  "threshold": float(table["score"][i]), "n_gt": n_gt,
                  "n_pred": int(len(scores))}
        print(f"AP: {ap:.4}")
        print(f"F1_max: {result['f1_max']:.4f} | Score thresh.: {result['threshold']:.4f}")
        if args.table_out:
            with open(args.table_out, "w") as f:
                json.dump({k: v.tolist() for k, v in table.items()}, f)
        if args.result_out:
            with open(args.result_out, "w") as f:
                json.dump(result, f)
    elif args.thresh_conf is None and args.emit_pseudo_coco:
        raise ValueError("No gt_instances in records: pass --thresh-conf explicitly.")

    if args.emit_pseudo_coco:
        thresh = args.thresh_conf if args.thresh_conf is not None else result["threshold"]
        coco = predictions_to_pseudo_coco(
            records, thresh, args.bboxes_size_px,
            (args.image_size, args.image_size),
        )
        out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.prediction_pkl))
        name = pseudo_coco_filename(args.detector_tag, args.dataset_tag, thresh,
                                    args.bboxes_size_px, args.iou_thresh)
        path = os.path.join(out_dir, name)
        save_coco(coco, path)
        print(f"wrote {path} ({len(coco['annotations'])} annotations)")
    return result


if __name__ == "__main__":
    main()
