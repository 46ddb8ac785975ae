"""CLI: precision/recall of pseudo annotations vs ground truth at IoU 0.5.

Flag-compatible with ``Data/utils/EvaluatePseudoAnn.py:64-75`` (same greedy
matching, same printed format) — pycocotools-free.

The port's copy of ``agenda_tpu/cli/evaluate_pseudo_ann.py``.
"""

from __future__ import annotations

import argparse

from agenda_tpu_torch.annotate.coco import evaluate_pseudo_annotations, load_coco


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluation.")
    p.add_argument("--ground_truth_file", type=str,
                   help="ground truth pseudo annotation file path")
    p.add_argument("--pseudo_pred_file", type=str,
                   help="pseudo annotation save path")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    gt = load_coco(args.ground_truth_file)
    pred = load_coco(args.pseudo_pred_file)
    precision, recall = evaluate_pseudo_annotations(gt, pred)
    print(f"Precision @ IoU 0.5: {precision:.4f}")
    print(f"Recall @ IoU 0.5: {recall:.4f}")
    return precision, recall


if __name__ == "__main__":
    main()
