"""CLI: snap predicted COCO boxes to canonical 42.36-px pseudo annotations.

Flag-compatible with ``Data/utils/ConvertPseudoAnn.py:7-15`` (clamp-variant
edge completion, score=1.0, indent=4 output).

The port's copy of ``agenda_tpu/cli/convert_pseudo_ann.py``.
"""

from __future__ import annotations

import argparse

from agenda_tpu_torch.annotate.coco import convert_pseudo_annotations, load_coco, save_coco


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert predicted bboxes to pseudo annotations.")
    p.add_argument("--pred_file", type=str, help="predicted bbox file path")
    p.add_argument("--pseudo_pred_file", type=str, help="pseudo annotation save path")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pred = load_coco(args.pred_file)
    out = convert_pseudo_annotations(pred)
    save_coco(out, args.pseudo_pred_file, indent=4)


if __name__ == "__main__":
    main()
