"""CLI: build an images-only COCO file for unlabeled synthetic data.

Flag-compatible with ``data_annotation/build_empty_annotation.py:5-11``
(same flags, same output: indent=4 JSON, ids by numeric filename order,
112x112, categories copied from the template COCO).

The port's copy of ``agenda_tpu/cli/build_empty_annotation.py``.
"""

from __future__ import annotations

import argparse

from agenda_tpu_torch.annotate.coco import build_empty_annotation, save_coco


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Image and attention map generation.")
    p.add_argument("--image-dir", type=str,
                   default="Data/Synthetic/LINZ-with-cars/images",
                   help="Directory where images are stored.")
    p.add_argument("--save-dir", type=str,
                   default="Data/Synthetic/LINZ-with-cars/annotations_coco_Empty.json",
                   help="Path to save the COCO annotation file.")
    p.add_argument("--coco-dir", type=str,
                   default="Data/Real/LINZ/test/annotations_coco_FakeBBoxes:42.36px_ForIoU:0.500.json",
                   help="Path to the COCO annotation as an example.")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    coco = build_empty_annotation(args.image_dir, args.coco_dir)
    save_coco(coco, args.save_dir, indent=4)


if __name__ == "__main__":
    main()
