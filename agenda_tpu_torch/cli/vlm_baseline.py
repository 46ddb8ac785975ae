"""CLI: zero-shot VLM car-detection baselines -> COCO prediction JSON.

Counterpart of ``agenda_tpu/cli/vlm_baseline.py`` (the reference's
``Data/inference/test_{gemini,internvl,deepseek}.py``): parse line-per-box
model responses normalised to 0-1000 (or 0-999), scale them to the image
size, and emit a COCO prediction JSON over a ground-truth COCO's image
list. It runs on the host only.

Backends:

- ``--backend responses``: replays cached model responses from a JSON file
  {file_name: response_text}, so the parse/convert/evaluate chain runs
  offline and the published VLM precision/recall rows are reproducible from
  response dumps;
- ``--backend gemini`` and ``--backend transformers`` raise: they need the
  Gemini API client or a local ``transformers`` model, and the machines the
  port runs on have neither.

``--model_format`` selects the per-model response conventions:

- ``gemini``   — boxes ``[y1, x1, y2, x2]``, normalized /1000
  (``test_gemini.py:78-83``);
- ``internvl`` — boxes ``[x1, y1, x2, y2]``, normalized /1000
  (``test_internvl.py:74-80``);
- ``deepseek`` — boxes ``[x1, y1, x2, y2]``, normalized /999
  (``test_deepseek.py:110-116``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Zero-shot VLM detection baseline.")
    p.add_argument("--backend", type=str, default="responses",
                   choices=["gemini", "transformers", "responses"])
    p.add_argument("--api_key", type=str, default=None,
                   help="API key (gemini backend; not available in the port)")
    p.add_argument("--model_path", type=str, default=None,
                   help="Local HF image-text-to-text checkpoint dir "
                        "(transformers backend; not available in the port)")
    p.add_argument("--max_new_tokens", type=int, default=512,
                   help="Generation budget (transformers backend; not available in the port)")
    p.add_argument("--responses_file", type=str, default=None,
                   help="JSON {file_name: response_text} (responses backend)")
    p.add_argument("--test_data_base_path", type=str, default="Data/Real/UGRC/test")
    p.add_argument("--annotation_file", type=str,
                   default="annotations_coco_FakeBBoxes:42.36px_ForIoU:0.500.json")
    p.add_argument("--save_path", type=str, default="annotations_vlm.json")
    p.add_argument("--image_width", type=int, default=112)
    p.add_argument("--image_height", type=int, default=112)
    p.add_argument("--model_format", type=str, default="gemini",
                   choices=["gemini", "internvl", "deepseek"],
                   help="Response conventions of the queried model "
                        "(box order + normalization denominator).")
    p.add_argument("--prompt", type=str, default=None,
                   help="Override the per-model default prompt.")
    args = p.parse_args(argv)
    if args.prompt is None:
        args.prompt = {
            "gemini": "Detect the 2d bounding boxes of all the cars.",
            "internvl": "Please provide the bounding box coordinate of all "
                        "cars in the image using the format [x1, y1, x2, y2].",
            "deepseek": "<|ref|>Cars.<|/ref|>.",
        }[args.model_format]
    return args


# (box order, normalization denominator) per reference script
MODEL_FORMATS = {
    "gemini": ("yxyx", 1000.0),
    "internvl": ("xyxy", 1000.0),
    "deepseek": ("xyxy", 999.0),
}


def parse_list_boxes(text: str) -> List[List[int]]:
    """Line-per-box '[a, b, c, d]' parser (test_gemini.py:33-44 semantics)."""
    result = []
    for line in text.strip().splitlines():
        try:
            numbers = line.split("[")[1].split("]")[0].split(",")
            result.append([int(num.strip()) for num in numbers])
        except (IndexError, ValueError):
            continue
    return result


def boxes_to_annotations(
    boxes: List[List[int]], image_id: int, start_id: int,
    image_width: int, image_height: int,
    order: str = "yxyx", denom: float = 1000.0,
) -> List[dict]:
    """Normalized model boxes -> COCO xywh annotations, including the
    min/max swap (test_gemini.py:75-93; internvl/deepseek differ only in
    box order and denominator — see MODEL_FORMATS)."""
    anns = []
    object_id = start_id
    for bbox in boxes:
        if len(bbox) != 4:
            continue
        if order == "yxyx":
            y1, x1, y2, x2 = bbox
        else:
            x1, y1, x2, y2 = bbox
        if y1 > y2:
            y1, y2 = y2, y1
        if x1 > x2:
            x1, x2 = x2, x1
        y1 = y1 / denom * image_height
        x1 = x1 / denom * image_width
        y2 = y2 / denom * image_height
        x2 = x2 / denom * image_width
        w, h = x2 - x1, y2 - y1
        anns.append({
            "iscrowd": 0,
            "category_id": 1,
            "id": object_id,
            "image_id": image_id,
            "bbox": [x1, y1, w, h],
            "area": w * h,
        })
        object_id += 1
    return anns


def main(argv=None):
    args = parse_args(argv)

    with open(os.path.join(args.test_data_base_path, args.annotation_file)) as f:
        gt = json.load(f)

    if args.backend == "responses":
        if not args.responses_file:
            raise ValueError("--backend responses requires --responses_file")
        with open(args.responses_file) as f:
            responses = json.load(f)

        def query(image_ann):
            return responses.get(image_ann["file_name"], "")

    else:
        raise SystemExit(
            f"--backend {args.backend} needs "
            + ("the Gemini API client (google-generativeai) and an API key"
               if args.backend == "gemini" else "the transformers package and a local model")
            + "; the port's installations have neither. Use --backend responses with "
              "cached model outputs.")

    pred = {
        "categories": list(gt["categories"]),
        "images": list(gt["images"]),
        "annotations": [],
    }
    order, denom = MODEL_FORMATS[args.model_format]
    for image_ann in gt["images"]:
        boxes = parse_list_boxes(query(image_ann))
        pred["annotations"] += boxes_to_annotations(
            boxes, image_ann["id"], len(pred["annotations"]),
            args.image_width, args.image_height, order=order, denom=denom,
        )

    with open(args.save_path, "w") as f:
        json.dump(pred, f)
    print(f"wrote {len(pred['annotations'])} annotations to {args.save_path}")
    return pred


if __name__ == "__main__":
    main()
