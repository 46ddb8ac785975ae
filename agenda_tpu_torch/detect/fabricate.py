"""Fabricated detector runs: a seeded checkpoint, its config, PNG tiles and a COCO file.

No trained detector is in the repository. These helpers write what the
labelling stages read, so they can be driven end to end: ``config.json``
(a ``DetectionConfig``, as the JAX ``det_train`` writes it) and
``latest.safetensors`` (the port's own seeded init with batch-norm
statistics measured on seeded noise, in the JAX checkpoint layout), and
tiles of bright squares on dark noise with their boxes as COCO
annotations (the 42.36-px vehicle boxes of the reference's tiles).

    python -m agenda_tpu_torch.detect.fabricate <dir> [--detector yolov8] [--tiles 12]

writes ``<dir>/work/{config.json,latest.safetensors}`` (128-px input, batch
4, seed 0) and ``<dir>/data/{images/<i>.png,ann.json}`` (112-px tiles).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig
from agenda_tpu_torch.detect.runner import save_variables
from agenda_tpu_torch.utils.png import write_png

BOX = 42.36


def calibrate_batch_norm(family, variables: Dict[str, torch.Tensor],
                         images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``variables`` with every BatchNorm's running statistics set to the
    batch statistics of ``images`` (B, H, W, 3) in [0, 1].

    A fresh init keeps mean 0 and var 1, so in eval mode each SiLU about
    halves the signal and the heads see activations of 1e-6: every anchor
    then scores alike and NMS turns on ties. Statistics measured on data, as
    a trained detector's are, keep the activations near unit scale.
    """
    model = family.model
    model.load_state_dict(variables)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: after one batch, that batch's statistics
    model.train()
    with torch.no_grad():
        model(images.permute(0, 3, 1, 2))
    model.eval()
    for m in norms:
        m.momentum = 0.03
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def fabricate_detector(work_dir: str, detector: str = "yolov8", seed: int = 0,
                       img_size: int = 128, batch_size: int = 192,
                       test: Optional[DatasetSpec] = None) -> Tuple[str, str]:
    """Write ``config.json`` and ``latest.safetensors`` -> their paths."""
    os.makedirs(work_dir, exist_ok=True)
    cfg = DetectionConfig(detector=detector, img_scale=(img_size, img_size), test_dataset=test)
    cfg.runner.batch_size = batch_size
    cfg.runner.output_dir = work_dir
    config_path = os.path.join(work_dir, "config.json")
    cfg.to_json(config_path)
    family = cfg.build_family()
    gen = torch.Generator().manual_seed(seed)
    variables = family.init_variables(gen)
    variables = calibrate_batch_norm(family, variables,
                                     torch.rand(16, img_size, img_size, 3, generator=gen))
    ckpt = os.path.join(work_dir, "latest.safetensors")
    save_variables(ckpt, variables)
    return config_path, ckpt


def square_tile(rng: np.random.Generator, size: int, n_boxes: int) -> Tuple[np.ndarray, List]:
    """uint8 (size, size, 3) dark noise with ``n_boxes`` bright squares -> (tile, xywh boxes)."""
    tile = rng.integers(0, 40, (size, size, 3)).astype(np.uint8)
    boxes = []
    side = int(round(BOX))
    for _ in range(n_boxes):
        x, y = (int(v) for v in rng.integers(0, size - side, 2))
        tile[y:y + side, x:x + side] = rng.integers(160, 256, 3)
        boxes.append([float(x), float(y), BOX, BOX])
    return tile, boxes


def coco_dict(file_names: Sequence[str], boxes: Sequence[Sequence], size: int = 112) -> dict:
    """COCO images (``size`` square) and their xywh boxes, category "small"."""
    images, anns = [], []
    for i, (name, bxs) in enumerate(zip(file_names, boxes)):
        images.append({"id": i, "file_name": name, "width": size, "height": size})
        for b in bxs:
            anns.append({"id": len(anns), "image_id": i, "category_id": 1, "iscrowd": 0,
                         "bbox": list(b), "area": float(b[2] * b[3])})
    return {"categories": [{"id": 1, "name": "small"}], "images": images, "annotations": anns}


def write_square_set(root: str, n: int, size: int = 112, seed: int = 0) -> str:
    """``root/images/<i>.png`` and ``root/ann.json`` -> the annotation path."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    names, boxes = [], []
    for i in range(n):
        tile, bxs = square_tile(rng, size, int(rng.integers(1, 3)))
        write_png(os.path.join(root, "images", f"{i}.png"), tile)
        names.append(f"{i}.png")
        boxes.append(bxs)
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump(coco_dict(names, boxes, size), f)
    return ann


def main(argv=None):
    p = argparse.ArgumentParser(description="Write a fabricated detector run and tiles.")
    p.add_argument("out_dir")
    p.add_argument("--detector", default="yolov8", choices=("yolov8", "yolov8n", "yolov8s"))
    p.add_argument("--tiles", type=int, default=12)
    args = p.parse_args(argv)
    data = os.path.join(args.out_dir, "data")
    write_square_set(data, args.tiles)
    config, ckpt = fabricate_detector(os.path.join(args.out_dir, "work"), args.detector,
                                      batch_size=4, test=DatasetSpec(data, "ann.json"))
    print(f"wrote {config}, {ckpt} and {args.tiles} tiles with {data}/ann.json")


if __name__ == "__main__":
    main()
