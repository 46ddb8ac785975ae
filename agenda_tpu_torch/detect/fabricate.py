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
4, seed 0) and ``<dir>/data/{images/<i>.png,ann.json}`` (112-px tiles);
``--mm-checkpoint PATH`` also writes a seeded checkpoint in the mmdet/mmyolo
layout of the detector's family with 80-class COCO heads
(``write_mm_checkpoint``), what ``det_train --pretrained`` reads.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig
from agenda_tpu_torch.detect.runner import IMPORT_KEYS, save_variables
from agenda_tpu_torch.detect.yolov8 import ConvBNAct
from agenda_tpu_torch.utils.png import write_png

BOX = 42.36


def calibrate_batch_norm(family, variables: Dict[str, torch.Tensor],
                         images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``variables`` with every BatchNorm's running statistics set to the
    batch statistics of ``images`` (B, H, W, 3) in [0, 1]: the mean and the
    unbiased variance of each norm's input, the model in train mode (a
    model without batch norm comes back as it is).

    A fresh init keeps mean 0 and var 1, so in eval mode each SiLU about
    halves the signal and the heads see activations of 1e-6: every anchor
    then scores alike and NMS turns on ties. Statistics measured on data, as
    a trained detector's are, keep the activations near unit scale.
    """
    model = family.model
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if not norms:
        return {k: v.detach().clone() for k, v in variables.items()}
    model.load_state_dict(variables)
    # a ConvBNAct normalises in train mode without calling its norm's forward:
    # its convolution's output is the norm's input
    conv_of = {id(b.bn): b.conv for b in model.modules() if isinstance(b, ConvBNAct)}
    stats = {}

    def record(norm, x):
        c = x.shape[1]
        mean, var = torch.zeros(c, dtype=x.dtype), torch.ones(c, dtype=x.dtype)
        # momentum 1: the running statistics become the batch's mean and
        # unbiased variance, as BatchNorm2d records a first batch
        F.batch_norm(x, mean, var, None, None, True, 1.0, norm.eps)
        stats[norm] = (mean, var)

    handles = [conv_of[id(n)].register_forward_hook(lambda _m, _i, out, n=n: record(n, out))
               if id(n) in conv_of else
               n.register_forward_pre_hook(lambda _m, inputs, n=n: record(n, inputs[0]))
               for n in norms]
    model.train()  # each norm normalises with its batch's statistics
    try:
        with torch.no_grad():
            model(images.permute(0, 3, 1, 2))
    finally:
        model.eval()
        for h in handles:
            h.remove()
    for n in norms:
        mean, var = stats[n]
        n.running_mean.copy_(mean)
        n.running_var.copy_(var)
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
    save_variables(ckpt, variables, family=family)
    return config_path, ckpt


# ---------------------------------------------------------------------------
# mmdet/mmyolo checkpoints (the reference's load_from files), fabricated
# ---------------------------------------------------------------------------


def _resnet_mm(path: List[str]) -> List[str]:
    out = []
    for p in path:
        head, sep, tail = p.rpartition("_")
        out += [head, tail] if sep and tail.isdigit() and head in (
            "layer1", "layer2", "layer3", "layer4", "downsample") else [p]
    return out


def _csp_mm(rest: List[str], style: str) -> List[str]:
    """The C3/C2f names -> mmyolo's CSPLayer(WithTwoConv) names."""
    table = ({"cv1": "main_conv", "cv2": "short_conv", "cv3": "final_conv"} if style == "v5"
             else {"cv1": "main_conv", "cv2": "final_conv"})
    if rest[0] in table:
        return [table[rest[0]]] + rest[1:]
    if style == "v5":  # m_{n}_cv{1,2}
        _, n, cv = rest[0].split("_")
        return ["blocks", n, "conv" + cv[-1]] + rest[1:]
    return ["blocks", rest[0].split("_")[1], "conv" + rest[1][-1]] + rest[2:]  # m_{n}.cv{1,2}


_V5_NECK = {"reduce5": "neck.reduce_layers.2", "neck_c3_1": "neck.top_down_layers.0.0",
            "reduce4": "neck.top_down_layers.0.1", "neck_c3_2": "neck.top_down_layers.1",
            "neck_down3": "neck.downsample_layers.0", "neck_down4": "neck.downsample_layers.1",
            "neck_c3_3": "neck.bottom_up_layers.0", "neck_c3_4": "neck.bottom_up_layers.1"}
_V8_NECK = {"neck_p4": "neck.top_down_layers.0", "neck_p3": "neck.top_down_layers.1",
            "neck_p4b": "neck.bottom_up_layers.0", "neck_p5": "neck.bottom_up_layers.1",
            "neck_down3": "neck.downsample_layers.0", "neck_down4": "neck.downsample_layers.1"}
_VIT_BLOCK = {"norm1": "ln1", "norm2": "ln2", "qkv": "attn.qkv", "proj": "attn.proj",
              "fc1": "ffn.layers.0.0", "fc2": "ffn.layers.1", "rel_pos_h": "attn.rel_pos_h",
              "rel_pos_w": "attn.rel_pos_w"}
_RPN_ROI = {"rpn": "rpn_head", "box_head.fc1": "roi_head.bbox_head.shared_fcs.0",
            "box_head.fc2": "roi_head.bbox_head.shared_fcs.1",
            "box_head.cls": "roi_head.bbox_head.fc_cls",
            "box_head.reg": "roi_head.bbox_head.fc_reg"}


def _yolo_mm(mods: List[str], style: str, csp: str, neck: Dict[str, str]) -> Optional[str]:
    m0 = mods[0]
    if m0 == "stem":
        return ".".join(["backbone.stem"] + mods[1:])
    if m0.startswith("down"):
        return ".".join([f"backbone.stage{m0[4:]}.0"] + mods[1:])
    if m0.startswith(csp + "_"):
        return ".".join([f"backbone.stage{m0.split('_')[1]}.1"] + _csp_mm(mods[1:], style))
    if m0 == "sppf":
        return ".".join(["backbone.stage4.2", "conv" + mods[1][-1]] + mods[2:])
    if m0 in neck:
        rest = mods[1:]
        if m0.startswith(("neck_c3", "neck_p")):
            rest = _csp_mm(rest, style)
        return ".".join([neck[m0]] + rest)
    if style == "v5" and m0.startswith("head_"):
        return f"bbox_head.head_module.convs_pred.{m0.split('_')[1]}"
    if style == "v8" and m0.startswith("head_"):
        kind, lvl = m0[len("head_"):].split("_")  # cls1, box3, ...
        branch = "cls" if kind.startswith("cls") else "reg"
        return ".".join([f"bbox_head.head_module.{branch}_preds.{lvl}.{int(kind[-1]) - 1}"]
                        + mods[1:])
    return None


def _mm_module(key: str, mods: List[str]) -> Optional[str]:
    """A flax module path of ``key``'s family -> the mm module name, or None
    where the mm model has no counterpart."""
    joined = ".".join(mods)
    if key in ("faster-rcnn", "vitdet"):
        for ours, mm in _RPN_ROI.items():
            if joined == ours or joined.startswith(ours + "."):
                return mm + joined[len(ours):]
    if key == "faster-rcnn":
        if mods[0] == "backbone":
            return ".".join(["backbone"] + _resnet_mm(mods[1:]))
        if mods[0] == "fpn":
            kind, i = mods[1].rsplit("_", 1)
            return f"neck.{'lateral_convs' if kind == 'lateral' else 'fpn_convs'}.{i}.conv"
        return None
    if key == "yolov5":
        return _yolo_mm(mods, "v5", "c3", _V5_NECK)
    if key == "yolov8":
        return _yolo_mm(mods, "v8", "c2f", _V8_NECK)
    if mods[:2] == ["backbone", "patch_embed"]:
        return "backbone.patch_embed.projection"
    if mods == ["backbone", "norm"]:
        return "backbone.ln1"
    if mods[0] == "backbone" and mods[1].startswith("block_") and len(mods) > 2:
        return f"backbone.blocks.{mods[1].split('_')[1]}.{_VIT_BLOCK[mods[2]]}"
    return None


COCO_CLASSES = 80


def mm_checkpoint(family, key: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded state dict in the mmdet/mmyolo layout of ``family`` (``key``:
    faster-rcnn, yolov5, yolov8, vitdet), as the reference's COCO
    checkpoints name and shape it: the class-count heads for 80 classes
    (Faster R-CNN's and ViTDet's fc_cls/fc_reg, YOLOv5's convs_pred,
    YOLOv8's cls_preds.*.2), ViTDet's ``pos_embed`` on a 14x14 grid with a
    cls token and its rel-pos tables at the 1024-px length 127. Kernels are
    normal with std 1/sqrt(fan in), norms near 1, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    na = 3
    for name, v in family.to_flax(family.model.state_dict()).items():
        col, _, path = name.partition(".")
        *mods, leaf = path.split(".")
        if leaf == "pos_embed":
            out["backbone.pos_embed"] = rng.normal(0, 0.02, (1, 14 * 14 + 1, v.shape[-1]))
            continue
        if leaf in ("rel_pos_h", "rel_pos_w"):
            out[f"backbone.blocks.{mods[1].split('_')[1]}.attn.{leaf}"] = rng.normal(
                0, 0.02, (127, v.shape[1]))
            continue
        mm = _mm_module(key, mods)
        if mm is None:
            continue
        if leaf == "kernel":
            shape = (v.shape[3], v.shape[2], v.shape[0], v.shape[1]) if v.ndim == 4 \
                else (v.shape[1], v.shape[0])
            out[mm + ".weight"] = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "scale":
            out[mm + ".weight"] = 1 + 0.1 * rng.normal(0, 1, v.shape)
        elif leaf == "bias":
            out[mm + ".bias"] = 0.1 * rng.normal(0, 1, v.shape)
        elif leaf == "mean":
            out[mm + ".running_mean"] = 0.1 * rng.normal(0, 1, v.shape)
        else:
            out[mm + ".running_var"] = rng.uniform(0.5, 1.5, v.shape)
            out[mm + ".num_batches_tracked"] = np.asarray(1000, np.int64)
    heads = {"faster-rcnn": ("roi_head.bbox_head", COCO_CLASSES + 1, 4 * COCO_CLASSES),
             "vitdet": ("roi_head.bbox_head", COCO_CLASSES + 1, 4 * COCO_CLASSES)}
    if key in heads:
        pre, n_cls, n_reg = heads[key]
        for name, n in (("fc_cls", n_cls), ("fc_reg", n_reg)):
            out[f"{pre}.{name}.weight"] = rng.normal(0, 1, (n, 1024)) / 32.0
            out[f"{pre}.{name}.bias"] = np.zeros(n)
    for k in list(out):
        if key == "yolov5" and k.startswith("bbox_head.head_module.convs_pred."):
            w = out[k]
            out[k] = (rng.normal(0, 1, (na * (5 + COCO_CLASSES),) + w.shape[1:]) / np.sqrt(
                np.prod(w.shape[1:])) if w.ndim == 4 else np.zeros(na * (5 + COCO_CLASSES)))
        if key == "yolov8" and re.fullmatch(r"bbox_head\.head_module\.cls_preds\.\d\.2\.\w+", k):
            w = out[k]
            out[k] = (rng.normal(0, 1, (COCO_CLASSES,) + w.shape[1:]) / np.sqrt(
                np.prod(w.shape[1:])) if w.ndim == 4 else np.zeros(COCO_CLASSES))
    return {k: np.asarray(v, np.float32 if v.dtype.kind == "f" else v.dtype)
            for k, v in out.items()}


def write_mm_checkpoint(path: str, detector: str, seed: int = 0, **model) -> Dict[str, np.ndarray]:
    """``mm_checkpoint`` of ``detector``'s family (``model``: its config
    overrides, e.g. img_size) saved as an mm-style ``.pth``
    (``{"state_dict": ..., "meta": ...}``) -> the state dict."""
    from agenda_tpu_torch.detect.families import build_family

    family = build_family(detector, model=model)
    sd = mm_checkpoint(family, IMPORT_KEYS[type(family).__name__], seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "meta": {"note": "fabricated, seed %d" % seed}}, path)
    return sd


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
    p.add_argument("--detector", default="yolov8",
                   choices=("yolov8", "yolov8n", "yolov8s", "yolov5", "yolov5s", "faster-rcnn",
                            "vitdet"))
    p.add_argument("--tiles", type=int, default=12)
    p.add_argument("--mm-checkpoint", default=None,
                   help="Also write an mmdet/mmyolo-layout .pth of the detector's family.")
    args = p.parse_args(argv)
    data = os.path.join(args.out_dir, "data")
    write_square_set(data, args.tiles)
    config, ckpt = fabricate_detector(os.path.join(args.out_dir, "work"), args.detector,
                                      batch_size=4, test=DatasetSpec(data, "ann.json"))
    print(f"wrote {config}, {ckpt} and {args.tiles} tiles with {data}/ann.json")
    if args.mm_checkpoint:
        sd = write_mm_checkpoint(args.mm_checkpoint, args.detector)
        print(f"wrote {args.mm_checkpoint} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
