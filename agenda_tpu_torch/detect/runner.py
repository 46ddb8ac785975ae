"""Detector runner, prediction side: checkpoints, batched labelling, mAP.

Counterpart of ``agenda_tpu/detect/runner.py:37-118, 679-808``:

- ``RunnerConfig`` with every field of the JAX package's, so a
  ``config.json`` from its ``det_train`` parses; only ``batch_size`` is
  read here;
- ``load_variables``/``save_variables``: the JAX runner's checkpoint, one
  safetensors file of flattened flax variables (``params.<path>`` and
  ``batch_stats.<path>``), read and written through the port's own
  safetensors code and mapped to and from the model's ``state_dict``
  (``yolov8.flax_to_state_dict``), so one file serves both packages;
- ``DetectorRunner._predict_batches``: one batch in flight. The host
  decodes batch i+1 while the card runs batch i; the tiles go up as uint8
  from pinned memory (non-blocking), are resized on the card (bilinear, two
  f32 passes, one rounding, as the JAX device path), and the batch's
  (boxes, scores, valid) come back in one device-to-host copy. The last
  batch is padded with its last tile. A set whose tiles differ in size is
  resized tile by tile on the device (the JAX package resizes those on the
  host), within one level of the JAX host path;
- ``evaluate`` (COCO mAP) and ``test`` (the ``prediction.pkl`` records).

The detector runs in f32 on the card with TF32 off (``allow_tf32=False``
for cuDNN and cuBLAS), as the reference's f32 convolutions. Training
(``fit``, optimizers, EMA) and the JAX package's dp-mesh sharding of the
batch are not ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch._device import resolve_device
from agenda_tpu_torch.annotate.records import save_predictions
from agenda_tpu_torch.data.device_resize import resize_levels, resize_weights
from agenda_tpu_torch.detect.coco_eval import coco_map
from agenda_tpu_torch.detect.yolov8 import flax_to_state_dict, state_dict_to_flax
from agenda_tpu_torch.io.safetensors_io import load_file, save_file


@dataclasses.dataclass
class RunnerConfig:
    output_dir: str = "work_dirs/run"
    max_epochs: int = 100
    batch_size: int = 16
    lr: float = 0.02
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 500
    lr_milestones: Tuple[float, ...] = (0.66, 0.88)
    val_interval: int = 5
    save_best: Tuple[str, ...] = ("bbox_mAP", "bbox_mAP_50")
    clip_grad_norm: Optional[float] = 35.0
    ema_decay: float = 0.0
    seed: int = 0
    log_interval: int = 20
    yolo_optimizer: bool = False
    nesterov: bool = False
    lr_factor: float = 0.01
    warmup_epochs: float = 3.0
    warmup_mim_iter: int = 1000
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8
    base_total_batch_size: int = 64
    auto_scale_lr: bool = False
    base_batch_size: Optional[int] = None
    close_mosaic_epochs: int = 0
    val_interval_stage2: Optional[int] = None
    device_aug: bool = False
    device_aug_workers: int = 0
    layer_decay_rate: Optional[float] = None
    layer_decay_layers: int = 12


def _st_path(path: str) -> str:
    return path if path.endswith(".safetensors") else path + ".safetensors"


def save_variables(path: str, variables: Dict[str, torch.Tensor]) -> None:
    """Write a state_dict in the JAX runner's checkpoint layout."""
    save_file(state_dict_to_flax(variables), _st_path(path))


def load_variables(path: str) -> Dict[str, torch.Tensor]:
    """Read a JAX (or port) detector checkpoint into the model's state_dict
    names, on the CPU. An unknown key raises."""
    flat = {k: v.float().numpy() for k, v in load_file(_st_path(path)).items()}
    return flax_to_state_dict(flat)


def full_f32(dev: torch.device):
    """Full f32 convolutions and matmuls on the card (no TF32), cuDNN
    autotuned for the fixed batch shape."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                                    deterministic=False, allow_tf32=False))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


class DetectorRunner:
    def __init__(self, family, cfg: Optional[RunnerConfig] = None, device: Any = "cuda"):
        self.family = family
        self.cfg = cfg or RunnerConfig()
        self.device = resolve_device(device)

    def variables_on_device(self, variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The checked variables on the runner's device."""
        self.family.check_variables(variables)
        return {k: v.to(self.device) for k, v in variables.items()}

    def _predict_batches(self, variables, dataset, batch_size: Optional[int] = None):
        bs = batch_size or self.cfg.batch_size
        dev = self.device
        cuda = dev.type == "cuda"
        n = len(dataset)
        params = self.variables_on_device(variables)
        out_w, out_h = dataset.img_scale
        src = dataset.source_size()  # one size: a batched resize; else tile by tile
        weights: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

        def resize_weights_on_device(w: int, h: int):
            if (w, h) not in weights:
                weights[(w, h)] = (
                    torch.from_numpy(resize_weights(h, out_h, "bilinear")).to(dev),
                    torch.from_numpy(resize_weights(w, out_w, "bilinear")).to(dev))
            return weights[(w, h)]

        # two pinned staging buffers each way: batch i's copies may still be
        # in flight while the host fills batch i+1's
        staged_in: List[Optional[torch.Tensor]] = [None, None]
        staged_out: List[Optional[torch.Tensor]] = [None, None]

        def upload(slot: int, images: np.ndarray) -> torch.Tensor:
            if not cuda:
                return torch.from_numpy(images)
            buf = staged_in[slot]
            if buf is None or buf.shape != images.shape:
                buf = staged_in[slot] = torch.empty(images.shape, dtype=torch.uint8,
                                                    pin_memory=True)
            buf.numpy()[...] = images
            return buf.to(dev, non_blocking=True)

        def dispatch(i: int, slot: int):
            if src is not None:
                items = [dataset.item_u8(j, expect_size=src) for j in range(i, min(i + bs, n))]
                pad = bs - len(items)
                u8 = np.stack([it["image_u8"] for it in items]
                              + [items[-1]["image_u8"]] * pad)
                wy, wx = resize_weights_on_device(*src)
                x = resize_levels(upload(slot, u8), wy, wx) / 255.0
            else:
                items = [dataset.item_u8(j) for j in range(i, min(i + bs, n))]
                pad = bs - len(items)
                tiles = []
                for it in items + [items[-1]] * pad:
                    u8 = torch.from_numpy(it["image_u8"]).to(dev)
                    h, w = u8.shape[:2]
                    wy, wx = resize_weights_on_device(w, h)
                    tiles.append(resize_levels(u8[None], wy, wx, half_up=True))
                x = torch.cat(tiles) / 255.0
            boxes, scores, valid = self.family.predict_fn(params, x)
            packed = torch.cat([boxes, scores[..., None], valid[..., None].to(boxes.dtype)],
                               dim=-1)
            if not cuda:
                return items, packed, None
            host = staged_out[slot]
            if host is None or host.shape != packed.shape:
                host = staged_out[slot] = torch.empty(packed.shape, dtype=packed.dtype,
                                                      pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return items, host, done

        records = []

        def collect(pending):
            items, host, done = pending
            if done is not None:
                done.synchronize()
            res = host.numpy()
            for k, it in enumerate(items):
                valid = res[k, :, 5] > 0
                scores = res[k, :, 4]
                keep = valid & (scores > 0)
                records.append({"item": it, "boxes": res[k, :, :4][keep],  # copies: a mask
                                "scores": scores[keep]})

        pending = None
        with full_f32(dev):
            for slot, i in enumerate(range(0, n, bs)):
                cur = dispatch(i, slot % 2)
                if pending is not None:
                    collect(pending)
                pending = cur
            if pending is not None:
                collect(pending)
        return records

    def evaluate(self, variables, dataset) -> Dict[str, float]:
        recs = self._predict_batches(variables, dataset)
        gts = [r["item"]["gt_boxes"][r["item"]["gt_valid"]] for r in recs]
        return coco_map(gts, [r["boxes"] for r in recs], [r["scores"] for r in recs])

    def test(self, variables, dataset, out_pkl: Optional[str] = None,
             img_dir: Optional[str] = None,
             batch_size: Optional[int] = None) -> List[dict]:
        """Produce prediction records (== mmdet tools/test.py --out)."""
        recs = self._predict_batches(variables, dataset, batch_size=batch_size)
        out = []
        for r in recs:
            it = r["item"]
            image_id = int(it["image_id"])
            file_name = dataset.file_name(image_id)
            sb = np.asarray(it.get("scale_back", np.ones(4)), np.float32)
            out.append({
                "img_path": os.path.join(img_dir or dataset.img_dir, file_name),
                "gt_instances": {
                    "bboxes": np.asarray(it["gt_boxes"][it["gt_valid"]], np.float32) * sb,
                    "labels": np.zeros(int(it["gt_valid"].sum()), np.int64),
                },
                "pred_instances": {
                    "bboxes": np.asarray(r["boxes"], np.float32) * sb,
                    "scores": np.asarray(r["scores"], np.float32),
                    "labels": np.zeros(len(r["scores"]), np.int64),
                },
            })
        if out_pkl:
            save_predictions(out, out_pkl)
        return out
