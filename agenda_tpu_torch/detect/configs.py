"""Detector run configuration (the JSON that ``det_train`` writes beside a checkpoint).

Counterpart of ``agenda_tpu/detect/configs.py:36-135``: ``DatasetSpec`` and
``DetectionConfig`` with ``to_json``/``from_json``, ``build_family`` and
``build_eval_dataset``, and ``AugConfig`` as a plain dataclass with the
fields of ``agenda_tpu/detect/augment.py::AugConfig``, so that a
``config.json`` written by the JAX ``det_train`` parses unchanged. The
stage presets (``preset``, ``HYPERPARAMS``) and the training dataset
belong to training and are not ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from agenda_tpu_torch.detect.runner import RunnerConfig


@dataclasses.dataclass
class AugConfig:
    """One stage's train-time augmentation recipe (read, not applied, here)."""

    mosaic: bool = False
    affine_scale: float = 0.9
    max_rotate_degree: float = 0.0
    max_shear_degree: float = 0.0
    max_translate_ratio: float = 0.1
    mixup_prob: float = 0.0
    mixup_mosaic_pre: bool = False
    blur_prob: float = 0.0
    median_blur_prob: float = 0.0
    to_gray_prob: float = 0.0
    clahe_prob: float = 0.0
    hsv: bool = False
    hue_delta: int = 5
    saturation_delta: int = 30
    value_delta: int = 30
    flip_prob: float = 0.5
    lsj: bool = False
    lsj_ratio_range: Tuple[float, float] = (0.1, 2.0)
    standalone_affine: bool = False


@dataclasses.dataclass
class DatasetSpec:
    data_root: str
    ann_file: str
    data_prefix: str = "images/"


@dataclasses.dataclass
class DetectionConfig:
    detector: str = "yolov8"  # yolov8 | yolov8s (yolov5, faster-rcnn, vitdet: not ported)
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    predict: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train_datasets: List[DatasetSpec] = dataclasses.field(default_factory=list)
    val_dataset: Optional[DatasetSpec] = None
    test_dataset: Optional[DatasetSpec] = None
    img_scale: Tuple[int, int] = (128, 128)
    max_gt: int = 64
    flip_prob: Optional[float] = None
    aug: AugConfig = dataclasses.field(default_factory=AugConfig)
    pretrained: Optional[str] = None
    runner: RunnerConfig = dataclasses.field(default_factory=RunnerConfig)

    def to_json(self, path: str) -> None:
        d = dataclasses.asdict(self)
        # A top-level flip_prob override is folded into the aug block, as the
        # JAX package does, so that a round trip keeps the effective value.
        if d.get("flip_prob") is not None and d.get("aug"):
            d["aug"]["flip_prob"] = d.pop("flip_prob")
        else:
            d.pop("flip_prob", None)
        with open(path, "w") as f:
            json.dump(d, f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "DetectionConfig":
        with open(path) as f:
            d = json.load(f)
        d["runner"] = RunnerConfig(**d.get("runner", {}))
        d["train_datasets"] = [DatasetSpec(**x) for x in d.get("train_datasets", [])]
        for k in ("val_dataset", "test_dataset"):
            if d.get(k):
                d[k] = DatasetSpec(**d[k])
        d["img_scale"] = tuple(d.get("img_scale", (128, 128)))
        if "aug" in d:
            a = d["aug"]
            a["lsj_ratio_range"] = tuple(a.get("lsj_ratio_range", (0.1, 2.0)))
            d["aug"] = AugConfig(**a)
            d.pop("flip_prob", None)
        # round-1 compat: old float-prob fields map onto an AugConfig
        legacy = {k: d.pop(k) for k in ("mosaic_prob", "mixup_prob", "hsv_prob") if k in d}
        if legacy and "aug" not in d:
            d["aug"] = AugConfig(
                mosaic=legacy.get("mosaic_prob", 0) > 0,
                mixup_prob=legacy.get("mixup_prob", 0.0),
                hsv=legacy.get("hsv_prob", 0) > 0,
            )
        return cls(**d)

    def build_family(self):
        from agenda_tpu_torch.detect.families import build_family

        model = dict(self.model)
        model.setdefault("img_size", self.img_scale[0])
        model.setdefault("max_gt", self.max_gt)
        return build_family(self.detector, model=model, predict=self.predict)

    def build_eval_dataset(self, spec: DatasetSpec):
        from agenda_tpu_torch.detect.dataset import CocoDetDataset

        return CocoDetDataset(spec.data_root, spec.ann_file, spec.data_prefix,
                              self.img_scale, self.max_gt, train=False)
