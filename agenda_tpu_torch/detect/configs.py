"""Detector run configuration and the stage presets.

Counterpart of ``agenda_tpu/detect/configs.py``: ``DatasetSpec`` and
``DetectionConfig`` with ``to_json``/``from_json``, ``build_family``,
``build_train_dataset`` and ``build_eval_dataset``, so that a
``config.json`` written by either package parses in the other; and the
stage presets (``preset``, ``HYPERPARAMS``) for the YOLOv8 family in all
three stages, with the reference's batch size, lr, epochs, val cadence,
optimizer and recipe. The other families' presets raise (ROADMAP.md §A).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from agenda_tpu_torch.detect.augment import AugConfig, lsj_aug, mix_stage_aug
from agenda_tpu_torch.detect.runner import RunnerConfig


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

    def build_train_dataset(self):
        from agenda_tpu_torch.detect.dataset import CocoDetDataset, ConcatDataset

        aug = dataclasses.replace(self.aug, flip_prob=self.flip_prob) \
            if self.flip_prob is not None else self.aug
        parts = [
            CocoDetDataset(s.data_root, s.ann_file, s.data_prefix, self.img_scale, self.max_gt,
                           train=True, aug=aug)
            for s in self.train_datasets
        ]
        return parts[0] if len(parts) == 1 else ConcatDataset(parts)

    def build_eval_dataset(self, spec: DatasetSpec):
        from agenda_tpu_torch.detect.dataset import CocoDetDataset

        return CocoDetDataset(spec.data_root, spec.ann_file, spec.data_prefix,
                              self.img_scale, self.max_gt, train=False)


# Per-stage hyperparameters of the YOLOv8 family, read off the reference's
# configs (Real_Source/yolov8.py:19,29-34,40; Synthetic_Heatmap/yolov8.py:
# 19,29-34,40; Synthetic_Target/yolov8.py:19,29-34,40,239-240,254-255).
# bs = train_batch_size_per_gpu. The rows differ only in these keys: every
# one trains with the YOLOv5 optimizer and the mix recipe with YOLOv5MixUp
# (the reference's aug="mix", yolo_mixup and yolo_opt), which ``preset`` sets.
HYPERPARAMS: Dict[Tuple[str, str], Dict[str, Any]] = {
    ("real_source", "yolov8"): dict(bs=512, lr=0.001, opt="sgd", epochs=1000,
                                    val_interval=1, lr_factor=0.01,
                                    close_mosaic=10, val_interval_stage2=1),
    ("synthetic_heatmap", "yolov8"): dict(bs=192, lr=1e-4, opt="sgd", epochs=500,
                                          val_interval=2, lr_factor=0.01,
                                          close_mosaic=10, val_interval_stage2=1),
    ("synthetic_target", "yolov8"): dict(bs=1024, lr=0.001, opt="sgd",
                                         epochs=1000, val_interval=1,
                                         lr_factor=0.01, close_mosaic=10,
                                         val_interval_stage2=1),
}
STAGES = ("real_source", "synthetic_heatmap", "synthetic_target")


def _family_key(detector: str) -> str:
    if detector.startswith("yolov8"):
        return "yolov8"
    if detector.startswith("yolov5"):
        return "yolov5"
    if detector.startswith("vitdet"):
        return "vitdet"
    return "faster-rcnn"


def preset(
    stage: str,
    detector: str,
    train: List[DatasetSpec],
    val: Optional[DatasetSpec] = None,
    test: Optional[DatasetSpec] = None,
    output_dir: str = "work_dirs/run",
    pretrained: Optional[str] = None,
    **overrides,
) -> DetectionConfig:
    """Stage x family presets carrying the reference's hyperparameters."""
    family = _family_key(detector)
    if stage not in STAGES:
        raise ValueError(f"Unknown stage/family {(stage, family)}; stages: {sorted(STAGES)}")
    if family != "yolov8":
        raise NotImplementedError(
            f"the {family} presets are not ported yet: ROADMAP.md §A, the item "
            "'Faster R-CNN, YOLOv5, ViTDet and io/torch_import.py'")
    hp = HYPERPARAMS[(stage, family)]
    # every row trains with mmyolo's YOLOv5OptimizerConstructor: SGD with
    # momentum 0.937, nesterov, wd 0.0005 scaled by the batch size, per-group
    # decay, the lr_factor schedule, no gradient clipping; the EMA of
    # ExpMomentumEMA(momentum=0.0002); and the mix recipe with YOLOv5MixUp
    # (a mosaic'd sample mixed in at prob 0.1)
    runner = RunnerConfig(
        output_dir=output_dir,
        max_epochs=hp["epochs"],
        batch_size=hp["bs"],
        lr=hp["lr"],
        optimizer=hp["opt"],
        weight_decay=0.0005,
        val_interval=hp["val_interval"],
        yolo_optimizer=True,
        momentum=0.937,
        nesterov=True,
        lr_factor=hp["lr_factor"],
        clip_grad_norm=None,
        close_mosaic_epochs=hp["close_mosaic"],
        val_interval_stage2=hp["val_interval_stage2"],
        ema_decay=0.9998,
    )
    # a row's "aug" names its recipe, as the JAX package's rows do; "lsj" is
    # the ViTDet heatmap stage's, whose rows are not ported yet
    aug = lsj_aug() if hp.get("aug") == "lsj" else \
        mix_stage_aug(mixup_prob=0.1, mixup_mosaic_pre=True)
    cfg = DetectionConfig(
        detector=detector, train_datasets=train, val_dataset=val,
        test_dataset=test, runner=runner, aug=aug, pretrained=pretrained,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
