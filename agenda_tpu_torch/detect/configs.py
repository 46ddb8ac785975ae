"""Detector run configuration and the stage presets.

Counterpart of ``agenda_tpu/detect/configs.py``: ``DatasetSpec`` and
``DetectionConfig`` with ``to_json``/``from_json``, ``build_family``,
``build_train_dataset`` and ``build_eval_dataset``, so that a
``config.json`` written by either package parses in the other; and the
stage presets (``preset``, ``HYPERPARAMS``): the twelve (stage, family)
rows with the reference's batch size, lr, optimizer, epochs, val cadence
and recipe. The yolo families train with mmyolo's SGD, EMA and
YOLOv5MixUp; Faster R-CNN and ViTDet with mmdet's MixUp at probability 1,
except in the heatmap stage (Faster R-CNN ``plain``, ViTDet ``lsj``);
ViTDet with AdamW and layer decay 0.7. Weight decay defaults to 1e-4 for
SGD and 0.05 for AdamW. ``pretrained`` names the checkpoint of the
reference's ``load_from`` (``io/torch_import.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from agenda_tpu_torch.detect.augment import AugConfig, lsj_aug, mix_stage_aug, plain_aug
from agenda_tpu_torch.detect.runner import RunnerConfig


@dataclasses.dataclass
class DatasetSpec:
    data_root: str
    ann_file: str
    data_prefix: str = "images/"


@dataclasses.dataclass
class DetectionConfig:
    detector: str = "yolov8"  # yolov8 | yolov8s | yolov5 | yolov5s | faster-rcnn | vitdet
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


# Per-(stage, family) hyperparameters, read off the reference's configs
# (file:line citations inline). bs = train_batch_size_per_gpu.
HYPERPARAMS: Dict[Tuple[str, str], Dict[str, Any]] = {
    # Real_Source: faster-rcnn.py:22-24,377-379; yolov5.py:28-38 (lr_factor
    # 0.1 at :38); yolov8.py:19,29-34 (close_mosaic_epochs 10 at :34,
    # val_interval_stage2 1 at :40); vitdet.py:22,28,335-339
    ("real_source", "faster-rcnn"): dict(bs=64, lr=0.2, opt="sgd", epochs=1000,
                                         val_interval=1, aug="mix", base_bs=64),
    ("real_source", "yolov5"): dict(bs=200, lr=0.01, opt="sgd", epochs=1000,
                                    val_interval=1, aug="mix", yolo_mixup=True,
                                    yolo_opt=True, lr_factor=0.1),
    ("real_source", "yolov8"): dict(bs=512, lr=0.001, opt="sgd", epochs=1000,
                                    val_interval=1, aug="mix", yolo_mixup=True,
                                    yolo_opt=True, lr_factor=0.01,
                                    close_mosaic=10, val_interval_stage2=1),
    ("real_source", "vitdet"): dict(bs=24, lr=0.001, opt="adamw", epochs=100,
                                    weight_decay=0.1, layer_decay=0.7,
                                    val_interval=1, aug="mix", base_bs=64),
    # Synthetic_Heatmap: faster-rcnn.py:19-21,279; yolov5.py:32-43;
    # yolov8.py:19,29-34,40; 001_lsj base: 29-33,148-152,228
    ("synthetic_heatmap", "faster-rcnn"): dict(bs=96, lr=0.02, opt="sgd",
                                               epochs=500, val_interval=2,
                                               aug="plain", base_bs=96),
    ("synthetic_heatmap", "yolov5"): dict(bs=96, lr=1e-4, opt="sgd", epochs=500,
                                          val_interval=2, aug="mix",
                                          yolo_mixup=True, yolo_opt=True,
                                          lr_factor=0.01),
    ("synthetic_heatmap", "yolov8"): dict(bs=192, lr=1e-4, opt="sgd", epochs=500,
                                          val_interval=2, aug="mix",
                                          yolo_mixup=True, yolo_opt=True,
                                          lr_factor=0.01, close_mosaic=10,
                                          val_interval_stage2=1),
    ("synthetic_heatmap", "vitdet"): dict(bs=48, lr=1e-4, opt="adamw",
                                          weight_decay=0.1, layer_decay=0.7,
                                          epochs=100, val_interval=1,
                                          aug="lsj", base_bs=64),
    # Synthetic_Target: faster-rcnn.py:17-18,388-390; yolov5.py:24-34;
    # yolov8.py:19,29-34,40 (close_mosaic 10, val_interval_stage2 1 at
    # :239-240,254-255); vitdet.py:17,23,327-329,423
    ("synthetic_target", "faster-rcnn"): dict(bs=256, lr=0.02, opt="sgd",
                                              epochs=1000, val_interval=5,
                                              aug="mix", base_bs=256),
    ("synthetic_target", "yolov5"): dict(bs=512, lr=1e-4, opt="sgd", epochs=500,
                                         val_interval=1, aug="mix",
                                         yolo_mixup=True, yolo_opt=True,
                                         lr_factor=0.01),
    ("synthetic_target", "yolov8"): dict(bs=1024, lr=0.001, opt="sgd",
                                         epochs=1000, val_interval=1, aug="mix",
                                         yolo_mixup=True, yolo_opt=True,
                                         lr_factor=0.01, close_mosaic=10,
                                         val_interval_stage2=1),
    ("synthetic_target", "vitdet"): dict(bs=24, lr=1e-4, opt="adamw", epochs=100,
                                         weight_decay=0.1, layer_decay=0.7,
                                         val_interval=1, aug="mix", base_bs=64),
}
STAGES = ("real_source", "synthetic_heatmap", "synthetic_target")
FAMILIES = ("faster-rcnn", "yolov5", "yolov8", "vitdet")


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
    key = (stage, _family_key(detector))
    if key not in HYPERPARAMS:
        raise ValueError(f"Unknown stage/family {key}; stages: {sorted(STAGES)}")
    hp = HYPERPARAMS[key]
    runner = RunnerConfig(
        output_dir=output_dir,
        max_epochs=hp["epochs"],
        batch_size=hp["bs"],
        lr=hp["lr"],
        optimizer=hp["opt"],
        weight_decay=hp.get("weight_decay", 1e-4 if hp["opt"] == "sgd" else 0.05),
        val_interval=hp["val_interval"],
        base_batch_size=hp.get("base_bs"),
    )
    if hp.get("yolo_opt"):
        # mmyolo's YOLOv5OptimizerConstructor: SGD with momentum 0.937,
        # nesterov, wd 0.0005 scaled by the batch size, per-group decay, the
        # lr_factor schedule, no gradient clipping
        runner.yolo_optimizer = True
        runner.momentum = 0.937
        runner.nesterov = True
        runner.weight_decay = hp.get("weight_decay", 0.0005)
        runner.lr_factor = hp["lr_factor"]
        runner.clip_grad_norm = None
    if hp.get("layer_decay"):
        # mmdet's LayerDecayOptimizerConstructor, every reference vitdet stage
        # (e.g. Real_Source/vitdet.py:327-341): decay_rate 0.7, 12 layers
        runner.layer_decay_rate = hp["layer_decay"]
    runner.close_mosaic_epochs = hp.get("close_mosaic", 0)
    runner.val_interval_stage2 = hp.get("val_interval_stage2")
    if detector.startswith("yolo"):
        runner.ema_decay = 0.9998  # mmyolo's ExpMomentumEMA(momentum=0.0002)
    recipe = hp["aug"]
    if recipe == "mix":
        # the yolo families mix in a mosaic'd sample at prob 0.1 (YOLOv5MixUp);
        # mmdet's MixUp (faster-rcnn and vitdet) always mixes a raw one
        aug = mix_stage_aug(mixup_prob=0.1, mixup_mosaic_pre=True) \
            if hp.get("yolo_mixup") else mix_stage_aug(mixup_prob=1.0)
    elif recipe == "lsj":
        aug = lsj_aug()
    else:
        aug = plain_aug()
    cfg = DetectionConfig(
        detector=detector, train_datasets=train, val_dataset=val,
        test_dataset=test, runner=runner, aug=aug, pretrained=pretrained,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
