"""Detector family adapters for the runner.

Counterpart of ``agenda_tpu/detect/families.py``. A family packages a
model, its variables, its loss and its predict function. Variables are the
model's ``state_dict`` (``flax_layout.FamilyVariables``: the parameters,
the batch-norm statistics and their names; ``runner.load_variables`` reads
the JAX checkpoint layout into it). ``loss_fn`` and
``predict_fn`` run on whatever device the variables and the images are
on. Every family of the JAX package's ``build_family`` is here: YOLOv8
(``yolov8``, ``yolov8n``, ``yolov8s``), Faster R-CNN (``faster-rcnn``,
``faster_rcnn``), YOLOv5 (``yolov5``, ``yolov5m``, ``yolov5s``) and ViTDet.
``loss_fn`` takes the
step's ``torch.Generator`` (the two-stage families' samplers and ViTDet's
drop path draw from it; the YOLO families draw nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from agenda_tpu_torch.detect.flax_layout import FamilyVariables
from agenda_tpu_torch.detect.yolov8 import (YOLOv8, YOLOv8Config, init_yolov8_, yolov8_loss,
                                            yolov8_predict)


@dataclasses.dataclass
class YOLOv8Family(FamilyVariables):
    config: YOLOv8Config = dataclasses.field(default_factory=YOLOv8Config)
    score_thr: float = 0.001
    iou_thr: float = 0.7
    max_dets: int = 300

    def __post_init__(self):
        self.model = YOLOv8(self.config).eval()
        self._name_variables()

    def init_variables(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh weights drawn from ``generator`` (a CPU generator), as a state_dict."""
        init_yolov8_(self.model, generator)
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def forward(self, variables: Dict[str, torch.Tensor], images: torch.Tensor):
        """images (B, H, W, 3) in [0, 1] -> the per-level NHWC head outputs.

        The layers run on NCHW memory: the f32 convolutions cuDNN picks on
        the H100 are NCHW kernels, which convert channels-last input back
        and forth around every layer."""
        x = images.permute(0, 3, 1, 2).contiguous()
        return functional_call(self.model, variables, (x,))

    def loss_fn(self, variables: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The train-mode forward and the v8 loss -> (loss, metrics, new_batch_stats).

        ``batch`` holds ``image`` (B, H, W, 3) in [0, 1], ``gt_boxes`` and
        ``gt_valid``. Gradients flow to the parameter tensors of
        ``variables``; its batch-norm statistics are left as they are, and
        their update (flax's, with the biased batch variance) comes back as
        ``new_batch_stats``, keyed as ``stat_names``. Draws nothing.
        """
        stats = {k: variables[k].clone() for k in self.stat_names}
        x = batch["image"].permute(0, 3, 1, 2).contiguous()
        self.model.train()
        try:
            outs = functional_call(self.model, {**variables, **stats}, (x,))
        finally:
            self.model.eval()
        loss, metrics = yolov8_loss(outs, batch, self.config)
        return loss, metrics, stats

    @torch.no_grad()
    def predict_fn(self, variables: Dict[str, torch.Tensor], images: torch.Tensor):
        """images (B, H, W, 3) in [0, 1] -> (boxes (B,K,4), scores (B,K), valid (B,K))."""
        return yolov8_predict(self.forward(variables, images), self.config,
                              self.score_thr, self.iou_thr, self.max_dets)


def build_family(name: str, **kw):
    # JSON gives lists; the config is hashed (anchors are cached per config)
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.get("model", {}).items()}
    if name in ("yolov8", "yolov8n"):
        return YOLOv8Family(YOLOv8Config(**model), **kw.get("predict", {}))
    if name == "yolov8s":
        mk = dict(depth=0.33, width=0.5, ratio=2.0)
        mk.update(model)
        return YOLOv8Family(YOLOv8Config(**mk), **kw.get("predict", {}))
    if name in ("faster-rcnn", "faster_rcnn"):
        from agenda_tpu_torch.detect.faster_rcnn import FasterRCNNConfig, FasterRCNNFamily

        return FasterRCNNFamily(FasterRCNNConfig(**model), **kw.get("predict", {}))
    if name in ("yolov5", "yolov5m", "yolov5s"):
        from agenda_tpu_torch.detect.yolov5 import YOLOv5Config, YOLOv5Family

        mk = dict(depth=0.33, width=0.5) if name == "yolov5s" else {}
        mk.update(model)
        return YOLOv5Family(YOLOv5Config(**mk), **kw.get("predict", {}))
    if name == "vitdet":
        from agenda_tpu_torch.detect.vitdet import ViTDetConfig, ViTDetFamily

        return ViTDetFamily(ViTDetConfig(**model), **kw.get("predict", {}))
    raise ValueError(f"Unknown detector family: {name}")
