"""Detector family adapters for the runner (prediction path).

Counterpart of ``agenda_tpu/detect/families.py``. A family packages a
model, its variables and its predict function. Variables are the model's
``state_dict`` (the port's names; ``runner.load_variables`` reads the JAX
checkpoint layout into it). ``predict_fn`` runs on whatever device the
variables and the images are on. Only YOLOv8 is ported; the other
families of the JAX package raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.func import functional_call

from agenda_tpu_torch.detect.yolov8 import YOLOv8, YOLOv8Config, init_yolov8_, yolov8_predict


@dataclasses.dataclass
class YOLOv8Family:
    config: YOLOv8Config = dataclasses.field(default_factory=YOLOv8Config)
    score_thr: float = 0.001
    iou_thr: float = 0.7
    max_dets: int = 300

    def __post_init__(self):
        self.model = YOLOv8(self.config).eval()

    def init_variables(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh weights drawn from ``generator`` (a CPU generator), as a state_dict."""
        init_yolov8_(self.model, generator)
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def check_variables(self, variables: Dict[str, torch.Tensor]) -> None:
        """Raise unless ``variables`` has exactly this model's names and shapes."""
        own = self.model.state_dict()
        missing = sorted(set(own) - set(variables))
        extra = sorted(set(variables) - set(own))
        if missing or extra:
            raise KeyError(f"variables do not fit {type(self.model).__name__} "
                           f"(width {self.config.width}): missing {missing[:5]}, "
                           f"unexpected {extra[:5]}")
        for k, v in own.items():
            if tuple(variables[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: shape {tuple(variables[k].shape)}, "
                                 f"the model has {tuple(v.shape)}")

    @torch.no_grad()
    def forward(self, variables: Dict[str, torch.Tensor], images: torch.Tensor):
        """images (B, H, W, 3) in [0, 1] -> the per-level NHWC head outputs.

        The layers run on NCHW memory: the f32 convolutions cuDNN picks on
        the H100 are NCHW kernels, which convert channels-last input back
        and forth around every layer."""
        x = images.permute(0, 3, 1, 2).contiguous()
        return functional_call(self.model, variables, (x,))

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
    if name in ("faster-rcnn", "faster_rcnn", "yolov5", "yolov5m", "yolov5s", "vitdet"):
        raise NotImplementedError(
            f"detector family {name!r} is not ported yet: ROADMAP.md §A, the item "
            "'Faster R-CNN, YOLOv5, ViTDet and io/torch_import.py'")
    raise ValueError(f"Unknown detector family: {name}")
