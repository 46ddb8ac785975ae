"""ResNet-50 as torch modules, with torchvision's module names.

Counterpart of ``agenda_tpu/models/resnet.py``, the label refiner's binary
crop classifier (torchvision's resnet50 with the fc head replaced by
``num_classes`` logits). The names are torchvision's (``conv1``, ``bn1``,
``layer{1-4}.{i}.conv{1-3}``, ``bn{1-3}``, ``downsample.{0,1}``, ``fc``), so
a torchvision state dict loads as it is (``io/resnet_import.py``);
``resnet_from_flax`` and ``resnet_to_flax`` carry the JAX package's
checkpoints across.

The numerics are flax's: batch norm with eps 1e-5 and, in train mode,
flax's update (``0.9 old + 0.1 batch``, biased variance;
``models/batch_norm.py``); the 3x3 and 7x7 convolutions pad 1 and 3 on both
sides; the max-pool pads both edges with -inf (``MaxPool2d(3, 2, 1)``). The
logits come out in f32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from agenda_tpu_torch.models.batch_norm import FlaxBatchNorm2d

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # flax's momentum 0.9
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _norm(ch: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = _norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _norm(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, planes * 4, 1, stride, bias=False),
                                         _norm(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet50(nn.Module):
    """Classifier logits (B, num_classes) f32, or the (C2, C3, C4, C5)
    pyramid with ``features=True``; input NCHW."""

    def __init__(self, num_classes: int = 1, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch, planes = 64, 64
        for li, n_blocks in enumerate(stage_sizes):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(Bottleneck(in_ch, planes, stride, downsample=(bi == 0)))
                in_ch = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor, features: bool = False):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        feats = []
        for li in range(self.n_stages):
            x = getattr(self, f"layer{li + 1}")(x)
            feats.append(x)
        if features:
            return tuple(feats)
        return self.fc(x.mean(dim=(2, 3))).float()


def init_resnet_(model: ResNet50, generator: torch.Generator) -> None:
    """Draw the weights as flax's defaults do, from ``generator`` (CPU):
    convolution and dense kernels lecun normal (truncated at 2 sigma, fan
    in), the dense bias 0; batch norm scale 1, bias 0, mean 0, var 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(mod.weight.shape[1:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()


def normalize_imagenet(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB, channels last -> ImageNet-normalised (the reference's
    transforms). The constants are f32, as the JAX package's are."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(x01.device, x01.dtype)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(x01.device, x01.dtype)
    return (x01 - mean) / std


# ---------------------------------------------------------------------------
# The JAX checkpoint layout: flattened flax variables
# ---------------------------------------------------------------------------

_LEAVES_FROM_FLAX = {("params", "scale"): "weight", ("params", "bias"): "bias",
                     ("batch_stats", "mean"): "running_mean",
                     ("batch_stats", "var"): "running_var"}
_LEAVES_TO_FLAX = {v: k for k, v in _LEAVES_FROM_FLAX.items()}


def _module_from_flax(path: str) -> str:
    """``layer1_0.downsample_1`` -> ``layer1.0.downsample.1``."""
    parts = []
    for p in path.split("."):
        head, sep, tail = p.rpartition("_")
        parts += [head, tail] if sep and tail.isdigit() else [p]
    return ".".join(parts)


def _module_to_flax(name: str) -> str:
    """``layer1.0.downsample.1`` -> ``layer1_0.downsample_1``."""
    out = []
    for p in name.split("."):
        if p.isdigit():
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return ".".join(out)


def resnet_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"params.layer1_0.conv1.kernel": HWIO, ..., "batch_stats.bn1.var":
    ...}`` (the JAX refine CLI's safetensors keys) -> this module's
    ``state_dict`` (without ``num_batches_tracked``).

    Conv ``kernel`` HWIO -> ``weight`` OIHW; dense ``kernel`` (in, out) ->
    ``weight`` (out, in); ``scale``/``bias``/``mean``/``var`` -> ``weight``/
    ``bias``/``running_mean``/``running_var``. Any other name raises.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        col, _, path = key.partition(".")
        parent, _, leaf = path.rpartition(".")
        module = _module_from_flax(parent)
        v = torch.tensor(np.asarray(value, np.float32))  # a copy: the reader's may be read-only
        if col == "params" and leaf == "kernel":
            out[f"{module}.weight"] = (v.permute(3, 2, 0, 1) if v.ndim == 4 else v.t()).contiguous()
        elif (col, leaf) in _LEAVES_FROM_FLAX:
            out[f"{module}.{_LEAVES_FROM_FLAX[col, leaf]}"] = v
        else:
            raise ValueError(f"unexpected ResNet-50 checkpoint key {key}")
    return out


def resnet_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """This module's ``state_dict`` -> the JAX checkpoint's flat arrays, in
    the tensors' dtype (f32 for a model as built; the inverse of
    :func:`resnet_from_flax`; ``num_batches_tracked`` is dropped)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        v = t.detach().cpu().numpy()
        path = _module_to_flax(module)
        is_norm = module.split(".")[-1].startswith("bn") or module.endswith("downsample.1")
        if leaf == "weight" and not is_norm:
            out[f"params.{path}.kernel"] = np.ascontiguousarray(
                v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T)
        elif leaf == "bias" and not is_norm:
            out[f"params.{path}.bias"] = v
        elif leaf in _LEAVES_TO_FLAX:
            col, flax_leaf = _LEAVES_TO_FLAX[leaf]
            out[f"{col}.{path}.{flax_leaf}"] = v
        else:
            raise ValueError(f"unexpected ResNet-50 state_dict key {name}")
    return out
