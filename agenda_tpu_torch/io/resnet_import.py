"""torchvision ResNet-50 checkpoints for the refine classifier.

The reference initializes the label refiner's classifier from torchvision's
ImageNet resnet50 (``data_annotation/refine_label.py:326``). Without network
access the user supplies the ``.pth`` or ``.safetensors`` file. Its keys are
already ``models/resnet.py``'s; the fc head is skipped when its width
differs from ``num_classes`` (the refiner replaces it with a 1-logit head),
as ``agenda_tpu/io/resnet_import.py`` skips it.
"""

from __future__ import annotations

from typing import Dict

import torch

from agenda_tpu_torch.io.safetensors_io import load_file


def read_torchvision_resnet50(path: str, num_classes: int = 1) -> Dict[str, torch.Tensor]:
    """Read a torchvision resnet50 state dict (f32 CPU tensors), without
    ``num_batches_tracked`` and without ``fc`` when its width is not
    ``num_classes``."""
    if path.endswith(".safetensors"):
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("fc.") and v.shape[0] != num_classes:
            continue
        out[key] = v.float()
    return out


def load_torchvision_resnet50(model: torch.nn.Module, path: str, num_classes: int = 1) -> None:
    """Load the file's weights into ``model`` in place. Every key of the file
    must be the model's; the model keeps its own ``fc`` when the file's was
    skipped."""
    sd = read_torchvision_resnet50(path, num_classes)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and not k.startswith("fc.")]
    if missing or unexpected:
        raise ValueError(f"{path} is not a torchvision resnet50: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
