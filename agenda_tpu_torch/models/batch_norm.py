"""flax's ``nn.BatchNorm`` in train mode, for the port's convolutional models.

torch's ``nn.BatchNorm2d`` moves ``running_var`` with the unbiased batch
variance; flax's moves it with the biased one. The port's YOLOv8 and
ResNet-50 keep ``nn.BatchNorm2d`` modules (torch's state-dict names, eval
mode reads the running statistics as flax does) and run this update in
train mode instead of torch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax ``nn.BatchNorm`` in train mode over NCHW ``x``: normalise with the
    batch mean and biased variance and ``bn.eps``, and move ``bn``'s running
    statistics to ``(1 - m) old + m batch`` with the biased variance, m =
    ``bn.momentum`` (torch's convention: flax's momentum 0.97 is 0.03 here,
    0.9 is 0.1). The statistics for the update are reduced in f32 at least,
    as flax reduces them (bf16 activations give f32 statistics)."""
    y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    m = bn.momentum
    with torch.no_grad():
        xs = x.detach().to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xs, dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
    return y


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is :func:`batch_norm_train`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_train(x, self) if self.training else super().forward(x)
