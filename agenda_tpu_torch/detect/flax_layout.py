"""The JAX checkpoint layout of the detectors, and flax's default init.

A JAX ``det_train`` checkpoint is one safetensors file of flattened flax
variables: ``params.<path>.kernel`` (convolutions HWIO, dense layers
(in, out)), ``params.<path>.scale``/``bias`` (batch and layer norms),
``batch_stats.<path>.mean``/``var`` and a model's own parameters
(``pos_embed``, ``rel_pos_h``, ``rel_pos_w``). The port's modules carry
the same paths as their ``state_dict`` names, so one pair of functions
converts every family: a convolution's ``kernel`` becomes ``weight`` OIHW,
a dense one's ``weight`` (out, in), ``scale`` becomes ``weight``, the
statistics ``running_mean``/``running_var`` (with torch's
``num_batches_tracked`` counter, which nothing reads), and the named
parameters stay as they are. ``module`` maps a flax module path to the
port's where they differ (Faster R-CNN's torchvision-named ResNet-50).
``FamilyVariables`` is what every family's variables share.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

OWN_PARAMS = ("pos_embed", "rel_pos_h", "rel_pos_w")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _same(path: str) -> str:
    return path


def flax_to_state_dict(flat: Dict[str, np.ndarray],
                       module: Callable[[str], str] = _same) -> Dict[str, torch.Tensor]:
    """``{"params.<path>.kernel": HWIO, ..., "batch_stats.<path>.mean": ...}``
    -> the port's ``state_dict``. Any other name raises."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        col, _, path = key.partition(".")
        parent, _, leaf = path.rpartition(".")
        v = torch.tensor(np.asarray(value, np.float32))  # a copy: the reader's may be read-only
        if col == "params" and leaf in OWN_PARAMS:
            out[f"{module(parent)}.{leaf}" if parent else leaf] = v
            continue
        name = module(parent)
        if col == "params" and leaf == "kernel" and v.ndim in (2, 4):
            out[f"{name}.weight"] = (v.permute(3, 2, 0, 1) if v.ndim == 4 else v.t()).contiguous()
        elif col == "params" and leaf == "scale":
            out[f"{name}.weight"] = v
        elif col == "params" and leaf == "bias":
            out[f"{name}.bias"] = v
        elif col == "batch_stats" and leaf in _STATS:
            out[f"{name}.{_STATS[leaf]}"] = v
            out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            raise KeyError(f"no state_dict name for the checkpoint key {key!r}")
    return out


def state_dict_to_flax(state: Dict[str, torch.Tensor],
                       module: Callable[[str], str] = _same) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_state_dict``, in f32 (``num_batches_tracked``
    has no flax counterpart and is not written)."""
    out: Dict[str, np.ndarray] = {}
    stats = {v: k for k, v in _STATS.items()}
    for key, value in state.items():
        parent, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        v = value.detach().to("cpu", torch.float32).numpy()
        if leaf in OWN_PARAMS:
            out[f"params.{module(parent)}.{leaf}" if parent else f"params.{leaf}"] = v
            continue
        name = module(parent)
        if leaf == "weight" and v.ndim in (2, 4):
            out[f"params.{name}.kernel"] = np.ascontiguousarray(
                v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T)
        elif leaf == "weight" and v.ndim == 1:
            out[f"params.{name}.scale"] = v
        elif leaf == "bias":
            out[f"params.{name}.bias"] = v
        elif leaf in stats:
            out[f"batch_stats.{name}.{stats[leaf]}"] = v
        else:
            raise KeyError(f"no checkpoint name for the state_dict key {key!r}")
    return out


class FamilyVariables:
    """A family's variables are its model's ``state_dict``: the parameters
    (``param_names``), the batch-norm statistics (``stat_names``, flax's
    ``batch_stats``) and torch's ``num_batches_tracked`` counters, which
    nothing reads; ``from_flax``/``to_flax`` map the JAX checkpoint layout."""

    model: nn.Module

    def _name_variables(self) -> None:
        self.param_names: List[str] = [n for n, _ in self.model.named_parameters()]
        self.stat_names: List[str] = [n for n, _ in self.model.named_buffers()
                                      if n.endswith(("running_mean", "running_var"))]

    def check_variables(self, variables: Dict[str, torch.Tensor]) -> None:
        """Raise unless ``variables`` has exactly this model's names and shapes."""
        own = self.model.state_dict()
        missing = sorted(set(own) - set(variables))
        extra = sorted(set(variables) - set(own))
        if missing or extra:
            raise KeyError(f"variables do not fit {type(self.model).__name__} ({self.config}): "
                           f"missing {missing[:5]}, unexpected {extra[:5]}")
        for k, v in own.items():
            if tuple(variables[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: shape {tuple(variables[k].shape)}, "
                                 f"the model has {tuple(v.shape)}")

    def from_flax(self, flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return flax_to_state_dict(flat)

    def to_flax(self, state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return state_dict_to_flax(state)


def lecun_init_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default init, drawn from ``generator`` (CPU): convolution and
    dense kernels lecun normal (truncated at 2 sigma, fan in), biases 0;
    batch and layer norms scale 1, bias 0, statistics 0 and 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(mod.weight.shape[1:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.mul_(std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
