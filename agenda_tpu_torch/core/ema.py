"""Exponential moving average of the trained parameters.

Counterpart of ``agenda_tpu/core/ema.py:28-56`` (diffusers ``EMAModel``
semantics): decay_t = min(max_decay, (1 + t) / (10 + t)) with t the number
of updates so far plus one. The shadow is a dict of f32 tensors keyed by
parameter name, on the parameters' device, with the update counter as a
device int32 tensor so that the decay is computed without a host sync. The
update runs in place with ``torch._foreach`` ops; the fused int8 AdamW path
blends the shadow inside its kernel instead (``kernels/fused_adamw.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]  # f32 shadow, keyed by parameter name
    step: torch.Tensor  # () int32 update counter


def ema_init(params: Dict[str, torch.Tensor]) -> EMAState:
    """An f32 COPY of every parameter (never an alias: the update is in place)."""
    first = next(iter(params.values()))
    return EMAState(
        params={k: v.detach().to(torch.float32, copy=True) for k, v in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def ema_decay_at(step: torch.Tensor, max_decay: float = 0.9999) -> torch.Tensor:
    """min(max_decay, (1 + t) / (10 + t)) with t = step + 1, f32 on step's device."""
    t = step.float() + 1.0
    return torch.clamp((1.0 + t) / (10.0 + t), max=max_decay)


def ema_update(state: EMAState, params: Dict[str, torch.Tensor],
               max_decay: float = 0.9999) -> EMAState:
    """shadow = shadow * decay + (1 - decay) * params, in place; step += 1."""
    decay = ema_decay_at(state.step, max_decay)
    names = list(state.params)
    shadow = [state.params[k] for k in names]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, torch._foreach_mul([params[k].detach().float() for k in names],
                                                   1.0 - decay))
    state.step += 1
    return state
