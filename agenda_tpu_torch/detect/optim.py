"""The detector trainer's optimizers and schedules, on tensors.

Counterpart of ``agenda_tpu/detect/runner.py:121-285``:

- ``make_lr_fn``: linear warmup over ``warmup_iters`` from 0.001 x lr, then
  x0.1 at each milestone (fractions of the run);
- ``make_yolo_schedules``: mmyolo's YOLOv5ParamSchedulerHook: a per-epoch
  linear decay to ``lr x lr_factor``, and over the warmup
  (``max(warmup_epochs x steps_per_epoch, warmup_mim_iter)`` steps) the
  weights' lr from 0, the biases' from ``warmup_bias_lr``, the momentum
  from ``warmup_momentum``;
- ``scaled_weight_decay``: YOLOv5OptimizerConstructor's wd x total_bs x
  accumulate / 64;
- ``decay_mask``, ``bias_mask``, ``not_bias_mask`` over the port's
  parameter names: conv weights decay; batch-norm scales and every bias do
  not; the biases form the second lr group;
- ``DetectorSGD``: the optax chains the JAX runner builds. The yolo one is
  ``add_decayed_weights(wd, decay_mask)`` then ``sgd(nesterov, momentum_fn)``
  masked once with ``lr_main`` on the non-biases and once with ``lr_bias``
  on the biases; the plain one is ``clip_by_global_norm`` (when set), then
  ``add_decayed_weights(wd)`` on every leaf, then ``sgd(lr_fn, momentum)``.
  Each schedule is read at the update's count before it is incremented, and
  the trace is ``g + momentum x trace`` with no dampening (nesterov:
  ``g + momentum x trace`` once more). AdamW and layer decay serve ViTDet
  and raise.

The schedules are evaluated on the host in float32 with the reference's
operation order, so the lr and momentum of a step are the reference's f32
values; the update multiplies and adds separately, as the optax chain does.
``trace_from_flax`` carries a JAX optax state's trace leaves into
``DetectorSGD``'s momentum buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from agenda_tpu_torch.detect.yolov8 import flax_to_state_dict

Tensors = Dict[str, torch.Tensor]
f32 = np.float32


def make_lr_fn(cfg, steps_per_epoch: int, base_lr: Optional[float] = None
               ) -> Callable[[int], float]:
    lr = cfg.lr if base_lr is None else base_lr
    total = cfg.max_epochs * steps_per_epoch
    milestones = [int(m * total) for m in cfg.lr_milestones]

    def fn(step: int) -> float:
        s = f32(step)
        warm = np.clip(s / f32(max(1, cfg.warmup_iters)), f32(0), f32(1))
        base = f32(lr) * (f32(0.001) + f32(1 - 0.001) * warm)
        decay = f32(1)
        for m in milestones:
            decay = decay * (f32(0.1) if s >= m else f32(1))
        return float(base * decay)

    return fn


def make_yolo_schedules(cfg, steps_per_epoch: int, base_lr: Optional[float] = None):
    """-> (lr_main, lr_bias, momentum_fn), each a function of the step."""
    base_lr = cfg.lr if base_lr is None else base_lr
    warm_total = max(round(cfg.warmup_epochs * steps_per_epoch), cfg.warmup_mim_iter)

    def epoch_lr(step: int):
        e = f32(min(step // steps_per_epoch, cfg.max_epochs))
        factor = ((f32(1) - e / f32(cfg.max_epochs)) * f32(1.0 - cfg.lr_factor)
                  + f32(cfg.lr_factor))
        return f32(base_lr) * factor

    def w(step: int):
        return np.clip(f32(step) / f32(warm_total), f32(0), f32(1))

    def lr_main(step: int) -> float:
        return float(w(step) * epoch_lr(step))

    def lr_bias(step: int) -> float:
        return float(f32(cfg.warmup_bias_lr)
                     + w(step) * (epoch_lr(step) - f32(cfg.warmup_bias_lr)))

    def momentum_fn(step: int) -> float:
        return float(f32(cfg.warmup_momentum)
                     + w(step) * f32(cfg.momentum - cfg.warmup_momentum))

    return lr_main, lr_bias, momentum_fn


def scaled_weight_decay(cfg, total_bs: int) -> float:
    """YOLOv5OptimizerConstructor: wd x total_bs x accumulate / 64, where
    accumulate = max(round(64 / total_bs), 1)."""
    accumulate = max(round(cfg.base_total_batch_size / max(1, total_bs)), 1)
    return cfg.weight_decay * total_bs * accumulate / cfg.base_total_batch_size


def decay_mask(params: Tensors) -> Dict[str, bool]:
    """mmyolo's groups: decay only the conv weights (flax's "kernel" leaves)."""
    return {k: k.endswith(".weight") and p.ndim == 4 for k, p in params.items()}


def bias_mask(params: Tensors) -> Dict[str, bool]:
    return {k: k.endswith(".bias") for k in params}


def not_bias_mask(params: Tensors) -> Dict[str, bool]:
    return {k: not b for k, b in bias_mask(params).items()}


@dataclasses.dataclass
class SGDState:
    count: int  # updates so far: the schedules' step
    trace: Tensors  # momentum buffer of every parameter


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class DetectorSGD:
    """The runner's SGD: the yolo chain or the plain one (see the module
    docstring), updating parameter tensors in place."""

    def __init__(self, cfg, steps_per_epoch: int, total_bs: Optional[int] = None,
                 base_lr: Optional[float] = None):
        if cfg.optimizer != "sgd" or cfg.layer_decay_rate:
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r} with layer decay {cfg.layer_decay_rate} serves "
                "ViTDet and is not ported yet: ROADMAP.md §A, the item 'Faster R-CNN, YOLOv5, "
                "ViTDet and io/torch_import.py'")
        self.clip = cfg.clip_grad_norm
        self.nesterov = cfg.nesterov
        self.yolo = cfg.yolo_optimizer
        if self.yolo:
            lr_main, lr_bias, momentum_fn = make_yolo_schedules(cfg, steps_per_epoch, base_lr)
            self.weight_decay = scaled_weight_decay(cfg, total_bs or cfg.batch_size)
            self.lr_fn = lr_main
            self._groups = lambda step: (momentum_fn(step), lr_main(step), lr_bias(step))
        else:
            self.weight_decay = cfg.weight_decay
            self.lr_fn = make_lr_fn(cfg, steps_per_epoch, base_lr)
            self._groups = lambda step: (cfg.momentum, self.lr_fn(step), self.lr_fn(step))

    def init(self, params: Tensors) -> SGDState:
        return SGDState(0, {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: SGDState, params: Tensors) -> None:
        """One step: ``params`` and ``state`` change in place."""
        names = list(params)
        g = dict(zip(names, self._clipped([grads[k] for k in names])))
        if self.weight_decay:
            decay = decay_mask(params) if self.yolo else dict.fromkeys(names, True)
            wd = [k for k in names if decay[k]]
            decayed = torch._foreach_add([g[k] for k in wd], torch._foreach_mul(
                [params[k] for k in wd], self.weight_decay))
            g.update(zip(wd, decayed))
        momentum, lr_main, lr_bias = self._groups(state.count)
        for mask, lr in ((not_bias_mask(params), lr_main), (bias_mask(params), lr_bias)):
            group = [k for k in names if mask[k]]
            gs = [g[k] for k in group]
            traces = [state.trace[k] for k in group]
            torch._foreach_mul_(traces, momentum)
            torch._foreach_add_(traces, gs)  # g + momentum x trace
            upd = (torch._foreach_add(gs, torch._foreach_mul(traces, momentum))
                   if self.nesterov else traces)
            torch._foreach_add_([params[k] for k in group], torch._foreach_mul(upd, -lr))
        state.count += 1

    def _clipped(self, g: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax's clip_by_global_norm: t / norm x clip when norm >= clip."""
        if not self.clip:
            return g
        norm = global_norm(g)
        keep = norm < self.clip
        return [torch.where(keep, t, t / norm * self.clip) for t in g]


def trace_from_flax(flat: Dict[str, np.ndarray]) -> Tensors:
    """Momentum buffers keyed by the port's parameter names from a JAX optax
    trace, flattened as its params are (``"params.<path>.kernel"`` ...):
    kernel leaves go HWIO -> OIHW, as the weights do."""
    out = flax_to_state_dict(flat)
    return {k: v for k, v in out.items() if not k.endswith("num_batches_tracked")}
