"""The detector trainer's optimizers and schedules, on tensors.

Counterpart of ``agenda_tpu/detect/runner.py:121-285``; ``make_optimizer``
picks the runner's:

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
  ``g + momentum x trace`` once more);
- ``DetectorAdamW``: the JAX runner's AdamW chain in its order:
  ``clip_by_global_norm`` (when set), ``optax.adamw(lr_fn, b1 0.9, b2
  0.999, eps 1e-8, weight_decay)`` (with layer decay, the decay only on
  parameters of more than one dimension, ``no_decay_mask``), then
  ``scale_by_layer_decay``: each update times ``layer_decay_scale`` of its
  parameter, ``rate ** (L + 1 - layer_id)`` with layer 0 the patch and
  position embeddings, ``i + 1`` backbone block i, ``L + 1`` the rest of the
  backbone, and 1 outside it. The port's parameter names carry the flax
  paths (``backbone.block_3.qkv.weight``), so the layer ids are the same.

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

from agenda_tpu_torch.detect.flax_layout import flax_to_state_dict

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


def clip_by_global_norm(g: List[torch.Tensor], clip: Optional[float]) -> List[torch.Tensor]:
    """optax's clip_by_global_norm: t / norm x clip when norm >= clip."""
    if not clip:
        return g
    norm = global_norm(g)
    keep = norm < clip
    return [torch.where(keep, t, t / norm * clip) for t in g]


class DetectorSGD:
    """The runner's SGD: the yolo chain or the plain one (see the module
    docstring), updating parameter tensors in place."""

    def __init__(self, cfg, steps_per_epoch: int, total_bs: Optional[int] = None,
                 base_lr: Optional[float] = None):
        if cfg.optimizer != "sgd":
            raise ValueError(f"DetectorSGD for optimizer {cfg.optimizer!r}")
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
        g = dict(zip(names, clip_by_global_norm([grads[k] for k in names], self.clip)))
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

    def buffers(self, state: SGDState) -> Dict[str, Tensors]:
        """The state's tensors by kind, as the runner's sidecar keeps them."""
        return {"momentum": state.trace}


def layer_decay_scale(name: str, rate: float, num_layers: int) -> float:
    """The lr multiplier of parameter ``name`` (mmdet's
    LayerDecayOptimizerConstructor, detectron2's ``get_vit_lr_decay_rate``)."""
    names = name.split(".")
    if names[0] != "backbone":
        return 1.0
    sub = names[1] if len(names) > 1 else ""
    if sub in ("patch_embed", "pos_embed"):
        layer_id = 0
    elif sub.startswith("block_"):
        layer_id = int(sub.split("_")[1]) + 1
    else:
        layer_id = num_layers + 1
    return rate ** (num_layers + 1 - layer_id)


def no_decay_mask(params: Tensors) -> Dict[str, bool]:
    """The constructor's decay group: parameters of more than one dimension."""
    return {k: p.ndim > 1 for k, p in params.items()}


@dataclasses.dataclass
class AdamWState:
    count: int  # updates so far
    mu: Tensors
    nu: Tensors


class DetectorAdamW:
    """The runner's AdamW (see the module docstring), updating parameter
    tensors in place. Each step's lr is ``lr_fn`` at the update's count
    before its increment; the bias corrections ``1 - b ** (count + 1)`` are
    computed in f32 on the host, as optax's are."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg, steps_per_epoch: int, total_bs: Optional[int] = None,
                 base_lr: Optional[float] = None):
        if cfg.optimizer != "adamw":
            raise ValueError(f"DetectorAdamW for optimizer {cfg.optimizer!r}")
        self.clip = cfg.clip_grad_norm
        self.weight_decay = cfg.weight_decay
        self.layer_decay = cfg.layer_decay_rate
        self.num_layers = cfg.layer_decay_layers
        self.lr_fn = make_lr_fn(cfg, steps_per_epoch, base_lr)

    def init(self, params: Tensors) -> AdamWState:
        return AdamWState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                          {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors) -> None:
        names = list(params)
        g = clip_by_global_norm([grads[k] for k in names], self.clip)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        # (1 - b) g + b t, in optax's order
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.B1))
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.B2))
        count = f32(state.count + 1)
        bc1 = float(f32(1) - f32(self.B1) ** count)
        bc2 = float(f32(1) - f32(self.B2) ** count)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.EPS))
        decay = no_decay_mask(params) if self.layer_decay else dict.fromkeys(names, True)
        if self.weight_decay:
            upd = [u + self.weight_decay * params[k] if decay[k] else u
                   for k, u in zip(names, upd)]
        lr = -self.lr_fn(state.count)
        for k, u in zip(names, upd):
            u = u * lr
            if self.layer_decay:
                u = u * layer_decay_scale(k, self.layer_decay, self.num_layers)
            params[k].add_(u)
        state.count += 1

    def buffers(self, state: AdamWState) -> Dict[str, Tensors]:
        return {"mu": state.mu, "nu": state.nu}


def make_optimizer(cfg, steps_per_epoch: int, total_bs: Optional[int] = None,
                   base_lr: Optional[float] = None):
    """The runner's optimizer for ``cfg.optimizer`` (sgd or adamw)."""
    if cfg.optimizer == "sgd":
        return DetectorSGD(cfg, steps_per_epoch, total_bs, base_lr)
    if cfg.optimizer == "adamw":
        return DetectorAdamW(cfg, steps_per_epoch, total_bs, base_lr)
    raise ValueError(cfg.optimizer)


def trace_from_flax(flat: Dict[str, np.ndarray]) -> Tensors:
    """Momentum buffers keyed by the port's parameter names from a JAX optax
    trace, flattened as its params are (``"params.<path>.kernel"`` ...):
    kernel leaves go HWIO -> OIHW, as the weights do."""
    out = flax_to_state_dict(flat)
    return {k: v for k, v in out.items() if not k.endswith("num_batches_tracked")}
