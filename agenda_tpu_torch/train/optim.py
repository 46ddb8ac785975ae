"""Optimizers and learning-rate schedules of the SD fine-tune, in PyTorch.

Counterpart of ``agenda_tpu/train/optim.py``:

- ``lr_schedule``: diffusers ``get_scheduler`` semantics for all six names
  (``optim.py:27-85``), computed in f32 on the step's device.
- ``quantize`` / ``dequantize`` and ``_Quantized``: the blockwise int8 log
  code of the 8-bit moments (``optim.py:88-141``): per 256-element row of a
  leaf's flat order, a sign and a 7-bit log magnitude below the row absmax.
- ``ScaleByAdam8bitState``: (count, mu, nu); leaves of fewer than 4096
  elements keep f32 moments (``optim.py:144-199``).
- ``make_fused_adamw_8bit``: the one-pass int8 AdamW (``optim.py:218-301``):
  the global norm and clip scale are computed on the device, lr from the
  count before its increment, c1 and c2 from count + 1; all quantized
  leaves go through ``kernels.fused_adamw.FusedLeaves`` together (one launch
  of the CUDA kernel a step on the card), the small leaves through the same
  math in plain torch.
- ``make_adamw``: f32 AdamW with optax ``clip_by_global_norm`` + ``adamw``
  semantics, the default of ``scripts/finetune_sd.sh``.
- ``multi_steps``: gradient accumulation, optax ``MultiSteps``
  (``optim.py:415-416``) around either optimizer.
- ``make_optimizer``: the dispatch (``optim.py:381-416``); ``use_8bit_adam``
  selects the fused kernel optimizer.

Parameters, gradients and states are dicts keyed by parameter name. Every
optimizer is an ``Optimizer(init, apply)``: ``apply(grads, state, params)``
updates the parameter tensors and the state IN PLACE (the JAX versions
return new trees) and returns (params, state, grad_norm), plus the new EMA
shadow when the fused optimizer is given ``ema=``. The step count lives in
a device int32 tensor, so no step waits on the host.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from agenda_tpu_torch.kernels.fused_adamw import BLOCK, SPAN, FusedLeaves

Tensors = Dict[str, torch.Tensor]
MIN_QUANTIZE_SIZE = 4096


def _steps(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def lr_schedule(name: str, learning_rate: float, num_warmup_steps: int,
                num_training_steps: int, num_cycles: int = 1,
                power: float = 1.0) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """diffusers get_scheduler semantics: step (int or tensor) -> f32 lr tensor."""
    w, t, lr = num_warmup_steps, num_training_steps, learning_rate

    def clip01(x):
        return torch.clamp(x, 0.0, 1.0)

    if name == "constant":
        return lambda step: torch.full_like(_steps(step), lr)
    if name == "constant_with_warmup":
        return lambda step: lr * torch.clamp(_steps(step) / max(1, w), max=1.0)
    if name == "linear":
        def linear(step):
            s = _steps(step)
            return lr * clip01(torch.where(s < w, s / max(1, w), (t - s) / max(1, t - w)))
        return linear
    if name == "cosine":
        def cosine(step):
            s = _steps(step)
            warm = clip01(s / max(1, w))
            prog = clip01((s - w) / max(1, t - w))
            cos = 0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * 0.5 * prog))
            return lr * torch.where(s < w, warm, torch.clamp(cos, min=0.0))
        return cosine
    if name == "cosine_with_restarts":
        def restarts(step):
            s = _steps(step)
            warm = clip01(s / max(1, w))
            prog = clip01((s - w) / max(1, t - w))
            cos = 0.5 * (1.0 + torch.cos(math.pi * torch.remainder(num_cycles * prog, 1.0)))
            val = torch.where(prog >= 1.0, torch.zeros_like(cos), torch.clamp(cos, min=0.0))
            return lr * torch.where(s < w, warm, val)
        return restarts
    if name == "polynomial":
        lr_end = 1e-7

        def polynomial(step):
            s = _steps(step)
            warm = clip01(s / max(1, w))
            prog = clip01((s - w) / max(1, t - w))
            poly = (lr - lr_end) * (1.0 - prog) ** power + lr_end
            return torch.where(s < w, lr * warm, poly)
        return polynomial
    raise ValueError(f"Unknown lr_scheduler {name}")


class _Quantized(NamedTuple):
    q: torch.Tensor  # int8 codes in the leaf's shape
    scale: torch.Tensor  # f32 absmax of each 256-element row, (ceil(n / 256),)


class ScaleByAdam8bitState(NamedTuple):
    count: torch.Tensor  # () int32, on the parameters' device
    mu: Dict[str, Union[_Quantized, torch.Tensor]]
    nu: Dict[str, Union[_Quantized, torch.Tensor]]


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Tensors
    nu: Tensors


class Optimizer(NamedTuple):
    init: Callable
    apply: Callable  # (grads, state, params, ...) -> (params, state, grad_norm[, ema])
    fused: bool = False


def _blocks(x: torch.Tensor):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK), n


def quantize(x: torch.Tensor) -> _Quantized:
    """Blockwise int8: code 0 is 0 (and anything below absmax * 10^-SPAN);
    |code| in 1..127 stands for absmax * 10^(SPAN (|code| - 127) / 126)."""
    fp, n = _blocks(x.float())
    absmax = fp.abs().amax(dim=1, keepdim=True)
    safe = torch.clamp(absmax, min=1e-30)
    ratio = fp.abs() / safe
    mag = torch.round(127.0 + 126.0 * torch.log10(torch.clamp(ratio, min=1e-30)) / SPAN)
    mag = torch.clamp(mag, 0.0, 127.0)
    q = (torch.sign(fp) * mag).to(torch.int8)
    return _Quantized(q=q.reshape(-1)[:n].reshape(x.shape), scale=absmax[:, 0].float())


def dequantize(z: _Quantized) -> torch.Tensor:
    fp, n = _blocks(z.q.float())
    mag = fp.abs()
    val = torch.where(mag > 0.0, torch.sign(fp) * torch.pow(10.0, SPAN * (mag - 127.0) / 126.0),
                      torch.zeros((), device=fp.device)) * z.scale[:, None]
    return val.reshape(-1)[:n].reshape(z.q.shape)


def _zero_moment(p: torch.Tensor, min_quantize_size: int, size: int):
    if size >= min_quantize_size:
        nb = (p.numel() + BLOCK - 1) // BLOCK
        return _Quantized(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                          torch.zeros(nb, dtype=torch.float32, device=p.device))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _init_8bit(min_quantize_size: int):
    def init(params: Tensors, sizes: Optional[Dict[str, int]] = None) -> ScaleByAdam8bitState:
        """``sizes``: the whole leaves' element counts where ``params`` holds
        runs of them (``parallel/blocks.py``): the int8-or-f32 choice is the
        whole leaf's."""
        device = next(iter(params.values())).device
        size = {k: (sizes or {}).get(k, p.numel()) for k, p in params.items()}
        return ScaleByAdam8bitState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: _zero_moment(p, min_quantize_size, size[k]) for k, p in params.items()},
            nu={k: _zero_moment(p, min_quantize_size, size[k]) for k, p in params.items()},
        )
    return init


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt(sum of squares of every gradient), f32 on the gradients' device."""
    return torch.nn.utils.get_total_norm([g.float() for g in grads.values()])


def _clip_scale(gnorm: torch.Tensor, max_grad_norm: Optional[float]) -> torch.Tensor:
    """1 if ||g|| < max_norm else max_norm / ||g|| (optax clip), f32."""
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if max_grad_norm is None:
        return one
    return torch.where(gnorm < max_grad_norm, one, max_grad_norm / gnorm).float()


def make_fused_adamw_8bit(learning_rate_fn, b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, weight_decay: float = 1e-2,
                          max_grad_norm: Optional[float] = 1.0,
                          min_quantize_size: int = MIN_QUANTIZE_SIZE) -> Optimizer:
    """Fused clip + int8 AdamW + apply, one kernel launch a step for all
    quantized leaves.

    lr = learning_rate_fn(count) before the increment; c1, c2 = 1 - b^(count+1);
    p' = p - lr (adam_update + weight_decay p). The leaves' checked pointers
    are kept while the parameter, moment and EMA tensors stay the same
    objects; a step checks and packs only its gradients. ``norm`` computes
    the clip's global norm from ``grads`` (a sharded run's is
    ``BlockRuns.global_norm``).
    """
    cached = []  # the last step's FusedLeaves

    @torch.no_grad()
    def apply(grads: Tensors, state: ScaleByAdam8bitState, params: Tensors,
              ema: Optional[Tensors] = None, ema_decay: Optional[torch.Tensor] = None,
              norm: Callable[[Tensors], torch.Tensor] = global_norm):
        gnorm = norm(grads)
        gscale = _clip_scale(gnorm, max_grad_norm)
        count1 = state.count + 1
        cf = count1.float()
        lr = learning_rate_fn(state.count).float()
        c1 = 1.0 - torch.pow(b1, cf)
        c2 = 1.0 - torch.pow(b2, cf)
        with_ema = ema is not None
        terms = [lr, gscale, c1, c2] + ([ema_decay.float()] if with_ema else [])
        scalars = torch.stack(terms).to(gnorm.device)
        small, big = [], []
        for name in params:
            (big if isinstance(state.mu[name], _Quantized) else small).append(name)
        if big:
            statics = [(params[k], state.mu[k].q, state.mu[k].scale, state.nu[k].q,
                        state.nu[k].scale) for k in big]
            emas = [ema[k] for k in big] if with_ema else None
            if not (cached and cached[0].matches(statics, emas)):
                cached[:] = [FusedLeaves(statics, emas)]
            cached[0]([grads[k].float().contiguous() for k in big], scalars, b1=b1, b2=b2,
                      eps=eps, weight_decay=weight_decay)
        if small:  # the same math in plain torch, on all small leaves at once
            ps = [params[k] for k in small]
            g = torch._foreach_mul([grads[k].float() for k in small], gscale)
            m = [state.mu[k] for k in small]
            v = [state.nu[k] for k in small]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
            g2 = torch._foreach_mul(g, 1.0 - b2)
            torch._foreach_mul_(g2, g)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, g2)
            u = torch._foreach_div(m, c1)
            den = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            step = torch._foreach_mul(ps, weight_decay)
            torch._foreach_add_(step, u)
            torch._foreach_mul_(step, lr)
            torch._foreach_sub_(ps, step)
            if with_ema:
                es = [ema[k] for k in small]
                torch._foreach_mul_(es, scalars[4])
                torch._foreach_add_(es, torch._foreach_mul(ps, 1.0 - scalars[4]))
        state.count.copy_(count1)
        if with_ema:
            return params, state, gnorm, ema
        return params, state, gnorm

    return Optimizer(init=_init_8bit(min_quantize_size), apply=apply, fused=True)


def make_adamw(learning_rate_fn, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-2, max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    """f32 AdamW with optax ``chain(clip_by_global_norm, adamw)`` semantics:
    g' = g if ||g|| < max_norm else (g / ||g||) max_norm; mu, nu EMAs of g' and
    g'^2; u = mu_hat / (sqrt(nu_hat) + eps) + wd p; p += -lr(count) u."""

    def init(params: Tensors, sizes: Optional[Dict[str, int]] = None) -> AdamState:
        device = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                         for k, p in params.items()}
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=zeros(), nu=zeros())

    @torch.no_grad()
    def apply(grads: Tensors, state: AdamState, params: Tensors,
              norm: Callable[[Tensors], torch.Tensor] = global_norm):
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k].float() for k in names]
        gnorm = norm(grads)
        if max_grad_norm is not None:
            clipped = torch._foreach_mul(torch._foreach_div(gs, gnorm), max_grad_norm)
            keep = gnorm < max_grad_norm
            gs = [torch.where(keep, g, c) for g, c in zip(gs, clipped)]
        count1 = state.count + 1
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
        u = torch._foreach_div(mu, 1 - torch.pow(b1, count1.float()))
        den = torch._foreach_div(nu, 1 - torch.pow(b2, count1.float()))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, torch._foreach_mul(ps, weight_decay))
        torch._foreach_mul_(u, -1 * learning_rate_fn(state.count).float())
        torch._foreach_add_(ps, u)
        state.count.copy_(count1)
        return params, state, gnorm

    return Optimizer(init=init, apply=apply)


def make_adam(lr: float) -> Optimizer:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, no decay, no clip (the
    refine classifier's and VAE pretraining's optimizer)."""
    return make_adamw(lr_schedule("constant", lr, 0, 0), weight_decay=0.0, max_grad_norm=None)


class MultiStepsState:
    """The accumulation state: the inner optimizer's state, the running mean
    of this update's micro-batch gradients (f32, by name) and how many
    micro-batches it holds (a host int: the loop counts them anyway)."""

    def __init__(self, inner: Any, acc: Tensors, mini_step: int = 0):
        self.inner = inner
        self.acc = acc
        self.mini_step = mini_step

    @property
    def count(self) -> torch.Tensor:
        """The inner optimizer's count: updates, not micro-batches."""
        return self.inner.count


def multi_steps(inner: Optimizer, every_k: int) -> Optimizer:
    """Gradient accumulation with optax ``MultiSteps`` semantics
    (``use_grad_mean``): each micro-batch folds its gradient into the running
    mean acc + (g - acc) / (n + 1); the k-th runs ``inner`` once on the mean
    (its clipping sees the mean, as ``MultiSteps(chain(clip, adam))`` does)
    and zeroes it. Only that call moves the parameters, the EMA shadow and
    the inner count (so the lr schedule and the bias corrections advance
    once an update). ``apply`` returns the micro-batch gradient's global
    norm, as the JAX trainer reports it."""

    def init(params: Tensors, sizes: Optional[Dict[str, int]] = None) -> MultiStepsState:
        return MultiStepsState(inner.init(params, sizes), {
            k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})

    @torch.no_grad()
    def apply(grads: Tensors, state: MultiStepsState, params: Tensors, **kw):
        gnorm = kw.get("norm", global_norm)(grads)
        accs = [state.acc[k] for k in params]
        gs = [grads[k].float() for k in params]
        n = state.mini_step
        if n == 0:
            torch._foreach_copy_(accs, gs)  # 0 + (g - 0) / 1, exactly
        else:
            d = torch._foreach_sub(gs, accs)
            torch._foreach_div_(d, float(n + 1))
            torch._foreach_add_(accs, d)
        if n + 1 < every_k:
            state.mini_step = n + 1
            return (params, state, gnorm) + ((kw["ema"],) if kw.get("ema") is not None else ())
        out = inner.apply(state.acc, state.inner, params, **kw)
        torch._foreach_zero_(accs)
        state.mini_step = 0
        return (out[0], state, gnorm) + tuple(out[3:])

    return Optimizer(init=init, apply=apply, fused=inner.fused)


def updated(opt_state) -> bool:
    """Whether the last ``apply`` on this state ran the update (always true
    without accumulation)."""
    return getattr(opt_state, "mini_step", 0) == 0


def make_optimizer(learning_rate_fn, adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                   adam_weight_decay: float = 1e-2, adam_epsilon: float = 1e-8,
                   max_grad_norm: Optional[float] = 1.0, gradient_accumulation_steps: int = 1,
                   use_8bit_adam: bool = False) -> Optimizer:
    """AdamW with global-norm clipping, optionally with int8 moments, and
    gradient accumulation over ``gradient_accumulation_steps`` micro-batches.

    ``use_8bit_adam`` gives the one-pass kernel optimizer (its ``fused`` is
    True, which the train step reads); otherwise f32 AdamW. Under
    accumulation the JAX package switches to its unfused int8 chain
    (``agenda_tpu/train/optim.py:384-385``); the port keeps the kernel and
    runs it once an update on the averaged gradient (``multi_steps``).
    """
    if gradient_accumulation_steps < 1:
        raise ValueError(f"gradient_accumulation_steps must be >= 1, got "
                         f"{gradient_accumulation_steps}")
    if use_8bit_adam:
        tx = make_fused_adamw_8bit(learning_rate_fn, adam_beta1, adam_beta2, adam_epsilon,
                                   adam_weight_decay, max_grad_norm)
    else:
        tx = make_adamw(learning_rate_fn, adam_beta1, adam_beta2, adam_epsilon,
                        adam_weight_decay, max_grad_norm)
    if gradient_accumulation_steps > 1:
        tx = multi_steps(tx, gradient_accumulation_steps)
    return tx
