"""Full-UNet SD fine-tuning: the train state, the diffusion loss and one step.

Counterpart of ``agenda_tpu/train/finetune_sd.py``:

  VAE latent moments (or encode) -> sample latents * scaling -> add noise at
  random timesteps -> CLIP context -> UNet prediction -> (min-SNR-weighted)
  MSE -> backward -> clip + AdamW (int8 fused kernel or f32) -> EMA.

The UNet keeps f32 master parameters. On the card the forward and backward
run under ``torch.autocast(bfloat16)``: convolutions and linears compute in
bf16, so the flash and GroupNorm kernels receive bf16 activations, while the
GroupNorm weights stay f32 parameters (the kernel reads them as f32). On the
CPU everything is f32. The frozen VAE and text encoder are separate modules
in the compute dtype (bf16 on the card), run without autograd.

Randomness: the step's draws (the latent eps, the noise, the timesteps, the
offset noise and the input perturbation, ``finetune_sd.py:81-87,155-157``)
come in a ``StepDraws``; without one the step makes its own from a
``torch.Generator``. That stream is the port's own, so the parity tests pass
in the draws of the JAX key stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agenda_tpu_torch.core.ema import EMAState, ema_decay_at, ema_init, ema_update
from agenda_tpu_torch.core.schedules import (
    DiffusionSchedule,
    add_noise,
    get_velocity,
    min_snr_weights,
)
from agenda_tpu_torch.data.device_resize import apply_resize
from agenda_tpu_torch.models.vae import sample_latents
from agenda_tpu_torch.train.optim import Optimizer, updated


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]  # the UNet's own f32 parameters, by name
    opt_state: Any
    step: int
    ema: Optional[EMAState]


def init_train_state(unet: nn.Module, tx: Optimizer, use_ema: bool) -> TrainState:
    """f32 master parameters (the UNet is cast to f32 in place) and fresh state."""
    unet.float()
    params = dict(unet.named_parameters())
    return TrainState(params=params, opt_state=tx.init(params), step=0,
                      ema=ema_init(params) if use_ema else None)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    prediction_type: Optional[str] = None  # overrides the schedule's


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step. Shapes: latents (B, h, w, C)."""

    latent_eps: torch.Tensor  # (B, h, w, C): the VAE sample's standard-normal draw
    noise: torch.Tensor  # (B, h, w, C)
    timesteps: torch.Tensor  # (B,) int64 in [0, num_train_timesteps)
    offset_noise: Optional[torch.Tensor] = None  # (B, 1, 1, C), with noise_offset
    perturbation: Optional[torch.Tensor] = None  # (B, h, w, C), with input_perturbation


def make_draws(generator: torch.Generator, shape, num_train_timesteps: int,
               cfg: LossConfig, device: torch.device) -> StepDraws:
    """One step's draws from the port's own generator (on ``device``)."""
    b, c = shape[0], shape[-1]

    def normal(s):
        return torch.randn(s, generator=generator, device=device)

    return StepDraws(
        latent_eps=normal(shape),
        noise=normal(shape),
        timesteps=torch.randint(0, num_train_timesteps, (b,), generator=generator,
                                device=device),
        offset_noise=normal((b, 1, 1, c)) if cfg.noise_offset else None,
        perturbation=normal(shape) if cfg.input_perturbation else None,
    )


def diffusion_loss(unet: nn.Module, schedule: DiffusionSchedule, latents: torch.Tensor,
                   context: torch.Tensor, draws: StepDraws, cfg: LossConfig) -> torch.Tensor:
    """Min-SNR-weighted epsilon / v MSE (``finetune_sd.py:70-114``), f32 scalar."""
    noise = draws.noise.float()
    if cfg.noise_offset:
        noise = noise + cfg.noise_offset * draws.offset_noise.float()
    timesteps = draws.timesteps
    if cfg.input_perturbation:
        noisy = add_noise(schedule, latents,
                          noise + cfg.input_perturbation * draws.perturbation.float(), timesteps)
    else:
        noisy = add_noise(schedule, latents, noise, timesteps)
    pred_type = cfg.prediction_type or schedule.prediction_type
    if pred_type == "epsilon":
        target = noise
    elif pred_type == "v_prediction":
        target = get_velocity(schedule, latents, noise, timesteps)
    else:
        raise ValueError(f"Unknown prediction type {pred_type}")
    model_pred, _ = unet(noisy, timesteps, context)
    err = (model_pred.float() - target) ** 2
    if cfg.snr_gamma is None:
        return err.mean()
    w = min_snr_weights(dataclasses.replace(schedule, prediction_type=pred_type), timesteps,
                        cfg.snr_gamma)
    return (err.mean(dim=(1, 2, 3)) * w).mean()


def _autocast(device: torch.device):
    if device.type == "cuda":
        return torch.autocast(device_type="cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def make_train_step(
    unet: nn.Module,
    vae: nn.Module,
    text_encoder: nn.Module,
    schedule: DiffusionSchedule,
    tx: Optimizer,
    loss_cfg: LossConfig,
    use_ema: bool = False,
    ema_decay: float = 0.9999,
    resize_weights: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Callable:
    """Build ``step(state, batch, draws=None, generator=None) -> (state, metrics)``.

    ``batch`` holds device tensors: ``input_ids`` (B, 77) and one of
    ``latent_moments`` (B, h, w, 2C) f32, ``pixel_u8`` (B, h0, w0, 3) uint8
    (resized on the device with ``resize_weights``) or ``pixel_values``
    (B, H, W, 3) in [-1, 1]. The parameters, optimizer state and EMA shadow
    are updated in place; ``metrics`` holds device scalars (loss, grad_norm
    of this micro-batch's gradient), so the step never waits on the host.
    ``state.step`` counts micro-batches; with ``tx`` accumulating (``multi_steps``)
    the parameters, the optimizer count and the EMA move on every k-th.
    """
    scaling = vae.config.scaling_factor
    device = next(unet.parameters()).device

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[StepDraws] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Dict]:
        with torch.no_grad():
            if "latent_moments" in batch:
                mean, logvar = batch["latent_moments"].float().chunk(2, dim=-1)
            else:
                pixels = (apply_resize(batch["pixel_u8"], *resize_weights)
                          if "pixel_u8" in batch else batch["pixel_values"])
                mean, logvar = vae.encode(pixels)
            if draws is None:
                draws = make_draws(generator, mean.shape, schedule.num_train_timesteps,
                                   loss_cfg, device)
            latents = sample_latents(mean, logvar, draws.latent_eps.float()) * scaling
            context = text_encoder(batch["input_ids"])[0]
        with _autocast(device):
            loss = diffusion_loss(unet, schedule, latents, context, draws, loss_cfg)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in state.params.items()}
        # under gradient accumulation only the update micro-batch moves the
        # parameters and blends the EMA (finetune_sd.py:211-217)
        if tx.fused and use_ema and state.ema is not None:
            # the shadow is blended inside the kernel, from the new params in registers
            decay = ema_decay_at(state.ema.step, ema_decay)
            _, _, grad_norm, _ = tx.apply(grads, state.opt_state, state.params,
                                          ema=state.ema.params, ema_decay=decay)
            if updated(state.opt_state):
                state.ema.step += 1
        else:
            _, _, grad_norm = tx.apply(grads, state.opt_state, state.params)
            if use_ema and state.ema is not None and updated(state.opt_state):
                ema_update(state.ema, state.params, ema_decay)
        for p in state.params.values():
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
