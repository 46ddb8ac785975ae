"""Learnable-token + UNet fine-tuning with cross-attention regularization.

Counterpart of ``agenda_tpu/train/finetune_sd_token.py`` (the reference's
AttnDreamBooth-style trainer, stages 1 and 2):

- ``splice_token_embeddings``: the learned (K, C) rows written into the
  batch's token embeddings where ``new_tokens_start`` > 0, one row over
  ``n_object_embedding`` positions (``:42``);
- ``attn_reg_loss``: per cross-attention layer, the fg-token map pulled (L1)
  toward the min-max and sum normalised object-word map and the bg-token
  map toward its inverse, divided by the valid samples and by the layers
  (``:82``);
- ``split_unet_params``: which UNet parameters train (all, only ``attn2``
  with ``--train_cross_attn``, or none); the frozen ones get
  ``requires_grad=False`` and never enter the optimizer (``:139``);
- ``make_token_train_step`` (``:227``), with the reference's quirks: the
  UNet-only clip ``min(1, max_grad_norm / (||g_unet|| + 1e-6))``, applied only
  when tokens train, with the optimizer built with ``max_grad_norm=None``;
  ``offset_noise`` a bool (0.1 N(0, 1) of shape (B, 1, 1, C)); the
  optimizer's parameters are {"embedding", "unet.<name>"}.

Mixed precision as in the SD trainer: f32 master parameters and the UNet
under ``torch.autocast(bfloat16)`` on the card. The text encoder runs in its
own dtype with autograd on when tokens train, so the gradient reaches the
learned rows through it while its weights stay frozen. The DAAM maps of
``collect_attn=True`` keep their autograd graph. The step's draws arrive as
a ``StepDraws`` (``train/finetune_sd.py``), so the parity tests can pass in
the JAX key stream's; the initial embedding is an argument for the same
reason.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agenda_tpu_torch.core.schedules import (
    DiffusionSchedule,
    add_noise,
    get_velocity,
    min_snr_weights,
)
from agenda_tpu_torch.data.device_resize import apply_resize
from agenda_tpu_torch.models.vae import sample_latents
from agenda_tpu_torch.train.finetune_sd import LossConfig, StepDraws, _autocast, make_draws
from agenda_tpu_torch.train.optim import Optimizer, global_norm

Tensors = Dict[str, torch.Tensor]
OFFSET_NOISE = 0.1  # the scale of --offset_noise (finetune_sd_token.py:269)


def splice_token_embeddings(base_embeds: torch.Tensor, starts: torch.Tensor,
                            training_embedding: torch.Tensor,
                            n_object_embedding: int = 1) -> torch.Tensor:
    """base (B, S, C) with training_embedding[k] at positions
    [starts[:, k], starts[:, k] + n) wherever starts[:, k] > 0."""
    pos = torch.arange(base_embeds.shape[1], device=base_embeds.device)[None, :]
    out = base_embeds
    for j in range(starts.shape[1]):
        sj = starts[:, j:j + 1].long()
        mask = (pos >= sj) & (pos < sj + n_object_embedding) & (sj > 0)
        out = torch.where(mask[..., None], training_embedding[j].to(out.dtype)[None, None, :], out)
    return out


def _minmax_sum_norm(m: torch.Tensor) -> torch.Tensor:
    """(B, h, w) -> min-max to [0, 1], then divided by its sum (per sample)."""
    mn = m.amin(dim=(1, 2), keepdim=True)
    mx = m.amax(dim=(1, 2), keepdim=True)
    n = (m - mn) / (mx - mn + 1e-8)
    return n / n.sum(dim=(1, 2), keepdim=True)


def _take_token(maps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """maps (B, T, h, w), idx (B,) -> (B, h, w)."""
    return maps[torch.arange(maps.shape[0], device=maps.device), idx]


def attn_reg_loss(maps: List[torch.Tensor], starts: torch.Tensor, n_object_embedding: int,
                  reg_weight: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(attn_loss, fg_loss, bg_loss) from the per-layer (B, T, h, w) maps.

    fg token = starts[:, 0]; object word = starts[:, 0] + n_object_embedding;
    bg token = the last start > -1. Samples with starts[:, 0] <= 0 add
    nothing; the terms divide by the valid samples, the totals by the layers.
    """
    t = maps[0].shape[1]
    starts = starts.long()
    valid = starts[:, 0] > 0
    n_valid = torch.clamp(valid.float().sum(), min=1.0)
    fg_idx = torch.clamp(starts[:, 0], 0, t - 1)
    obj_idx = torch.clamp(starts[:, 0] + n_object_embedding, 0, t - 1)
    k = starts.shape[1]
    bg_col = k - 1 - torch.argmax((starts > -1).int().flip(1), dim=1)  # the last valid column
    bg_idx = torch.clamp(starts.gather(1, bg_col[:, None])[:, 0], 0, t - 1)
    w = valid.float()
    fg_total = torch.zeros((), dtype=torch.float32, device=starts.device)
    bg_total = torch.zeros((), dtype=torch.float32, device=starts.device)
    for m in maps:
        m = m.float()
        obj = _take_token(m, obj_idx)
        mn = obj.amin(dim=(1, 2), keepdim=True)
        mx = obj.amax(dim=(1, 2), keepdim=True)
        norm_obj = (obj - mn) / (mx - mn + 1e-8)
        bg_ref = 1.0 - norm_obj
        bg_ref = bg_ref / bg_ref.sum(dim=(1, 2), keepdim=True)
        norm_obj = norm_obj / norm_obj.sum(dim=(1, 2), keepdim=True)
        fg = _minmax_sum_norm(_take_token(m, fg_idx))
        bg = _minmax_sum_norm(_take_token(m, bg_idx))
        fg_term = (norm_obj - fg).abs().mean(dim=(1, 2))
        bg_term = (bg_ref - bg).abs().mean(dim=(1, 2))
        fg_total = fg_total + reg_weight * (fg_term * w).sum() / n_valid
        bg_total = bg_total + reg_weight * (bg_term * w).sum() / n_valid
    n_layers = float(len(maps))
    return (fg_total + bg_total) / n_layers, fg_total / n_layers, bg_total / n_layers


def split_unet_params(unet: nn.Module, train_unet: bool,
                      train_cross_attn: bool) -> Tuple[Dict[str, nn.Parameter],
                                                       Dict[str, nn.Parameter]]:
    """(trainable, frozen) UNet parameters by name; sets ``requires_grad``.
    ``train_cross_attn`` trains the parameters with "attn2" in their name
    (the reference's unfreeze_model(unet, ['attn2']))."""
    named = dict(unet.named_parameters())
    if train_unet:
        trainable = named
    elif train_cross_attn:
        trainable = {k: p for k, p in named.items() if any("attn2" in part
                                                           for part in k.split("."))}
    else:
        trainable = {}
    frozen = {k: p for k, p in named.items() if k not in trainable}
    for p in trainable.values():
        p.requires_grad_(True)
    for p in frozen.values():
        p.requires_grad_(False)
    return trainable, frozen


def merge_params(trainable: Dict[str, torch.Tensor],
                 frozen: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {**frozen, **trainable}


@dataclasses.dataclass
class TokenTrainState:
    embedding: Optional[torch.Tensor]  # (K, C) f32 leaf, or None without --train_token
    unet_trainable: Dict[str, nn.Parameter]  # the UNet's own f32 parameters, by name
    unet_frozen: Dict[str, nn.Parameter]
    opt_state: Any
    step: int  # micro-batches

    def opt_params(self) -> Tensors:
        """The optimizer's parameters: {"embedding", "unet.<name>"}."""
        out = {} if self.embedding is None else {"embedding": self.embedding}
        out.update({f"unet.{k}": p for k, p in self.unet_trainable.items()})
        return out


@dataclasses.dataclass(frozen=True)
class TokenLossConfig:
    snr_gamma: Optional[float] = None
    offset_noise: bool = False
    with_cross_attn_reg: bool = False
    reg_weight: float = 1.0
    n_object_embedding: int = 1
    train_token: bool = False
    max_grad_norm: Optional[float] = 1.0


def init_token_train_state(unet: nn.Module, tx: Optimizer, train_token: bool, train_unet: bool,
                           train_cross_attn: bool, n_tokens: int, hidden_size: int,
                           generator: Optional[torch.Generator] = None,
                           init_embedding: Optional[np.ndarray] = None) -> TokenTrainState:
    """f32 master parameters (the UNet is cast to f32 in place), the split,
    the (K, C) embedding (``init_embedding``, else 0.02 N(0, 1) from
    ``generator``, as the reference's random init) and a fresh optimizer."""
    unet.float()
    device = next(unet.parameters()).device
    trainable, frozen = split_unet_params(unet, train_unet, train_cross_attn)
    emb = None
    if train_token:
        if init_embedding is not None:
            emb = torch.tensor(np.asarray(init_embedding), dtype=torch.float32, device=device)
        else:
            emb = 0.02 * torch.randn((n_tokens, hidden_size), generator=generator,
                                     device=device)
        emb.requires_grad_(True)
    state = TokenTrainState(embedding=emb, unet_trainable=trainable, unet_frozen=frozen,
                            opt_state=None, step=0)
    state.opt_state = tx.init(state.opt_params())
    return state


def make_token_train_step(unet: nn.Module, vae: nn.Module, text_encoder: nn.Module,
                          schedule: DiffusionSchedule, tx: Optimizer, cfg: TokenLossConfig,
                          resize_weights: Optional[Tuple[np.ndarray, np.ndarray]] = None
                          ) -> Callable:
    """Build ``step(state, batch, draws=None, generator=None) -> (state, metrics)``.

    ``batch`` holds device tensors: ``input_ids`` (B, 77), ``new_tokens_start``
    (B, K) int32 and one of ``latent_moments``, ``pixel_u8`` (resized with
    ``resize_weights``) or ``pixel_values``, as the SD step takes them. The
    token table is the text encoder's own (f32, extended by the caller with
    the new tokens' rows). Parameters, embedding and optimizer state are
    updated in place; ``metrics`` are device scalars (loss, mse, attn_loss,
    fg_loss, bg_loss).
    """
    scaling = vae.config.scaling_factor
    device = next(unet.parameters()).device
    draw_cfg = LossConfig(noise_offset=OFFSET_NOISE if cfg.offset_noise else 0.0)
    table = text_encoder.text_model.embeddings.token_embedding.weight

    def step(state: TokenTrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[StepDraws] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[TokenTrainState, Dict]:
        with torch.no_grad():
            if "latent_moments" in batch:
                mean, logvar = batch["latent_moments"].float().chunk(2, dim=-1)
            else:
                pixels = (apply_resize(batch["pixel_u8"], *resize_weights)
                          if "pixel_u8" in batch else batch["pixel_values"])
                mean, logvar = vae.encode(pixels)
            if draws is None:
                draws = make_draws(generator, mean.shape, schedule.num_train_timesteps,
                                   draw_cfg, device)
            latents = sample_latents(mean, logvar, draws.latent_eps.float()) * scaling
            noise = draws.noise.float()
            if cfg.offset_noise:
                noise = noise + OFFSET_NOISE * draws.offset_noise.float()
            timesteps = draws.timesteps
            noisy = add_noise(schedule, latents, noise, timesteps)
            if schedule.prediction_type == "epsilon":
                target = noise
            elif schedule.prediction_type == "v_prediction":
                target = get_velocity(schedule, latents, noise, timesteps)
            else:
                raise ValueError(schedule.prediction_type)

        ids, starts = batch["input_ids"], batch["new_tokens_start"]
        if cfg.train_token:
            base = F.embedding(ids, table.detach()).float()
            spliced = splice_token_embeddings(base, starts, state.embedding,
                                              cfg.n_object_embedding)
            context = text_encoder(ids, inputs_embeds=spliced)[0]
        else:
            with torch.no_grad():
                context = text_encoder(ids)[0]
        with _autocast(device):
            model_pred, maps = unet(noisy, timesteps, context,
                                    collect_attn=cfg.with_cross_attn_reg)
        err = (model_pred.float() - target) ** 2
        if cfg.snr_gamma is None:
            mse = err.mean()
        else:
            mse = (err.mean(dim=(1, 2, 3)) * min_snr_weights(schedule, timesteps,
                                                             cfg.snr_gamma)).mean()
        if cfg.with_cross_attn_reg:
            attn, fg, bg = attn_reg_loss(maps, starts, cfg.n_object_embedding, cfg.reg_weight)
        else:
            attn = fg = bg = torch.zeros((), dtype=torch.float32, device=device)
        loss = mse + attn
        loss.backward()

        params = state.opt_params()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        unet_grads = {k: g for k, g in grads.items() if k != "embedding"}
        if cfg.train_token and cfg.max_grad_norm is not None and unet_grads:
            # the reference clips the UNet's gradient only, and only when tokens
            # train (finetune_sd_token.py:1090-1092)
            scale = torch.clamp(cfg.max_grad_norm / (global_norm(unet_grads) + 1e-6), max=1.0)
            torch._foreach_mul_(list(unet_grads.values()), scale)
        tx.apply(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "mse": mse.detach(), "attn_loss": attn.detach(),
                       "fg_loss": fg.detach(), "bg_loss": bg.detach()}

    return step
