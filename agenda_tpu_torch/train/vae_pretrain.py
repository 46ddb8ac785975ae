"""AutoencoderKL pretraining (reconstruction + KL) for a domain without a VAE.

Counterpart of ``agenda_tpu/train/vae_pretrain.py:31-99``. The loss is the
reconstruction MSE plus ``kl_weight`` times the KL divergence against
N(0, 1); plain Adam at ``lr`` (``optax.adam``); batches are the indices
``np.random.RandomState(seed).randint(0, n, batch_size)`` draws, as in the
JAX package, so both draw the same images. The latent noise of each step
comes from an explicit ``torch.Generator`` (the JAX package draws from a
threefry key a step, which torch cannot reproduce: the parity tests pass
the JAX draw in as ``eps``). ``scaling_factor`` is 1 / std of the sampled
latents over up to 64 training images, the measured counterpart of
SD-1.x's 0.18215.

On the card the step runs under bf16 autocast, as the SD fine-tune does:
the flash kernels take bf16 (the VAE's mid-block attention at SD-1.4's
widths is single-head with D = 512: K1 forward, the wide K2/K3 backward),
and every GroupNorm is K6. The loss terms are f32. On the CPU the step runs
in f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch.models.vae import AutoencoderKL, sample_latents
from agenda_tpu_torch.train.finetune_sd import _autocast
from agenda_tpu_torch.train.optim import AdamState, Optimizer, make_adam

SCALE_IMAGES = 64  # training images whose sampled latents set scaling_factor


def make_vae_pretrain_step(vae: AutoencoderKL, tx: Optimizer, kl_weight: float
                           ) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> ``step(opt_state, pixels, eps) -> {"loss", "recon", "kl"}`` (0-dim
    f32 tensors, not synchronised): pixels (B, H, W, 3) in [-1, 1] and eps
    (B, h, w, 4) on the VAE's device. Updates the VAE's parameters and
    ``opt_state`` in place."""
    names = [n for n, _ in vae.named_parameters()]
    params = dict(vae.named_parameters())

    def step(opt_state: AdamState, pixels: torch.Tensor, eps: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        vae.train()
        with _autocast(pixels.device):
            recon, mean, logvar = vae(pixels, eps)
        recon_loss = torch.mean((recon.float() - pixels) ** 2)
        kl = -0.5 * torch.mean(1.0 + logvar - mean ** 2 - torch.exp(logvar))
        loss = recon_loss + kl_weight * kl
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        tx.apply(dict(zip(names, grads)), opt_state, params)
        return {"loss": loss.detach(), "recon": recon_loss.detach(), "kl": kl.detach()}

    return step


def latent_shape(vae: AutoencoderKL, batch: int, h: int, w: int) -> Tuple[int, int, int, int]:
    """(B, h, w, latent channels) of images (B, H, W, 3)."""
    f = 2 ** (len(vae.config.block_out_channels) - 1)
    return batch, h // f, w // f, vae.config.latent_channels


@torch.no_grad()
def measure_scaling_factor(vae: AutoencoderKL, pixels_all: np.ndarray, batch_size: int,
                           noise: Callable[[int, Tuple[int, ...]], torch.Tensor]) -> float:
    """1 / std of latents sampled from the first ``SCALE_IMAGES`` images, in
    batches from each multiple of ``batch_size`` below it, as the JAX package
    slices them; ``noise(start, shape)`` is the batch's standard-normal draw."""
    device = next(vae.parameters()).device
    vae.eval()
    samples = []
    for start in range(0, min(len(pixels_all), SCALE_IMAGES), batch_size):
        x = torch.from_numpy(pixels_all[start:start + batch_size]).to(device)
        with _autocast(device):
            mean, logvar = vae.encode(x)
        samples.append(sample_latents(mean, logvar, noise(start, tuple(mean.shape))))
    std = float(torch.cat(samples).std(correction=0))
    return 1.0 / max(std, 1e-6)


def pretrain_vae(
    vae: AutoencoderKL,
    images_u8: np.ndarray,  # (N, H, W, 3) uint8
    *,
    steps: int = 400,
    batch_size: int = 8,
    lr: float = 2e-3,
    kl_weight: float = 1e-4,
    seed: int = 0,
    log_fn: Optional[Callable[[str], None]] = None,
) -> Tuple[AutoencoderKL, float, float]:
    """Train ``vae`` in place on its device; returns (vae, the measured
    scaling_factor, the last step's reconstruction MSE)."""
    device = next(vae.parameters()).device
    pixels_all = images_u8.astype(np.float32) / 127.5 - 1.0
    n, h, w = pixels_all.shape[:3]
    tx = make_adam(lr)
    opt_state = tx.init(dict(vae.named_parameters()))
    step = make_vae_pretrain_step(vae, tx, kl_weight)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = latent_shape(vae, batch_size, h, w)
    metrics = {}
    for i in range(steps):
        idx = rng.randint(0, n, batch_size)
        batch = torch.from_numpy(pixels_all[idx]).to(device)
        eps = torch.randn(shape, generator=gen, device=device)
        metrics = step(opt_state, batch, eps)
        if log_fn and (i + 1) % 100 == 0:
            log_fn(f"vae pretrain step {i + 1}/{steps}: recon {float(metrics['recon']):.5f} "
                   f"kl {float(metrics['kl']):.3f}")

    def noise(start: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)

    scaling = measure_scaling_factor(vae, pixels_all, batch_size, noise)
    recon_mse = float(metrics["recon"]) if metrics else float("nan")
    return vae, scaling, recon_mse
