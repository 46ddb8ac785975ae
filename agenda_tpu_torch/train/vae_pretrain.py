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

The step computes in ``dtype``, f32 by default, as the JAX package
computes in the dtype of the ``AutoencoderKL`` it is given (f32 by
default, ``agenda_tpu/models/vae.py:102-104``): on the card in f32 under
``_device.full_f32`` (TF32 off), where the flash kernels take f32 (the
VAE's mid-block attention at SD-1.4's widths is single-head with D = 512:
the f32 forward and the wide f32 dK/dV and dQ of
``csrc/flash_bwd_f32_wide.cu``) and every GroupNorm is K6's f32
instantiation; under bf16 autocast for ``dtype=torch.bfloat16``, as a JAX
caller gets with ``AutoencoderKL(dtype=jnp.bfloat16)`` (the bf16 kernels).
The loss terms are f32. On the CPU the step runs in f32 whatever
``dtype`` says (neither context does anything there), as the fine-tunes'
``_device.compute_dtype`` gives.

The f32 step on the card takes cuDNN's heuristics, not its autotuning: at
SD-1.4's widths, 256 px, batch 8, on an H100 80GB HBM3 at 700 W,
autotuning cost 29.6-30.5 s once and a peak of 71.45 GiB against 13.43 GiB
for a step 6% faster (0.5857 s against 0.6245-0.6251;
``scripts/vae_autotune.py``), so it would pay only after about 800 steps,
twice ``pretrain_vae``'s default.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch._device import full_f32_if
from agenda_tpu_torch.models.vae import AutoencoderKL, sample_latents
from agenda_tpu_torch.train.finetune_sd import _autocast
from agenda_tpu_torch.train.optim import AdamState, Optimizer, make_adam

SCALE_IMAGES = 64  # training images whose sampled latents set scaling_factor


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"VAE pretraining computes in f32 or bf16, not {dtype}")


def make_vae_pretrain_step(vae: AutoencoderKL, tx: Optimizer, kl_weight: float,
                           dtype: torch.dtype = torch.float32
                           ) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> ``step(opt_state, pixels, eps) -> {"loss", "recon", "kl"}`` (0-dim
    f32 tensors, not synchronised): pixels (B, H, W, 3) in [-1, 1] and eps
    (B, h, w, 4) on the VAE's device, computed in ``dtype`` on the card (f32
    on the CPU). Updates the VAE's parameters and ``opt_state`` in place."""
    _check_dtype(dtype)
    names = [n for n, _ in vae.named_parameters()]
    params = dict(vae.named_parameters())

    def step(opt_state: AdamState, pixels: torch.Tensor, eps: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        vae.train()
        device = pixels.device
        with full_f32_if(dtype, device, benchmark=False):
            with _autocast(device, dtype):
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
                           noise: Callable[[int, Tuple[int, ...]], torch.Tensor],
                           dtype: torch.dtype = torch.float32) -> float:
    """1 / std of latents sampled from the first ``SCALE_IMAGES`` images, in
    batches from each multiple of ``batch_size`` below it, as the JAX package
    slices them; ``noise(start, shape)`` is the batch's standard-normal draw.
    The encode computes in ``dtype`` on the card, f32 on the CPU (one-off
    shapes: cuDNN's heuristics, not its autotuning, in f32)."""
    _check_dtype(dtype)
    device = next(vae.parameters()).device
    vae.eval()
    samples = []
    for start in range(0, min(len(pixels_all), SCALE_IMAGES), batch_size):
        x = torch.from_numpy(pixels_all[start:start + batch_size]).to(device)
        with full_f32_if(dtype, device, benchmark=False), _autocast(device, dtype):
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
    dtype: torch.dtype = torch.float32,
) -> Tuple[AutoencoderKL, float, float]:
    """Train ``vae`` in place on its device, computing in ``dtype`` on the
    card and f32 on the CPU; returns (vae, the measured
    scaling_factor, the last step's reconstruction MSE)."""
    device = next(vae.parameters()).device
    pixels_all = images_u8.astype(np.float32) / 127.5 - 1.0
    n, h, w = pixels_all.shape[:3]
    tx = make_adam(lr)
    opt_state = tx.init(dict(vae.named_parameters()))
    step = make_vae_pretrain_step(vae, tx, kl_weight, dtype)
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

    scaling = measure_scaling_factor(vae, pixels_all, batch_size, noise, dtype)
    recon_mse = float(metrics["recon"]) if metrics else float("nan")
    return vae, scaling, recon_mse
