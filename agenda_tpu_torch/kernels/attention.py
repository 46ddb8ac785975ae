"""Attention for the UNet, VAE and CLIP, in the JAX package's (B, S, H, D) layout.

Counterpart of ``agenda_tpu/kernels/attention.py``:

- ``attention_reference``: plain attention with an optional additive mask
  (CLIP's causal attention), f32 softmax.
- ``cross_attention_with_probs``: plain torch; returns the output and the
  head-mean f32 probabilities (B, Sq, Sk), the DAAM side output.
- ``attention``: on CUDA every unmasked self-attention goes through the flash
  kernel (UNet ``attn1`` at every level and the VAE mid-block attention);
  the TPU's cutoffs on head dim and sequence length are not inherited. On
  the CPU it takes the plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from agenda_tpu_torch.kernels.flash import flash_attention_fwd


def _probs(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, Sq, Sk) f32 softmax of Q K^T / sqrt(D) (+ mask)."""
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 3, 1)
    logits = torch.matmul(qf, kf) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        logits = logits + mask
    return torch.softmax(logits, dim=-1)


def _apply(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B, H, Sq, Sk) in v's dtype times v (B, Sk, H, D) -> (B, Sq, H, D)."""
    out = torch.matmul(probs.to(v.dtype), v.permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3)


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D)."""
    return _apply(_probs(q, k, mask), v)


def cross_attention_with_probs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D), head-mean probabilities (B, Sq, Sk) f32)."""
    probs = _probs(q, k, None)
    return _apply(probs, v), probs.mean(dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked self-attention: the flash kernel on CUDA, plain on the CPU."""
    return flash_attention_fwd(q, k, v)[0]
