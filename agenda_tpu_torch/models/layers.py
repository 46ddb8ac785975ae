"""Building blocks of the SD UNet and VAE (NCHW inside, diffusers key names).

Counterpart of ``agenda_tpu/models/layers.py``. Parameter names equal the
diffusers keys so a safetensors state dict loads with ``strict=True``. The
numerics follow the JAX package, not diffusers, where the two differ: the
transformer block's LayerNorms use flax's default eps 1e-6.

Every GroupNorm goes through ``kernels.groupnorm.group_norm_act`` (the CUDA
kernel on the card) and every unmasked self-attention through
``kernels.attention.attention`` (the flash kernel on the card).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from agenda_tpu_torch.kernels.attention import attention, cross_attention_with_probs
from agenda_tpu_torch.kernels.groupnorm import group_norm_act


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
) -> torch.Tensor:
    """Sinusoidal embeddings, diffusers ``get_timestep_embedding`` semantics (f32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                     device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def groups_for(channels: int) -> int:
    """32 groups as in SD configs, fewer for the tiny test models."""
    return min(32, channels)


class GroupNormAct(nn.Module):
    """GroupNorm with an optional SiLU; parameters stay f32 in a bf16 model."""

    def __init__(self, channels: int, eps: float, act: Optional[str] = None):
        super().__init__()
        self.num_groups = groups_for(channels)
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


def cast_for_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast a model to its compute dtype, keeping GroupNorm parameters f32
    (the kernel reads f32 weight and bias) and embedding tables f32 (the JAX
    package looks them up in f32 and casts after the position add)."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (GroupNormAct, nn.Embedding)):
            m.float()
    return module


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class Attention(nn.Module):
    """Multi-head attention (self or cross), diffusers ``Attention`` names.

    ``collect_probs=True`` (cross-attention) also returns the head-mean
    probabilities (B, Sq, Sk) f32, the DAAM maps.
    """

    def __init__(self, query_dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                collect_probs: bool = False):
        ctx = x if context is None else context
        b, sq, inner = x.shape
        d = inner // self.heads
        q = self.to_q(x).view(b, sq, self.heads, d)
        k = self.to_k(ctx).view(b, ctx.shape[1], self.heads, d)
        v = self.to_v(ctx).view(b, ctx.shape[1], self.heads, d)
        probs = None
        if collect_probs:
            out, probs = cross_attention_with_probs(q, k, v)
        else:
            out = attention(q, k, v)
        out = self.to_out[0](out.reshape(b, sq, inner))
        return (out, probs) if collect_probs else out


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # net.1 is diffusers' dropout slot; keeping it preserves the key names.
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, collect_probs: bool = False):
        x = x + self.attn1(self.norm1(x))
        probs = None
        if collect_probs:
            out, probs = self.attn2(self.norm2(x), context, collect_probs=True)
        else:
            out = self.attn2(self.norm2(x), context)
        x = x + out
        x = x + self.ff(self.norm3(x))
        return x, probs


class Transformer2D(nn.Module):
    """GN -> 1x1 conv in -> transformer block -> 1x1 conv out, plus residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNormAct(channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor, collect_probs: bool = False):
        b, c, h, w = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        probs = None
        for block in self.transformer_blocks:
            x, probs = block(x, context, collect_probs)
        # contiguous NCHW again: the next GroupNorm kernel reads contiguous input
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        x = self.proj_out(x) + residual
        maps = None
        if collect_probs:
            # (B, HW, tokens) -> (B, tokens, h, w), the JAX package's maps layout
            maps = probs.transpose(1, 2).reshape(b, -1, h, w)
        return x, maps


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv -> (+time) -> GN -> SiLU -> conv, 1x1 shortcut."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNormAct(in_channels, eps, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNormAct(out_channels, eps, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad  # the VAE encoder pads (0, 1, 0, 1)
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid blocks (D = channels)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNormAct(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(x).view(b, h * w, 1, c)
        k = self.to_k(x).view(b, h * w, 1, c)
        v = self.to_v(x).view(b, h * w, 1, c)
        out = self.to_out[0](attention(q, k, v).reshape(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous() + residual

