"""SD ``UNet2DConditionModel`` in PyTorch, diffusers key names.

Counterpart of ``agenda_tpu/models/unet.py``. Notes carried over:

- ``attention_head_dim`` holds the number of heads (diffusers' SD-1.x quirk).
- ``collect_attn=True`` returns every cross-attention layer's head-mean
  probability map as (B, tokens, h, w), ordered down blocks, mid, up blocks.
- The public layout is the JAX package's: sample (B, H, W, C) in, eps
  (B, H, W, C) f32 out. Inside, activations are NCHW in the compute dtype.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from agenda_tpu_torch.io.configs import UNetConfig
from agenda_tpu_torch.models.layers import (
    Downsample2D,
    GroupNormAct,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    timestep_embedding,
)


class _Block(nn.Module):
    """One down or up block: resnets, optional transformers, optional resampler."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        tdim = ch[0] * 4
        heads, ctx = cfg.attention_head_dim, cfg.cross_attention_dim
        n = cfg.layers_per_block
        self.time_embedding = TimestepEmbedding(ch[0], tdim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        skips = [ch[0]]
        x_ch = ch[0]
        downs = []
        for i, kind in enumerate(cfg.down_block_types):
            if kind not in ("CrossAttnDownBlock2D", "DownBlock2D"):
                raise ValueError(f"Unknown down block {kind}")
            out = ch[i]
            resnets, attns = [], []
            for _ in range(n):
                resnets.append(ResnetBlock2D(x_ch, out, tdim))
                x_ch = out
                if kind == "CrossAttnDownBlock2D":
                    attns.append(Transformer2D(out, heads, ctx))
                skips.append(out)
            down = None
            if i < len(cfg.down_block_types) - 1:
                down = Downsample2D(out)
                skips.append(out)
            downs.append(_Block(resnets, attns, downsample=down))
        self.down_blocks = nn.ModuleList(downs)

        mid = ch[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid, mid, tdim), ResnetBlock2D(mid, mid, tdim)],
            [Transformer2D(mid, heads, ctx)])

        ups = []
        rev = list(reversed(ch))
        for i, kind in enumerate(cfg.up_block_types):
            if kind not in ("CrossAttnUpBlock2D", "UpBlock2D"):
                raise ValueError(f"Unknown up block {kind}")
            out = rev[i]
            resnets, attns = [], []
            for _ in range(n + 1):
                resnets.append(ResnetBlock2D(x_ch + skips.pop(), out, tdim))
                x_ch = out
                if kind == "CrossAttnUpBlock2D":
                    attns.append(Transformer2D(out, heads, ctx))
            up = Upsample2D(out) if i < len(cfg.up_block_types) - 1 else None
            ups.append(_Block(resnets, attns, upsample=up))
        self.up_blocks = nn.ModuleList(ups)

        self.conv_norm_out = GroupNormAct(ch[0], eps=1e-5, act="silu")
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        collect_attn: bool = False,
    ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """sample (B, H, W, C), timesteps (B,) or scalar, context (B, 77, C)
        -> (eps (B, H, W, C) f32, maps list[(B, tokens, h, w)] or None)."""
        cfg = self.config
        dtype = self.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  flip_sin_to_cos=cfg.flip_sin_to_cos,
                                  downscale_freq_shift=cfg.freq_shift).to(dtype)
        temb = self.time_embedding(temb)
        ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2).contiguous())

        maps: List[torch.Tensor] = []
        res = [x]

        def transformer(attn, x):
            x, m = attn(x, ctx, collect_attn)
            if m is not None:
                maps.append(m)
            return x

        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for i, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if attns is not None:
                    x = transformer(attns[i], x)
                res.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                res.append(x)

        x = self.mid_block.resnets[0](x, temb)
        x = transformer(self.mid_block.attentions[0], x)
        x = self.mid_block.resnets[1](x, temb)

        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for i, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, res.pop()], dim=1), temb)
                if attns is not None:
                    x = transformer(attns[i], x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        eps = x.float().permute(0, 2, 3, 1).contiguous()
        return eps, (maps if collect_attn else None)
