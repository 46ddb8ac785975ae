"""SD ``UNet2DConditionModel`` in PyTorch, diffusers key names.

Counterpart of ``agenda_tpu/models/unet.py``. Notes carried over:

- ``attention_head_dim`` holds the number of heads (diffusers' SD-1.x quirk).
- ``collect_attn=True`` returns every cross-attention layer's head-mean
  probability map as (B, tokens, h, w), ordered down blocks, mid, up blocks.
- TGATE (``agenda_tpu/models/unet.py:219-364``): ``collect_cross=True`` adds
  a third element, every cross-attention layer's output contribution in the
  same traversal order; ``cached_cross=<that list>`` replays them and skips
  the cross-attention. The two are never set together.
- The public layout is the JAX package's: sample (B, H, W, C) in, eps
  (B, H, W, C) f32 out. Inside, activations are NCHW in the compute dtype.
- ``gradient_checkpointing = True`` recomputes each resnet and transformer
  in the backward (``torch.utils.checkpoint``; the JAX package remats whole
  blocks).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        self.gradient_checkpointing = False

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        collect_attn: bool = False,
        collect_cross: bool = False,
        cached_cross: Optional[Sequence[torch.Tensor]] = None,
    ):
        """sample (B, H, W, C), timesteps (B,) or scalar, context (B, 77, C)
        -> (eps (B, H, W, C) f32, maps list[(B, tokens, h, w)] or None), and
        with ``collect_cross`` the list of cross-attention contributions
        (B, h*w, C) as a third element."""
        assert not (collect_cross and cached_cross is not None)
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
        remat = self.gradient_checkpointing and torch.is_grad_enabled()

        def run(module, *args):
            if remat:
                return checkpoint(module, *args, use_reentrant=False)
            return module(*args)

        cross_outs: List[torch.Tensor] = []
        cache = iter(cached_cross) if cached_cross is not None else None

        def transformer(attn, x):
            cached = None
            if cache is not None:  # this transformer's slice of the flat list
                cached = [next(cache) for _ in attn.transformer_blocks]
            x, m, *co = run(attn, x, ctx, collect_attn, collect_cross, cached)
            if m is not None:
                maps.append(m)
            if co:
                cross_outs.extend(co[0])
            return x

        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for i, resnet in enumerate(block.resnets):
                x = run(resnet, x, temb)
                if attns is not None:
                    x = transformer(attns[i], x)
                res.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                res.append(x)

        x = run(self.mid_block.resnets[0], x, temb)
        x = transformer(self.mid_block.attentions[0], x)
        x = run(self.mid_block.resnets[1], x, temb)

        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for i, resnet in enumerate(block.resnets):
                x = run(resnet, torch.cat([x, res.pop()], dim=1), temb)
                if attns is not None:
                    x = transformer(attns[i], x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        eps = x.float().permute(0, 2, 3, 1).contiguous()
        if collect_cross:
            return eps, (maps if collect_attn else None), cross_outs
        return eps, (maps if collect_attn else None)
