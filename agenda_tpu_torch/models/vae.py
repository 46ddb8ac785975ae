"""SD ``AutoencoderKL`` in PyTorch, diffusers key names.

Counterpart of ``agenda_tpu/models/vae.py``. The full encoder and decoder
are here so that a diffusers VAE state dict loads strictly; generation only
runs ``decode``. Public layout: latents (B, h, w, 4) in, images
(B, H, W, 3) f32 out.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from agenda_tpu_torch.io.configs import VAEConfig
from agenda_tpu_torch.models.layers import (
    Downsample2D,
    GroupNormAct,
    ResnetBlock2D,
    Upsample2D,
    VAEAttention,
)


class _Block(nn.Module):
    def __init__(self, resnets, downsample=None, upsample=None, attentions=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


def _mid(ch: int) -> _Block:
    return _Block([ResnetBlock2D(ch, ch, None, eps=1e-6), ResnetBlock2D(ch, ch, None, eps=1e-6)],
                  attentions=[VAEAttention(ch)])


def _run_mid(mid: _Block, x: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, x_ch = [], ch[0]
        for i, out in enumerate(ch):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, out, None, eps=1e-6))
                x_ch = out
            down = Downsample2D(out, asymmetric_pad=True) if i < len(ch) - 1 else None
            blocks.append(_Block(resnets, downsample=down))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(ch[-1])
        self.conv_norm_out = GroupNormAct(ch[-1], eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0])
        blocks, x_ch = [], rev[0]
        for i, out in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch, out, None, eps=1e-6))
                x_ch = out
            up = Upsample2D(out) if i < len(rev) - 1 else None
            blocks.append(_Block(resnets, upsample=up))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNormAct(rev[-1], eps=1e-6, act="silu")
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images (B, H, W, 3) in [-1, 1] -> (mean, logvar) (B, h, w, 4) f32."""
        h = self.quant_conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2).contiguous()))
        mean, logvar = h.float().permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean.contiguous(), torch.clamp(logvar, -30.0, 20.0).contiguous()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, h, w, 4) -> images (B, H, W, 3) f32 in about [-1, 1]."""
        z = self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2).contiguous())
        return self.decoder(z).float().permute(0, 2, 3, 1).contiguous()
