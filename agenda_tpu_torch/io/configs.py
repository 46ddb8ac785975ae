"""Model configs and their diffusers ``config.json`` parsers.

Counterparts: ``agenda_tpu/models/unet.py:39-76`` (UNetConfig),
``models/vae.py:30-41`` (VAEConfig), ``models/clip_text.py:31-50``
(CLIPTextConfig) and the JSON translation at ``io/diffusers_io.py:286-395``.
The defaults are SD-1.4's full widths; ``.tiny()`` gives the test sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    attention_head_dim: int = 8  # SD-1.x: the number of heads (diffusers naming quirk)
    cross_attention_dim: int = 768
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(
            sample_size=8,
            block_out_channels=(32, 64),
            layers_per_block=1,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            attention_head_dim=2,
            cross_attention_dim=32,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(
            vocab_size=1000,
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=2,
        )


def unet_config_from_json(cfg: dict) -> UNetConfig:
    return UNetConfig(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        down_block_types=tuple(cfg.get("down_block_types", UNetConfig().down_block_types)),
        up_block_types=tuple(cfg.get("up_block_types", UNetConfig().up_block_types)),
        attention_head_dim=cfg.get("attention_head_dim", 8),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        freq_shift=cfg.get("freq_shift", 0),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
    )


def unet_config_to_json(cfg: UNetConfig) -> dict:
    return {
        "_class_name": "UNet2DConditionModel",
        "_diffusers_version": "0.27.0",
        "act_fn": "silu",
        "attention_head_dim": cfg.attention_head_dim,
        "block_out_channels": list(cfg.block_out_channels),
        "center_input_sample": False,
        "cross_attention_dim": cfg.cross_attention_dim,
        "down_block_types": list(cfg.down_block_types),
        "downsample_padding": 1,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "freq_shift": cfg.freq_shift,
        "in_channels": cfg.in_channels,
        "layers_per_block": cfg.layers_per_block,
        "mid_block_scale_factor": 1,
        "norm_eps": 1e-05,
        "norm_num_groups": 32,
        "out_channels": cfg.out_channels,
        "sample_size": cfg.sample_size,
        "up_block_types": list(cfg.up_block_types),
    }


def vae_config_from_json(cfg: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def vae_config_to_json(cfg: VAEConfig) -> dict:
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": "0.27.0",
        "act_fn": "silu",
        "block_out_channels": list(cfg.block_out_channels),
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "in_channels": cfg.in_channels,
        "latent_channels": cfg.latent_channels,
        "layers_per_block": cfg.layers_per_block,
        "norm_num_groups": 32,
        "out_channels": cfg.out_channels,
        "sample_size": 512,
        "scaling_factor": cfg.scaling_factor,
        "up_block_types": ["UpDecoderBlock2D"] * n,
    }


def clip_config_from_json(cfg: dict) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        intermediate_size=cfg.get("intermediate_size", 3072),
        num_hidden_layers=cfg.get("num_hidden_layers", 12),
        num_attention_heads=cfg.get("num_attention_heads", 12),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
    )


def clip_config_to_json(cfg: CLIPTextConfig) -> dict:
    return {
        "architectures": ["CLIPTextModel"],
        "model_type": "clip_text_model",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_act": cfg.hidden_act,
        "projection_dim": cfg.hidden_size,
        "torch_dtype": "float32",
    }
