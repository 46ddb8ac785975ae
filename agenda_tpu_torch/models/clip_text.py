"""CLIP text encoder in PyTorch with HF ``CLIPTextModel`` key names.

Counterpart of ``agenda_tpu/models/clip_text.py``: causal self-attention,
quick-GELU MLP, final LayerNorm, f32 output, pooled output at the argmax
(EOS) token id. Attention here is the plain masked version (77 tokens).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agenda_tpu_torch.io.configs import CLIPTextConfig
from agenda_tpu_torch.kernels.attention import attention_reference


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"Unknown activation {name}")


class _SelfAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)


class _MLP(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(c, inner)
        self.fc2 = nn.Linear(inner, c)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.act = _act(cfg.hidden_act)
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(c)
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(c, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.heads
        h = self.layer_norm1(x)
        a = self.self_attn
        out = attention_reference(a.q_proj(h).view(b, s, self.heads, hd),
                                  a.k_proj(h).view(b, s, self.heads, hd),
                                  a.v_proj(h).view(b, s, self.heads, hd),
                                  mask=causal_mask)
        x = x + a.out_proj(out.reshape(b, s, c))
        h = self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))
        return x + h


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor,
                inputs_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, S) -> (last hidden state (B, S, C) f32, pooled (B, C) at EOS).

        ``inputs_embeds`` (B, S, C) replaces the token-table lookup: they are
        the pre-position embeddings (the token fine-tune splices its learned
        rows into them). Position is added in f32 and the sum cast to the
        layers' dtype, as for the lookup; the gradient reaches
        ``inputs_embeds`` whether or not the weights take one.
        """
        tm = self.text_model
        emb = tm.embeddings
        dtype = tm.final_layer_norm.weight.dtype
        s = input_ids.shape[1]
        if inputs_embeds is None:
            inputs_embeds = emb.token_embedding(input_ids)
        x = (inputs_embeds.float() + emb.position_embedding.weight[:s].float()).to(dtype)
        causal = torch.triu(torch.full((s, s), -1e9, dtype=torch.float32,
                                       device=input_ids.device), diagonal=1)[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x).float()
        eos = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        return x, pooled
