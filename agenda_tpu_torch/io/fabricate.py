"""Write diffusers-layout pipelines with seeded random weights.

Real SD-1.4 weights are not in the repository, so the full-width run uses
fabricated ones: SD-1.4's exact shapes and diffusers key names, every
matrix, convolution and embedding drawn from normal(0, 0.02) with a seeded
CPU ``torch.Generator``, norm weights 1 and biases 0 (so activations keep a
realistic scale through the GroupNorms). ``write_tiny_tokenizer`` is the
port's own copy of ``agenda_tpu/io/tiny_fixture.py:31-85``: a minimal but
valid CLIP BPE vocab/merges pair.

    python -m agenda_tpu_torch.io.fabricate <out_dir> [--tiny] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from agenda_tpu_torch.io.configs import CLIPTextConfig, UNetConfig, VAEConfig
from agenda_tpu_torch.io.diffusers_io import save_pipeline
from agenda_tpu_torch.io.learned_embeds import save_learned_embeddings
from agenda_tpu_torch.models.clip_text import CLIPTextModel
from agenda_tpu_torch.models.unet import UNet2DConditionModel
from agenda_tpu_torch.models.vae import AutoencoderKL

LEARNED_TOKENS = ("new_token_v0", "new_token_v1", "new_token_v2")


def bytes_to_unicode():
    """GPT-2/CLIP byte<->unicode table (standard public algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def write_tiny_tokenizer(d: str) -> int:
    """Write a CLIP-format vocab.json/merges.txt. Returns the vocab size."""
    os.makedirs(d, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = [
        "c a", "ca r", "car s</w>",         # cars -> single token
        "a e", "ae r", "aer i", "aeri al</w>",  # partial merges for 'aerial'
        "a l</w>",
        "u t", "ut a", "uta h</w>",          # utah -> single token
        "l i", "li n", "lin z</w>",          # linz -> single token
    ]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump(
            {
                "model_max_length": 77,
                "bos_token": "<|startoftext|>",
                "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>",
                "pad_token": "<|endoftext|>",
                "tokenizer_class": "CLIPTokenizer",
            },
            f,
        )
    return len(vocab)


def random_state(module_cls, config, seed: int) -> Dict[str, torch.Tensor]:
    """A state dict with the module's exact keys and shapes, drawn from a seed."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in module_cls(config).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        if len(shape) == 1 and key.endswith(".bias"):
            out[key] = torch.zeros(shape)
        elif len(shape) == 1:
            out[key] = torch.ones(shape)  # GroupNorm / LayerNorm scales
        else:
            out[key] = torch.randn(shape, generator=g).mul_(0.02)
    return out


def fabricate_pipeline(out_dir: str, tiny: bool = False,
                       seed: int = 0) -> Tuple[UNetConfig, VAEConfig, CLIPTextConfig]:
    """Write a pipeline dir: SD-1.4's full widths, or the tiny test sizes."""
    tok_dir = os.path.join(out_dir, "tokenizer")
    vocab_size = write_tiny_tokenizer(tok_dir)
    if tiny:
        unet_cfg, vae_cfg = UNetConfig.tiny(), VAEConfig.tiny()
        text_cfg = CLIPTextConfig(vocab_size=vocab_size, hidden_size=unet_cfg.cross_attention_dim,
                                  intermediate_size=64, num_hidden_layers=2, num_attention_heads=2)
    else:
        unet_cfg, vae_cfg, text_cfg = UNetConfig(), VAEConfig(), CLIPTextConfig()
    save_pipeline(
        out_dir,
        unet_cfg, random_state(UNet2DConditionModel, unet_cfg, seed),
        vae_cfg, random_state(AutoencoderKL, vae_cfg, seed + 1),
        text_cfg, random_state(CLIPTextModel, text_cfg, seed + 2),
        tokenizer_dir=tok_dir,
    )
    return unet_cfg, vae_cfg, text_cfg


def write_learned_embeds(path: str, hidden: int, seed: int = 0,
                         tokens: Sequence[str] = LEARNED_TOKENS) -> None:
    """Learned-token embeddings (.bin, the reference's format), normal(0, 0.02)."""
    rng = np.random.RandomState(seed)
    save_learned_embeddings(list(tokens),
                            (rng.standard_normal((len(tokens), hidden)) * 0.02).astype(np.float32),
                            path)


def main(argv=None):
    p = argparse.ArgumentParser(description="Write a fabricated diffusers-layout pipeline.")
    p.add_argument("out_dir")
    p.add_argument("--tiny", action="store_true", help="test sizes instead of SD-1.4's widths")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    _, _, text_cfg = fabricate_pipeline(args.out_dir, tiny=args.tiny, seed=args.seed)
    write_learned_embeds(os.path.join(args.out_dir, "learned_embeds.bin"),
                         text_cfg.hidden_size, seed=args.seed)


if __name__ == "__main__":
    main()
