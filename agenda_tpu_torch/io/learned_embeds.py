"""Learned token-embedding checkpoints, compatible with the reference's format.

The port's own copy of ``agenda_tpu/io/learned_embeds.py`` (the port imports nothing of
agenda_tpu, not even its numpy-only modules).

The reference stores stage-1 learnable embeddings as a torch-pickled dict
``{token_name: tensor(768,)}`` named ``learned_embeds_steps_N.bin``
(``data_generation/finetune_sd_token.py:156-161``) and reloads it with
``torch.load`` in stage 2 and in generation (``finetune_sd_token.py:637-646``,
``data_generation/data_generation.py:33``). We keep the exact same on-disk
format.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def save_learned_embeddings(tokens: List[str], embeddings: np.ndarray, path: str) -> None:
    """tokens: [k], embeddings: (k, hidden) -> torch .bin dict {token: tensor}."""
    import torch

    d = {
        tok: torch.from_numpy(np.array(embeddings[i], dtype=np.float32, copy=True))
        for i, tok in enumerate(tokens)
    }
    torch.save(d, path)


def load_learned_embeddings(path: str) -> Dict[str, np.ndarray]:
    import torch

    d = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in d.items()}
