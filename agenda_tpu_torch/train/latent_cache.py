"""Latent-moment caching: the frozen VAE encoder runs once per image.

Counterpart of ``agenda_tpu/train/latent_cache.py``. The training transform
is deterministic (resize and [-1, 1], no augmentation), so each image's
latent distribution (mean, logvar) never changes across epochs; only the
reparameterized sample must be fresh at every visit. The cache encodes
every image once, in index order, and the step samples from the cached
moments with the same draw it would have used after encoding: the result is
the same. On by default in the CLI, as in the JAX package.

The cache is a host (N, h, w, 2C) f32 array; a batch of 4 512x512 images
ships 0.5 MB of moments a step instead of its pixels.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch._device import full_f32_if
from agenda_tpu_torch.data.device_resize import apply_resize


@torch.no_grad()
def precompute_latent_moments(vae, dataset, batch_size: int = 8,
                              resize_weights: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                              device: Optional[torch.device] = None, log_fn=None) -> np.ndarray:
    """Encode every dataset image once -> host (N, h, w, 2C) f32 moments.

    The trailing batch is padded to ``batch_size`` by repeating its last
    image, so every encode has one shape. uint8 tiles are resized on the
    device with ``resize_weights``, as in the step. The encode runs in the
    VAE's dtype, the compute dtype: an f32 VAE on the card (``--mixed_precision
    no``) encodes with TF32 off, without autotuning (each image is encoded
    once).
    """
    device = device or next(vae.parameters()).device
    n = len(dataset)
    out: Optional[np.ndarray] = None
    t0 = time.perf_counter()
    with full_f32_if(vae.dtype, device, benchmark=False):
        for start in range(0, n, batch_size):
            idx = list(range(start, min(start + batch_size, n)))
            rows = [dataset[i] for i in idx]
            key = "pixel_u8" if "pixel_u8" in rows[0] else "pixel_values"
            batch = np.stack([r[key] for r in rows])
            if len(idx) < batch_size:
                pad = np.repeat(batch[-1:], batch_size - len(idx), 0)
                batch = np.concatenate([batch, pad])
            pixels = torch.from_numpy(batch).to(device)
            if key == "pixel_u8":
                pixels = apply_resize(pixels, *resize_weights)
            mean, logvar = vae.encode(pixels)
            moments = torch.cat([mean, logvar], dim=-1).float().cpu().numpy()
            if out is None:
                out = np.empty((n, *moments.shape[1:]), np.float32)
            out[idx] = moments[: len(idx)]
    if log_fn:
        log_fn(f"cached latent moments for {n} images in {time.perf_counter() - t0:.1f}s "
               f"({out.nbytes / 1e6:.1f} MB host RAM)")
    return out


class LatentMomentsDataset:
    """Replaces a dataset row's pixels with its cached moments."""

    def __init__(self, dataset, moments: np.ndarray):
        if len(dataset) != len(moments):
            raise ValueError(f"{len(dataset)} rows but {len(moments)} cached moments")
        self.dataset = dataset
        self.moments = moments

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        row = dict(self.dataset[index])
        row.pop("pixel_u8", None)
        row.pop("pixel_values", None)
        row["latent_moments"] = self.moments[index]
        return row
