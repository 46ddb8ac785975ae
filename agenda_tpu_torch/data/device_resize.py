"""Resize of the uint8 training tiles on the device, with Pillow's filters.

Counterpart of ``agenda_tpu/data/device_resize.py:40-76``. The trainer ships
each source tile as uint8 and resizes it where the model runs, as two
separable filter products out = W_h @ img @ W_w^T per channel.
``resize_weights`` builds Pillow's filter matrix (support window, half-pixel
centres, per-position normalisation); each pass rounds and clamps to the
uint8 range as Pillow's 8-bit resample does, so the result agrees with
Pillow's ``resize`` to about one level. ``resize_levels`` is the detector's
eval-time resize (``agenda_tpu/detect/runner.py:712-725``): both passes in
f32, then one rounding to a level.
"""

from __future__ import annotations

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < 3.0, np.sinc(x) * np.sinc(x / 3.0), 0.0)


_FILTERS = {"bilinear": (_triangle, 1.0), "lanczos": (_lanczos3, 3.0)}


def resize_weights(src: int, dst: int, filt: str = "lanczos") -> np.ndarray:
    """(dst, src) f32 row-stochastic filter matrix, Pillow semantics."""
    kernel, support0 = _FILTERS[filt]
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    w = np.zeros((dst, src), np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(src, int(center + support + 0.5))
        xs = np.arange(xmin, xmax)
        ww = kernel((xs - center + 0.5) / filterscale)
        s = ww.sum()
        if s != 0:
            w[i, xmin:xmax] = ww / s
    return w.astype(np.float32)


def apply_resize(pixels_u8: torch.Tensor, wy, wx, half_up: bool = False) -> torch.Tensor:
    """(B, h, w, 3) uint8 -> (B, H, W, 3) f32 in [-1, 1], on pixels_u8's device.

    The width pass runs first, then the height pass, as in Pillow. Each pass
    rounds half to even, as the JAX package's device resize does;
    ``half_up`` rounds ties up, as Pillow's 8-bit resample does (a bilinear
    upscale lands on ties at most pixels), for the host path that stands in
    for Pillow.
    """
    dev = pixels_u8.device
    wy = torch.as_tensor(np.asarray(wy), dtype=torch.float32).to(dev)
    wx = torch.as_tensor(np.asarray(wx), dtype=torch.float32).to(dev)

    def to_level(v):
        v = torch.clamp(v, 0.0, 255.0)
        return torch.floor(v + 0.5) if half_up else torch.round(v)

    x = pixels_u8.float()
    x = to_level(torch.einsum("Ww,bhwc->bhWc", wx, x))
    x = to_level(torch.einsum("Hh,bhwc->bHwc", wy, x))
    return x / 255.0 * 2.0 - 1.0


def resize_levels(pixels_u8: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
                  half_up: bool = False) -> torch.Tensor:
    """(B, h, w, 3) uint8 -> (B, H, W, 3) f32 levels in [0, 255].

    Width pass, then height pass, both in f32, then one clamp and one
    rounding: half to even as the JAX package's device resize
    (``jnp.round``), or half up (``half_up``) as its native host resize,
    which stands in for Pillow there. ``wy`` and ``wx`` are f32 tensors on
    pixels_u8's device.
    """
    x = pixels_u8.float()
    x = torch.einsum("Ww,bhwc->bhWc", wx, x)
    x = torch.einsum("Hh,bhwc->bHwc", wy, x).clamp_(0.0, 255.0)
    return torch.floor(x + 0.5) if half_up else torch.round(x)
