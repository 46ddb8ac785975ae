"""Separable resizes as weight matrices applied with ``torch.einsum``.

Two kernels, both Keys cubic with a = -0.5:

- ``cubic_weights`` / ``resize_bicubic``: ``jax.image.resize(method="cubic")``
  exactly as ``jax._src.image.scale.compute_weight_mat`` builds it -- the
  kernel widened by the scale when downscaling (antialias), per-output
  normalisation, zero weight where the sample lies outside the input. The
  pipeline uses it for the DAAM maps and the 512 -> 112 image resize.
  (``F.interpolate(mode="bicubic")`` uses a = -0.75, clamps at the borders
  and does not antialias, so it does not match.)
- ``pil_bicubic_weights`` / ``resize_uint8_pil``: Pillow's 8-bit BICUBIC
  ``Image.resize`` (the CLI's 64 -> 112 heatmap upscale): PIL's support
  window, coefficients quantised to 22 fractional bits, horizontal pass then
  vertical, each rounded and clipped to uint8. On the card it matches PIL
  within 1 LSB.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PIL_PRECISION_BITS = 22  # 32 - 8 - 2, Pillow's 8-bit resample precision


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax's _fill_keys_cubic_kernel on |x| (a = -0.5)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cubic_np(in_size: int, out_size: int) -> np.ndarray:
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(f32))  # (in, out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))  # (out, in)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    # cached per device so that the sampling loop copies no weights to the card
    w = _cubic_np(in_size, out_size) if kind == "cubic" else _pil_np(in_size, out_size)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def cubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) f32 weights of jax.image.resize 'cubic' along one axis."""
    return _on_device("cubic", in_size, out_size, torch.device(device or "cpu"))


def resize_bicubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Resize the trailing two dims of f32 x like jax.image.resize 'cubic'."""
    in_h, in_w = x.shape[-2:]
    if (in_h, in_w) == (h, w):
        return x  # jax skips unchanged dims; the kernel is an identity there
    wy = cubic_weights(in_h, h, x.device)
    wx = cubic_weights(in_w, w, x.device)
    return torch.einsum("Hh,...hw,Ww->...HW", wy, x, wx)


def _pil_bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


@functools.lru_cache(maxsize=None)
def _pil_np(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    one = 1 << _PIL_PRECISION_BITS
    w = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = np.array([_pil_bicubic((x - center + 0.5) / filterscale)
                      for x in range(xmin, xmax)])
        if k.sum() != 0.0:
            k = k / k.sum()
        # Pillow's normalize_coeffs_8bpc: round half away from zero to fixed point
        q = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one))
        w[xx, xmin:xmax] = q / one
    return w


def pil_bicubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) f32 weights of Pillow's 8-bit BICUBIC resize along one axis."""
    return _on_device("pil", in_size, out_size, torch.device(device or "cpu"))


def resize_uint8_pil(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """uint8 (..., H, W) -> uint8 (..., h, w), Pillow's BICUBIC resize."""
    y = x.float()
    in_h, in_w = x.shape[-2:]
    if in_w != w:  # horizontal pass first, as Pillow does
        y = torch.einsum("...hw,Ww->...hW", y, pil_bicubic_weights(in_w, w, x.device))
        y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)
    if in_h != h:
        y = torch.einsum("Hh,...hw->...Hw", pil_bicubic_weights(in_h, h, x.device), y)
        y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)
    return y.to(torch.uint8)
