"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces ``agenda_tpu/kernels/flash.py::_flash_fwd_kernel`` (the Pallas TPU
kernel). ``flash_attention_fwd`` launches ``csrc/flash_fwd.cu`` on CUDA
tensors and takes the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises. ``flash_attention_fwd.launches`` counts the
kernel launches. The backward kernels (TPU K2/K3) come with the trainer.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from agenda_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 softmax(Q K^T / sqrt(D)) V and the row logsumexp.

    q, k, v: (B, S, H, D) -> (out (B, S, H, D) in q.dtype, lse (B*H, S) f32).
    """
    b, s, h, d = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.matmul(torch.exp(logits - lse[..., None]), vf)
    return out.permute(0, 2, 1, 3).to(q.dtype), lse.reshape(b * h, s)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.function("agenda_flash_fwd", [_P] * 5 + [_I] * 4 + [_L] * 12 + [_P])
    max_d = lib.function("agenda_flash_fwd_max_head_dim", [])()
    return fn, max_d


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash attention takes equal (B, S, H, D) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal unmasked attention over (B, S, H, D) for any S.

    Returns (out (B, S, H, D), lse (B*H, S) f32). CUDA tensors must be bf16
    with a unit-stride head dim that is a multiple of 8; the kernel copies
    16-byte chunks, so the other strides must be multiples of 8 and the data
    16-byte aligned. Such strides are read as they are.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernel takes bf16, got {q.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the flash kernel needs a unit-stride head dim")
    if any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("the flash kernel needs 16-byte-aligned q, k, v with batch, "
                         "sequence and head strides that are multiples of 8")
    fn, max_d = _kernel()
    b, s, h, d = q.shape
    if d % 8 or d > max_d:
        raise ValueError(f"the flash kernel takes a head dim that is a multiple of 8 up to "
                         f"{max_d}, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds 65535")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
