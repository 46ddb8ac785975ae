"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd ``Function`` that joins them.

Replaces the Pallas TPU kernels of ``agenda_tpu/kernels/flash.py``:

- ``flash_attention_fwd`` -> ``csrc/flash_fwd.cu`` (``_flash_fwd_kernel``);
- ``flash_attention_bwd_dkv`` -> ``csrc/flash_bwd.cu`` (``_flash_bwd_dkv_kernel``);
- ``flash_attention_bwd_dq`` -> ``csrc/flash_bwd.cu`` (``_flash_bwd_dq_kernel``).

Each wrapper launches its kernel on CUDA tensors and takes its plain version
only for CPU tensors; on a CUDA tensor it launches the kernel or raises. Each
counts its kernel launches in ``<wrapper>.launches``. ``flash_attention``
mirrors the JAX ``custom_vjp`` (``flash.py:295-312``): the forward saves the
output and the row logsumexp, the backward computes delta = rowsum(dO * O)
in f32 outside the kernels (``flash.py:235``) and returns the gradients in
the input dtype (``flash.py:306-309``).
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


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta):
    """Plain dK/dV: (B, S, H, D) q, k, v, dO; lse, delta (B*H, S) f32 ->
    (dk, dv) in q.dtype, f32 inside (``_flash_bwd_dkv_kernel``'s math)."""
    qf, kf, vf, dof, p, ds, scale = _bwd_terms(q, k, v, do, lse, delta)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return _from_heads(dk, q.dtype), _from_heads(dv, q.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta):
    """Plain dQ, same inputs -> dq in q.dtype (``_flash_bwd_dq_kernel``'s math)."""
    qf, kf, vf, dof, p, ds, scale = _bwd_terms(q, k, v, do, lse, delta)
    return _from_heads(torch.matmul(ds, kf) * scale, q.dtype)


def _bwd_terms(q, k, v, do, lse, delta):
    """P = exp(Q K^T scale - lse) and dS = P (dO V^T - delta), all f32 (B, H, S, S)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(logits - lse.reshape(b, h, s, 1))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, s, 1))
    return qf, kf, vf, dof, p, ds, scale


def _from_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, S, D) f32 -> (B, S, H, D) in dtype."""
    return x.permute(0, 2, 1, 3).to(dtype)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, S, H, D) -> (B*H, S)."""
    b, s, h, _ = out.shape
    delta = (do.float() * out.float()).sum(dim=-1)  # (B, S, H)
    return delta.permute(0, 2, 1).reshape(b * h, s).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do):
    """Plain backward of ``flash_attention``: (dq, dk, dv) in q.dtype."""
    delta = flash_delta(out, do)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta)
    return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta), dk, dv


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.function("agenda_flash_fwd", [_P] * 5 + [_I] * 4 + [_L] * 12 + [_P])
    max_d = lib.function("agenda_flash_fwd_max_head_dim", [])()
    return fn, max_d


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = _build.load_library()
    ptrs = [_P] * 6
    dkv = lib.function("agenda_flash_bwd_dkv", ptrs + [_P, _P] + [_I] * 4 + [_P, _P])
    dq = lib.function("agenda_flash_bwd_dq", ptrs + [_P] + [_I] * 4 + [_P, _P])
    max_d = lib.function("agenda_flash_bwd_max_head_dim", [])()
    return dkv, dq, max_d


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, *more)):
        raise ValueError(f"flash attention takes equal (B, S, H, D) q/k/v, got "
                         f"{[tuple(t.shape) for t in (q, k, v, *more)]}")
    if any(t.device != q.device for t in (k, v, *more)):
        raise ValueError("q, k and v must be on one device")
    if any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError("q, k and v must share one dtype")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _check_cuda(name: str, tensors, max_d: int) -> None:
    """What the CUDA kernels take: bf16, unit-stride D, 16-byte chunks, D <= max_d."""
    q = tensors[0]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes bf16, got {q.dtype}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"the {name} kernel needs a unit-stride head dim")
    if any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in tensors):
        raise ValueError(f"the {name} kernel needs 16-byte-aligned inputs with batch, "
                         "sequence and head strides that are multiples of 8")
    b, _, h, d = q.shape
    if d % 8 or d > max_d:
        raise ValueError(f"the {name} kernel takes a head dim that is a multiple of 8 up to "
                         f"{max_d}, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds 65535")


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
    fn, max_d = _kernel()
    _check_cuda("flash", (q, k, v), max_d)
    b, s, h, d = q.shape
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


def _stats_on(lse: torch.Tensor, delta: torch.Tensor, q: torch.Tensor) -> None:
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b * h, s) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be (B*H, S) = {(b * h, s)} f32 on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _bwd_args(q, k, v, do, lse, delta):
    """Pointers, dims and the 12 input strides (q, k, v, dO) of a backward launch."""
    strides = (ctypes.c_longlong * 12)(*[st for t in (q, k, v, do) for st in t.stride()[:3]])
    return [t.data_ptr() for t in (q, k, v, do, lse, delta)], list(q.shape), strides


def flash_attention_bwd_dkv(q, k, v, do, lse, delta):
    """dK, dV of non-causal unmasked attention over (B, S, H, D) for any S.

    lse and delta are (B*H, S) f32. CUDA tensors: as ``flash_attention_fwd``
    takes them, with D up to 512 (above 160 the wide mma.sync kernels); dk
    and dv come back contiguous bf16.
    """
    _check(q, k, v, do)
    _stats_on(lse, delta, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta)
    fn, _, max_d = _bwd_kernels()
    _check_cuda("flash backward", (q, k, v, do), max_d)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse, delta = lse.contiguous(), delta.contiguous()
    ptrs, dims, strides = _bwd_args(q, k, v, do, lse, delta)
    rc = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, strides, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta):
    """dQ, same inputs as ``flash_attention_bwd_dkv``; dq contiguous bf16 on CUDA."""
    _check(q, k, v, do)
    _stats_on(lse, delta, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta)
    _, fn, max_d = _bwd_kernels()
    _check_cuda("flash backward", (q, k, v, do), max_d)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse, delta = lse.contiguous(), delta.contiguous()
    ptrs, dims, strides = _bwd_args(q, k, v, do, lse, delta)
    rc = fn(*ptrs, dq.data_ptr(), *dims, strides, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """out = softmax(Q K^T / sqrt(D)) V with the flash kernels both ways."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.device.type == "cuda" and (do.stride(-1) != 1 or any(
                st % 8 for st in do.stride()[:3]) or do.data_ptr() % 16):
            do = do.contiguous()
        delta = flash_delta(out, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable flash attention over (B, S, H, D). Without autograd (no
    input requires grad, or under ``torch.no_grad``) it is one forward launch
    and saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)[0]
