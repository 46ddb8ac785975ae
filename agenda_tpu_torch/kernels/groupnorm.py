"""Fused GroupNorm(+SiLU): the CUDA kernel's wrapper and its plain version.

Replaces ``agenda_tpu/kernels/groupnorm.py::_gn_kernel`` (the Pallas TPU
kernel). The JAX package's model defaults to flax ``nn.GroupNorm``; the
numerics here are flax's (``_compute_stats`` with fast variance, clamped at
0). ``group_norm_act`` launches ``csrc/groupnorm.cu`` for every GroupNorm of
a CUDA model and takes the plain version only for CPU tensors;
``group_norm_act.launches`` counts the kernel launches.

``group_norm_act`` is differentiable, as the JAX ``custom_vjp`` is
(``groupnorm.py:193-217``): the forward is the kernel, the backward is the
VJP of ``group_norm_act_reference`` recomputed in f32 from the saved input
(``groupnorm.py:208-214``). There is no backward kernel: the JAX package has
none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from agenda_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def group_norm_act_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Plain version on (B, C, *spatial): f32 statistics, output in x.dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    meansq = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(torch.clamp(meansq - mean * mean, min=0.0) + eps)
    y = ((xf - mean) * rstd).reshape(b, c, -1)
    y = y * weight.float()[None, :, None] + bias.float()[None, :, None]
    if act == "silu":
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)


def _empty_aligned_as(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor like x whose address agrees with x's mod
    16: the kernel moves 16-byte chunks from the same offsets of both."""
    off = (x.data_ptr() % 16) // x.element_size()
    if off == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + 16 // x.element_size(), dtype=x.dtype, device=x.device)
    return buf[off:off + x.numel()].view(x.shape)


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.load_library().function(
        "agenda_groupnorm", [_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, _P])


def _group_norm_act_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """The forward: the kernel on CUDA, the plain version on the CPU."""
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    if x.dim() < 3:
        raise ValueError(f"group norm takes (B, C, *spatial), got {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{c} channels, {groups} groups, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return group_norm_act_reference(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the group-norm kernel takes bf16, got {x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("the group-norm kernel takes f32 weight and bias")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("the group-norm kernel takes contiguous NCHW input")
    if not (weight.device == bias.device == x.device):
        raise ValueError("x, weight and bias must be on one device")
    b = x.shape[0]
    hw = x[0, 0].numel()
    y = _empty_aligned_as(x)
    rc = _kernel()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                   b, c, hw, groups, float(eps), 1 if act == "silu" else 0,
                   _build.stream_ptr(x.device))
    _build.check(rc, "group_norm_act")
    group_norm_act.launches += 1
    return y


class _GroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (groups, eps, act)
        return _group_norm_act_fwd(x, weight, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
            y = group_norm_act_reference(*leaves, *ctx.args)
        dx, dw, db = torch.autograd.grad(y, leaves, dy)
        return dx, dw, db, None, None, None


def group_norm_act(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of x (B, C, *spatial); weight, bias (C,).

    CUDA: x contiguous bf16 of any H*W and offset (the kernel moves each
    span's unaligned head and tail one element at a time and maps each
    element to its channel), weight and bias f32. Differentiable in x,
    weight and bias; without autograd it is one kernel launch and saves
    nothing.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return _GroupNormAct.apply(x, weight, bias, groups, eps, act)
    return _group_norm_act_fwd(x, weight, bias, groups, eps, act)


group_norm_act.launches = 0
