"""One-pass int8 AdamW (+ EMA) update of one parameter leaf: the CUDA kernel's
wrapper and its plain version.

Replaces ``agenda_tpu/kernels/fused_adamw.py::_kernel`` and ``::_kernel_ema``
(the Pallas TPU kernels, math at ``fused_adamw.py:61-108``).
``fused_adamw8bit_leaf`` launches ``csrc/fused_adamw.cu`` on CUDA tensors and
takes ``fused_adamw8bit_leaf_reference`` only for CPU tensors; on a CUDA
tensor it launches the kernel or raises. It counts its launches in
``fused_adamw8bit_leaf.launches`` (without EMA) and
``fused_adamw8bit_leaf.launches_ema`` (with it).

Unlike the JAX function, which returns new arrays, both versions update
``p``, ``qm``, ``sm``, ``qv``, ``sv`` and ``ema`` IN PLACE (the TPU kernel
aliases the same buffers, ``fused_adamw.py:210-212``) and return them. The
layout is ``train.optim._Quantized``'s: ``qm``/``qv`` int8 in the leaf's
shape, ``sm``/``sv`` the f32 absmax of each 256-element row of the leaf's
flat order. ``scalars`` is a device f32 tensor [lr, clip scale, c1, c2] or
[lr, clip scale, c1, c2, decay] with ``ema``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from agenda_tpu_torch.kernels import _build

BLOCK = 256  # quantization row (train/optim.py)
SPAN = 7.0  # log-code decades (train/optim.py)
_LN10 = math.log(10.0)

_P = ctypes.c_void_p
_F = ctypes.c_float


def _deq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 rows (nb, 256) and f32 scales (nb, 1) -> f32 values (the kernel's deq)."""
    qf = q.float()
    mag = qf.abs()
    val = torch.where(mag > 0.0, torch.sign(qf) * torch.exp((_LN10 * SPAN / 126.0) * (mag - 127.0)),
                      torch.zeros((), dtype=torch.float32, device=q.device))
    return val * s


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rows (nb, 256) -> (int8 codes, f32 row absmax (nb, 1)) (the kernel's quant)."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    safe = torch.clamp(absmax, min=1e-30)
    ratio = x.abs() / safe
    mag = torch.round(127.0 + (126.0 / SPAN) * (torch.log(torch.clamp(ratio, min=1e-30)) / _LN10))
    mag = torch.clamp(mag, 0.0, 127.0)
    return (torch.sign(x) * mag).to(torch.int8), absmax


def _rows(x: torch.Tensor, nb: int) -> torch.Tensor:
    """A leaf's flat order as (nb, 256), zero-padded past its end (a copy)."""
    flat = x.reshape(-1)
    out = torch.zeros(nb * BLOCK, dtype=x.dtype, device=x.device)
    out[: flat.numel()] = flat
    return out.reshape(nb, BLOCK)


def fused_adamw8bit_leaf_reference(p, g, qm, sm, qv, sv, scalars, *, b1: float, b2: float,
                                   eps: float, weight_decay: float,
                                   ema: Optional[torch.Tensor] = None):
    """Plain version of the kernel: the same update in torch ops, in place."""
    n = p.numel()
    nb = (n + BLOCK - 1) // BLOCK
    lr, gscale, c1, c2 = (scalars[i] for i in range(4))
    gr = _rows(g.float(), nb) * gscale
    pr = _rows(p, nb)
    m = _deq(_rows(qm, nb), sm.reshape(nb, 1))
    v = _deq(_rows(qv, nb), sv.reshape(nb, 1))
    m = b1 * m + (1.0 - b1) * gr
    v = b2 * v + (1.0 - b2) * gr * gr
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    p2 = pr - lr * (u + weight_decay * pr)
    cm, new_sm = _quant(m)
    cv, new_sv = _quant(v)

    def put(dst, rows):
        dst.copy_(rows.reshape(-1)[:n].reshape(dst.shape))

    put(p, p2)
    put(qm, cm)
    put(qv, cv)
    sm.copy_(new_sm.reshape(sm.shape))
    sv.copy_(new_sv.reshape(sv.shape))
    if ema is None:
        return p, qm, sm, qv, sv
    decay = scalars[4]
    put(ema, _rows(ema, nb) * decay + (1.0 - decay) * p2)
    return p, qm, sm, qv, sv, ema


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.load_library().function(
        "agenda_fused_adamw8bit",
        [_P] * 8 + [ctypes.c_longlong] + [_F] * 6 + [_P])


def _check(p, g, qm, sm, qv, sv, scalars, ema) -> None:
    n = p.numel()
    nb = (n + BLOCK - 1) // BLOCK
    want = {"p": (p, torch.float32, n), "g": (g, torch.float32, n), "qm": (qm, torch.int8, n),
            "sm": (sm, torch.float32, nb), "qv": (qv, torch.int8, n),
            "sv": (sv, torch.float32, nb)}
    if ema is not None:
        want["ema"] = (ema, torch.float32, n)
        if scalars.numel() < 5:
            raise ValueError("the EMA update reads its decay from scalars[4]")
    elif scalars.numel() < 4:
        raise ValueError("scalars holds [lr, clip scale, c1, c2]")
    for name, (t, dtype, size) in want.items():
        if t.dtype != dtype or t.numel() != size or t.device != p.device:
            raise ValueError(f"{name}: expected {size} {dtype} on {p.device}, got "
                             f"{t.numel()} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: the update is in place")
    if scalars.dtype != torch.float32 or scalars.device != p.device:
        raise ValueError(f"scalars must be f32 on {p.device}")
    if n == 0:
        raise ValueError("empty leaf")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused AdamW runs on cuda or cpu, not {p.device}")


def fused_adamw8bit_leaf(p, g, qm, sm, qv, sv, scalars, *, b1: float, b2: float, eps: float,
                         weight_decay: float, ema: Optional[torch.Tensor] = None):
    """One leaf's int8 AdamW update (plus the EMA shadow's with ``ema``), in
    place. Returns (p, qm, sm, qv, sv) and ema when given, the same tensors.

    p, g, ema: f32, contiguous; qm, qv: int8 in p's shape; sm, sv: f32
    (ceil(n / 256),). On CUDA p, g and ema must be 16-byte aligned and qm, qv
    4-byte aligned (as every fresh allocation is).
    """
    _check(p, g, qm, sm, qv, sv, scalars, ema)
    if p.device.type == "cpu":
        return fused_adamw8bit_leaf_reference(p, g, qm, sm, qv, sv, scalars, b1=b1, b2=b2,
                                              eps=eps, weight_decay=weight_decay, ema=ema)
    if any(t.data_ptr() % 16 for t in (p, g) + ((ema,) if ema is not None else ())) or any(
            t.data_ptr() % 4 for t in (qm, qv)):
        raise ValueError("the fused AdamW kernel needs 16-byte-aligned p, g, ema and "
                         "4-byte-aligned qm, qv")
    # 1 - b rounds from the double, as the JAX kernel's weakly typed constants do
    rc = _kernel()(p.data_ptr(), g.data_ptr(), qm.data_ptr(), sm.data_ptr(), qv.data_ptr(),
                   sv.data_ptr(), None if ema is None else ema.data_ptr(), scalars.data_ptr(),
                   p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
                   _build.stream_ptr(p.device))
    _build.check(rc, "fused_adamw8bit_leaf")
    if ema is None:
        fused_adamw8bit_leaf.launches += 1
        return p, qm, sm, qv, sv
    fused_adamw8bit_leaf.launches_ema += 1
    return p, qm, sm, qv, sv, ema


fused_adamw8bit_leaf.launches = 0
fused_adamw8bit_leaf.launches_ema = 0
