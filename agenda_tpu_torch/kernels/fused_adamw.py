"""One-pass int8 AdamW (+ EMA) update of a training step's parameter leaves:
the CUDA kernel's wrapper and its plain version.

Replaces ``agenda_tpu/kernels/fused_adamw.py::_kernel`` and ``::_kernel_ema``
(the Pallas TPU kernels, math at ``fused_adamw.py:61-108``), which run once
a leaf. ``fused_adamw8bit_leaves`` updates every leaf of a list in one launch
of ``csrc/fused_adamw.cu`` (one launch for up to the kernel's capacity of
leaves; ``leaf_plan`` says how a longer list is split) on CUDA tensors, and
takes ``fused_adamw8bit_leaves_reference`` (the per-leaf plain version,
``fused_adamw8bit_leaf_reference``, in a loop) only for CPU tensors; on CUDA
tensors it launches the kernel or raises. ``FusedLeaves`` keeps the checked
parameter and state pointers of a list between steps, so a step packs and
checks only its gradients. ``fused_adamw8bit_leaf`` is the one-leaf case. The
counts: ``fused_adamw8bit_leaves.launches`` (without EMA) and
``.launches_ema`` (with it) count kernel launches; ``.leaves`` and
``.leaves_ema`` the leaf updates those launches made.

Unlike the JAX function, which returns new arrays, both versions update
``p``, ``qm``, ``sm``, ``qv``, ``sv`` and ``ema`` IN PLACE (the TPU kernel
aliases the same buffers, ``fused_adamw.py:210-212``). The layout is
``train.optim._Quantized``'s: ``qm``/``qv`` int8 in the leaf's shape,
``sm``/``sv`` the f32 absmax of each 256-element row of the leaf's flat
order. ``scalars`` is a device f32 tensor [lr, clip scale, c1, c2] or [lr,
clip scale, c1, c2, decay] with the EMA shadows.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from agenda_tpu_torch.kernels import _build

BLOCK = 256  # quantization row (train/optim.py)
SPAN = 7.0  # log-code decades (train/optim.py)
ROWS_PER_PASS = 16  # rows a block of the kernel takes at a time
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


def fused_adamw8bit_leaves_reference(leaves, scalars, *, b1: float, b2: float, eps: float,
                                     weight_decay: float,
                                     emas: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Plain version of the one-launch update: the per-leaf plain version on
    each leaf (p, g, qm, sm, qv, sv) of ``leaves``, in place."""
    for i, leaf in enumerate(leaves):
        fused_adamw8bit_leaf_reference(*leaf, scalars, b1=b1, b2=b2, eps=eps,
                                       weight_decay=weight_decay,
                                       ema=None if emas is None else emas[i])


def leaf_plan(sizes: Sequence[int], capacity: int) -> List[Tuple[int, List[int]]]:
    """The kernel's launches for leaves of ``sizes`` elements, as the C entry
    splits them: consecutive runs of at most ``capacity`` leaves, each as
    (first leaf, the first row of each of its leaves and then its row
    count). Raises where the C entry refuses: an empty leaf, or a launch of
    2^31 - 17 rows or more."""
    if capacity <= 0:
        raise ValueError("capacity must be positive")
    plan = []
    for first in range(0, len(sizes), capacity):
        rows = [0]
        for n in sizes[first:first + capacity]:
            if n <= 0:
                raise ValueError("empty leaf")
            rows.append(rows[-1] + (n + BLOCK - 1) // BLOCK)
        if rows[-1] >= 2 ** 31 - 1 - ROWS_PER_PASS:
            raise ValueError(f"{rows[-1]} rows in one launch: more than the kernel indexes")
        plan.append((first, rows))
    return plan


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.load_library().function(
        "agenda_fused_adamw8bit_leaves",
        [_P, _P, ctypes.c_int, ctypes.c_int, _P] + [_F] * 6 + [_P])


@functools.lru_cache(maxsize=None)
def capacity() -> int:
    """The most leaves one launch takes (the kernel's parameter space)."""
    return _build.load_library().function("agenda_fused_adamw8bit_capacity", [])()


def _want(name, t, dtype, size, device) -> None:
    if t.dtype != dtype or t.numel() != size or t.device != device:
        raise ValueError(f"{name}: expected {size} {dtype} on {device}, got "
                         f"{t.numel()} {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous: the update is in place")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: the fused AdamW kernel needs 16-byte-aligned tensors")


class FusedLeaves:
    """A step's quantized leaves for ``fused_adamw8bit_leaves``: parameters
    and moments (p, qm, sm, qv, sv) and the EMA shadows, checked and their
    pointers packed once, since their storage stays put from step to step;
    calling it with a step's gradients checks and packs those and updates
    every leaf in place."""

    def __init__(self, statics: Sequence[Sequence[torch.Tensor]],
                 emas: Optional[Sequence[torch.Tensor]] = None):
        self.statics = [tuple(s) for s in statics]
        self.emas = None if emas is None else list(emas)
        if not self.statics:
            raise ValueError("no leaves")
        if self.emas is not None and len(self.emas) != len(self.statics):
            raise ValueError(f"{len(self.emas)} EMA shadows for {len(self.statics)} leaves")
        self.device = self.statics[0][0].device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the fused AdamW runs on cuda or cpu, not {self.device}")
        self.sizes = np.array([s[0].numel() for s in self.statics], dtype=np.int64)
        for i, (p, qm, sm, qv, sv) in enumerate(self.statics):
            n = p.numel()
            if n == 0:
                raise ValueError("empty leaf")
            nb = (n + BLOCK - 1) // BLOCK
            for name, t, dtype, size in (("p", p, torch.float32, n), ("qm", qm, torch.int8, n),
                                         ("sm", sm, torch.float32, nb),
                                         ("qv", qv, torch.int8, n),
                                         ("sv", sv, torch.float32, nb)):
                _want(f"leaf {i} {name}", t, dtype, size, self.device)
            if self.emas is not None:
                _want(f"leaf {i} ema", self.emas[i], torch.float32, n, self.device)
        if self.device.type == "cuda":
            count = len(self.statics)
            self.ptrs = np.zeros((7, count), dtype=np.int64)
            for s, k in ((0, 0), (2, 1), (3, 2), (4, 3), (5, 4)):
                self.ptrs[s] = [leaf[k].data_ptr() for leaf in self.statics]
            if self.emas is not None:
                self.ptrs[6] = [e.data_ptr() for e in self.emas]
            self.launches = len(leaf_plan(self.sizes.tolist(), capacity()))

    def matches(self, statics, emas=None) -> bool:
        """Whether ``statics`` and ``emas`` are this list's tensors, in order."""
        if len(statics) != len(self.statics) or (emas is None) != (self.emas is None):
            return False
        if any(a is not b for s, mine in zip(statics, self.statics) for a, b in zip(s, mine)):
            return False
        return emas is None or all(a is b for a, b in zip(emas, self.emas))

    def __call__(self, grads: Sequence[torch.Tensor], scalars: torch.Tensor, *, b1: float,
                 b2: float, eps: float, weight_decay: float) -> None:
        if len(grads) != len(self.statics):
            raise ValueError(f"{len(grads)} gradients for {len(self.statics)} leaves")
        for i, (g, n) in enumerate(zip(grads, self.sizes)):
            _want(f"leaf {i} g", g, torch.float32, int(n), self.device)
        if self.emas is not None and scalars.numel() < 5:
            raise ValueError("the EMA update reads its decay from scalars[4]")
        if scalars.numel() < 4:
            raise ValueError("scalars holds [lr, clip scale, c1, c2]")
        if scalars.dtype != torch.float32 or scalars.device != self.device:
            raise ValueError(f"scalars must be f32 on {self.device}")
        if self.device.type == "cpu":
            fused_adamw8bit_leaves_reference(
                [(s[0], g) + s[1:] for s, g in zip(self.statics, grads)], scalars, b1=b1,
                b2=b2, eps=eps, weight_decay=weight_decay, emas=self.emas)
            return
        self.ptrs[1] = [g.data_ptr() for g in grads]
        ema = self.emas is not None
        # 1 - b rounds from the double, as the JAX kernel's weakly typed constants do
        rc = _kernel()(self.ptrs.ctypes.data, self.sizes.ctypes.data, len(self.statics),
                       int(ema), scalars.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
                       weight_decay, _build.stream_ptr(self.device))
        _build.check(rc, "fused_adamw8bit_leaves")
        counts = fused_adamw8bit_leaves
        if ema:
            counts.launches_ema += self.launches
            counts.leaves_ema += len(self.statics)
        else:
            counts.launches += self.launches
            counts.leaves += len(self.statics)


def fused_adamw8bit_leaves(leaves, scalars, *, b1: float, b2: float, eps: float,
                           weight_decay: float,
                           emas: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Every leaf's int8 AdamW update (plus its EMA shadow's with ``emas``),
    in place, in one launch (or ``leaf_plan``'s count for a list longer than
    the kernel takes). ``leaves``: (p, g, qm, sm, qv, sv) a leaf.

    p, g, ema: f32, contiguous; qm, qv: int8 in p's shape; sm, sv: f32
    (ceil(n / 256),). On CUDA every tensor must be 16-byte aligned (as every
    fresh allocation is). An optimizer that steps the same leaves again keeps
    a ``FusedLeaves`` instead, which checks only the gradients each step.
    """
    leaves = list(leaves)
    FusedLeaves([(p, qm, sm, qv, sv) for p, _, qm, sm, qv, sv in leaves], emas)(
        [leaf[1] for leaf in leaves], scalars, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


fused_adamw8bit_leaves.launches = 0
fused_adamw8bit_leaves.launches_ema = 0
fused_adamw8bit_leaves.leaves = 0
fused_adamw8bit_leaves.leaves_ema = 0


def fused_adamw8bit_leaf(p, g, qm, sm, qv, sv, scalars, *, b1: float, b2: float, eps: float,
                         weight_decay: float, ema: Optional[torch.Tensor] = None):
    """One leaf's update: ``fused_adamw8bit_leaves`` of a one-leaf list (the
    same kernel, counted there). Returns (p, qm, sm, qv, sv) and ema when
    given, the same tensors, updated in place."""
    fused_adamw8bit_leaves([(p, g, qm, sm, qv, sv)], scalars, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, emas=None if ema is None else [ema])
    return (p, qm, sm, qv, sv) if ema is None else (p, qm, sm, qv, sv, ema)
