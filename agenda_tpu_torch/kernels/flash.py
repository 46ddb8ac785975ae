"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd ``Function`` that joins them.

Replaces the Pallas TPU kernels of ``agenda_tpu/kernels/flash.py``:

- ``flash_attention_fwd`` -> ``csrc/flash_fwd.cu`` (``_flash_fwd_kernel``);
- ``flash_attention_bwd_dkv`` -> ``csrc/flash_bwd.cu`` (``_flash_bwd_dkv_kernel``);
- ``flash_attention_bwd_dq`` -> ``csrc/flash_bwd.cu`` (``_flash_bwd_dq_kernel``);
- on f32 operands (``--mixed_precision no``), as the TPU kernels take f32 as
  they take bf16, every kernel runs the tensor cores on three bf16 pieces of
  each operand, which the pre-pass ``flash_f32_split`` writes: the forward
  (up to D = 512) -> ``csrc/flash_fwd_f32.cu``; dK/dV and dQ, from the
  pieces of q, k, v and dO, up to D = 160 -> ``csrc/flash_bwd_f32.cu`` (one
  pass, no scratch); above 160 (f32 VAE pretraining's mid-block D = 512)
  -> ``csrc/flash_bwd_f32_wide.cu``: over the chunks of
  ``f32_wide_bwd_plan``, a scores pass ``f32_wide_bwd_scores`` (P and dS
  into scratch) and the gradient products ``f32_wide_bwd_products``.

Each wrapper launches its kernel on CUDA tensors and takes its plain version
only for CPU tensors; on a CUDA tensor it launches the bf16 kernel for bf16,
the f32 kernel for f32, and raises for any other dtype. Each counts its
kernel launches in ``<wrapper>.launches`` and the f32 kernel's among them in
``<wrapper>.launches_f32``; each also counts its launches at D > 160 (the
wide kernels of the bf16 path; the f32 ones above that D) in
``<wrapper>.launches_wide``; the pre-pass counts its own in
``flash_f32_split.launches`` (one launch an f32 forward, one an f32
backward through ``flash_attention``, whose two entries share its pieces,
and one an f32 dK/dV or dQ called alone), and the wide f32 backward's other
passes theirs in ``f32_wide_bwd_scores.launches`` and
``f32_wide_bwd_products.launches``.
``flash_attention`` mirrors the JAX ``custom_vjp`` (``flash.py:295-312``):
the forward saves the output and the row logsumexp, the backward computes
delta = rowsum(dO * O) in f32 outside the kernels (``flash.py:235``) and
returns the gradients in the input dtype (``flash.py:306-309``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import torch

from agenda_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
WIDE_ABOVE = 160  # csrc/flash_fwd.cu's kMaxWgmmaHeadDim: a larger D runs the wide kernel


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in its own dtype where that is wider (float64: the
    references the f32 kernels are held to on the card)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 softmax(Q K^T / sqrt(D)) V and the row logsumexp
    (float64 throughout for float64 inputs).

    q, k, v: (B, S, H, D) -> (out (B, S, H, D) in q.dtype, lse (B*H, S) f32).
    """
    b, s, h, d = q.shape
    qf, kf, vf = (_wide(t).permute(0, 2, 1, 3) for t in (q, k, v))
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
    """P = exp(Q K^T scale - lse) and dS = P (dO V^T - delta), all f32 (B, H, S, S)
    (float64 for float64 inputs)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (_wide(t).permute(0, 2, 1, 3) for t in (q, k, v, do))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(logits - _wide(lse).reshape(b, h, s, 1))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - _wide(delta).reshape(b, h, s, 1))
    return qf, kf, vf, dof, p, ds, scale


def _from_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, S, D) f32 -> (B, S, H, D) in dtype."""
    return x.permute(0, 2, 1, 3).to(dtype)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32 (float64 for float64 inputs), (B, S, H, D)
    -> (B*H, S)."""
    b, s, h, _ = out.shape
    delta = (_wide(do) * _wide(out)).sum(dim=-1)  # (B, S, H)
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
def _f32_kernels():
    """``csrc/flash_fwd_f32.cu`` and ``csrc/flash_bwd_f32.cu``: (split,
    forward, backward (dK/dV or dQ), the forward's and the backward's largest
    head dim)."""
    lib = _build.load_library()
    split = lib.function("agenda_flash_f32_split", [_P] * 5 + [_I] * 4 + [_P, _P])
    fwd = lib.function("agenda_flash_fwd_f32", [_P] * 3 + [_I] * 4 + [_P])
    bwd = lib.function("agenda_flash_bwd_f32", [_P] * 5 + [_I] * 5 + [_P])
    max_fwd = lib.function("agenda_flash_fwd_f32_max_head_dim", [])()
    max_bwd = lib.function("agenda_flash_bwd_f32_max_head_dim", [])()
    return split, fwd, bwd, max_fwd, max_bwd


@functools.lru_cache(maxsize=None)
def _f32_wide_bwd_kernels():
    """``csrc/flash_bwd_f32_wide.cu`` (D above ``csrc/flash_bwd_f32.cu``'s):
    (the scores pass, the gradient products, the largest head dim)."""
    lib = _build.load_library()
    scores = lib.function("agenda_flash_f32_wide_scores", [_P] * 4 + [_I] * 9 + [_P])
    products = lib.function("agenda_flash_f32_wide_products", [_P] * 4 + [_I] * 10 + [_P])
    return scores, products, lib.function("agenda_flash_f32_wide_bwd_max_head_dim", [])()


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


def _chunked(t: torch.Tensor) -> bool:
    """16-byte-aligned with batch, sequence and head strides of whole 16-byte chunks."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % per == 0 for st in t.stride()[:3])


def _check_cuda(name: str, tensors, max_d: int) -> None:
    """What the CUDA kernels take: bf16 or f32, unit-stride D, 16-byte chunks,
    D <= max_d (the caller's, by dtype)."""
    q = tensors[0]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the {name} kernels take bf16 or f32, got {q.dtype}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"the {name} kernel needs a unit-stride head dim")
    if not all(_chunked(t) for t in tensors):
        raise ValueError(f"the {name} kernel needs 16-byte-aligned inputs with batch, "
                         "sequence and head strides of whole 16-byte chunks")
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
    (D up to 512) or f32 (``csrc/flash_fwd_f32.cu``, D up to 512) with a
    unit-stride head dim that is a multiple of 8; the kernels copy 16-byte
    chunks, so the other strides must be whole chunks (multiples of 8 bf16
    or 4 f32 elements) and the data 16-byte aligned. Such strides are read
    as they are.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    f32 = q.dtype == torch.float32
    _check_cuda("flash", (q, k, v), _f32_kernels()[3] if f32 else _kernel()[1])
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if f32:
        pieces = flash_f32_split(q, k, v)
        rc = _f32_kernels()[1](pieces.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h, d,
                               _build.stream_ptr(q.device))
    else:
        strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
        rc = _kernel()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          lse.data_ptr(), b, s, h, d, *strides, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_f32 += int(f32)
    if d > WIDE_ABOVE:
        flash_attention_fwd.launches_wide += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_f32 = 0
flash_attention_fwd.launches_wide = 0


def flash_f32_split_reference(*operands: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32 pre-pass: (3 n, B, S, H, D) bf16 for n
    operands (q, k, v for the forward; q, k, v, dO for the wide backward),
    plane 3 t + i the piece i of operand t, b0 = bf16(x), b1 = bf16(x - b0),
    b2 = bf16(x - b0 - b1), so that b0 + b1 + b2 = x (the remainders are
    exact in f32)."""
    planes = []
    for x in operands:
        rest = x.float()
        for _ in range(3):
            piece = rest.to(torch.bfloat16)
            planes.append(piece)
            rest = rest - piece.float()
    return torch.stack(planes)


def flash_f32_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor = None) -> torch.Tensor:
    """The f32 pre-pass (``csrc/flash_fwd_f32.cu``): f32 (B, S, H, D) q, k, v,
    taken as ``flash_attention_fwd`` takes them, and for the f32 backward dO
    too -> their bf16 pieces as ``flash_f32_split_reference`` lays them out
    (nine planes, or twelve with dO), contiguous."""
    ops = (q, k, v) if do is None else (q, k, v, do)
    _check(*ops)
    if q.dtype != torch.float32:
        raise TypeError(f"the f32 split takes f32, got {q.dtype}")
    if q.device.type == "cpu":
        return flash_f32_split_reference(*ops)
    split, _, _, max_d, _ = _f32_kernels()
    _check_cuda("flash f32 split", ops, max_d)
    b, s, h, d = q.shape
    pieces = torch.empty((3 * len(ops), b, s, h, d), dtype=torch.bfloat16, device=q.device)
    strides = (ctypes.c_longlong * 12)(*[st for t in ops for st in t.stride()[:3]])
    rc = split(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if do is None else do.data_ptr(),
               pieces.data_ptr(), b, s, h, d, strides, _build.stream_ptr(q.device))
    _build.check(rc, "flash_f32_split")
    flash_f32_split.launches += 1
    return pieces


flash_f32_split.launches = 0

# The most bytes of P and dS pieces one wide f32 backward call holds at once
# (``f32_wide_bwd_plan`` chunks the work under it): 12 bytes an element of
# the S x S matrix in the dK/dV entry, 6 in the dQ, so 96 MiB at (8, 1024,
# 1, 512) and 384 MiB at (2, 4096, 1, 512) are one chunk, while a 1024-px
# mid-block (S = 16384, 3 GiB a head) is cut into query chunks.
F32_WIDE_BWD_SCRATCH = 1 << 30


def _up128(n: int) -> int:
    """n rounded up to a multiple of 128, as the scratch's columns are."""
    return -(-n // 128) * 128


def f32_wide_bwd_scratch_bytes(s: int, nbh: int, nq: int, dkv: bool) -> int:
    """Bytes of scratch a chunk of ``nbh`` (batch, head) pairs and ``nq``
    queries takes: P^T's and dS^T's pieces, S x nq (rounded up to 128), for
    the dK/dV entry; dS's, nq x S (rounded up to 128), for the dQ."""
    return (6 * s * _up128(nq) if dkv else 3 * nq * _up128(s)) * nbh * 2


def f32_wide_bwd_plan(b: int, s: int, h: int, dkv: bool) -> List[Tuple[int, int, int, int]]:
    """The chunks (bh0, nbh, q0, nq) of a wide f32 backward call, in launch
    order, whose scratch each stays within ``F32_WIDE_BWD_SCRATCH`` bytes:
    as many whole (batch, head) pairs a chunk as fit; where one does not,
    one pair a chunk and its queries in runs of a multiple of 128 (at least
    128, whatever the cap), in order, so that the dK/dV sums continue tile
    by tile from chunk to chunk."""
    cap = F32_WIDE_BWD_SCRATCH
    bh = b * h
    whole = f32_wide_bwd_scratch_bytes(s, 1, s, dkv)
    if whole <= cap:
        n = max(1, min(bh, cap // whole, 32767))
        return [(i, min(n, bh - i), 0, s) for i in range(0, bh, n)]
    per_query = 12 * s if dkv else 6 * _up128(s)
    nq = max(128, cap // per_query // 128 * 128)
    return [(i, 1, q0, min(nq, s - q0)) for i in range(bh) for q0 in range(0, s, nq)]


def f32_wide_bwd_scratch(shape, dkv: bool, device) -> Tuple[List[Tuple[int, int, int, int]],
                                                            torch.Tensor]:
    """(the chunks of ``f32_wide_bwd_plan``, one bf16 scratch buffer that
    each of them fits) for a wide f32 dK/dV (dkv) or dQ call at (B, S, H,
    D) ``shape``."""
    b, s, h, _ = shape
    plan = f32_wide_bwd_plan(b, s, h, dkv)
    nbytes = max(f32_wide_bwd_scratch_bytes(s, nbh, nq, dkv) for _, nbh, _, nq in plan)
    return plan, torch.empty(nbytes // 2, dtype=torch.bfloat16, device=device)


def f32_wide_bwd_scores(pieces, lse, delta, scratch, shape, chunk, dkv: bool) -> None:
    """The scores pass of one chunk (bh0, nbh, q0, nq) of a (B, S, H, D) call:
    P^T and dS^T (dkv) or dS as bf16 pieces into ``scratch`` (at least
    ``f32_wide_bwd_scratch_bytes`` of the chunk, bf16); ``pieces`` from
    ``flash_f32_split(q, k, v, do)``, lse and delta contiguous (B*H, S) f32."""
    fn = _f32_wide_bwd_kernels()[0]
    rc = fn(pieces.data_ptr(), lse.data_ptr(), delta.data_ptr(), scratch.data_ptr(),
            *shape, *chunk, int(dkv), _build.stream_ptr(pieces.device))
    _build.check(rc, "f32_wide_bwd_scores")
    f32_wide_bwd_scores.launches += 1


def f32_wide_bwd_products(pieces, scratch, outs, shape, chunk, dkv: bool) -> None:
    """The gradient products of one chunk from its scores pass's scratch:
    ``outs`` (dV, dK) for dkv, else (dQ,), contiguous (B, S, H, D) f32; a
    dK/dV chunk of queries after the first adds to them."""
    fn = _f32_wide_bwd_kernels()[1]
    out0, out1 = (outs[0], outs[1]) if dkv else (outs[0], outs[0])
    rc = fn(pieces.data_ptr(), scratch.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            *shape, *chunk, int(dkv), int(dkv and chunk[2] > 0),
            _build.stream_ptr(pieces.device))
    _build.check(rc, "f32_wide_bwd_products")
    f32_wide_bwd_products.launches += 1


f32_wide_bwd_scores.launches = f32_wide_bwd_products.launches = 0


def _f32_wide_bwd(pieces, lse, delta, shape, dkv: bool):
    """The wide f32 dK/dV (dkv: returns (dk, dv)) or dQ (returns (dq,)) on
    CUDA from ``flash_f32_split(q, k, v, do)``'s pieces: the scores pass and
    the products chunk by chunk through one scratch buffer."""
    outs = [torch.empty(shape, dtype=torch.float32, device=pieces.device)
            for _ in range(2 if dkv else 1)]
    plan, scratch = f32_wide_bwd_scratch(shape, dkv, pieces.device)
    for chunk in plan:
        f32_wide_bwd_scores(pieces, lse, delta, scratch, shape, chunk, dkv)
        f32_wide_bwd_products(pieces, scratch, outs, shape, chunk, dkv)
    return (outs[1], outs[0]) if dkv else (outs[0],)


def _f32_bwd(q, k, v, do, lse, delta, pieces, dkv: bool):
    """The f32 dK/dV (dkv: (dk, dv)) or dQ ((dq,)) on CUDA, from ``pieces``
    (``flash_f32_split(q, k, v, do)``'s twelve planes, or None: the pre-pass
    runs here): ``csrc/flash_bwd_f32.cu`` up to its largest D, the wide
    passes above it."""
    _, _, bwd, _, max_narrow = _f32_kernels()
    _check_cuda("flash backward", (q, k, v, do), _f32_wide_bwd_kernels()[2])
    if pieces is None:
        pieces = flash_f32_split(q, k, v, do)
    elif (pieces.shape != (12, *q.shape) or pieces.dtype != torch.bfloat16
          or pieces.device != q.device or not pieces.is_contiguous()):
        raise ValueError(f"pieces must be flash_f32_split(q, k, v, do)'s contiguous bf16 "
                         f"{(12, *q.shape)} on {q.device}, got {tuple(pieces.shape)} "
                         f"{pieces.dtype} on {pieces.device}")
    if q.shape[3] > max_narrow:
        return _f32_wide_bwd(pieces, lse, delta, q.shape, dkv)
    outs = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
            for _ in range(2 if dkv else 1)]
    rc = bwd(pieces.data_ptr(), lse.data_ptr(), delta.data_ptr(), outs[0].data_ptr(),
             outs[-1].data_ptr(), *q.shape, int(dkv), _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_bwd_dkv" if dkv else "flash_attention_bwd_dq")
    return tuple(outs)


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


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, pieces=None):
    """dK, dV of non-causal unmasked attention over (B, S, H, D) for any S.

    lse and delta are (B*H, S) f32. CUDA tensors: as ``flash_attention_fwd``
    takes them, with D up to 512 in either dtype; dk and dv come back
    contiguous in q's dtype. In f32 the kernels read the bf16 pieces of q, k,
    v and dO: ``pieces``, ``flash_f32_split(q, k, v, do)``'s, lets one
    pre-pass serve this entry and ``flash_attention_bwd_dq``; without it the
    pre-pass runs here. The plain version (CPU tensors) needs no pieces.
    """
    _check(q, k, v, do)
    _stats_on(lse, delta, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta)
    lse, delta = lse.contiguous(), delta.contiguous()
    if q.dtype == torch.float32:
        dk, dv = _f32_bwd(q, k, v, do, lse, delta, pieces, dkv=True)
    else:
        fn, _, max_d = _bwd_kernels()
        _check_cuda("flash backward", (q, k, v, do), max_d)
        _no_pieces(pieces)
        dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        ptrs, dims, strides = _bwd_args(q, k, v, do, lse, delta)
        rc = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, strides,
                _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.launches_f32 += int(q.dtype == torch.float32)
    flash_attention_bwd_dkv.launches_wide += int(q.shape[3] > WIDE_ABOVE)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, pieces=None):
    """dQ, same inputs as ``flash_attention_bwd_dkv``; dq contiguous in q's
    dtype on CUDA."""
    _check(q, k, v, do)
    _stats_on(lse, delta, q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta)
    lse, delta = lse.contiguous(), delta.contiguous()
    if q.dtype == torch.float32:
        dq, = _f32_bwd(q, k, v, do, lse, delta, pieces, dkv=False)
    else:
        _, fn, max_d = _bwd_kernels()
        _check_cuda("flash backward", (q, k, v, do), max_d)
        _no_pieces(pieces)
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        ptrs, dims, strides = _bwd_args(q, k, v, do, lse, delta)
        rc = fn(*ptrs, dq.data_ptr(), *dims, strides, _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_f32 += int(q.dtype == torch.float32)
    flash_attention_bwd_dq.launches_wide += int(q.shape[3] > WIDE_ABOVE)
    return dq


def _no_pieces(pieces) -> None:
    if pieces is not None:
        raise ValueError("pieces are the f32 backward's; the bf16 kernels read q, k, v, dO")


for _fn in (flash_attention_bwd_dkv, flash_attention_bwd_dq):
    _fn.launches = _fn.launches_f32 = _fn.launches_wide = 0


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
        if do.device.type == "cuda" and (do.stride(-1) != 1 or not _chunked(do)):
            do = do.contiguous()
        delta = flash_delta(out, do)
        pieces = None
        if do.device.type == "cuda" and q.dtype == torch.float32:  # one pre-pass for both
            pieces = flash_f32_split(q, k, v, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, pieces)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, pieces)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable flash attention over (B, S, H, D). Without autograd (no
    input requires grad, or under ``torch.no_grad``) it is one forward launch
    and saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)[0]
