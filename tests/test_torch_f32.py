"""Full precision (``--mixed_precision no``) in the PyTorch port against agenda_tpu, on the CPU.

The JAX CLIs compute in f32 under ``--mixed_precision no``
(``agenda_tpu/cli/finetune_sd.py:165``, ``finetune_sd_token.py:170``) and run
their Pallas flash and GroupNorm kernels on f32 operands. On the card the
port does the same with the f32 kernels of ``csrc/flash_fwd_f32.cu`` (the
forward), ``csrc/flash_bwd_f32.cu`` (the backward up to D = 160, one pass),
``csrc/flash_bwd_f32_wide.cu`` (the backward above D = 160, three passes),
all on the tensor cores over three bf16 pieces of each operand, and the f32
instantiation of ``csrc/groupnorm.cu`` (held to float64 in
``test_torch_cuda.py``). Here, on the CPU: the compute dtype of each choice,
the wrappers' dtype checks on metadata, the plain f32 versions against the
Pallas kernels in interpret mode, the pieces and the accuracy budgets of the
forward and of both backward designs emulated, the wide backward's chunk
plan, and both fine-tune CLIs
against the JAX CLIs with the same flags on the tiny fixture, with the JAX
key stream's draws handed to the port.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agenda_tpu.cli import finetune_sd as jax_finetune_sd
from agenda_tpu.cli import finetune_sd_token as jax_finetune_sd_token
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.io.tiny_fixture import make_tiny_pipeline_dir
from agenda_tpu.kernels.flash import _flash_bwd_impl, _flash_fwd_impl
from agenda_tpu.kernels.groupnorm import _gn_pallas
from agenda_tpu_torch._device import compute_dtype
from agenda_tpu_torch.io.diffusers_io import load_pipeline, params_from_jax
from agenda_tpu_torch.io.learned_embeds import load_learned_embeddings
from agenda_tpu_torch.kernels import flash as fl
from agenda_tpu_torch.kernels import groupnorm as gn
from agenda_tpu_torch.train import finetune_sd as ttrain
from agenda_tpu_torch.train import finetune_sd_token as ttoken
from agenda_tpu_torch.utils.png import write_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 2e-5  # f32 on both sides; only the summation order differs
GRAD_TOL = 1e-4  # f32 gradients through exp and two products of S terms
LOSS_RTOL = 1e-4  # as test_torch_train.py's TOL, at every step here
LR = 1e-3
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: extra intra-op threads only contend with the other
    test workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the compute dtype and the kernels' dtype checks ------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("choice", [None, "no", "bf16", "fp16"])
def test_compute_dtype_of_each_mixed_precision_choice(choice, device):
    """"no" is f32 everywhere (as the JAX CLIs' f32); the other choices keep
    the rule: bf16 on the card, f32 on the CPU."""
    want = torch.float32 if choice == "no" or device == "cpu" else torch.bfloat16
    assert compute_dtype(torch.device(device), choice) == want
    if choice is None:
        assert compute_dtype(torch.device(device)) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_kernel_checks_take_bf16_and_f32_and_refuse_f16(dtype):
    """The CUDA-side checks of the flash and GroupNorm wrappers, on metadata
    (no card): f32 and bf16 pass, f16 raises TypeError; an f32 view whose
    strides are not whole 16-byte chunks raises ValueError."""
    q = torch.empty(2, 64, 2, 40, dtype=dtype, device="meta")
    x = torch.empty(2, 64, 8, 8, dtype=dtype, device="meta")
    w = torch.empty(64, device="meta")
    if dtype == torch.float16:
        with pytest.raises(TypeError):
            fl._check_cuda("flash", (q, q, q), 512)
        with pytest.raises(TypeError):
            gn._check_cuda(x, w, w)
        return
    fl._check_cuda("flash", (q, q, q), 512)
    fl._check_cuda("flash backward", (q, q, q, q), 160)
    gn._check_cuda(x, w, w)
    fl._check_cuda("flash backward", (torch.empty(1, 64, 1, 512, dtype=dtype, device="meta"),) * 4,
                   512)
    for d in (520, 204):  # D above the wide backward's 512; D not a multiple of 8
        with pytest.raises(ValueError):
            wide = torch.empty(1, 64, 1, d, dtype=dtype, device="meta")
            fl._check_cuda("flash backward", (wide,) * 4, 512)
    odd = torch.empty(2, 64, 2, 42, dtype=dtype, device="meta")[..., :40]
    with pytest.raises(ValueError):  # a head stride of 42 elements: not 16-byte chunks
        fl._check_cuda("flash", (odd, odd, odd), 512)


# -- the plain f32 versions against the Pallas kernels (interpret mode) ------------


@pytest.mark.parametrize("b,s,h,d", [(1, 256, 2, 40), (1, 128, 1, 512), (1, 333, 2, 264)])
def test_f32_flash_forward_and_backward_match_pallas(b, s, h, d):
    """The port's f32 path on the CPU (``flash_attention`` through autograd:
    the forward, delta and both backward plain versions) against
    ``_flash_fwd_impl`` and ``_flash_bwd_impl`` in interpret mode, f32 in
    and out. Tolerances: F32_TOL for the output and lse, GRAD_TOL for the
    gradients (relative to their largest element)."""
    rng = np.random.RandomState(s + d)
    q, k, v, do = (_rand(rng, b, s, h, d) for _ in range(4))
    out_j, res = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert out_j.dtype == jnp.float32
    grads_j = _flash_bwd_impl(res, jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t = fl.flash_attention(tq, tk, tv)
    out_t.backward(torch.from_numpy(do))
    _, lse_t = fl.flash_attention_fwd(*(t.detach() for t in (tq, tk, tv)))
    assert out_t.dtype == torch.float32 and tq.grad.dtype == torch.float32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(res[-1])[:, 0, :], atol=F32_TOL,
                               rtol=F32_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        want = np.asarray(want)
        assert want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max())


# -- the f32 forward's accuracy budget: three bf16 pieces, six products ------------
#
# csrc/flash_fwd_f32.cu runs the f32 forward on the tensor cores: each
# operand (Q, K, V, and P in registers) is split into three bf16 pieces and
# each product is the six piece products with i + j <= 2, smallest first,
# summed in f32. Here that design is emulated with torch in f32 and held to
# the card tests' limit (tests/test_torch_cuda.py): at most F32_LIMIT times
# the f32 plain version's max |error| against float64, output and lse alike.

F32_LIMIT = 4.0  # as tests/test_torch_cuda.py's
PIECE_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _pieces(x, keep):
    """x's three bf16 pieces as f32 (b0 = bf16(x), b1 = bf16(x - b0), b2 =
    bf16(x - b0 - b1)), those past the first `keep` zero."""
    out, rest = [], x
    for i in range(3):
        piece = rest.to(torch.bfloat16).float()
        out.append(piece if i < keep else torch.zeros_like(piece))
        rest = rest - piece
    return out


def _piece_product(a, b, keep):
    """a @ b as the kernel forms it: the six piece products, smallest first,
    added into one f32 sum."""
    pa, pb = _pieces(a, keep), _pieces(b, keep)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for i, j in PIECE_PAIRS:
        acc = acc + pa[i] @ pb[j]
    return acc


def _emulated_f32_forward(q, k, v, keep=3):
    """(out, lse) of (B, S, H, D) f32 attention with every product over
    `keep` pieces, the softmax in f32 (P split as the kernel splits it)."""
    b, s, h, d = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    scores = _piece_product(qh, kh.transpose(-1, -2), keep) * (1.0 / np.sqrt(d))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = _piece_product(p, vh, keep) / l
    return out.permute(0, 2, 1, 3), (m + torch.log(l)).reshape(b * h, s)


def test_f32_split_pieces_sum_to_the_operand():
    """The pre-pass's plain version: nine bf16 planes (operand t, piece i at
    3 t + i) whose three pieces of each operand sum to it within 2^-24 of
    its magnitude, at magnitudes from 1e-6 to 1e6."""
    rng = np.random.RandomState(3)
    scale = 10.0 ** rng.uniform(-6, 6, size=(1, 33, 2, 24))
    q, k, v = (torch.from_numpy((_rand(rng, 1, 33, 2, 24) * scale).astype(np.float32))
               for _ in range(3))
    pieces = fl.flash_f32_split(q, k, v)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (9, 1, 33, 2, 24)
    for t, x in enumerate((q, k, v)):
        total = sum(pieces[3 * t + i].double() for i in range(3))
        assert bool(((total - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all())
        assert torch.equal(pieces[3 * t], x.to(torch.bfloat16))


@pytest.mark.parametrize("d", [24, 40, 80, 160, 264, 512])
def test_f32_forward_design_fits_the_limit_and_fewer_pieces_do_not(d):
    """The six-product forward emulated in f32 at a ragged S stays within
    F32_LIMIT x the f32 plain version's max |error| against float64; keeping
    only b0, or only b0 + b1, of every operand breaks that limit."""
    rng = np.random.RandomState(d)
    h = 1 if d > 160 else 2
    q, k, v = (torch.from_numpy(_rand(rng, 1, 77, h, d)) for _ in range(3))
    ref = fl.flash_attention_reference(q.double(), k.double(), v.double())
    plain = fl.flash_attention_reference(q, k, v)

    def over_limit(got):
        return max((x.double() - r).abs().max().item()
                   / (F32_LIMIT * (p.double() - r).abs().max().item())
                   for x, p, r in zip(got, plain, ref))

    ratios = [over_limit(_emulated_f32_forward(q, k, v, keep=n)) for n in (3, 2, 1)]
    print(f"D = {d}: worst error over the limit with 3, 2, 1 pieces {ratios}")
    assert ratios[0] <= 1.0 and ratios[1] > 1.0 and ratios[2] > 1.0


# -- the wide f32 backward's design: pieces, P and dS as pieces, tile by tile -------
#
# csrc/flash_bwd_f32_wide.cu runs the f32 dK/dV and dQ above D = 160 on the
# tensor cores in three passes (a pre-pass splits q, k, v and dO into three
# bf16 pieces; a scores pass forms S and dP over D in 64-column boxes, P and
# dS = P (dP - delta) scale, and writes them as pieces; the gradient products
# run over the reduction in 64-row tiles), chunk by chunk as
# ``fl.f32_wide_bwd_plan`` cuts the work. ``_wide_bwd_chunked`` is that path
# in torch with the tile product as a parameter: in f32 (``torch.matmul``)
# it is the path's plain version; with ``_tc_product`` it models the
# pieces' products with a simple accumulator, which sums each 16-deep step
# exactly and rounds it toward zero. The tensor cores' own accumulator
# also truncates each addend as it aligns it to the largest exponent, which
# this model does not, so it is more accurate than the card: it shows what
# the pieces and the scratch's pieces cost, not the drift of one
# accumulator over all of S, which only the card shows (the broken copy
# ``wide_bwd_tiles_in_the_tensor_cores`` of ``test_torch_cuda.py``, at
# S = 4096).

TILE = 64  # the kernels' boxes of D and tiles of the reduction


def _round_toward_zero(x):
    """float64 x rounded to f32 toward zero, as float64."""
    y = x.float()
    y = torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)
    return y.double()


def _tc_product(a, b, keep=3):
    """a @ b (f32) as the kernels form one tile's, in the model above: the six
    piece products (i + j <= 2; pieces past the first ``keep`` zero),
    smallest first, each 16 deep at a time into one accumulator that rounds
    toward zero."""
    pa, pb = _pieces(a, keep), _pieces(b, keep)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for i, j in PIECE_PAIRS:
        for k0 in range(0, a.shape[-1], 16):
            acc = _round_toward_zero(acc + pa[i][..., k0:k0 + 16].double()
                                     @ pb[j][..., k0:k0 + 16, :].double())
    return acc.float()


def _tiled(product, a, b, out=None):
    """out + a @ b over the reduction in tiles of TILE: each tile's product
    from zero, added to the f32 sum in order."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if out is None else out
    for k0 in range(0, a.shape[-1], TILE):
        out = out + product(a[..., k0:k0 + TILE], b[..., k0:k0 + TILE, :])
    return out


def _wide_bwd_chunked(q, k, v, do, lse, delta, dkv, product=torch.matmul, keep=3):
    """The wide f32 backward's path over (B, S, H, D) f32 inputs, in the
    chunks of ``fl.f32_wide_bwd_plan`` under ``fl.F32_WIDE_BWD_SCRATCH``:
    (dk, dv) for dkv, else (dq,); ``keep`` pieces of P and dS go into the
    products, as the scratch holds them."""
    b, s, h, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).reshape(b * h, s, d) for t in (q, k, v, do))
    outs = [torch.zeros(b * h, s, d) for _ in range(2 if dkv else 1)]
    for bh0, nbh, q0, nq in fl.f32_wide_bwd_plan(b, s, h, dkv):
        g, r = slice(bh0, bh0 + nbh), slice(q0, q0 + nq)
        st = _tiled(product, qh[g, r], kh[g].transpose(1, 2))  # (nbh, nq, S), over D
        dpt = _tiled(product, doh[g, r], vh[g].transpose(1, 2))
        p = torch.exp(st * scale - lse.reshape(b * h, s)[g, r, None])
        ds = p * (dpt - delta.reshape(b * h, s)[g, r, None]) * scale
        p, ds = (sum(_pieces(x, keep)) for x in (p, ds))  # as the scratch holds them
        if dkv:  # dV = P^T dO, dK = dS^T Q, continued from the earlier query chunks
            outs[1][g] = _tiled(product, p.transpose(1, 2), doh[g, r], outs[1][g])
            outs[0][g] = _tiled(product, ds.transpose(1, 2), qh[g, r], outs[0][g])
        else:
            outs[0][g, r] = _tiled(product, ds, kh[g])
    return tuple(x.reshape(b, h, s, d).permute(0, 2, 1, 3) for x in outs)


def _bwd_inputs(rng, shape):
    q, k, v, do = (torch.from_numpy(_rand(rng, *shape)) for _ in range(4))
    out, lse = fl.flash_attention_reference(q, k, v)
    return q, k, v, do, lse, fl.flash_delta(out, do)


@pytest.mark.parametrize("shape", [(1, 77, 3, 168), (1, 333, 2, 264), (1, 77, 1, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_wide_backward_design_fits_the_limit_and_fewer_pieces_do_not(shape, monkeypatch):
    """The wide backward's path in the model above (three pieces of every
    operand, P and dS written as three pieces, each tile's products from
    zero, the dK/dV entry's queries in chunks of 128) stays within F32_LIMIT
    x the f32 plain version's max |error| against float64 in dK, dV and dQ;
    two pieces, or one, break that limit. (The model cannot show one
    accumulator over each product's whole reduction failing: it read
    0.06-0.24 of the limit at these S, and the card test's broken copy
    fails only at S = 4096.)"""
    rng = np.random.RandomState(shape[1] + shape[3])
    ins = _bwd_inputs(rng, shape)
    ref = (*fl.flash_attention_bwd_dkv_reference(*(t.double() for t in ins)),
           fl.flash_attention_bwd_dq_reference(*(t.double() for t in ins)))
    plain = (*fl.flash_attention_bwd_dkv_reference(*ins), fl.flash_attention_bwd_dq_reference(*ins))
    # the dK/dV entry's queries in chunks of 128
    monkeypatch.setattr(fl, "F32_WIDE_BWD_SCRATCH", 12 * shape[1] * 128)

    def over_limit(keep):
        kw = dict(product=functools.partial(_tc_product, keep=keep), keep=keep)
        got = (*_wide_bwd_chunked(*ins, True, **kw), *_wide_bwd_chunked(*ins, False, **kw))
        return max((x.double() - r).abs().max().item()
                   / (F32_LIMIT * (p.double() - r).abs().max().item())
                   for x, p, r in zip(got, plain, ref))

    ratios = [over_limit(n) for n in (3, 2, 1)]
    print(f"{shape}: worst error over the limit with 3, 2, 1 pieces {ratios}")
    assert ratios[0] <= 1.0 and ratios[1] > 1.0 and ratios[2] > 1.0, ratios


# -- the f32 backward up to D = 160: one pass, P and dS split in registers ----------
#
# csrc/flash_bwd_f32.cu keeps the owned side's pieces in shared memory and
# streams the other side's in tiles: S and dP are six piece products over D
# in one accumulator, P = exp(S scale - lse) and dS = P (dP - delta) are f32
# and split into three pieces, and each streamed tile's gradient products
# (dV = P^T dO and dK = dS^T Q over query tiles of 32 rows; dQ = dS K over
# key tiles of 64 rows at D <= 40, 32 above) start from zero and are added
# to the f32 sums; the scale multiplies dK and dQ at the end.
# ``_one_pass_bwd`` is that design in the model above (``_tc_product``).

def _one_pass_bwd(q, k, v, do, lse, delta, keep=3):
    """(dk, dv, dq) of the one-pass design over (B, S, H, D) f32 inputs, every
    product a ``_tc_product`` over ``keep`` pieces of its operands."""
    b, s, h, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    product = functools.partial(_tc_product, keep=keep)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).reshape(b * h, s, d) for t in (q, k, v, do))
    st = product(qh, kh.transpose(1, 2))  # over all of D, one accumulator
    dpt = product(doh, vh.transpose(1, 2))
    p = torch.exp(st * scale - lse.reshape(b * h, s, 1))
    ds = p * (dpt - delta.reshape(b * h, s, 1))
    dk, dv, dq = (torch.zeros(b * h, s, d) for _ in range(3))
    for q0 in range(0, s, 32):  # the dK/dV kernel's query tiles
        r = slice(q0, q0 + 32)
        dv = dv + product(p[:, r].transpose(1, 2), doh[:, r])
        dk = dk + product(ds[:, r].transpose(1, 2), qh[:, r])
    tile = 64 if d <= 40 else 32
    for k0 in range(0, s, tile):  # the dQ kernel's key tiles
        c = slice(k0, k0 + tile)
        dq = dq + product(ds[:, :, c], kh[:, c])
    return tuple(x.reshape(b, h, s, d).permute(0, 2, 1, 3)
                 for x in (dk * scale, dv, dq * scale))


@pytest.mark.parametrize("shape", [(1, 77, 2, 24), (1, 77, 2, 40), (1, 77, 2, 80),
                                   (1, 77, 2, 160), (1, 333, 2, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_narrow_backward_design_fits_the_limit_and_fewer_pieces_do_not(shape):
    """The one-pass backward in the model above (three pieces of every
    operand and of P and dS, each streamed tile's gradient products from
    zero) stays within F32_LIMIT x the f32 plain version's max |error|
    against float64 in dK, dV and dQ at a ragged S; two pieces, or one,
    break that limit. (As the wide test's, the model cannot show one
    accumulator over all of S failing: only the card's copy can.)"""
    rng = np.random.RandomState(shape[1] + shape[3])
    ins = _bwd_inputs(rng, shape)
    ref = (*fl.flash_attention_bwd_dkv_reference(*(t.double() for t in ins)),
           fl.flash_attention_bwd_dq_reference(*(t.double() for t in ins)))
    plain = (*fl.flash_attention_bwd_dkv_reference(*ins), fl.flash_attention_bwd_dq_reference(*ins))

    def over_limit(keep):
        return max((x.double() - r).abs().max().item()
                   / (F32_LIMIT * (p.double() - r).abs().max().item())
                   for x, p, r in zip(_one_pass_bwd(*ins, keep=keep), plain, ref))

    ratios = [over_limit(n) for n in (3, 2, 1)]
    print(f"{shape}: worst error over the limit with 3, 2, 1 pieces {ratios}")
    assert ratios[0] <= 1.0 and ratios[1] > 1.0 and ratios[2] > 1.0, ratios


@pytest.mark.parametrize("dkv", [True, False], ids=["dkv", "dq"])
def test_f32_wide_backward_plain_chunks_are_bitwise_equal_at_two_caps(dkv, monkeypatch):
    """The plain version of the wide f32 backward's chunked path gives the
    same bits whether the scratch cap takes a call whole or cuts it into a
    chunk a (batch, head) and 128 queries (the dK/dV sums continuing from
    chunk to chunk tile by tile), and agrees with the plain version."""
    ins = _bwd_inputs(np.random.RandomState(11), (2, 200, 2, 264))
    b, s, h, _ = ins[0].shape
    whole = _wide_bwd_chunked(*ins, dkv)
    monkeypatch.setattr(fl, "F32_WIDE_BWD_SCRATCH", 1)
    assert len(fl.f32_wide_bwd_plan(b, s, h, dkv)) == b * h * 2
    cut = _wide_bwd_chunked(*ins, dkv)
    assert all(torch.equal(x, y) for x, y in zip(whole, cut))
    want = (fl.flash_attention_bwd_dkv_reference(*ins) if dkv
            else (fl.flash_attention_bwd_dq_reference(*ins),))
    for x, w in zip(whole, want):
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL * w.abs().max().item())


@pytest.mark.parametrize("b,s,h,cap", [(8, 1024, 1, None), (2, 4096, 1, None),
                                       (1, 16384, 1, None), (3, 333, 2, 1), (2, 200, 3, 10**6)])
def test_f32_wide_backward_plan_covers_each_row_once_within_the_cap(b, s, h, cap, monkeypatch):
    """Each (batch, head) and query falls in one chunk, in launch order; a
    chunk of queries starts at a multiple of 128; a chunk's scratch stays
    within the cap unless it is the smallest chunk (one pair, 128 queries);
    the VAE's shapes at 256 and 512 px run in one chunk."""
    if cap is not None:
        monkeypatch.setattr(fl, "F32_WIDE_BWD_SCRATCH", cap)
    limit = fl.F32_WIDE_BWD_SCRATCH
    for dkv in (True, False):
        plan = fl.f32_wide_bwd_plan(b, s, h, dkv)
        rows = [(bh, q) for bh0, nbh, q0, nq in plan
                for bh in range(bh0, bh0 + nbh) for q in range(q0, q0 + nq)]
        assert rows == [(bh, q) for bh in range(b * h) for q in range(s)]
        for bh0, nbh, q0, nq in plan:
            assert q0 % 128 == 0
            smallest = fl.f32_wide_bwd_scratch_bytes(s, 1, min(128, s), dkv)
            assert fl.f32_wide_bwd_scratch_bytes(s, nbh, nq, dkv) <= max(limit, smallest)
        if s <= 4096 and cap is None:
            assert plan == [(0, b * h, 0, s)]


def test_f32_bwd_split_pieces_sum_to_the_operand():
    """The pre-pass with dO, as the wide backward runs it, on the CPU: twelve
    bf16 planes (q, k, v, dO; piece i of operand t at 3 t + i) whose pieces
    of each operand sum to it within 2^-24 of its magnitude, the split of
    q, k, v alone the first nine."""
    rng = np.random.RandomState(4)
    scale = 10.0 ** rng.uniform(-6, 6, size=(1, 33, 2, 168))
    ops = [torch.from_numpy((_rand(rng, 1, 33, 2, 168) * scale).astype(np.float32))
           for _ in range(4)]
    pieces = fl.flash_f32_split(*ops)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (12, 1, 33, 2, 168)
    assert torch.equal(pieces[:9], fl.flash_f32_split(*ops[:3]))
    for t, x in enumerate(ops):
        total = sum(pieces[3 * t + i].double() for i in range(3))
        assert bool(((total - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all())


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("b,c,hw,g,eps", [(2, 320, 64, 32, 1e-5), (1, 128, 256, 32, 1e-6)])
def test_f32_groupnorm_matches_pallas(b, c, hw, g, eps, act):
    """The port's f32 GroupNorm(+SiLU) on the CPU against ``_gn_pallas`` in
    interpret mode on f32 input with a per-channel offset (a UNet and a VAE
    width); F32_TOL."""
    rng = np.random.RandomState(c + hw)
    offset = 4.0 * (np.arange(c) % (c // g)) / (c // g)
    x = _rand(rng, b, hw, c) * 2.0 + offset.astype(np.float32)
    scale, bias = _rand(rng, c), _rand(rng, c)
    want = np.asarray(_gn_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g, eps,
                                 act, interpret=True))
    assert want.dtype == np.float32
    x_nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    y = gn.group_norm_act(x_nchw, torch.from_numpy(scale), torch.from_numpy(bias), g, eps, act)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), want, atol=F32_TOL, rtol=F32_TOL)


# -- the CLIs at --mixed_precision no against the JAX CLIs ----------------------------


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    """The JAX package's tiny pipeline and 8 16x16 PNG tiles with prompts
    that hold the token CLI's trigger words."""
    root = tmp_path_factory.mktemp("f32_cli")
    pipe, tiles = str(root / "pipe"), str(root / "tiles")
    make_tiny_pipeline_dir(pipe, seed=SEED)
    os.makedirs(tiles)
    rng = np.random.RandomState(9)
    prompts = ["An aerial view image with cars in Utah",
               "An aerial view image with cars in New Zealand"]
    with open(os.path.join(tiles, "train.json"), "w") as f:
        json.dump({f"{i}.png": prompts[i % 2] for i in range(8)}, f)
    for i in range(8):
        write_png(os.path.join(tiles, f"{i}.png"),
                  rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    return pipe, tiles


# The JAX CLIs split the global batch over every JAX device (8 on the test
# CPU): --train_batch_size 1 there is the port's 8 on its one device.
JAX_BATCH, PORT_BATCH = "1", "8"


def _common(pipe, tiles, out):
    return ["--pretrained_model_name_or_path", pipe, "--dataset_folder", tiles,
            "--json_file_name", "train.json", "--output_dir", out, "--resolution", "32",
            "--max_train_steps", "2", "--snr_gamma", "5", "--seed", str(SEED),
            "--learning_rate", str(LR), "--report_to", "jsonl", "--mixed_precision", "no",
            "--checkpointing_steps", "100", "--validation_steps", "2"]


def _logged(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_draws(step, shape, num_train_timesteps, token):
    """The JAX steps' draws at micro-batch ``step`` from key(SEED): the SD
    step splits fold_in(key, step) into (vae, loss) and the loss key into
    (noise, t, ...) (``train/finetune_sd.py``); the token step splits it into
    (vae, noise, t, offset) (``train/finetune_sd_token.py:246``)."""
    key = jax.random.fold_in(jax.random.key(SEED), step)
    if token:
        k_vae, k_noise, k_t, _ = jax.random.split(key, 4)
    else:
        k_vae, k_loss = jax.random.split(key)
        k_noise, k_t, _, _ = jax.random.split(k_loss, 4)
    as_torch = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return ttrain.StepDraws(
        latent_eps=as_torch(jax.random.normal(k_vae, shape, jnp.float32)),
        noise=as_torch(jax.random.normal(k_noise, shape, jnp.float32)),
        timesteps=as_torch(jax.random.randint(k_t, (shape[0],), 0,
                                              num_train_timesteps)).long())


def _jax_key_draws(monkeypatch, module, token):
    """Replace ``module.make_draws`` with the JAX key stream's draws, one
    micro-batch a call."""
    calls = []

    def draws(generator, shape, num_train_timesteps, cfg, device, mesh=None):
        calls.append(tuple(shape))
        return _jax_draws(len(calls) - 1, tuple(shape), num_train_timesteps, token)

    monkeypatch.setattr(module, "make_draws", draws)
    return calls


def _weight_faults(got, want, base, steps):
    """test_torch_train.py::_step_faults' limits at the last of ``steps``
    Adam steps: at most 0.1% of the elements more than 0.25 lr (steps - 1)
    + 1e-6 apart, none more than 2 lr past that; and the run moved them."""
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel() for k in want])
    moved = np.concatenate([np.abs(want[k].numpy() - base[k].numpy()).ravel() for k in want])
    near = 0.25 * LR * (steps - 1) + 1e-6
    faults = []
    if float(np.mean(diffs > near)) > 1e-3:
        faults.append(("share above", near, float(np.mean(diffs > near))))
    if diffs.max() > 2 * LR + near:
        faults.append(("max", float(diffs.max())))
    if np.median(moved) < 0.5 * LR:
        faults.append(("not trained", float(np.median(moved))))
    return faults


def _unet_of(path, jax_side):
    if jax_side:
        tree = jax.tree.map(np.asarray, jax_load_pipeline(path).unet_params)
        return {k: v.float() for k, v in params_from_jax(tree)[0].items()}
    return {k: v.float() for k, v in load_pipeline(path).unet_state.items()}


def _assert_losses_agree(port, theirs, keys):
    assert [m["step"] for m in port] == [m["step"] for m in theirs] == [1, 2]
    for m_t, m_j in zip(port, theirs):
        for key in keys:
            assert abs(m_t[key] - m_j[key]) <= LOSS_RTOL * abs(m_j[key]), (key, m_t, m_j)


def test_finetune_sd_cli_in_f32_matches_the_jax_cli(fixture_dirs, tmp_path, monkeypatch):
    """Two steps and one validation call (4 images, 20 PNDM steps) of
    ``finetune_sd --mixed_precision no`` in both packages, f32 AdamW: the
    logged loss and gradient norm of each step, and the exported UNet."""
    from agenda_tpu_torch.cli import finetune_sd

    pipe, tiles = fixture_dirs
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_finetune_sd.main(_common(pipe, tiles, jax_out) + [
        "--train_batch_size", JAX_BATCH, "--validation_prompts", "cars"])
    calls = _jax_key_draws(monkeypatch, ttrain, token=False)
    stats = finetune_sd.main(_common(pipe, tiles, port_out) + [
        "--train_batch_size", PORT_BATCH, "--validation_prompts", "cars", "--device", "cpu"])
    assert stats["steps"] == 2 and len(calls) == 2
    _assert_losses_agree(_logged(port_out), _logged(jax_out), ("loss", "grad_norm"))
    for out in (port_out, jax_out):
        assert len(os.listdir(os.path.join(out, "logs", "images"))) == 4
    assert _weight_faults(_unet_of(port_out, False), _unet_of(jax_out, True),
                          _unet_of(pipe, True), steps=2) == []


TOKEN_FLAGS = ["--reg_weight", "0.5", "--object_token", "new_token", "--initialize_token",
               "cars", "Utah", "New Zealand", "--train_token", "--train_unet",
               "--with_cross_attn_reg", "--num_validation_images", "1",
               "--validation_prompts", "An aerial view image with {} cars in {} Utah"]


def test_finetune_sd_token_cli_in_f32_matches_the_jax_cli(fixture_dirs, tmp_path, monkeypatch):
    """Two steps of stage 1 (tokens + UNet + cross-attention regularizer) and
    one validation image of ``finetune_sd_token --mixed_precision no`` in
    both packages, the initial embedding the JAX CLI's: the logged losses of
    each step, the exported UNet and the learned rows."""
    from agenda_tpu_torch.cli import finetune_sd_token

    pipe, tiles = fixture_dirs
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_finetune_sd_token.main(_common(pipe, tiles, jax_out) + TOKEN_FLAGS + [
        "--train_batch_size", JAX_BATCH])
    calls = _jax_key_draws(monkeypatch, ttoken, token=True)
    init = ttoken.init_token_train_state

    def init_as_jax(unet, tx, train_token, train_unet, train_cross_attn, n_tokens,
                    hidden_size, generator=None, init_embedding=None):
        emb = 0.02 * jax.random.normal(jax.random.key(SEED), (n_tokens, hidden_size))
        return init(unet, tx, train_token, train_unet, train_cross_attn, n_tokens,
                    hidden_size, init_embedding=np.asarray(emb, np.float32))

    monkeypatch.setattr(ttoken, "init_token_train_state", init_as_jax)
    stats = finetune_sd_token.main(_common(pipe, tiles, port_out) + TOKEN_FLAGS + [
        "--train_batch_size", PORT_BATCH, "--device", "cpu"])
    assert stats["steps"] == 2 and len(calls) == 2
    _assert_losses_agree(_logged(port_out), _logged(jax_out),
                         ("loss", "attn_loss", "fg_loss", "bg_loss"))
    for out in (port_out, jax_out):
        assert len(os.listdir(os.path.join(out, "logs", "images"))) == 1
    export = "full_model_step_2"
    assert _weight_faults(_unet_of(os.path.join(port_out, export), False),
                          _unet_of(os.path.join(jax_out, export), True),
                          _unet_of(pipe, True), steps=2) == []
    rows = [load_learned_embeddings(os.path.join(out, "learned_embeds_steps_2.bin"))
            for out in (port_out, jax_out)]
    assert list(rows[0]) == list(rows[1]) == [f"new_token_v{i}" for i in range(3)]
    for name in rows[1]:  # the rows move by about lr a step, as the UNet's elements do
        np.testing.assert_allclose(rows[0][name], rows[1][name], rtol=0, atol=0.25 * LR)
