"""The port's CUDA kernels against their plain versions, on the card.

Every test here that launches a kernel is marked ``cuda`` and skips without a
GPU; two checks of the sources (the broken copies' edits, chip_smoke.py's
ptxas report) run anywhere. The file imports
neither jax nor agenda_tpu, so it also runs on the card's machine, where
JAX is not installed (``tests/conftest.py`` imports jax, hence
``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import agenda_tpu_torch
from agenda_tpu_torch.kernels import flash as fl
from agenda_tpu_torch.kernels.flash import flash_attention_fwd, flash_attention_reference
from agenda_tpu_torch.kernels.fused_adamw import (
    fused_adamw8bit_leaf,
    fused_adamw8bit_leaf_reference,
    fused_adamw8bit_leaves,
    fused_adamw8bit_leaves_reference,
)
from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference

# flash output, elementwise: |out - ref| <= FLASH_ATOL_RMS * rms(ref) + FLASH_RTOL * |ref|
# (both sides round to bf16; P is rounded to bf16 before P V). rms(ref) falls as
# 1/sqrt(S) here, so the limit scales with it. As in chip_smoke.py.
FLASH_ATOL_RMS, FLASH_RTOL = 0.05, 1.6e-2
FLASH_TOL_LSE = 1e-3  # f32 logsumexp from bf16 q, k
GN_ATOL, GN_RTOL = 2e-2, 1.6e-2  # about two bf16 ulps of the output

REPO = Path(__file__).resolve().parent.parent


def _root_module(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the variant timer at the root; its copy_package makes the broken copies below
kernel_variants = _root_module("kernel_variants")


def _assert_flash_close(out, ref):
    ref = ref.float()
    rms = ref.square().mean().sqrt()
    assert bool(((out.float() - ref).abs() <= FLASH_ATOL_RMS * rms + FLASH_RTOL * ref.abs()).all())


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the H100: pytest -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 8, 80), (2, 1000, 8, 40), (1, 77, 3, 24),
                                   (4, 1700, 8, 40),  # a block pair past S, a ragged last tile
                                   (2, 300, 4, 80),  # one warpgroup a block at D = 80
                                   (2, 300, 2, 200),  # D padded to 512 in shared memory
                                   (1, 4096, 1, 512), (1, 333, 2, 264)])
def test_flash_kernel_matches_plain(shape):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(3))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v)
    ref, ref_lse = flash_attention_reference(q, k, v)
    assert flash_attention_fwd.launches == before + 1
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= FLASH_TOL_LSE


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views():
    """q/k/v as head-split views of one packed projection, as a fused QKV would give."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 256, 3, 4, 40, device="cuda", generator=g).bfloat16()
    q, k, v = qkv.unbind(dim=2)  # (B, S, H, D) with a sequence stride of 3*H*D
    out, lse = flash_attention_fwd(q, k, v)
    ref, ref_lse = flash_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= FLASH_TOL_LSE


# Broken copies of csrc/flash_fwd.cu that the flash limit (the output's and
# the logsumexp's) must fail; each breaks the wgmma kernel (D <= 160) and the
# mma.sync one (D = 512, 264) alike.
FLASH_MUTATIONS = {
    "v_from_wrong_ring_stage": [
        ("Vs + (j + T::kStages - 1) % T::kStages * T::kTileBytes",
         "Vs + (j + T::kStages - 2) % T::kStages * T::kTileBytes"),
        ("Vs + (n_tiles - 1) % T::kStages * T::kTileBytes",
         "Vs + n_tiles % T::kStages * T::kTileBytes"),
        ("const __nv_bfloat16* Vt = Vs + stage * BK * ROW;",
         "const __nv_bfloat16* Vt = Vs + (stage ^ 1) * BK * ROW;")],
    "o_rescale_skipped": [
        ("    for (int i = 0; i < ND / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n", ""),
        ("      o[n][0] *= alpha[0];\n      o[n][1] *= alpha[0];\n"
         "      o[n][2] *= alpha[1];\n      o[n][3] *= alpha[1];\n", "")],
    "last_tile_mask_dropped": [
        ("if (key0 + BK > p.S) {  // the last tile", "if (false) {  // the last tile"),
        ("const float v = key < p.S ? s[n][e] * p.scale_log2 : -INFINITY;",
         "const float v = s[n][e] * p.scale_log2;")],
}
# the main path's flash shapes and chip_smoke.py's three ragged ones, which
# reach every instantiation of the wgmma kernel: (2, 1000, 8, 40) one
# warpgroup a block at D = 40, (2, 300, 4, 80) one at D = 80
FLASH_LIMIT_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                      (2, 4096, 1, 512), (2, 1000, 8, 40), (2, 300, 4, 80), (1, 333, 2, 264)]
# Each broken copy is held to every one of them where the code it breaks runs:
# O is rescaled only from a second key tile on ((4, 64, 8, 160) has one), and
# the mask only acts on a ragged last tile.
FLASH_MUTATION_SHAPES = {
    "v_from_wrong_ring_stage": FLASH_LIMIT_SHAPES,
    "o_rescale_skipped": [s for s in FLASH_LIMIT_SHAPES if s != (4, 64, 8, 160)],
    "last_tile_mask_dropped": [(2, 1000, 8, 40), (2, 300, 4, 80), (1, 333, 2, 264),
                               (4, 1700, 8, 40)],
}
_WORST_ERROR_OVER_LIMIT = """
import json, torch
from agenda_tpu_torch.kernels.flash import flash_attention_fwd, flash_attention_reference
worst = {}
for shape in %r:
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(3))
    ref, ref_lse = flash_attention_reference(q, k, v)
    out, lse = flash_attention_fwd(q, k, v)
    ref = ref.float()
    limit = %r * ref.square().mean().sqrt() + %r * ref.abs()
    ratio = ((out.float() - ref).abs() / limit).max().item()
    lse_ratio = (lse - ref_lse).abs().max().item() / %r
    worst[str(shape)] = ratio if ratio != ratio else max(ratio, lse_ratio)  # NaN stays NaN
print(json.dumps(worst))
"""


def _broken_copy(tmp_path, source, edits):
    """agenda_tpu_torch copied into tmp_path with `edits` (old, new) made to csrc/<source>."""
    kernel_variants.copy_package(tmp_path, [(source, old, new) for old, new in edits])


def _worst_over_limit(tmp_path, script):
    run = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", sorted(FLASH_MUTATIONS))
def test_flash_limit_fails_broken_kernels(mutation, tmp_path):
    """Build a broken copy of the package in tmp_path; the limit must fail it at every shape."""
    _need_cuda()
    _broken_copy(tmp_path, "flash_fwd.cu", FLASH_MUTATIONS[mutation])
    worst = _worst_over_limit(tmp_path, _WORST_ERROR_OVER_LIMIT % (
        FLASH_MUTATION_SHAPES[mutation], FLASH_ATOL_RMS, FLASH_RTOL, FLASH_TOL_LSE))
    print(f"{mutation}: worst error over the limit (output or lse) per shape {worst}")
    assert all(not r <= 1.0 for r in worst.values()), worst  # NaN fails too


@pytest.mark.parametrize("mutation", sorted(FLASH_MUTATIONS))
def test_flash_forward_mutations_apply_to_the_source(mutation):
    """Runs anywhere: each edit of each broken forward copy above finds exactly
    one place in the source, so the card test keeps testing what it names."""
    src = (Path(agenda_tpu_torch.__file__).parent / "csrc" / "flash_fwd.cu").read_text()
    assert all(src.count(old) == 1 and (not new or new not in src)
               for old, new in FLASH_MUTATIONS[mutation])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4096, 8, 40), (4, 256, 8, 160), (2, 1000, 8, 40),
                                   (4, 1700, 8, 40), (2, 300, 4, 80), (1, 333, 2, 264)])
def test_flash_forward_is_deterministic(shape):
    """Each output element has one owner and a fixed summation order: two
    launches on the same inputs give bitwise-equal outputs and lse."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(3))
    first, second = flash_attention_fwd(q, k, v), flash_attention_fwd(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_wrapper_raises_instead_of_falling_back():
    _need_cuda()
    q = torch.randn(1, 64, 2, 40, device="cuda")
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q)  # f32 on the card: the kernel takes bf16
    qb = q.bfloat16()
    with pytest.raises(ValueError):
        flash_attention_fwd(qb, qb, qb.transpose(1, 3).contiguous().transpose(1, 3))
    with pytest.raises(ValueError):
        flash_attention_fwd(*(torch.zeros(1, 8, 1, 720, device="cuda").bfloat16(),) * 3)
    with pytest.raises(ValueError):  # D not a multiple of 8
        flash_attention_fwd(*(torch.zeros(1, 8, 1, 36, device="cuda").bfloat16(),) * 3)
    wide = torch.zeros(1, 8, 1, 48, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # 2-byte offset: not 16-byte aligned
        flash_attention_fwd(*(wide[..., 1:41],) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,eps,act", [((4, 320, 64, 64), 1e-5, "silu"),
                                           ((2, 512, 64, 64), 1e-6, None),
                                           ((2, 128, 512, 512), 1e-6, "silu"),
                                           ((2, 256, 512, 512), 1e-6, "silu"),
                                           ((4, 1280, 8, 8), 1e-5, "silu"),
                                           ((1, 96, 8, 9), 1e-6, "silu")])
def test_groupnorm_kernel_matches_plain(shape, eps, act):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).bfloat16()
    w = torch.randn(shape[1], device="cuda", generator=g)
    b = torch.randn(shape[1], device="cuda", generator=g)
    before = group_norm_act.launches
    y = group_norm_act(x, w, b, 32, eps, act)
    ref = group_norm_act_reference(x, w, b, 32, eps, act)
    assert group_norm_act.launches == before + 1
    assert bool(((y.float() - ref.float()).abs() <= GN_ATOL + GN_RTOL * ref.float().abs()).all())


@pytest.mark.cuda
def test_groupnorm_wrapper_raises_instead_of_falling_back():
    _need_cuda()
    x = torch.randn(2, 64, 8, 8, device="cuda").bfloat16()
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        group_norm_act(x.float(), w, b, 32, 1e-5)
    with pytest.raises(TypeError):
        group_norm_act(x, w.bfloat16(), b.bfloat16(), 32, 1e-5)
    with pytest.raises(ValueError):
        group_norm_act(x.to(memory_format=torch.channels_last), w, b, 32, 1e-5)
    # H*W not a multiple of 8 raised before the kernel had its tail path; now
    # it runs the kernel and agrees with the plain version
    odd = x[:, :, :7, :7].contiguous()
    before = group_norm_act.launches
    y = group_norm_act(odd, w, b, 32, 1e-5)
    assert group_norm_act.launches == before + 1
    _assert_gn_close(y, group_norm_act_reference(odd, w, b, 32, 1e-5))


def _assert_gn_close(y, ref):
    assert bool(((y.float() - ref.float()).abs() <= GN_ATOL + GN_RTOL * ref.float().abs()).all())


# the tail path: the UNet's 6x6 and 10x10 levels (384 and 640 pixels), where
# a 16-byte chunk crosses a channel boundary; spans whose length is not a
# multiple of 8, so that later spans start off a 16-byte boundary; and a
# clustered span (VAE-sized) whose H*W is odd
GN_TAIL_SHAPES = [(2, 1280, 6, 6), (2, 1280, 10, 10), (2, 640, 10, 10), (2, 640, 6, 6),
                  (2, 64, 3, 3), (3, 96, 7, 5), (1, 32, 1, 1), (2, 128, 255, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GN_TAIL_SHAPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_groupnorm_tail_path_matches_plain(shape, act):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).bfloat16()
    w = torch.randn(shape[1], device="cuda", generator=g)
    b = torch.randn(shape[1], device="cuda", generator=g)
    before = group_norm_act.launches
    _assert_gn_close(group_norm_act(x, w, b, 32, 1e-5, act),
                     group_norm_act_reference(x, w, b, 32, 1e-5, act))
    # the same values at a base 2, 6 and 14 bytes past a 16-byte boundary
    for off in (1, 3, 7):
        buf = torch.empty(x.numel() + 8, device="cuda", dtype=torch.bfloat16)
        xo = buf[off:off + x.numel()].view(shape)
        xo.copy_(x)
        assert xo.data_ptr() % 16 == 2 * off
        _assert_gn_close(group_norm_act(xo, w, b, 32, 1e-5, act),
                         group_norm_act_reference(xo, w, b, 32, 1e-5, act))
    assert group_norm_act.launches == before + 4


# Broken copies of csrc/groupnorm.cu that the group-norm tolerance must fail
# at every shape below: the VAE's, where a cluster of two blocks shares each
# span (the inputs' mean varies across the channels of a group, so each
# block's slice has its own).
GN_MUTATIONS = {
    "cluster_rank_dropped": [
        ("sum = lane < (int)cs ? hopper::ld_cluster_f2(&total, lane)",
         "sum = lane < (int)cs && lane != 1 ? hopper::ld_cluster_f2(&total, lane)")],
    "mean_over_one_block": [
        ("sum = lane < (int)cs ? hopper::ld_cluster_f2(&total, lane) : make_float2(0.f, 0.f);",
         "sum = lane == 0 ? make_float2(sum.x * cs, sum.y * cs) : make_float2(0.f, 0.f);")],
}
GN_MUTATION_SHAPES = [(2, 512, 64, 64), (2, 256, 256, 256), (2, 128, 512, 512),
                      (2, 256, 512, 512)]
_GN_WORST_ERROR_OVER_LIMIT = """
import json, torch
from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference
worst = {}
for shape in %r:
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    c = shape[1]
    offset = 4.0 * (torch.arange(c, device="cuda") %% (c // 32)) / (c // 32)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + offset[:, None, None]).bfloat16()
    w = torch.randn(c, device="cuda", generator=g)
    b = torch.randn(c, device="cuda", generator=g)
    ref = group_norm_act_reference(x, w, b, 32, 1e-6, "silu").float()
    diff = (group_norm_act(x, w, b, 32, 1e-6, "silu").float() - ref).abs()
    worst[str(shape)] = (diff / (%r + %r * ref.abs())).max().item()
print(json.dumps(worst))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", sorted(GN_MUTATIONS))
def test_groupnorm_tolerance_fails_broken_kernels(mutation, tmp_path):
    """Build a broken copy of the group norm in tmp_path; its tolerance must
    fail it at every shape (the sound kernel stays within it, as these
    inputs show in test_groupnorm_kernel_matches_plain's shapes)."""
    _need_cuda()
    _broken_copy(tmp_path, "groupnorm.cu", GN_MUTATIONS[mutation])
    worst = _worst_over_limit(tmp_path, _GN_WORST_ERROR_OVER_LIMIT % (
        GN_MUTATION_SHAPES, GN_ATOL, GN_RTOL))
    print(f"{mutation}: worst |y - ref| / tolerance per shape {worst}")
    assert all(not r <= 1.0 for r in worst.values()), worst  # NaN fails too


@pytest.mark.parametrize("mutation", sorted(GN_MUTATIONS))
def test_groupnorm_mutations_apply_to_the_source(mutation):
    """Runs anywhere: each broken group-norm copy above edits exactly one place."""
    src = (Path(agenda_tpu_torch.__file__).parent / "csrc" / "groupnorm.cu").read_text()
    assert all(src.count(old) == 1 and new not in src for old, new in GN_MUTATIONS[mutation])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 512, 512), (4, 320, 64, 64), (4, 1280, 8, 8)])
def test_groupnorm_is_deterministic(shape):
    """Every block of a cluster sums the cluster's pairs in rank order: two
    launches give bitwise-equal outputs."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 0.5).bfloat16()
    w, b = torch.randn(shape[1], device="cuda", generator=g), torch.zeros(shape[1], device="cuda")
    assert torch.equal(group_norm_act(x, w, b, 32, 1e-6, "silu"),
                       group_norm_act(x, w, b, 32, 1e-6, "silu"))


# -- training kernels: flash backward (dK/dV, dQ) and the fused int8 AdamW ---------

# The backward's limit is the forward's: the kernels round P and dS to bf16
# before their products and store the gradients in bf16 (chip_smoke.py).
ADAMW_KW = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)


# the wide backward (D > 160, mma.sync): the VAE step's shape, a longer S,
# and ragged S at D = 264 (zero-padded to the tiles' 512) and at D = 512
WIDE_BWD_SHAPES = [(8, 1024, 1, 512), (2, 4096, 1, 512), (1, 333, 2, 264), (1, 77, 2, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160),
                                   (4, 64, 8, 160), (2, 1000, 8, 40), (1, 333, 2, 152),
                                   (1, 77, 3, 24), *WIDE_BWD_SHAPES])
def test_flash_backward_kernels_match_plain(shape):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(out, do)
    before = (fl.flash_attention_bwd_dkv.launches, fl.flash_attention_bwd_dq.launches)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    dq = fl.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    assert (fl.flash_attention_bwd_dkv.launches, fl.flash_attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    rk, rv = fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta)
    rq = fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta)
    for got, ref in ((dk, rk), (dv, rv), (dq, rq)):
        assert got.dtype == torch.bfloat16 and got.shape == shape
        _assert_flash_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 8, 80), (2, 1000, 8, 40), (1, 333, 2, 152),
                                   (8, 1024, 1, 512), (1, 333, 2, 264)])
def test_flash_backward_kernels_are_deterministic(shape):
    """Each gradient element has one owner and a fixed summation order: two
    launches on the same inputs give bitwise-equal dK, dV and dQ."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(out, do)
    first = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
             fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
    second = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
              fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# Broken copies of csrc/flash_bwd.cu that the backward's limit must fail at
# every shape of test_flash_backward_kernels_match_plain.
FLASH_BWD_MUTATIONS = {
    "q_tile_from_wrong_ring_stage": (
        "const uint32_t q_s = smem_u32(Qs + s * T::kTileBytes);",
        "const uint32_t q_s = smem_u32(Qs + (s + 1) % T::kStages * T::kTileBytes);"),
    "drop_first_k_step_of_dk": (
        "WgmmaRS<ND, 1>::run(dk, pb[kk], desc_mn_major<BQ>(q_s, kk), 1);",
        "if (kk > 0) WgmmaRS<ND, 1>::run(dk, pb[kk], desc_mn_major<BQ>(q_s, kk), 1);"),
    "skip_last_query_tile_of_dkv": (
        "    mbar_wait(&full[s], (i / T::kStages) & 1);\n",
        "    mbar_wait(&full[s], (i / T::kStages) & 1);\n    if (i + 1 == n_tiles) break;\n"),
    "skip_last_key_tile_of_dq": (
        "    mbar_wait(&full[st], (j / T::kStages) & 1);\n",
        "    mbar_wait(&full[st], (j / T::kStages) & 1);\n    if (j + 1 == n_tiles) break;\n"),
    # the wide kernels: a query past S keeps its probabilities (the rows past S
    # are loaded as row S - 1), a key past S likewise, and dK written from the
    # next quarter of D's columns
    "wide_query_mask_dropped": (
        "l[u] = q < p.S ? lse[qr] * kLog2e : INFINITY;",
        "l[u] = lse[qr] * kLog2e;"),
    "wide_key_mask_dropped": (
        "const float pv = key < p.S ? exp2f(s[x] * p.scale_log2 - l[x >> 1]) : 0.f;",
        "const float pv = exp2f(s[x] * p.scale_log2 - l[x >> 1]);"),
    "wide_dk_from_wrong_d_slice": (
        "store_wide(p.dk + off, dk, k0 + 16 * w.slice, w.c0, p.scale, p);",
        "store_wide(p.dk + off, dk, k0 + 16 * w.slice, (w.c0 + kCols) % kDP, p.scale, p);"),
}
FLASH_BWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                    (2, 1000, 8, 40), (1, 333, 2, 152), (1, 77, 3, 24)]
# each broken copy is held to the shapes where the code it breaks runs: the
# wgmma kernels' at D <= 160, the wide masks' only on a ragged S
FLASH_BWD_MUTATION_SHAPES = {
    **{name: FLASH_BWD_SHAPES for name in FLASH_BWD_MUTATIONS if not name.startswith("wide_")},
    "wide_query_mask_dropped": [(1, 333, 2, 264), (1, 77, 2, 512)],
    "wide_key_mask_dropped": [(1, 333, 2, 264), (1, 77, 2, 512)],
    "wide_dk_from_wrong_d_slice": [(8, 1024, 1, 512), (1, 333, 2, 264)],
}
_WORST_BWD_ERROR_OVER_LIMIT = """
import json, torch
from agenda_tpu_torch.kernels import flash as fl
worst = {}
for shape in %r:
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(4))
    out, lse = fl.flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(out, do)
    got = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
           fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
    want = (*fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta),
            fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta))
    ratio = 0.0
    for x, ref in zip(got, want):
        ref = ref.float()
        limit = %r * ref.square().mean().sqrt() + %r * ref.abs()
        r = ((x.float() - ref).abs() / limit).max().item()
        ratio = r if r != r else max(ratio, r)  # NaN stays NaN
    worst[str(shape)] = ratio
print(json.dumps(worst))
"""


@pytest.mark.parametrize("mutation", sorted(FLASH_BWD_MUTATIONS))
def test_flash_backward_mutations_apply_to_the_source(mutation):
    """Runs anywhere: each broken copy above edits exactly one place of the
    backward's source, so the card test keeps testing what it names."""
    src = (Path(agenda_tpu_torch.__file__).parent / "csrc" / "flash_bwd.cu").read_text()
    old, new = FLASH_BWD_MUTATIONS[mutation]
    assert src.count(old) == 1 and new not in src


def test_chip_smoke_reads_ptxas_registers_and_spills():
    """Runs anywhere: chip_smoke.py's report of each kernel instantiation."""
    chip_smoke = _root_module("chip_smoke")
    name = "_ZN45_GLOBAL__N__c8e2eb60_12_flash_bwd_cu_2c9866a3{}ILi{}EEEvNS_9BwdParamsE"
    fwd = "_ZN45_GLOBAL__N__0d1c2e3f_12_flash_fwd_cu_1a2b3c4d22flash_fwd_wgmma_kernelILi40ELi3EEEvNS_9FwdParamsE"
    log = "\n".join([
        "== flash_bwd.cu",
        f"ptxas info    : Compiling entry function '{name.format('19flash_bwd_dq_kernel', 40)}' "
        "for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('19flash_bwd_dq_kernel', 40)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 113 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{name.format('20flash_bwd_dkv_kernel', 80)}' "
        "for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format('20flash_bwd_dkv_kernel', 80)}",
        "    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 24 bytes cumulative stack size",
        "== flash_fwd.cu",
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 150 registers, used 4 barriers",
        "== groupnorm.cu",
        "    8 bytes stack frame, 12 bytes spill stores, 32 bytes spill loads",
        "ptxas info    : Used 32 registers, used 1 barriers, 132 bytes smem",
    ])
    assert chip_smoke.ptxas_report(log) == {
        "flash_bwd_dq_kernel<40>": "113 registers, 0 bytes stack frame, 0 bytes spill stores, "
                                   "0 bytes spill loads",
        "flash_bwd_dkv_kernel<80>": "168 registers, 24 bytes stack frame, 20 bytes spill "
                                    "stores, 20 bytes spill loads",
        "flash_fwd_wgmma_kernel<40, 3>": "150 registers, 0 bytes stack frame, 0 bytes spill "
                                         "stores, 0 bytes spill loads"}


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", sorted(FLASH_BWD_MUTATIONS))
def test_flash_backward_limit_fails_broken_kernels(mutation, tmp_path):
    """Build a broken copy of the backward in tmp_path; the limit must fail it
    at every shape (the sound kernels stay within it: the test above)."""
    _need_cuda()
    _broken_copy(tmp_path, "flash_bwd.cu", [FLASH_BWD_MUTATIONS[mutation]])
    worst = _worst_over_limit(tmp_path, _WORST_BWD_ERROR_OVER_LIMIT % (
        FLASH_BWD_MUTATION_SHAPES[mutation], FLASH_ATOL_RMS, FLASH_RTOL))
    print(f"{mutation}: worst |grad - ref| / limit per shape {worst}")
    assert all(not r <= 1.0 for r in worst.values()), worst  # NaN fails too


def test_chip_smoke_reads_adamw_ptxas():
    """Runs anywhere: both AdamW instantiations (without and with the EMA
    shadow) in chip_smoke.py's ptxas report, named by their bool argument."""
    chip_smoke = _root_module("chip_smoke")
    name = ("_ZN47_GLOBAL__N__da3835c9_14_fused_adamw_cu_1d39184e22fused_adamw8bit_kernel"
            "ILb{}EEEvNS_12LeavesParamsE")
    lines = ["== fused_adamw.cu", "ptxas info    : 0 bytes gmem"]
    for ema, regs in ((0, 96), (1, 121)):
        lines += [f"ptxas info    : Compiling entry function '{name.format(ema)}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name.format(ema)}",
                  "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers, 1032 bytes smem"]
    assert chip_smoke.ptxas_report("\n".join(lines)) == {
        f"fused_adamw8bit_kernel<{ema}>": f"{regs} registers, 0 bytes stack frame, 0 bytes "
                                          "spill stores, 0 bytes spill loads"
        for ema, regs in ((0, 96), (1, 121))}


@pytest.mark.cuda
def test_flash_autograd_reads_strided_views_both_ways():
    """Gradients through ``flash_attention`` of head-split views of one packed
    projection, against autograd through the plain attention in f32."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(2, 256, 3, 4, 40, device="cuda", generator=g).bfloat16().requires_grad_()
    do = torch.randn(2, 256, 4, 40, device="cuda", generator=g).bfloat16()
    fl.flash_attention(*qkv.unbind(dim=2)).backward(do)
    ref = qkv.detach().float().requires_grad_()
    q, k, v = ref.unbind(dim=2)
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 40 ** 0.5, dim=-1)
    torch.einsum("bhqk,bkhd->bqhd", probs, v).backward(do.float())
    _assert_flash_close(qkv.grad, ref.grad)


@pytest.mark.cuda
def test_flash_backward_wrapper_raises_instead_of_falling_back():
    _need_cuda()
    x = torch.randn(1, 64, 2, 40, device="cuda")
    lse = torch.zeros(2, 64, device="cuda")
    with pytest.raises(TypeError):
        fl.flash_attention_bwd_dkv(x, x, x, x, lse, lse)  # f32 on the card
    wide = torch.zeros(1, 64, 1, 520, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # D above the backward's 512
        fl.flash_attention_bwd_dq(wide, wide, wide, wide, lse[:1], lse[:1])
    xb = x.bfloat16()
    with pytest.raises(ValueError):  # lse of the wrong shape
        fl.flash_attention_bwd_dq(xb, xb, xb, xb, lse[:1], lse[:1])


def _adamw_inputs(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = (n + 255) // 256
    return [torch.randn(n, device="cuda", generator=g),
            torch.randn(n, device="cuda", generator=g) * 1e-3,
            torch.randint(-127, 128, (n,), device="cuda", generator=g).to(torch.int8),
            torch.rand(nb, device="cuda", generator=g) * 1e-3,
            torch.randint(0, 128, (n,), device="cuda", generator=g).to(torch.int8),
            torch.rand(nb, device="cuda", generator=g) * 1e-6,
            torch.randn(n, device="cuda", generator=g)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1280 * 1280 * 9, 4096, 77_000, 300])
@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("clip", [1.0, 0.25])
def test_fused_adamw_kernel_matches_plain(n, ema, clip):
    """Params and shadow to f32 rounding, codes within one, scales to 1e-5."""
    _need_cuda()
    p, grad, qm, sm, qv, sv, e = _adamw_inputs(n, n + ema)
    scalars = torch.tensor([1e-4, clip, 0.271, 0.0029701, 0.97], device="cuda")
    ours = [t.clone() for t in (p, grad, qm, sm, qv, sv)]
    ref = [t.clone() for t in (p, grad, qm, sm, qv, sv)]
    e_ours, e_ref = (e.clone(), e.clone()) if ema else (None, None)
    counter = "launches_ema" if ema else "launches"
    before = getattr(fused_adamw8bit_leaves, counter)
    fused_adamw8bit_leaf(*ours, scalars, ema=e_ours, **ADAMW_KW)
    fused_adamw8bit_leaf_reference(*ref, scalars, ema=e_ref, **ADAMW_KW)
    assert getattr(fused_adamw8bit_leaves, counter) == before + 1
    assert (ours[0] - ref[0]).abs().max().item() <= 1e-6
    for i in (2, 4):
        assert (ours[i].int() - ref[i].int()).abs().max().item() <= 1
    for i in (3, 5):
        assert ((ours[i] - ref[i]).abs() / ref[i].abs().clamp(min=1e-30)).max().item() <= 1e-5
    if ema:
        assert (e_ours - e_ref).abs().max().item() <= 1e-6


def _assert_adamw_close(ours, ref, e_ours=None, e_ref=None):
    """Params and shadow to f32 rounding, codes within one, scales to 1e-5."""
    assert (ours[0] - ref[0]).abs().max().item() <= 1e-6
    for i in (2, 4):
        assert (ours[i].int() - ref[i].int()).abs().max().item() <= 1
    for i in (3, 5):
        assert ((ours[i] - ref[i]).abs() / ref[i].abs().clamp(min=1e-30)).max().item() <= 1e-5
    if e_ours is not None:
        assert (e_ours - e_ref).abs().max().item() <= 1e-6


# one launch over leaves of every kind: a ragged one-row leaf, a small one, a
# ragged many-row one and the largest leaf shape of the UNet
ADAMW_LIST = [300, 4096, 77_000, 1280 * 1280 * 9]


@pytest.mark.cuda
@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("clip", [1.0, 0.25])
def test_fused_adamw_leaves_one_launch_matches_plain(ema, clip):
    """All leaves in one launch, held leaf by leaf to the plain version."""
    _need_cuda()
    leaves = [_adamw_inputs(n, i) for i, n in enumerate(ADAMW_LIST)]
    scalars = torch.tensor([1e-4, clip, 0.271, 0.0029701, 0.97], device="cuda")
    ours = [[t.clone() for t in leaf[:6]] for leaf in leaves]
    ref = [[t.clone() for t in leaf[:6]] for leaf in leaves]
    e_ours = [leaf[6].clone() for leaf in leaves] if ema else None
    e_ref = [leaf[6].clone() for leaf in leaves] if ema else None
    counter = "launches_ema" if ema else "launches"
    before = (getattr(fused_adamw8bit_leaves, counter),
              getattr(fused_adamw8bit_leaves, "leaves_ema" if ema else "leaves"))
    fused_adamw8bit_leaves(ours, scalars, emas=e_ours, **ADAMW_KW)
    fused_adamw8bit_leaves_reference(ref, scalars, emas=e_ref, **ADAMW_KW)
    assert (getattr(fused_adamw8bit_leaves, counter),
            getattr(fused_adamw8bit_leaves, "leaves_ema" if ema else "leaves")) == (
        before[0] + 1, before[1] + len(ADAMW_LIST))
    for i in range(len(ADAMW_LIST)):
        _assert_adamw_close(ours[i], ref[i], *((e_ours[i], e_ref[i]) if ema else ()))


@pytest.mark.cuda
def test_fused_adamw_kernel_does_not_drift_from_plain():
    """20 updates of one leaf from zero moments, each side feeding its own
    codes and scales into its next update, with fresh gradients each step.
    A code differs from the plain version's only where a ratio lies within an
    ulp of a bin edge; such an element's moment is then a bin (14%) apart on
    the two sides until it decays, which moves its update by a fraction of
    lr * |u| a step (|u| <= (1 - b1) / sqrt(1 - b2) ~ 3.2 for Adam). So: every
    param within 20 steps x lr x 3.2 x 0.3, and all but 0.1% of params within
    20 x 1e-6 (f32 rounding a step) and of codes equal."""
    _need_cuda()
    n, lr, steps = 1280 * 1280 * 3, 1e-4, 20
    g = torch.Generator(device="cuda").manual_seed(20)
    p = torch.randn(n, device="cuda", generator=g)
    nb = n // 256
    ours = [p.clone(), None, torch.zeros(n, dtype=torch.int8, device="cuda"),
            torch.zeros(nb, device="cuda"), torch.zeros(n, dtype=torch.int8, device="cuda"),
            torch.zeros(nb, device="cuda")]
    ref = [t.clone() if t is not None else None for t in ours]
    for step in range(1, steps + 1):
        grad = torch.randn(n, device="cuda", generator=g) * 1e-3
        scalars = torch.tensor([lr, 1.0, 1 - 0.9 ** step, 1 - 0.999 ** step], device="cuda")
        ours[1], ref[1] = grad, grad.clone()
        fused_adamw8bit_leaf(*ours, scalars, **ADAMW_KW)
        fused_adamw8bit_leaf_reference(*ref, scalars, **ADAMW_KW)
    diff = (ours[0] - ref[0]).abs()
    print(f"after {steps} updates: max |p - ref| {diff.max().item():.3g}, share past "
          f"{steps}e-6 {(diff > steps * 1e-6).float().mean().item():.3g}, codes differing "
          f"{[(ours[i] != ref[i]).float().mean().item() for i in (2, 4)]}")
    assert diff.max().item() <= steps * lr * 3.2 * 0.3
    assert (diff > steps * 1e-6).float().mean().item() <= 1e-3
    for i in (2, 4):
        assert (ours[i] != ref[i]).float().mean().item() <= 1e-3


# Broken copies of csrc/fused_adamw.cu that the AdamW limits must fail on
# ADAMW_LIST in one launch, with and without EMA (the sound kernel stays
# within them: test_fused_adamw_leaves_one_launch_matches_plain).
ADAMW_MUTATIONS = {
    # the table's largest magnitudes (the row absmax's) one place down
    "deq_table_entry_off_by_one": (
        "expf(__fmul_rn(kDeqK, mag - 127.f))",
        "expf(__fmul_rn(kDeqK, (mag == 127.f ? 126.f : mag) - 127.f))"),
    # the first row of every leaf after the first is taken as a row of the
    # leaf before (past its end: nothing is loaded or stored but a scale)
    "row_given_the_leaf_before": (
        "while (r >= a.row0[leaf + 1]) ++leaf;", "while (r > a.row0[leaf + 1]) ++leaf;"),
    "row_absmax_dropped": ("    mmax = half_max(mmax);\n", ""),
}
_ADAMW_WORST_OVER_LIMIT = """
import json, torch
from agenda_tpu_torch.kernels.fused_adamw import fused_adamw8bit_leaves, fused_adamw8bit_leaves_reference
kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
worst = {}
for ema in (False, True):
    g = torch.Generator(device="cuda").manual_seed(7)
    leaves, emas = [], []
    for n in %r:
        nb = (n + 255) // 256
        leaves.append([torch.randn(n, device="cuda", generator=g),
                       torch.randn(n, device="cuda", generator=g) * 1e-3,
                       torch.randint(-127, 128, (n,), device="cuda", generator=g).to(torch.int8),
                       torch.rand(nb, device="cuda", generator=g) * 1e-3,
                       torch.randint(0, 128, (n,), device="cuda", generator=g).to(torch.int8),
                       torch.rand(nb, device="cuda", generator=g) * 1e-6])
        emas.append(torch.randn(n, device="cuda", generator=g))
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    e_ref = [e.clone() for e in emas]
    scalars = torch.tensor([1e-4, 0.25, 0.271, 0.0029701, 0.97], device="cuda")
    fused_adamw8bit_leaves(leaves, scalars, emas=emas if ema else None, **kw)
    fused_adamw8bit_leaves_reference(ref, scalars, emas=e_ref if ema else None, **kw)
    ratio = 0.0
    for ours, want, e1, e2 in zip(leaves, ref, emas, e_ref):
        parts = [(ours[0] - want[0]).abs().max().item() / 1e-6,
                 max((ours[i].int() - want[i].int()).abs().max().item() for i in (2, 4)),
                 max(((ours[i] - want[i]).abs() / want[i].abs().clamp(min=1e-30)).max().item()
                     for i in (3, 5)) / 1e-5]
        if ema:
            parts.append((e1 - e2).abs().max().item() / 1e-6)
        for r in parts:
            ratio = r if r != r else max(ratio, r)  # NaN stays NaN
    worst["ema" if ema else "no_ema"] = ratio
print(json.dumps(worst))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", sorted(ADAMW_MUTATIONS))
def test_fused_adamw_limits_fail_broken_kernels(mutation, tmp_path):
    """Build a broken copy of the AdamW in tmp_path; its limits (params and
    shadow 1e-6, codes within one, scales 1e-5 relative) must fail it with
    and without the EMA shadow."""
    _need_cuda()
    _broken_copy(tmp_path, "fused_adamw.cu", [ADAMW_MUTATIONS[mutation]])
    worst = _worst_over_limit(tmp_path, _ADAMW_WORST_OVER_LIMIT % (ADAMW_LIST,))
    print(f"{mutation}: worst error over its limit {worst}")
    assert all(not r <= 1.0 for r in worst.values()), worst  # NaN fails too


@pytest.mark.parametrize("mutation", sorted(ADAMW_MUTATIONS))
def test_fused_adamw_mutations_apply_to_the_source(mutation):
    """Runs anywhere: each broken AdamW copy above edits exactly one place."""
    src = (Path(agenda_tpu_torch.__file__).parent / "csrc" / "fused_adamw.cu").read_text()
    old, new = ADAMW_MUTATIONS[mutation]
    assert src.count(old) == 1 and (not new or new not in src)


@pytest.mark.cuda
def test_fused_adamw_wrapper_raises_instead_of_falling_back():
    _need_cuda()
    p, grad, qm, sm, qv, sv, _ = _adamw_inputs(1024, 0)
    scalars = torch.tensor([1e-4, 1.0, 0.1, 0.001], device="cuda")
    with pytest.raises(ValueError):  # f16 gradient
        fused_adamw8bit_leaf(p, grad.half(), qm, sm, qv, sv, scalars, **ADAMW_KW)
    with pytest.raises(ValueError):  # not 16-byte aligned
        fused_adamw8bit_leaf(p[1:1000], grad[1:1000], qm[1:1000], sm[:4], qv[1:1000], sv[:4],
                             scalars, **ADAMW_KW)
    with pytest.raises(ValueError):  # the EMA needs its decay in scalars[4]
        fused_adamw8bit_leaf(p, grad, qm, sm, qv, sv, scalars, ema=p.clone(), **ADAMW_KW)
    with pytest.raises(ValueError):  # int8 codes at an 8-byte offset: not 16-byte aligned
        fused_adamw8bit_leaves([(p[:512], grad[:512], qm[8:520], sm[:2], qv[:512], sv[:2])],
                               scalars, **ADAMW_KW)


def _greedy_nms_loop(boxes, scores, iou_thr, k, score_thr):
    """Plain greedy NMS of one image, one box at a time, in float64 numpy."""
    import numpy as np

    order = np.argsort(-scores, kind="stable")
    alive = scores[order] > score_thr
    b = boxes[order].astype(np.float64)
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    for r in range(len(order)):
        if not alive[r]:
            continue
        for j in range(r + 1, len(order)):
            w = max(0.0, min(b[r, 2], b[j, 2]) - max(b[r, 0], b[j, 0]))
            h = max(0.0, min(b[r, 3], b[j, 3]) - max(b[r, 1], b[j, 1]))
            union = area[r] + area[j] - w * h
            if union > 0 and w * h / union > iou_thr:
                alive[j] = False
    kept = order[alive][:k]
    return np.concatenate([kept, np.zeros(k - len(kept), kept.dtype)]), np.arange(k) < len(kept)


@pytest.mark.cuda
def test_batched_nms_on_the_card_matches_the_plain_loop():
    """The labelling NMS (YOLOv8n at 128 px: N = 336 anchors, K = 300) on
    the card, all images in one rank loop, against a plain CPU loop per
    image; scores drawn from a few values, so ties are everywhere."""
    import numpy as np

    from agenda_tpu_torch.detect.ops import nms_images

    _need_cuda()
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 128, (24, 336, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 48, (24, 336, 2))], -1).astype(np.float32)
    boxes = np.round(boxes)  # integer corners: the IoU is exact in f32 and f64 alike
    scores = rng.choice(np.asarray([0.0005, 0.01, 0.02, 0.3, 0.7], np.float32), (24, 336))
    keep, valid = nms_images(torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda(),
                             0.7, 300, 0.001)
    for i in range(24):
        want_keep, want_valid = _greedy_nms_loop(boxes[i], scores[i], 0.7, 300, 0.001)
        assert (valid[i].cpu().numpy() == want_valid).all(), i
        assert (keep[i].cpu().numpy() == want_keep).all(), i


@pytest.mark.cuda
def test_yolov8n_predicts_on_the_card_as_on_the_cpu():
    """YOLOv8n (seeded init, batch-norm statistics measured on noise) on one
    batch of 32 at 128 px: each head output within 6e-4 rms(ref) in f32
    (TF32 off), and at most 2% of the kept detections without a partner at
    IoU >= 0.99 and |d score| <= 1e-3 (near-tied scores may trade places in
    NMS). The limits are chip_smoke.py's. The same heads with TF32 on, the
    control, fail the head limit."""
    from agenda_tpu_torch.detect.fabricate import calibrate_batch_norm
    from agenda_tpu_torch.detect.families import build_family
    from agenda_tpu_torch.detect.runner import full_f32

    _need_cuda()
    fam = build_family("yolov8")
    g = torch.Generator().manual_seed(0)
    state = calibrate_batch_norm(fam, fam.init_variables(g), torch.rand(16, 128, 128, 3,
                                                                        generator=g))
    images = torch.rand(32, 128, 128, 3, generator=g)
    on_card = {k: v.cuda() for k, v in state.items()}
    with full_f32(torch.device("cuda")):
        heads = fam.forward(on_card, images.cuda())
        boxes, scores, valid = (t.cpu() for t in fam.predict_fn(on_card, images.cuda()))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                        allow_tf32=True):
            control = fam.forward(on_card, images.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ref_heads = fam.forward(state, images)

    def rel_err(outs):
        return max(float((out.cpu() - ref).abs().max()) / float(ref.square().mean().sqrt())
                   for pair, ref_pair in zip(outs, ref_heads) for out, ref in zip(pair, ref_pair))

    err, control_err = rel_err(heads), rel_err(control)
    assert err <= 6e-4 < control_err, (err, control_err)
    ref_boxes, ref_scores, ref_valid = fam.predict_fn(state, images)
    from agenda_tpu_torch.detect.ops import box_iou

    kept = unmatched = 0
    for i in range(32):
        a, sa = boxes[i][valid[i]], scores[i][valid[i]]
        r, sr = ref_boxes[i][ref_valid[i]], ref_scores[i][ref_valid[i]]
        ok = (box_iou(a, r) >= 0.99) & ((sa[:, None] - sr[None, :]).abs() <= 1e-3)
        kept += len(a)
        unmatched += int((~ok.any(dim=1)).sum())
    assert kept > 32 and unmatched <= 0.02 * kept, (unmatched, kept)


@pytest.mark.cuda
def test_runner_test_on_the_card_as_on_the_cpu(tmp_path):
    """DetectorRunner.test, the path det_test runs (pinned staging buffers
    reused every other batch, one packed copy back a batch), with YOLOv8n
    over 40 tiles at batch 16: three batches, the last padded. The card's
    records equal the CPU's in image path and GT fields, and at most 2% of
    the detections go without a partner either way (IoU >= 0.99, |d score|
    <= 1e-3), as chip_smoke.py holds it at batch 192."""
    import numpy as np

    from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig
    from agenda_tpu_torch.detect.fabricate import fabricate_detector, write_square_set
    from agenda_tpu_torch.detect.ops import box_iou
    from agenda_tpu_torch.detect.runner import DetectorRunner, load_variables

    _need_cuda()
    write_square_set(str(tmp_path / "data"), 40)
    config, ckpt = fabricate_detector(str(tmp_path / "work"), batch_size=16)
    cfg = DetectionConfig.from_json(config)
    ds = cfg.build_eval_dataset(DatasetSpec(str(tmp_path / "data"), "ann.json"))
    state = load_variables(ckpt)
    card, ref = (DetectorRunner(cfg.build_family(), cfg.runner, device=d).test(state, ds)
                 for d in ("cuda", "cpu"))
    assert len(card) == len(ref) == 40

    def unmatched(p, q):
        ok = (box_iou(torch.from_numpy(p["bboxes"]), torch.from_numpy(q["bboxes"])) >= 0.99) & (
            (torch.from_numpy(p["scores"])[:, None] - torch.from_numpy(q["scores"])[None, :])
            .abs() <= 1e-3)
        return int((~ok.any(dim=1)).sum())

    kept = ref_kept = lost = ref_lost = 0
    for a, r in zip(card, ref):
        assert a["img_path"] == r["img_path"]
        for key in ("bboxes", "labels"):
            assert np.array_equal(a["gt_instances"][key], r["gt_instances"][key])
        pa, pr = a["pred_instances"], r["pred_instances"]
        kept, ref_kept = kept + len(pa["scores"]), ref_kept + len(pr["scores"])
        lost, ref_lost = lost + unmatched(pa, pr), ref_lost + unmatched(pr, pa)
    assert kept > 40 and lost <= 0.02 * kept and ref_lost <= 0.02 * ref_kept, (
        lost, kept, ref_lost, ref_kept)


def _classifier_step(dev, state_dict, images, labels, mask, dtype=torch.float32):
    """One refine-classifier step (Adam, lr 4e-4) -> (loss, gradients, new
    running statistics, parameters after), all float64 on the CPU."""
    from agenda_tpu_torch.annotate.classifier import make_adam, make_classifier_train_step
    from agenda_tpu_torch.models.resnet import ResNet50

    model = ResNet50(num_classes=1)
    model.load_state_dict(state_dict)
    model = model.to(dev, dtype)
    tx = make_adam(4e-4)
    opt_state = tx.init(dict(model.named_parameters()))
    loss = make_classifier_train_step(model, tx, dtype)(
        opt_state, images.to(dev, dtype), labels.to(dev, dtype), mask.to(dev, dtype))
    cpu = torch.device("cpu")
    return (float(loss), {k: (v / 0.1).to(cpu, torch.float64) for k, v in opt_state.mu.items()},
            {k: v.to(cpu, torch.float64) for k, v in model.state_dict().items() if "running" in k},
            {k: v.detach().to(cpu, torch.float64) for k, v in model.named_parameters()})


@pytest.mark.cuda
def test_resnet50_train_step_on_the_card_as_on_the_cpu():
    """The refine classifier's step (ResNet-50 from the CLI's fresh init, 112
    px, 6 real rows padded to 8) on the card in f32 (TF32 off) against the
    CPU, with chip_smoke.py's limits: the loss within 1e-5 relative, every
    gradient within 0.1 relative L2 (a fresh ResNet-50 in train mode is
    chaotic: the CPU's own f32 lies up to 2.8e-2 from its float64), the new
    running statistics within 5e-3 of their move, at most 3% of the Adam
    update's elements more than 0.01 lr apart; in float64 on both sides the
    gradients within 1e-6."""
    from agenda_tpu_torch.detect.runner import full_f32
    from agenda_tpu_torch.models.resnet import ResNet50, init_resnet_

    _need_cuda()
    model = ResNet50(num_classes=1)
    init_resnet_(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(6, 112, 112, 3, generator=g)
    images = torch.cat([x, x[:1], x[:1]])  # batches_padded's pad rows: copies of row 0
    labels = torch.tensor([1.0, 0, 1, 1, 0, 0, 1, 1])
    mask = (torch.arange(8) < 6).float()
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    ref = _classifier_step(cpu, sd, images, labels, mask)
    with full_f32(dev):
        card = _classifier_step(dev, sd, images, labels, mask)
    assert abs(card[0] - ref[0]) <= 1e-5 * abs(ref[0]), (card[0], ref[0])
    worst = max(float((card[1][k] - v).norm() / v.norm()) for k, v in ref[1].items())
    assert worst <= 0.1, worst
    old = {k: v.double() for k, v in sd.items() if "running" in k}
    stats = max(float((card[2][k] - v).abs().max() / (v - old[k]).square().mean().sqrt())
                for k, v in ref[2].items())
    assert stats <= 5e-3, stats
    apart = sum(int(((card[3][k] - v).abs() > 0.01 * 4e-4).sum()) for k, v in ref[3].items())
    assert apart <= 0.03 * sum(v.numel() for v in ref[3].values()), apart
    ref64 = _classifier_step(cpu, sd, images, labels, mask, torch.float64)
    card64 = _classifier_step(dev, sd, images, labels, mask, torch.float64)
    worst64 = max(float((card64[1][k] - v).norm() / v.norm()) for k, v in ref64[1].items())
    assert worst64 <= 1e-6, worst64


# VAE pretraining's step on the card (bf16 autocast) against the CPU (f32),
# at a VAE whose mid-block attention takes the wide flash backward (two
# levels of 64 and 256 channels: D = 256, S = 32 x 32 at 64 px): the loss
# within VAE_LOSS_RTOL, each gradient (read from Adam's first moment) within
# VAE_GRAD_TOL_L2 relative L2, over the tensors whose CPU gradient is not
# float noise (norm above VAE_NULL_GRAD of the largest). The limit lies
# between the bf16 reading and a control that drops the attention's gradient
# (the wide kernels' dK, dV and dQ zeroed); read on an H100 80GB HBM3 at
# 700 W: loss 2.8e-4, gradients 3.1e-2 / the control's 1.07
VAE_LOSS_RTOL, VAE_GRAD_TOL_L2, VAE_NULL_GRAD = 2e-3, 0.15, 1e-4


def _vae_step(dev, state_dict, pixels, eps):
    """One vae_pretrain step -> (loss, gradients by name on the CPU in f32)."""
    from agenda_tpu_torch.io.configs import VAEConfig
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train.optim import make_adam
    from agenda_tpu_torch.train.vae_pretrain import make_vae_pretrain_step

    vae = AutoencoderKL(VAEConfig(block_out_channels=(64, 256), layers_per_block=1))
    vae.load_state_dict(state_dict)
    vae.to(dev)
    tx = make_adam(1e-4)
    opt_state = tx.init(dict(vae.named_parameters()))
    m = make_vae_pretrain_step(vae, tx, 1e-2)(opt_state, pixels.to(dev), eps.to(dev))
    cpu = torch.device("cpu")
    return float(m["loss"]), {k: (v / 0.1).to(cpu) for k, v in opt_state.mu.items()}


def _vae_readings(card, ref):
    top = max(float(v.norm()) for v in ref[1].values())
    grads = max(float((card[1][k] - v).norm() / v.norm()) for k, v in ref[1].items()
                if float(v.norm()) > VAE_NULL_GRAD * top)
    return abs(card[0] - ref[0]) / abs(ref[0]), grads


@pytest.mark.cuda
def test_vae_pretrain_step_on_the_card_as_on_the_cpu(monkeypatch):
    from agenda_tpu_torch.io.configs import VAEConfig
    from agenda_tpu_torch.models.vae import AutoencoderKL

    _need_cuda()
    torch.manual_seed(0)
    sd = AutoencoderKL(VAEConfig(block_out_channels=(64, 256), layers_per_block=1)).state_dict()
    g = torch.Generator().manual_seed(1)
    pixels = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    eps = torch.randn(2, 32, 32, 4, generator=g)
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    ref = _vae_step(cpu, sd, pixels, eps)
    before = (fl.flash_attention_bwd_dkv.launches, fl.flash_attention_bwd_dq.launches)
    sound = _vae_readings(_vae_step(dev, sd, pixels, eps), ref)
    assert (fl.flash_attention_bwd_dkv.launches - before[0],
            fl.flash_attention_bwd_dq.launches - before[1]) == (2, 2)
    monkeypatch.setattr(fl, "flash_attention_bwd_dkv",
                        lambda q, *a: (torch.zeros_like(q), torch.zeros_like(q)))
    monkeypatch.setattr(fl, "flash_attention_bwd_dq", lambda q, *a: torch.zeros_like(q))
    control = _vae_readings(_vae_step(dev, sd, pixels, eps), ref)
    print(f"VAE step, card (bf16) against the CPU (f32): loss {sound[0]:.3g}, gradients "
          f"{sound[1]:.3g} relative L2; control without the attention's gradient: loss "
          f"{control[0]:.3g}, gradients {control[1]:.3g}")
    assert sound[0] <= VAE_LOSS_RTOL and sound[1] <= VAE_GRAD_TOL_L2, sound
    assert control[1] > VAE_GRAD_TOL_L2, control


@pytest.mark.cuda
def test_roi_align_on_the_card_matches_the_cpu():
    """RoIAlign (``detect/ops.py``) at the two-stage train step's shape per
    image (P2 32x32x256 at 128 px, 256 RoIs, some partly off the map), 4
    images: forward and gradient on the card in f32 (TF32 off) within
    ROI_CARD_TOL_RMS of their rms of the CPU's. Both are two matrix products
    a chunk of images (the gradient is not a scatter-add), so the card sums
    them in cuBLAS's order: the forward read 1.7e-5 of its rms (on an
    H100 80GB HBM3 at 700 W), the limit is 1e-4 for both."""
    from agenda_tpu_torch.detect.ops import roi_align
    from agenda_tpu_torch.detect.runner import full_f32

    _need_cuda()
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(4, 32, 32, 256, generator=g)
    xy = torch.rand(4, 256, 2, generator=g) * 140 - 10
    wh = torch.rand(4, 256, 2, generator=g) * 60 + 0.5
    rois = torch.cat([xy, xy + wh], dim=-1) / 4.0
    cot = torch.randn(4, 256, 7, 7, 256, generator=g)
    outs = []
    dev = torch.device("cuda")
    for d in (torch.device("cpu"), dev):
        f = feats.to(d).requires_grad_(True)
        with full_f32(dev):
            out = roi_align(f, rois.to(d), 7)
            (grad,) = torch.autograd.grad((out * cot.to(d)).sum(), [f])
        outs.append((out.detach().cpu(), grad.cpu()))
    errs = [float((got - want).abs().max() / want.square().mean().sqrt())
            for got, want in zip(outs[1], outs[0])]
    assert max(errs) <= 1e-4, errs


def _variant_applies_edits(edits):
    csrc = Path(agenda_tpu_torch.__file__).parent / "csrc"
    return bool(edits) and all(old in (csrc / source).read_text() for source, old, _ in edits)


def _variant_applies(name):
    """The variant's edits (for a variant with alternatives, the first: this
    tree's) all find their lines in this tree's sources."""
    edits = kernel_variants.VARIANTS[name]
    return _variant_applies_edits(edits[0] if isinstance(edits, tuple) else edits)


@pytest.mark.parametrize("variant", ["no_exp", "loads_and_s_only", "one_warpgroup", "two_stages"])
def test_flash_bwd_variants_apply_to_the_source(variant):
    """Runs anywhere: every edit of kernel_variants.py's backward variants
    finds its line in the backward's source, so the tool keeps measuring what
    it names."""
    assert _variant_applies(f"bwd_{variant}")


@pytest.mark.parametrize("variant", sorted(
    name for name in kernel_variants.VARIANTS
    if name.startswith(("fwd_", "gn_", "adamw_")) and not name.endswith("_base")))
def test_kernel_variants_apply_to_the_source(variant):
    """Runs anywhere: the same for the forward's, the group norm's and the
    AdamW's variants (for the AdamW, the alternative for this tree's source)."""
    assert _variant_applies(variant)

