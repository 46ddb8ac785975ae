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


def _shape_id(shape):
    """A shape's test id, e.g. 2x4096x1x512, so that -k can pick a head dim."""
    return "x".join(map(str, shape))


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
                                   (2, 300, 2, 200),  # D zero-filled to 512 in shared memory
                                   (1, 4096, 1, 512), (1, 333, 2, 264),
                                   (2, 4096, 1, 512), (8, 1024, 1, 512)],  # the VAE's
                         ids=_shape_id)
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
# the logsumexp's) must fail; the first three break the kernel for D <= 160
# and the wide one (D = 512, 264) alike, the last the wide one's own hazard:
# a group whose S keeps only its own half of D's partial sum.
FLASH_MUTATIONS = {
    "v_from_wrong_ring_stage": [
        ("Vs + (j + T::kStages - 1) % T::kStages * T::kTileBytes",
         "Vs + (j + T::kStages - 2) % T::kStages * T::kTileBytes"),
        ("Vs + (n_tiles - 1) % T::kStages * T::kTileBytes",
         "Vs + n_tiles % T::kStages * T::kTileBytes"),
        ("hopper::smem_u32(Vs + st * W::kTileBytes)",
         "hopper::smem_u32(Vs + (st ^ 1) * W::kTileBytes)")],
    "o_rescale_skipped": [
        ("    for (int i = 0; i < ND / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n", ""),
        ("    for (int i = 0; i < W::kHalf / 2; ++i) o[i] *= alpha[(i >> 1) & 1];\n", "")],
    "last_tile_mask_dropped": [
        ("if (key0 + BK > p.S) {  // the last tile", "if (false) {  // the last tile"),
        ("if (key0 + W::kBK > p.S) {  // keys past S get P = 0",
         "if (false) {  // keys past S get P = 0")],
    "wide_partial_s_of_own_half_only": [
        ("        s[i] += xo.x;\n        s[i + 1] += xo.y;\n        s[i + 2] += xo.z;\n"
         "        s[i + 3] += xo.w;\n", "")],
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
    "wide_partial_s_of_own_half_only": [(2, 4096, 1, 512), (1, 333, 2, 264)],
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
                                   (4, 1700, 8, 40), (2, 300, 4, 80), (1, 333, 2, 264),
                                   (2, 4096, 1, 512)], ids=_shape_id)
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
        flash_attention_fwd(*(q.half(),) * 3)  # f16: the kernels take bf16 or f32
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
        group_norm_act(x.half(), w, b, 32, 1e-5)  # f16: the kernel takes bf16 or f32
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


# the wide backward (D > 160): the VAE step's shape, a longer S, and ragged S
# at D = 264 (zero-filled to the tiles' 512) and at D = 512
WIDE_BWD_SHAPES = [(8, 1024, 1, 512), (2, 4096, 1, 512), (1, 333, 2, 264), (1, 77, 2, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160),
                                   (4, 64, 8, 160), (2, 1000, 8, 40), (1, 333, 2, 152),
                                   (1, 77, 3, 24), *WIDE_BWD_SHAPES], ids=_shape_id)
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
                                   (8, 1024, 1, 512), (1, 333, 2, 264)], ids=_shape_id)
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
    # the wide kernels. dK/dV: the query mask keeps a query past S from
    # reading lse and delta past its (batch, head) row (past the end of both
    # buffers in the last one), and its value reaches the products: an
    # inverted mask (lse = -inf, so P = +inf) must fail. dK/dV again: dK
    # written from the next chunk of D's columns, each chunk's gradient
    # product reading the box of the ring slot after its own, and the keys
    # past S stored too (into the next batch element's first rows, and past
    # the end of dK and dV).
    "wide_query_mask_dropped": (
        "row < p.S ? (c == 0 ? stats[row] * kLog2e : stats[row]) : (c == 0 ? INFINITY : 0.f);",
        "row < p.S ? (c == 0 ? stats[row] * kLog2e : stats[row]) : (c == 0 ? -INFINITY : 0.f);"),
    "wide_dk_from_wrong_d_slice": (
        "store_chunk(p.dk + off, acc[a], 64 * a, k0, p.scale, p);",
        "store_chunk(p.dk + off, acc[a], 64 * ((a + 1) % W::kAtoms), k0, p.scale, p);"),
    "wide_grad_box_from_wrong_ring_slot": (
        "ring + (n0 + a) % W::kSlots * W::kBoxBytes",
        "ring + (n0 + a + 1) % W::kSlots * W::kBoxBytes"),
    "wide_key_guard_dropped": (
        "if (key < p.S && col < p.D) out[key * rs + col]",
        "if (col < p.D) out[key * rs + col]"),
    # dQ: the owned queries' mask inverted (every query before S gets lse =
    # +inf, so P = 0), a chunk staged at the next 64-column block of its
    # group's half of D, each chunk's product reading the K box of the ring
    # slot after its own, and the queries past S stored too. Those are zeros
    # (their Q and dO rows are zero-filled), written into the next batch
    # element's first rows, where the owner's store may come later, and past
    # the end of dq: the guard band of the harness below.
    "wide_dq_lse_mask_inverted": ("st[x] = q < p.S ?", "st[x] = q >= p.S ?"),
    "wide_dq_to_wrong_d_block": ("* W::kPitch + 64 * a + 16 * w",
                                 "* W::kPitch + 64 * ((a + 1) % 4) + 16 * w"),
    "wide_dq_box_from_wrong_ring_slot": ("Kr + (n0 + 4 * c + a) % W::kKSlots",
                                         "Kr + (n0 + 4 * c + a + 1) % W::kKSlots"),
    "wide_dq_store_guard_dropped": ("if (q < p.S && col < p.D)", "if (col < p.D)"),
}
FLASH_BWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                    (2, 1000, 8, 40), (1, 333, 2, 152), (1, 77, 3, 24)]
# each broken copy is held to the shapes where the code it breaks runs: the
# wgmma kernels' at D <= 160, the wide masks' only on a ragged S
FLASH_BWD_MUTATION_SHAPES = {
    **{name: FLASH_BWD_SHAPES for name in FLASH_BWD_MUTATIONS if not name.startswith("wide_")},
    "wide_query_mask_dropped": [(1, 333, 2, 264), (1, 77, 2, 512)],
    "wide_dk_from_wrong_d_slice": [(8, 1024, 1, 512), (1, 333, 2, 264)],
    "wide_grad_box_from_wrong_ring_slot": [(8, 1024, 1, 512), (1, 333, 2, 264)],
    "wide_key_guard_dropped": [(2, 333, 2, 264), (4, 77, 2, 512)],
    "wide_dq_lse_mask_inverted": [(1, 333, 2, 264), (1, 77, 2, 512)],
    "wide_dq_to_wrong_d_block": [(8, 1024, 1, 512), (1, 333, 2, 264)],
    "wide_dq_box_from_wrong_ring_slot": [(8, 1024, 1, 512), (1, 333, 2, 264)],
    "wide_dq_store_guard_dropped": [(2, 333, 2, 264), (4, 77, 2, 512)],
}
# The kernels are launched as the wrappers launch them, but each gradient is
# written into the head of a NaN-filled buffer: a kernel that writes past the
# end of its output (up to 64 rows) fails as one that writes a NaN does.
_WORST_BWD_ERROR_OVER_LIMIT = """
import json, math, torch
from agenda_tpu_torch.kernels import _build, flash as fl
dkv_fn, dq_fn, _ = fl._bwd_kernels()
worst = {}
for shape in %r:
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(4))
    out, lse = fl.flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(out, do)
    n, pad = math.prod(shape), 64 * shape[2] * shape[3]
    bufs = [torch.full((n + pad,), float("nan"), dtype=torch.bfloat16, device="cuda")
            for _ in range(3)]
    got = [buf[:n].view(shape) for buf in bufs]
    ptrs, dims, strides = fl._bwd_args(q, k, v, do, lse, delta)
    stream = _build.stream_ptr(q.device)
    _build.check(dkv_fn(*ptrs, got[0].data_ptr(), got[1].data_ptr(), *dims, strides, stream),
                 "flash_attention_bwd_dkv")
    _build.check(dq_fn(*ptrs, got[2].data_ptr(), *dims, strides, stream), "flash_attention_bwd_dq")
    want = (*fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta),
            fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta))
    ratio = 0.0
    for x, ref in zip(got, want):
        ref = ref.float()
        limit = %r * ref.square().mean().sqrt() + %r * ref.abs()
        r = ((x.float() - ref).abs() / limit).max().item()
        ratio = r if r != r else max(ratio, r)  # NaN stays NaN
    if not all(bool(buf[n:].isnan().all()) for buf in bufs):
        ratio = float("inf")  # written past the end of an output
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
    wide = "_ZN45_GLOBAL__N__0d1c2e3f_12_flash_fwd_cu_1a2b3c4d27flash_fwd_wide_wgmma_kernelENS_9FwdParamsE"
    wide_dq = ("_ZN45_GLOBAL__N__c8e2eb60_12_flash_bwd_cu_2c9866a330flash_bwd_dq_wide_wgmma_kernel"
               "ENS_9BwdParamsE")
    f32 = "_ZN45_GLOBAL__N__5e6f7a8b_16_flash_fwd_f32_cu_9c8d7e6f{}"
    f32_fwd = f32.format("20flash_fwd_f32_kernelILi80ELi2EEEvNS_9FwdParamsE")
    f32_wide = f32.format("25flash_fwd_f32_wide_kernelENS_9FwdParamsE")
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
        f"ptxas info    : Compiling entry function '{wide}' for 'sm_90a'",
        f"ptxas info    : Function properties for {wide}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 2 barriers",
        "== flash_bwd.cu",
        f"ptxas info    : Compiling entry function '{wide_dq}' for 'sm_90a'",
        f"ptxas info    : Function properties for {wide_dq}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 3 barriers",
        "== flash_fwd_f32.cu",
        f"ptxas info    : Compiling entry function '{f32_fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {f32_fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{f32_wide}' for 'sm_90a'",
        f"ptxas info    : Function properties for {f32_wide}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 210 registers, used 1 barriers",
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
                                         "stores, 0 bytes spill loads",
        "flash_fwd_wide_wgmma_kernel": "168 registers, 0 bytes stack frame, 0 bytes spill "
                                       "stores, 0 bytes spill loads",
        "flash_bwd_dq_wide_wgmma_kernel": "128 registers, 0 bytes stack frame, 0 bytes spill "
                                          "stores, 0 bytes spill loads",
        "flash_fwd_f32_kernel<80, 2>": "154 registers, 0 bytes stack frame, 0 bytes spill "
                                       "stores, 0 bytes spill loads",
        "flash_fwd_f32_wide_kernel": "210 registers, 0 bytes stack frame, 0 bytes spill stores, "
                                     "0 bytes spill loads"}


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


def test_chip_smoke_reads_serialized_wgmma():
    """Runs anywhere: chip_smoke.py names each kernel whose wgmma products
    ptxas serializes, with the note's code, from the build's log."""
    chip_smoke = _root_module("chip_smoke")
    note = ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
            "are serialized due to insufficient register resources for the wgmma pipeline in the "
            "function '_ZN45_GLOBAL__N__c8e2eb60_12_flash_bwd_cu_2c9866a3{}ENS_9BwdParamsE'")
    for kernel in ("flash_bwd_dkv_wide_wgmma_kernel", "flash_bwd_dq_wide_wgmma_kernel"):
        line = note.format(f"{len(kernel)}{kernel}")
        log = "\n".join([line, line, "ptxas info    : Used 128 registers, used 3 barriers"])
        assert chip_smoke.serialized_report(log) == [f"C7512 {kernel}"]
    assert chip_smoke.serialized_report("ptxas info    : Used 128 registers") == []


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
        fl.flash_attention_bwd_dkv(*(x.half(),) * 4, lse, lse)  # f16 on the card
    wide32 = torch.zeros(1, 64, 1, 512, device="cuda")  # the wide f32 kernels take it
    dk, dv = fl.flash_attention_bwd_dkv(*(wide32,) * 4, lse[:1], lse[:1])
    assert dk.shape == dv.shape == wide32.shape and dk.dtype == torch.float32
    for d in (520, 204):  # above the f32 backward's 512; in (160, 512], not a multiple of 8
        bad32 = torch.zeros(1, 64, 1, d, device="cuda")
        with pytest.raises(ValueError):
            fl.flash_attention_bwd_dkv(*(bad32,) * 4, lse[:1], lse[:1])
        with pytest.raises(ValueError):
            fl.flash_attention_bwd_dq(*(bad32,) * 4, lse[:1], lse[:1])
    wide = torch.zeros(1, 64, 1, 520, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # D above the backward's 512
        fl.flash_attention_bwd_dq(wide, wide, wide, wide, lse[:1], lse[:1])
    xb = x.bfloat16()
    with pytest.raises(ValueError):  # lse of the wrong shape
        fl.flash_attention_bwd_dq(xb, xb, xb, xb, lse[:1], lse[:1])
    pieces = fl.flash_f32_split(x, x, x, x)
    with pytest.raises(ValueError):  # the pieces of other operands
        fl.flash_attention_bwd_dkv(x, x, x, x, lse, lse, pieces[:, :, :32])
    with pytest.raises(ValueError):  # pieces beside bf16 operands
        fl.flash_attention_bwd_dq(xb, xb, xb, xb, lse, lse, pieces)


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


# VAE pretraining's step on the card against the CPU (f32), in each compute
# dtype, at a VAE whose mid-block attention takes the wide flash backward
# (two levels of 64 and 256 channels: D = 256, S = 32 x 32 at 64 px): the
# loss within its dtype's VAE_LIMITS[0], each gradient (read from Adam's
# first moment) within VAE_LIMITS[1] relative L2, over the tensors whose CPU
# gradient is not float noise (norm above VAE_NULL_GRAD of the largest).
# Each gradient limit lies between the sound reading and a control that
# drops the attention's gradient (the wide kernels' dK, dV and dQ zeroed).
# bf16 autocast, read on an H100 80GB HBM3 at 700 W: loss 2.8e-4, gradients
# 3.1e-2 / the control's 1.07. f32 (TF32 off, the wide f32 kernels), set
# before its first run on the card from the f32 SD step's card-vs-CPU
# readings (loss 8.8e-8, gradients 4.9e-6 over all of them): cuDNN's and the
# CPU's summation orders, a few 1e-6 a layer.
VAE_LIMITS = {torch.bfloat16: (2e-3, 0.15), torch.float32: (1e-5, 1e-3)}
VAE_NULL_GRAD = 1e-4


def _vae_step(dev, state_dict, pixels, eps, dtype=torch.float32):
    """One vae_pretrain step computing in ``dtype`` -> (loss, gradients by
    name on the CPU in f32)."""
    from agenda_tpu_torch.io.configs import VAEConfig
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train.optim import make_adam
    from agenda_tpu_torch.train.vae_pretrain import make_vae_pretrain_step

    vae = AutoencoderKL(VAEConfig(block_out_channels=(64, 256), layers_per_block=1))
    vae.load_state_dict(state_dict)
    vae.to(dev)
    tx = make_adam(1e-4)
    opt_state = tx.init(dict(vae.named_parameters()))
    m = make_vae_pretrain_step(vae, tx, 1e-2, dtype)(opt_state, pixels.to(dev), eps.to(dev))
    cpu = torch.device("cpu")
    return float(m["loss"]), {k: (v / 0.1).to(cpu) for k, v in opt_state.mu.items()}


def _vae_readings(card, ref):
    top = max(float(v.norm()) for v in ref[1].values())
    grads = max(float((card[1][k] - v).norm() / v.norm()) for k, v in ref[1].items()
                if float(v.norm()) > VAE_NULL_GRAD * top)
    return abs(card[0] - ref[0]) / abs(ref[0]), grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_vae_pretrain_step_on_the_card_as_on_the_cpu(dtype, monkeypatch):
    from agenda_tpu_torch.io.configs import VAEConfig
    from agenda_tpu_torch.models.vae import AutoencoderKL

    _need_cuda()
    torch.manual_seed(0)
    sd = AutoencoderKL(VAEConfig(block_out_channels=(64, 256), layers_per_block=1)).state_dict()
    g = torch.Generator().manual_seed(1)
    pixels = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    eps = torch.randn(2, 32, 32, 4, generator=g)
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    loss_tol, grad_tol = VAE_LIMITS[dtype]
    ref = _vae_step(cpu, sd, pixels, eps)
    counts = [(w.launches, w.launches_wide, w.launches_f32)
              for w in (fl.flash_attention_bwd_dkv, fl.flash_attention_bwd_dq)]
    sound = _vae_readings(_vae_step(dev, sd, pixels, eps, dtype), ref)
    f32 = 2 * int(dtype == torch.float32)
    assert [(w.launches, w.launches_wide, w.launches_f32)
            for w in (fl.flash_attention_bwd_dkv, fl.flash_attention_bwd_dq)] == [
                (n + 2, wide + 2, f + f32) for n, wide, f in counts]
    monkeypatch.setattr(fl, "flash_attention_bwd_dkv",
                        lambda q, *a: (torch.zeros_like(q), torch.zeros_like(q)))
    monkeypatch.setattr(fl, "flash_attention_bwd_dq", lambda q, *a: torch.zeros_like(q))
    control = _vae_readings(_vae_step(dev, sd, pixels, eps, dtype), ref)
    print(f"VAE step, card ({dtype}) against the CPU (f32): loss {sound[0]:.3g}, gradients "
          f"{sound[1]:.3g} relative L2; control without the attention's gradient: loss "
          f"{control[0]:.3g}, gradients {control[1]:.3g}")
    assert sound[0] <= loss_tol and sound[1] <= grad_tol, sound
    assert control[1] > grad_tol, control


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


@pytest.mark.parametrize("variant", ["no_exp", "loads_and_s_only", "one_warpgroup", "two_stages",
                                     "wide_maxnreg", "wide_dq_loads_and_scores", "wide_dq_k10_v8",
                                     "wide_dq_staggered", "wide_dq_cluster2"])
def test_flash_bwd_variants_apply_to_the_source(variant):
    """Runs anywhere: every edit of kernel_variants.py's backward variants
    finds its line in the backward's source, so the tool keeps measuring what
    it names."""
    assert _variant_applies(f"bwd_{variant}")


@pytest.mark.parametrize("variant", sorted(
    name for name in kernel_variants.VARIANTS
    if name.startswith(("fwd_", "gn_", "adamw_", "bwd_f32_"))
    and not name.endswith("_base")))
def test_kernel_variants_apply_to_the_source(variant):
    """Runs anywhere: the same for the forward's, the group norm's, the
    AdamW's (the alternative for this tree's source) and the f32 backward's
    variants (both files')."""
    assert _variant_applies(variant)



# -- the f32 kernels (--mixed_precision no) -------------------------------------------
#
# csrc/flash_fwd_f32.cu's forward (three bf16 pieces an operand, six
# tensor-core products), csrc/flash_bwd_f32.cu's dK/dV and dQ (up to D = 160:
# one pass on the pieces of the pre-pass), csrc/flash_bwd_f32_wide.cu's
# (above it: a scores pass, the gradient products, all on the tensor cores)
# and groupnorm.cu's f32 instantiation, each held to its plain version
# computed in float64 on the card: the kernel's max |error| may be at most
# F32_LIMIT times that of the f32 plain version (TF32 off) on the same
# inputs. The broken copies round each kernel's operands (or the group
# norm's input) to TF32, one pass of the tensor cores, keep only the pieces
# b0 + b1, or let a backward's products accumulate every tile in the tensor
# cores, and must fail that limit at every shape where they are held.

F32_LIMIT = 4.0
F32_FWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                  (2, 4096, 1, 512), (2, 1000, 8, 40), (1, 333, 2, 264), (1, 77, 3, 24)]
# the f32 SD step's (csrc/flash_bwd_f32.cu's, one pass), a ragged S at each
# of its block shapes (ND = 40, 80, 160: D = 24 and 40, 80, 152)
F32_NARROW_BWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                         (2, 1000, 8, 40), (1, 333, 2, 152), (1, 77, 3, 24), (1, 333, 2, 80)]
# f32 VAE pretraining's (8, 1024, 1, 512), a longer S, a ragged S at a D the
# tiles zero-fill (264 to 384) and the narrowest wide D
F32_WIDE_BWD_SHAPES = [(8, 1024, 1, 512), (2, 4096, 1, 512), (1, 333, 2, 264), (1, 77, 3, 168)]
F32_BWD_SHAPES = F32_NARROW_BWD_SHAPES + F32_WIDE_BWD_SHAPES
F32_GN_SHAPES = [(4, 320, 64, 64), (4, 1280, 8, 8), (2, 512, 64, 64), (1, 128, 512, 512),
                 (2, 1280, 6, 6), (3, 96, 7, 5)]
_TF32 = ("{\n    uint32_t r;\n    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
         "    return __uint_as_float(r);\n  }")
# The f32 pre-pass (flash_fwd_f32.cu's split) splits the operands of the
# forward and of both wide backward entries, and f32_pieces.cuh's split3 is
# every f32 kernel's: each of these edits is held to each kernel it reaches.
_SPLIT_OPERANDS_TF32 = ("flash_fwd_f32.cu", "struct SplitOperand {\n  __device__ "
                        "__forceinline__ float operator()(float x) const { return x; }",
                        "struct SplitOperand {\n  __device__ __forceinline__ float "
                        "operator()(float x) const " + _TF32)
_PIECES_B0_B1 = ("f32_pieces.cuh", "  b[2] = __float2bfloat16_rn(r);",
                 "  b[2] = __float2bfloat16_rn(0.f);")
F32_MUTATIONS = {
    "fwd_operands_tf32": _SPLIT_OPERANDS_TF32,
    # every f32 backward reads the pieces of the same pre-pass
    "dkv_operands_tf32": _SPLIT_OPERANDS_TF32,
    "dq_operands_tf32": _SPLIT_OPERANDS_TF32,
    "bwd_pieces_b0_b1": ("flash_bwd_f32.cu", "constexpr int kPieces = 3;",
                         "constexpr int kPieces = 2;"),
    "bwd_tiles_in_the_tensor_cores": ("flash_bwd_f32.cu", "constexpr bool kTileFromZero = true;",
                                      "constexpr bool kTileFromZero = false;"),
    "wide_dkv_operands_tf32": _SPLIT_OPERANDS_TF32,
    "wide_dq_operands_tf32": _SPLIT_OPERANDS_TF32,
    "fwd_pieces_b0_b1": _PIECES_B0_B1,
    "wide_bwd_pieces_b0_b1": _PIECES_B0_B1,
    "wide_bwd_tiles_in_the_tensor_cores": ("flash_bwd_f32_wide.cu",
                                           "constexpr bool kTileFromZero = true;",
                                           "constexpr bool kTileFromZero = false;"),
    "gn_input_tf32": ("groupnorm.cu", "__device__ __forceinline__ static float load(float v) "
                      "{ return v; }", "__device__ __forceinline__ static float load(float v) "
                      + _TF32.replace("(x)", "(v)")),
}
# The copy that keeps the forward's pieces b0 + b1 only (16 bits an operand)
# stays within the limit at (2, 4096, 1, 512): 0.52 of it on the H100, where
# the f32 plain version's own error there (5.0e-7 in the output, 8.2e-7 in
# lse) is larger than what dropping b2 adds on these inputs; at every other
# shape it reads 1.03-3.16. It is held to those.
# Each backward copy is held at the shapes its source runs. Of the wide
# backward's (csrc/flash_bwd_f32_wide.cu), on the H100: keeping the pieces
# b0 + b1 only read 2.54-4.36 of the limit at (1, 333, 2, 264) and (1, 77,
# 3, 168) but 0.60-0.82 at (8, 1024, 1, 512) and (2, 4096, 1, 512), where
# the f32 plain version's own error is larger; accumulating every tile of
# the products in the tensor cores read 1.95-2.22 at (2, 4096, 1, 512) but
# 0.09-0.99 at S <= 1024 (the drift grows with S, as the forward's did). Each
# is held to the shapes where it fails. Of the one-pass backward's
# (csrc/flash_bwd_f32.cu), on the H100: keeping b0 + b1 read 1.28-5.17 at
# every shape it runs; accumulating every streamed tile's products in the
# tensor cores read 2.44 (dK/dV) and 3.00 (dQ) at (4, 4096, 8, 40) and 1.92
# and 1.11 at (2, 1000, 8, 40), but 0.57-1.52 at (4, 1024, 8, 80), (1, 77,
# 3, 24) and (1, 333, 2, 80), where one of the two stays within.
F32_MUTATION_SHAPES = {"fwd_pieces_b0_b1": [s for s in F32_FWD_SHAPES if s != (2, 4096, 1, 512)],
                       "dkv_operands_tf32": F32_NARROW_BWD_SHAPES,
                       "dq_operands_tf32": F32_NARROW_BWD_SHAPES,
                       "wide_dkv_operands_tf32": F32_WIDE_BWD_SHAPES,
                       "wide_dq_operands_tf32": F32_WIDE_BWD_SHAPES,
                       "wide_bwd_pieces_b0_b1": [(1, 333, 2, 264), (1, 77, 3, 168)],
                       "wide_bwd_tiles_in_the_tensor_cores": [(2, 4096, 1, 512)],
                       "bwd_pieces_b0_b1": F32_NARROW_BWD_SHAPES,
                       "bwd_tiles_in_the_tensor_cores": [(4, 4096, 8, 40), (2, 1000, 8, 40)]}
# which outputs each broken copy must break: the whole forward, dK/dV, dQ, GN
# (a backward file's pieces and products are both entries')
F32_MUTATION_KERNEL = {"fwd_operands_tf32": "fwd", "fwd_pieces_b0_b1": "fwd",
                       "dkv_operands_tf32": "dkv", "dq_operands_tf32": "dq",
                       "wide_dkv_operands_tf32": "dkv", "wide_dq_operands_tf32": "dq",
                       "wide_bwd_pieces_b0_b1": ("dkv", "dq"),
                       "wide_bwd_tiles_in_the_tensor_cores": ("dkv", "dq"),
                       "bwd_pieces_b0_b1": ("dkv", "dq"),
                       "bwd_tiles_in_the_tensor_cores": ("dkv", "dq"),
                       "gn_input_tf32": "gn"}

# Prints {kernel: {shape: worst kernel error / (F32_LIMIT x the f32 plain
# version's)}} for the kernels and shapes it is given; imports only the port.
_F32_RATIOS = """
import json, sys, torch
from agenda_tpu_torch.kernels import flash as fl
from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
LIMIT = %r

def ratio(got, plain, ref):
    worst = 0.0
    for x, p, r in zip(got, plain, ref):
        r = r.double()
        e_k = (x.double() - r).abs().max().item()
        e_p = (p.double() - r).abs().max().item()
        worst = e_k if e_k != e_k else max(worst, e_k / (LIMIT * e_p))
    return worst

def flash_inputs(shape):
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    return [torch.randn(shape, device="cuda", generator=g) for _ in range(4)]

out = {}
for kind, shapes in json.loads(sys.argv[1]).items():
    out[kind] = {}
    for shape in map(tuple, shapes):
        if kind == "gn":
            g = torch.Generator(device="cuda").manual_seed(sum(shape))
            c = shape[1]
            off = 4.0 * (torch.arange(c, device="cuda") %% (c // 32)) / (c // 32)
            x = torch.randn(shape, device="cuda", generator=g) * 2 + off[:, None, None]
            w, b = (torch.randn(c, device="cuda", generator=g) for _ in range(2))
            args = (32, 1e-6, "silu")
            got = [group_norm_act(x, w, b, *args)]
            plain = [group_norm_act_reference(x, w, b, *args)]
            ref = [group_norm_act_reference(x.double(), w.double(), b.double(), *args)]
        else:
            q, k, v, do = flash_inputs(shape)
            if kind == "fwd":
                got = fl.flash_attention_fwd(q, k, v)
                plain = fl.flash_attention_reference(q, k, v)
                ref = fl.flash_attention_reference(q.double(), k.double(), v.double())
            else:
                o, lse = fl.flash_attention_fwd(q, k, v)
                delta = fl.flash_delta(o, do)
                ins = (q, k, v, do, lse, delta)
                if kind == "dkv":
                    fn, plain_fn = fl.flash_attention_bwd_dkv, fl.flash_attention_bwd_dkv_reference
                else:
                    fn = lambda *a: (fl.flash_attention_bwd_dq(*a),)
                    plain_fn = lambda *a: (fl.flash_attention_bwd_dq_reference(*a),)
                got, plain = fn(*ins), plain_fn(*ins)
                ref = plain_fn(*(t.double() for t in ins))
        torch.cuda.synchronize()
        out[kind][str(shape)] = ratio(got, plain, ref)
print(json.dumps(out))
"""


def _f32_ratios(kinds, cwd=None):
    """Worst error over the limit per kernel and shape, in a child process
    (the package of ``cwd``, a broken copy, or this tree's)."""
    env = {**os.environ, "PYTHONPATH": str(cwd or REPO)}
    run = subprocess.run([sys.executable, "-c", _F32_RATIOS % F32_LIMIT, json.dumps(kinds)],
                         cwd=cwd or REPO, capture_output=True, text=True, timeout=900, env=env)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout.splitlines()[-1])


@pytest.mark.cuda
def test_f32_kernels_within_the_limit_of_float64():
    """Each f32 kernel at every main-path shape (the train step's and the
    VAE's), ragged S and a zero-filled D, against float64: at most
    F32_LIMIT x the f32 plain version's max |error|, output and lse alike."""
    _need_cuda()
    worst = _f32_ratios({"fwd": F32_FWD_SHAPES, "dkv": F32_BWD_SHAPES, "dq": F32_BWD_SHAPES,
                         "gn": F32_GN_SHAPES})
    print(f"f32 kernels: worst error over {F32_LIMIT} x the f32 plain version's {worst}")
    assert all(r <= 1.0 for per in worst.values() for r in per.values()), worst


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", sorted(F32_MUTATIONS))
def test_f32_limit_fails_tf32_rounding_mutations(mutation, tmp_path):
    """A copy of a kernel that rounds its operands to TF32 (one tensor-core
    pass) fails the limit at every shape; a forward that keeps two of its
    three bf16 pieces at every shape of F32_MUTATION_SHAPES."""
    _need_cuda()
    _broken_copy(tmp_path, F32_MUTATIONS[mutation][0], [F32_MUTATIONS[mutation][1:]])
    kinds = F32_MUTATION_KERNEL[mutation]
    kinds = (kinds,) if isinstance(kinds, str) else kinds
    default = {"fwd": F32_FWD_SHAPES, "dkv": F32_BWD_SHAPES, "dq": F32_BWD_SHAPES,
               "gn": F32_GN_SHAPES}
    worst = _f32_ratios({kind: F32_MUTATION_SHAPES.get(mutation, default[kind])
                         for kind in kinds}, cwd=tmp_path)
    print(f"{mutation}: worst error over the limit per shape {worst}")
    assert all(not r <= 1.0 for per in worst.values() for r in per.values()), worst  # NaN too


@pytest.mark.parametrize("mutation", sorted(F32_MUTATIONS))
def test_f32_mutations_apply_to_the_source(mutation):
    """Runs anywhere: each broken f32 copy above edits exactly one place."""
    source, old, new = F32_MUTATIONS[mutation]
    src = (Path(agenda_tpu_torch.__file__).parent / "csrc" / source).read_text()
    assert src.count(old) == 1 and new not in src


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_NARROW_BWD_SHAPES, ids=_shape_id)
def test_f32_kernels_launch_count_and_read_strided_views(shape):
    """f32 q, k, v as head-split views of one packed projection (sequence
    stride 3*H*D) give what their contiguous copies give, bit for bit, both
    ways; each wrapper counts the f32 launch in launches and launches_f32,
    and the pre-pass one launch a forward and one a backward entry called
    alone in its own count."""
    _need_cuda()
    b, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(b, s, 3, h, d, device="cuda", generator=g)
    do = torch.randn(b, s, h, d, device="cuda", generator=g)
    views = qkv.unbind(dim=2)
    copies = [t.contiguous() for t in views]
    wrappers = (fl.flash_attention_fwd, fl.flash_attention_bwd_dkv, fl.flash_attention_bwd_dq)
    before = [(w.launches, w.launches_f32) for w in wrappers]
    splits = fl.flash_f32_split.launches
    results = []
    for q, k, v in (views, copies):
        out, lse = flash_attention_fwd(q, k, v)
        delta = fl.flash_delta(out, do)
        results.append((out, lse, *fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                        fl.flash_attention_bwd_dq(q, k, v, do, lse, delta)))
    assert all(torch.equal(a, b) for a, b in zip(*results))
    assert [(w.launches, w.launches_f32) for w in wrappers] == [(n + 2, f + 2) for n, f in before]
    assert fl.flash_f32_split.launches == splits + 6
    x = torch.randn(2, 64, 8, 8, device="cuda", generator=g)
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    n, f = group_norm_act.launches, group_norm_act.launches_f32
    group_norm_act(x, w, b, 32, 1e-5, "silu")
    group_norm_act(x.bfloat16(), w, b, 32, 1e-5, "silu")
    assert (group_norm_act.launches, group_norm_act.launches_f32) == (n + 2, f + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_f32_groupnorm_tail_path_at_every_offset(offset):
    """The f32 instantiation's tail path (4 elements a chunk) at a base 4, 8
    and 12 bytes past a 16-byte boundary and at H*W % 4 != 0: the same
    values as the aligned launch, bit for bit where the statistics' sums
    agree, and within the f32 limit of float64 everywhere."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(offset)
    for shape in ((2, 1280, 6, 6), (2, 640, 10, 10), (3, 96, 7, 5)):
        x = torch.randn(shape, device="cuda", generator=g) * 2 + 0.5
        w, b = torch.randn(shape[1], device="cuda", generator=g), torch.zeros(shape[1],
                                                                              device="cuda")
        buf = torch.empty(x.numel() + 4, device="cuda")
        xo = buf[offset:offset + x.numel()].view(shape)
        xo.copy_(x)
        assert xo.data_ptr() % 16 == 4 * offset
        got = group_norm_act(xo, w, b, 32, 1e-5, "silu").double()
        plain = group_norm_act_reference(xo, w, b, 32, 1e-5, "silu").double()
        ref = group_norm_act_reference(xo.double(), w.double(), b.double(), 32, 1e-5, "silu")
        assert (got - ref).abs().max() <= F32_LIMIT * (plain - ref).abs().max()


@pytest.mark.cuda
def test_f32_wide_backward_counts_and_reads_strided_views():
    """At D > 160 the f32 dK/dV and dQ read head-split views of one packed
    projection as their contiguous copies, bit for bit, and count each
    launch in launches, launches_f32 and launches_wide; each call runs the
    pre-pass (flash_f32_split) once and, in one chunk, the scores pass and
    the products once."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn(2, 200, 3, 2, 264, device="cuda", generator=g)
    do = torch.randn(2, 200, 2, 264, device="cuda", generator=g)
    views = qkv.unbind(dim=2)
    wrappers = (fl.flash_attention_bwd_dkv, fl.flash_attention_bwd_dq)
    passes = (fl.flash_f32_split, fl.f32_wide_bwd_scores, fl.f32_wide_bwd_products)
    out, lse = flash_attention_fwd(*views)
    delta = fl.flash_delta(out, do)
    before = [(w.launches, w.launches_f32, w.launches_wide) for w in wrappers]
    before_passes = [w.launches for w in passes]
    results = [(*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
               for q, k, v in (views, [t.contiguous() for t in views])]
    assert all(torch.equal(a, b) for a, b in zip(*results))
    assert [(w.launches, w.launches_f32, w.launches_wide) for w in wrappers] == [
        (n + 2, f + 2, wide + 2) for n, f, wide in before]
    assert [w.launches for w in passes] == [n + 4 for n in before_passes]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 333, 2, 264), (1, 1024, 1, 512)], ids=_shape_id)
def test_f32_wide_backward_is_bitwise_equal_at_two_scratch_caps(shape, monkeypatch):
    """A scratch cap that cuts a call into a chunk a (batch, head) and 128
    queries gives the bits of the whole call: dK and dV continue tile by
    tile from chunk to chunk, dQ's rows are independent."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(out, do)

    def run():
        return (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))

    whole = run()
    monkeypatch.setattr(fl, "F32_WIDE_BWD_SCRATCH", 1)
    scores = fl.f32_wide_bwd_scores.launches
    cut = run()
    b, s, h, _ = shape
    assert fl.f32_wide_bwd_scores.launches - scores == 2 * b * h * -(-s // 128)
    assert all(torch.equal(x, y) for x, y in zip(whole, cut))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 8, 160), (2, 333, 2, 40), (1, 1000, 3, 80),
                                   (1, 333, 2, 264)], ids=_shape_id)
def test_f32_backward_gives_the_same_bits_from_shared_and_own_pieces(shape):
    """The dK/dV and dQ entries given the pieces of one pre-pass
    (flash_f32_split of q, k, v and dO) give the bits they give when each
    splits for itself, and so does autograd through flash_attention, whose
    backward runs that one pre-pass for both: one pre-pass launch a forward
    and one a backward."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(out, do)
    own = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
           fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
    pieces = fl.flash_f32_split(q, k, v, do)
    shared = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta, pieces),
              fl.flash_attention_bwd_dq(q, k, v, do, lse, delta, pieces))
    assert all(torch.equal(a, b) for a, b in zip(own, shared))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    splits = fl.flash_f32_split.launches
    fl.flash_attention(*leaves).backward(do)
    assert fl.flash_f32_split.launches == splits + 2
    dk, dv, dq = own
    assert all(torch.equal(t.grad, want) for t, want in zip(leaves, (dq, dk, dv)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_NARROW_BWD_SHAPES + [(8, 1024, 1, 512), (1, 333, 2, 264)],
                         ids=_shape_id)
def test_f32_kernels_are_deterministic(shape):
    """One owner and one summation order a result element: two launches of
    each f32 kernel give bitwise-equal outputs."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
    x = torch.randn(shape[0], 512, 64, 64, device="cuda", generator=g)  # a clustered span
    w, b = torch.randn(512, device="cuda", generator=g), torch.zeros(512, device="cuda")

    def run():
        out, lse = flash_attention_fwd(q, k, v)
        delta = fl.flash_delta(out, do)
        return (out, lse, *fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                fl.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                group_norm_act(x, w, b, 32, 1e-6, "silu"))

    assert all(torch.equal(a, b) for a, b in zip(run(), run()))
