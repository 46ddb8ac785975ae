#!/usr/bin/env python3
"""Time edited copies of the port's kernels on one NVIDIA H100.

    python3 kernel_variants.py [--tree DIR] [--batch N] [variant ...]

Each variant is a copy of agenda_tpu_torch/ (of this checkout, or of the
checkout at DIR) in a temporary directory with a few lines of its CUDA
sources replaced (copy_package, which the kernel tests' broken copies use
too). A child process builds the copy and times the kernels whose sources
the variant edits (all three for "base") by CUDA-graph replay, as
chip_smoke.py does, and reports the worst error over each kernel's limit (a
variant that drops work fails it) and the sums over one generation batch of
N images (flash forward and group norm; N = 2 by default, as chip_smoke.py
runs it; the UNet's batch is 2N under classifier-free guidance) or over one
training step at batch 4 (flash backward, dK/dV and dQ; the fused int8 AdamW
over the UNet's 293 quantized leaves, without and with the EMA shadow, as
the trainer launches it: one launch a step where the package has
fused_adamw8bit_leaves, else one a leaf):

  base                   the kernels as they are (adamw_base: the AdamW alone);
  fwd_no_exp             exponentials replaced by the identity;
  fwd_loads_and_s_only   only the tile loads and S = Q K^T left (no P V, no
                         exponentials);
  fwd_loads_only         and not S either: the supply floor;
  fwd_one_warpgroup      one consumer warpgroup a block at every head dim;
  fwd_most_warpgroups    the most a block at each head dim, even where that
                         leaves fewer blocks than SMs;
  fwd_two_warpgroups_at_40, fwd_three_warpgroups_at_40  two or three at D = 40,
                         not four;
  fwd_two_stages         a ring of two stages at every head dim;
  fwd_three_stages_at_40, fwd_five_stages_at_40  a ring of three or five
                         stages at D = 40, not four;
  fwd_128_key_tiles_at_40  128-key tiles at D = 40;
  fwd_64_key_tiles       64-key tiles at every head dim (D = 80 too);
  fwd_three_warpgroups_at_80  three consumer warpgroups and 64-key tiles at D = 80;
  gn_base                the group norm alone, as it is;
  gn_tail_everywhere     its tail path (per-element channels, head and tail
                         elements one at a time) at every shape;
  gn_no_cluster          one block a span at every shape;
  gn_clusters_x2         clusters that take a launch up to two blocks an SM, not one;
  bwd_no_exp             the backward's exponentials replaced by the identity;
  bwd_loads_and_s_only   only its tile loads and S product left (no dP, no RS
                         products, no exponentials): the supply floor;
  bwd_one_warpgroup      one consumer warpgroup a block in both backward kernels;
  bwd_two_stages         a ring of two stages in both;
  adamw_no_transcendentals  the AdamW's exponentials and logarithms (or their
                         table lookups and lg2) replaced by the identity;
  adamw_no_div           its divisions (and its reciprocals) turned into products;
  adamw_loads_only       every stream read and written once with no math: the
                         supply floor;
  adamw_streaming        every stream loaded and stored with the evict-first
                         cache hint (__ldcs, __stcs);
  adamw_three_blocks_an_sm  registers capped for three blocks an SM, not two;
  adamw_three_blocks_an_sm_without_ema  the same for the kernel without EMA only.

A variant may hold alternative edit lists, one for this tree's AdamW source
and one for the earlier kernel's (one warp a row), so that --tree DIR on a
checkout of that kernel times the same variant; the first list whose edits
all apply is made.

One JSON line per variant: {"variant": ..., "fwd": {shape: ms}, "fwd_batch_ms",
"fwd_worst", "gn": {shape: ms}, "gn_batch_ms", "gn_worst", "bwd": {shape:
[dK/dV ms, dQ ms]}, "bwd_step_ms", "bwd_worst", "adamw_step_ms",
"adamw_ema_step_ms" (with their TB/s), "adamw_host_us" (the host's time to
enqueue one step's update with the EMA, eager, as the optimizer calls it:
one FusedLeaves call, or a wrapper call a leaf), "adamw_worst", "copy_tbps"
and "add_tbps" (what a PyTorch copy_ and an in-place add_ over as many f32
elements reach: the supply one library kernel gets), "adamw_sass",
"build_s", "spills", "warnings"} (the keys of the kernels it times).
"adamw_sass" counts, for each instantiation of the AdamW kernel, the SASS
instructions and MUFU operations of `cuobjdump -sass` of the built library
(static: the whole function, its ragged-row and loop code included) and
divides them by the elements a thread updates a row.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
# generation at 2 images a batch: (B, S, H, D) and launches a batch; B is 4
# in the UNet (classifier-free guidance) and 2 in the VAE
FWD_SHAPES = [
    ((4, 4096, 8, 40), 105), ((4, 1024, 8, 80), 105), ((4, 256, 8, 160), 105),
    ((4, 64, 8, 160), 21), ((2, 4096, 1, 512), 1)]
GN_SHAPES = [  # (B, C, H, W), eps, act, launches a batch
    ((4, 320, 64, 64), 1e-05, "silu", 168), ((4, 320, 64, 64), 1e-06, None, 105),
    ((4, 320, 32, 32), 1e-05, "silu", 21), ((4, 640, 32, 32), 1e-05, "silu", 126),
    ((4, 640, 32, 32), 1e-06, None, 105), ((4, 640, 16, 16), 1e-05, "silu", 21),
    ((4, 1280, 16, 16), 1e-05, "silu", 126), ((4, 1280, 16, 16), 1e-06, None, 105),
    ((4, 1280, 8, 8), 1e-05, "silu", 231), ((4, 1280, 8, 8), 1e-06, None, 21),
    ((4, 2560, 8, 8), 1e-05, "silu", 63), ((4, 2560, 16, 16), 1e-05, "silu", 42),
    ((4, 1920, 16, 16), 1e-05, "silu", 21), ((4, 1920, 32, 32), 1e-05, "silu", 21),
    ((4, 1280, 32, 32), 1e-05, "silu", 21), ((4, 960, 32, 32), 1e-05, "silu", 21),
    ((4, 960, 64, 64), 1e-05, "silu", 21), ((4, 640, 64, 64), 1e-05, "silu", 42),
    ((2, 512, 64, 64), 1e-06, "silu", 10), ((2, 512, 64, 64), 1e-06, None, 1),
    ((2, 512, 128, 128), 1e-06, "silu", 6), ((2, 512, 256, 256), 1e-06, "silu", 1),
    ((2, 256, 256, 256), 1e-06, "silu", 5), ((2, 256, 512, 512), 1e-06, "silu", 1),
    ((2, 128, 512, 512), 1e-06, "silu", 6)]
# training at batch 4: (B, S, H, D) and dK/dV (and dQ) launches a step
BWD_SHAPES = [((4, 4096, 8, 40), 5), ((4, 1024, 8, 80), 5), ((4, 256, 8, 160), 5),
              ((4, 64, 8, 160), 1)]

_FWD, _GN, _BWD, _ADAMW = "flash_fwd.cu", "groupnorm.cu", "flash_bwd.cu", "fused_adamw.cu"
KERNELS = {_FWD: "fwd", _GN: "gn", _BWD: "bwd", _ADAMW: "adamw"}
_OFF = "if (p.S < 0) "  # a condition that is false at run time keeps the operands live
_WGS = "constexpr int fwd_warpgroups(int nd) { return nd == 40 ? 4 : nd == 80 ? 2 : 1; }"
_BK = "static constexpr int kBK = ND == 80 ? 128 : 64;"
_STAGES = "static constexpr int kStages = ND == 40 ? 4 : 3;"
_CLUSTER = "2ll * spans * pl.cluster <= sms"
_S_ONLY = [  # only the tile loads and S = Q K^T: no exponentials, no P V
    (_FWD, "s[i] = exp2_ftz(fmaf(s[i], p.scale_log2, neg[(i >> 1) & 1]));",
     "s[i] = fmaf(s[i], p.scale_log2, neg[(i >> 1) & 1]);"),
    (_FWD, "        WgmmaRS<ND, 1>::run(o, pa[kk], desc_mn_major<BK>(v_prev, kk), 1);",
     "        " + _OFF + "WgmmaRS<ND, 1>::run(o, pa[kk], desc_mn_major<BK>(v_prev, kk), 1);")]
_BWD_NO_EXP = (_BWD, "exp2_ftz(s", "(s")


_ADAMW_NO_TRANSCENDENTALS = [
    (_ADAMW, "__fmul_rn(deq[(word >> (8 * t)) & 0xffu], scale)",
     "__fmul_rn((float)(int8_t)(word >> (8 * t)), scale)"),
    (_ADAMW, "fmaf(__log2f(r), kQuantLog2, 127.f)", "fmaf(r, kQuantLog2, 127.f)")]
_ADAMW_NO_DIV = [
    (_ADAMW, "const float ic1 = 1.f / c1, ic2 = 1.f / c2;", "const float ic1 = c1, ic2 = c2;"),
    (_ADAMW, "const float u = div_by(m[i], c1, ic1) / __fadd_rn(sqrtf(div_by(v[i], c2, ic2)), a.eps);",
     "const float u = __fmul_rn(m[i], ic1) * __fadd_rn(sqrtf(__fmul_rn(v[i], ic2)), a.eps);"),
    (_ADAMW, "minv = 1.f / fmaxf(mmax, 1e-30f), vinv = 1.f / fmaxf(vmax, 1e-30f);",
     "minv = fmaxf(mmax, 1e-30f), vinv = fmaxf(vmax, 1e-30f);")]
_ADAMW_LOADS_ONLY = [
    (_ADAMW, "m[i] = __fadd_rn(__fmul_rn(a.b1, dequant(deq, wm[i / 4], i % 4, sm)),\n"
     "                       __fmul_rn(a.omb1, gi));",
     "m[i] = (float)(int8_t)(wm[i / 4] >> (8 * (i % 4))) + gi;"),
    (_ADAMW, "v[i] = __fadd_rn(__fmul_rn(a.b2, dequant(deq, wv[i / 4], i % 4, sv)),\n"
     "                       __fmul_rn(__fmul_rn(a.omb2, gi), gi));",
     "v[i] = (float)(int8_t)(wv[i / 4] >> (8 * (i % 4)));"),
    (_ADAMW, "const float u = div_by(m[i], c1, ic1) / __fadd_rn(sqrtf(div_by(v[i], c2, ic2)), a.eps);",
     "const float u = 0.f;"),
    (_ADAMW, "p[i] = __fsub_rn(p[i], __fmul_rn(lr, __fadd_rn(u, __fmul_rn(a.wd, p[i]))));",
     "p[i] = p[i] + u;"),
    (_ADAMW, "wm[j] |= quantize(edge, m[4 * j + t], minv) << (8 * t);",
     "wm[j] |= ((uint32_t)(int)m[4 * j + t] & 0xffu) << (8 * t);"),
    (_ADAMW, "wv[j] |= quantize(edge, v[4 * j + t], vinv) << (8 * t);",
     "wv[j] |= ((uint32_t)(int)v[4 * j + t] & 0xffu) << (8 * t);")]
# the earlier AdamW (one launch a leaf, one warp a row, 8 values a lane), for --tree
_ADAMW_PARENT_NO_TRANSCENDENTALS = [
    (_ADAMW, "expf(__fmul_rn(kDeqK, mag - 127.f))", "(__fmul_rn(kDeqK, mag - 127.f))"),
    (_ADAMW, "logf(fmaxf(ratio, 1e-30f))", "(fmaxf(ratio, 1e-30f))")]
_ADAMW_PARENT_NO_DIV = [
    (_ADAMW, "const float ratio = fabsf(x) / safe;", "const float ratio = fabsf(x) * safe;"),
    (_ADAMW, "logf(fmaxf(ratio, 1e-30f)) / kLn10", "logf(fmaxf(ratio, 1e-30f)) * kLn10"),
    (_ADAMW, "const float u = (m[j] / c1) / __fadd_rn(sqrtf(v[j] / c2), a.eps);",
     "const float u = (m[j] * c1) * __fadd_rn(sqrtf(v[j] * c2), a.eps);")]
_ADAMW_PARENT_LOADS_ONLY = [
    (_ADAMW, "m[j] = __fadd_rn(__fmul_rn(a.b1, dequant(qm[j], sm)), __fmul_rn(a.omb1, gj));",
     "m[j] = (float)qm[j] + gj;"),
    (_ADAMW, "v[j] = __fadd_rn(__fmul_rn(a.b2, dequant(qv[j], sv)), "
     "__fmul_rn(__fmul_rn(a.omb2, gj), gj));", "v[j] = (float)qv[j];"),
    (_ADAMW, "const float u = (m[j] / c1) / __fadd_rn(sqrtf(v[j] / c2), a.eps);",
     "const float u = 0.f;"),
    (_ADAMW, "p2[j] = __fsub_rn(p[j], __fmul_rn(lr, __fadd_rn(u, __fmul_rn(a.wd, p[j]))));",
     "p2[j] = p[j] + u;"),
    (_ADAMW, "cm[t] = quantize(m[4 * h + t], msafe);", "cm[t] = (int8_t)m[4 * h + t];"),
    (_ADAMW, "cv[t] = quantize(v[4 * h + t], vsafe);", "cv[t] = (int8_t)v[4 * h + t];")]


def _warpgroups(at40, at80):
    """The forward with `at40` and `at80` consumer warpgroups a block at D = 40 and 80."""
    return (_FWD, _WGS, _WGS.replace("nd == 40 ? 4 : nd == 80 ? 2",
                                     f"nd == 40 ? {at40} : nd == 80 ? {at80}"))


VARIANTS = {  # name: [(source in csrc/, old, new), ...]; every `old` is replaced.
    # A tuple of such lists holds alternatives: the first that applies is made.
    "base": [],
    "fwd_no_exp": _S_ONLY[:1],
    "fwd_loads_and_s_only": _S_ONLY,
    "fwd_loads_only": _S_ONLY + [
        (_FWD, "      WgmmaSS<BK>::run(s, desc_k_major<OWN>(q_s, kk), desc_k_major<BK>(k_s, kk), kk > 0);",
         "      " + _OFF + "WgmmaSS<BK>::run(s, desc_k_major<OWN>(q_s, kk), desc_k_major<BK>(k_s, kk), kk > 0);")],
    "fwd_one_warpgroup": [_warpgroups(1, 1)],
    "fwd_most_warpgroups": [
        (_FWD, "WGS > 1 && (long long)bh * ((p->S + Many::kOwn - 1) / Many::kOwn) >= sms",
         "WGS > 1")],
    "fwd_two_warpgroups_at_40": [_warpgroups(2, 2)],
    "fwd_three_warpgroups_at_40": [_warpgroups(3, 2)],
    "fwd_two_stages": [(_FWD, _STAGES, "static constexpr int kStages = 2;")],
    "fwd_three_stages_at_40": [(_FWD, _STAGES, "static constexpr int kStages = 3;")],
    "fwd_five_stages_at_40": [(_FWD, _STAGES, "static constexpr int kStages = ND == 40 ? 5 : 3;")],
    "fwd_128_key_tiles_at_40": [(_FWD, _BK, "static constexpr int kBK = ND == 160 ? 64 : 128;")],
    "fwd_64_key_tiles": [(_FWD, _BK, "static constexpr int kBK = 64;")],
    "fwd_three_warpgroups_at_80": [_warpgroups(4, 3), (_FWD, _BK, "static constexpr int kBK = 64;")],
    "gn_base": [],  # the group norm alone, as it is
    "gn_tail_everywhere": [(_GN, "if (HW % 8 != 0 || xa % 16 != 0)  // the tail path",
                            "if (true)  // the tail path")],
    "gn_no_cluster": [(_GN, _CLUSTER, "false")],
    "gn_clusters_x2": [(_GN, _CLUSTER, "2ll * spans * pl.cluster <= 2 * sms")],
    "bwd_no_exp": [_BWD_NO_EXP],
    "bwd_loads_and_s_only": [
        (_BWD, "      " + product, "      " + _OFF + product) for product in (
            "WgmmaRS<ND, 1>::run(dq, pa[kk]", "WgmmaRS<ND, 1>::run(dv, pa[kk]",
            "WgmmaRS<ND, 1>::run(dk, pb[kk]", "WgmmaSS<BK>::run(dp, ", "WgmmaSS<BQ>::run(dpt, ")
    ] + [_BWD_NO_EXP],
    "bwd_one_warpgroup": [
        (_BWD, "constexpr int dkv_warpgroups(int nd) { return nd > 80 ? 1 : 2; }",
         "constexpr int dkv_warpgroups(int nd) { return 1; }"),
        (_BWD, "constexpr int dq_warpgroups(int nd) { return nd > 80 ? 1 : nd > 40 ? 2 : 3; }",
         "constexpr int dq_warpgroups(int nd) { return 1; }")],
    "bwd_two_stages": [
        (_BWD, "static constexpr int kStages = 3;                // ring",
         "static constexpr int kStages = 2;                // ring"),
        (_BWD, "static constexpr int kStages = ND > 80 ? 2 : 3;  // ring",
         "static constexpr int kStages = 2;  // ring")],
    "adamw_base": [],  # the AdamW alone, as it is
    "adamw_no_transcendentals": (_ADAMW_NO_TRANSCENDENTALS, _ADAMW_PARENT_NO_TRANSCENDENTALS),
    "adamw_no_div": (_ADAMW_NO_DIV, _ADAMW_PARENT_NO_DIV),
    "adamw_loads_only": (_ADAMW_LOADS_ONLY, _ADAMW_PARENT_LOADS_ONLY),
    "adamw_streaming": [
        (_ADAMW, "return *reinterpret_cast<const T*>(p);",
         "return __ldcs(reinterpret_cast<const T*>(p));"),
        (_ADAMW, "*reinterpret_cast<T*>(p) = v;", "__stcs(reinterpret_cast<T*>(p), v);")],
    "adamw_three_blocks_an_sm": [
        (_ADAMW, "__launch_bounds__(kThreads) fused", "__launch_bounds__(kThreads, 3) fused")],
    "adamw_three_blocks_an_sm_without_ema": [
        (_ADAMW, "__launch_bounds__(kThreads) fused",
         "__launch_bounds__(kThreads, kEma ? 2 : 3) fused")],
}


def _source(package: str, source: str) -> str:
    with open(os.path.join(package, "csrc", source)) as f:
        return f.read()


def applicable(edits, package: str = os.path.join(REPO, "agenda_tpu_torch")):
    """The edit list of a variant that applies to `package`'s sources: the list
    itself, or the first of its alternatives whose every `old` is found; None
    if none applies."""
    for alt in (edits if isinstance(edits, tuple) else (edits,)):
        if all(old in _source(package, source) for source, old, _ in alt):
            return alt
    return None


def copy_package(dest, edits, tree: str = REPO) -> str:
    """Copy agenda_tpu_torch/ of `tree` into `dest` (without its build) and make
    each edit (source in csrc/, old, new) there, replacing every `old`; raise
    if an `old` is not in its source. `edits` may be a tuple of alternative
    lists (the first that applies is made). Returns the package's copy."""
    copy = os.path.join(str(dest), "agenda_tpu_torch")
    shutil.copytree(os.path.join(tree, "agenda_tpu_torch"), copy,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if isinstance(edits, tuple):
        chosen = applicable(edits, copy)
        if chosen is None:
            raise ValueError(f"no alternative of {edits!r} applies to {tree}")
        edits = chosen
    for source, old, new in edits:
        path = os.path.join(copy, "csrc", source)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise ValueError(f"{old!r} is not in {source}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return copy


CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
import torch
from agenda_tpu_torch.kernels import _build, flash as fl
from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference
from chip_smoke import FLASH_ATOL_RMS, FLASH_RTOL, GN_ATOL, GN_RTOL, time_ms
kernels, shapes = json.loads(sys.argv[3]), json.loads(sys.argv[4])
lib = _build.load_library()
out = {"build_s": round(lib.build_seconds, 1),
       "spills": [line.strip() for line in lib.log.splitlines()
                  if "spill stores" in line and not line.strip().startswith("0 bytes")],
       "warnings": [line.strip()[:200] for line in lib.log.splitlines() if "warning" in line][:8]}


def flash_over_limit(got, ref):
    ref = ref.float()
    limit = FLASH_ATOL_RMS * ref.square().mean().sqrt() + FLASH_RTOL * ref.abs()
    return ((got.float() - ref).abs() / limit).max().item()


def worse(worst, r):
    return r if r != r else max(worst, r)  # NaN stays NaN


def qkv(shape, n):
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    return [torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(n)]


if "fwd" in kernels:
    out["fwd"], worst, total = {}, 0.0, 0.0
    for shape, count in shapes["fwd"]:
        shape = tuple(shape)
        q, k, v = qkv(shape, 3)
        worst = worse(worst, flash_over_limit(fl.flash_attention_fwd(q, k, v)[0],
                                              fl.flash_attention_reference(q, k, v)[0]))
        ms = time_ms(lambda: fl.flash_attention_fwd(q, k, v))[0]
        out["fwd"][str(shape)] = round(ms, 4)
        total += count * ms
    out["fwd_batch_ms"], out["fwd_worst"] = round(total, 3), round(worst, 4)
if "gn" in kernels:
    out["gn"], worst, total = {}, 0.0, 0.0
    for shape, eps, act, count in shapes["gn"]:
        shape, c = tuple(shape), shape[1]
        g = torch.Generator(device="cuda").manual_seed(sum(shape) + c)
        x = (torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5).bfloat16()
        w, b = torch.randn(c, device="cuda", generator=g), torch.randn(c, device="cuda", generator=g)
        ref = group_norm_act_reference(x, w, b, 32, eps, act).float()
        diff = (group_norm_act(x, w, b, 32, eps, act).float() - ref).abs()
        worst = worse(worst, (diff / (GN_ATOL + GN_RTOL * ref.abs())).max().item())
        ms = time_ms(lambda: group_norm_act(x, w, b, 32, eps, act))[0]
        out["gn"][f"{shape} {act}"] = round(ms, 4)
        total += count * ms
    out["gn_batch_ms"], out["gn_worst"] = round(total, 3), round(worst, 4)
if "bwd" in kernels:
    out["bwd"], worst, total = {}, 0.0, 0.0
    for shape, count in shapes["bwd"]:
        shape = tuple(shape)
        q, k, v, do = qkv(shape, 4)
        o, lse = fl.flash_attention_fwd(q, k, v)
        delta = fl.flash_delta(o, do)
        got = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
               fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
        want = (*fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta),
                fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta))
        for x, ref in zip(got, want):
            worst = worse(worst, flash_over_limit(x, ref))
        del got, want
        a = time_ms(lambda: fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta))[0]
        b = time_ms(lambda: fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))[0]
        out["bwd"][str(shape)] = [round(a, 4), round(b, 4)]
        total += count * (a + b)
    out["bwd_step_ms"], out["bwd_worst"] = round(total, 3), round(worst, 4)
if "adamw" in kernels:
    import math, time
    from agenda_tpu_torch.kernels import fused_adamw as fa
    from chip_smoke import ADAMW_KW, ADAMW_TOL_P, ADAMW_TOL_SCALE, H100_BYTES_PER_S
    from kernel_variants import sass_counts
    shapes_a = [tuple(s) for s in shapes["adamw"]]
    g = torch.Generator(device="cuda").manual_seed(5)
    leaves, emas = [], []
    for shape in shapes_a:
        nb = (math.prod(shape) + 255) // 256
        leaves.append([torch.randn(shape, device="cuda", generator=g),
                       torch.randn(shape, device="cuda", generator=g) * 1e-3,
                       torch.randint(-127, 128, shape, device="cuda", generator=g).to(torch.int8),
                       torch.rand(nb, device="cuda", generator=g) * 1e-3,
                       torch.randint(0, 128, shape, device="cuda", generator=g).to(torch.int8),
                       torch.rand(nb, device="cuda", generator=g) * 1e-6])
        emas.append(torch.randn(shape, device="cuda", generator=g))
    scalars = torch.tensor([1e-4, 0.4, 0.271, 0.0029701, 0.97], device="cuda")
    one_launch = hasattr(fa, "fused_adamw8bit_leaves")

    def step(ema):
        if one_launch:
            fa.fused_adamw8bit_leaves(leaves, scalars, emas=emas if ema else None, **ADAMW_KW)
        else:
            for leaf, e in zip(leaves, emas):
                fa.fused_adamw8bit_leaf(*leaf, scalars, ema=e if ema else None, **ADAMW_KW)

    sizes = [math.prod(s) for s in shapes_a]
    check = sorted({sizes.index(max(sizes)), sizes.index(min(sizes)), len(sizes) // 2})
    worst = 0.0
    for ema in (False, True):  # the step against the plain version at three leaves
        want = {i: ([t.clone() for t in leaves[i]], emas[i].clone()) for i in check}
        step(ema)
        for i, (ref, e_ref) in want.items():
            fa.fused_adamw8bit_leaf_reference(*ref, scalars, ema=e_ref if ema else None,
                                              **ADAMW_KW)
            got = leaves[i]
            ratios = [(got[0] - ref[0]).abs().max().item() / ADAMW_TOL_P,
                      max((got[k].int() - ref[k].int()).abs().max().item() for k in (2, 4)),
                      max(((got[k] - ref[k]).abs() / ref[k].abs().clamp(min=1e-30)).max().item()
                          for k in (3, 5)) / ADAMW_TOL_SCALE]
            if ema:
                ratios.append((emas[i] - e_ref).abs().max().item() / ADAMW_TOL_P)
            for r in ratios:
                worst = worse(worst, r)
        del want
    n_all, rows_all = sum(sizes), sum((n + 255) // 256 for n in sizes)
    for ema, key in ((False, "adamw_step_ms"), (True, "adamw_ema_step_ms")):
        ms = time_ms(lambda: step(ema))[0]
        nbytes = n_all * (24.0 if ema else 16.0) + 16.0 * rows_all
        out[key] = round(ms, 4)
        out[key.replace("_ms", "_tbps")] = round(nbytes / (ms * 1e-3) / 1e12, 3)
    if one_launch:  # as the optimizer calls it: pointers packed once, gradients each step
        table = fa.FusedLeaves([(leaf[0], *leaf[2:]) for leaf in leaves], emas)
        call = lambda: table([leaf[1] for leaf in leaves], scalars, **ADAMW_KW)
    else:
        call = lambda: step(True)
    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
    out["adamw_host_us"] = round(1e6 * sorted(host)[3], 1)  # the median, EMA path
    out["adamw_worst"] = round(worst, 4)
    # what one PyTorch elementwise kernel reaches over as many elements: a copy
    # (read 4, write 4 bytes an element) and an in-place add (read 8, write 4)
    a_, b_ = torch.zeros(n_all, device="cuda"), torch.ones(n_all, device="cuda")
    out["copy_tbps"] = round(8.0 * n_all / (time_ms(lambda: a_.copy_(b_))[0] * 1e-3) / 1e12, 3)
    out["add_tbps"] = round(12.0 * n_all / (time_ms(lambda: a_.add_(b_))[0] * 1e-3) / 1e12, 3)
    del a_, b_
    out["adamw_sass"] = sass_counts(str(lib.path), _build.CSRC_DIR / "fused_adamw.cu")
print(json.dumps(out))
"""


def sass_counts(lib_path: str, source) -> dict:
    """{AdamW kernel instantiation: SASS instructions and MUFU operations, and
    both per element} from `cuobjdump -sass` of the library at `lib_path`;
    `source` (its fused_adamw.cu) gives the elements a thread updates a row
    (kPerLane, or 8 in the earlier kernel, which lacks it)."""
    import re

    from agenda_tpu_torch.kernels import _build

    text = open(source).read()
    m = re.search(r"constexpr int kPerLane = (\d+);", text)
    per_lane = int(m.group(1)) if m else 8
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        f = re.search(r"Function : (\S+)", line)
        if f:
            name = f.group(1)
            current = None
            if "fused_adamw8bit" in name:
                current = "ema" if "ILb1E" in name else "no_ema"
                counts[current] = {"instructions": 0, "mufu": 0}
            continue
        ins = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and ins and not ins.group(2).startswith("NOP"):
            counts[current]["instructions"] += 1
            counts[current]["mufu"] += ins.group(2).startswith("MUFU")
    for c in counts.values():
        c["per_element"] = round(c["instructions"] / per_lane, 2)
        c["mufu_per_element"] = round(c["mufu"] / per_lane, 2)
    return counts


def generation_shapes(images: int) -> dict:
    """The shapes of a generation batch of `images` images (the lists above are at 2)."""
    def scale(shape):
        return (shape[0] * images // 2, *shape[1:])

    return {"fwd": [(scale(s), n) for s, n in FWD_SHAPES],
            "gn": [(scale(s), eps, act, n) for s, eps, act, n in GN_SHAPES],
            "bwd": BWD_SHAPES, "adamw": adamw_leaf_shapes()}


def adamw_leaf_shapes() -> list:
    """The shapes of the full-width UNet's quantized leaves (293), in order."""
    import torch

    from agenda_tpu_torch.io.configs import UNetConfig
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.train.optim import MIN_QUANTIZE_SIZE

    with torch.device("meta"):
        params = list(UNet2DConditionModel(UNetConfig()).parameters())
    return [list(p.shape) for p in params if p.numel() >= MIN_QUANTIZE_SIZE]


def run_variant(name: str, tree: str, images: int) -> dict:
    edits = VARIANTS[name]
    first = edits[0] if isinstance(edits, tuple) else edits
    kernels = (sorted({KERNELS[src] for src, _, _ in first})
               or ([name[:-len("_base")]] if name.endswith("_base") else sorted(KERNELS.values())))
    with tempfile.TemporaryDirectory(prefix=f"variant_{name}_") as tmp:
        copy_package(tmp, edits, tree)
        run = subprocess.run([sys.executable, "-c", CHILD, tmp, REPO, json.dumps(kernels),
                              json.dumps(generation_shapes(images))],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"variant {name} failed:\n{run.stderr[-3000:]}")
        return {"variant": name, **json.loads(run.stdout.splitlines()[-1])}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs the card", file=sys.stderr)
        return 2
    from chip_smoke import smi_name_power

    tree, images = REPO, 2
    while argv[:1] in (["--tree"], ["--batch"]):
        if argv[0] == "--tree":
            tree = os.path.abspath(argv[1])
        else:
            images = int(argv[1])
        argv = argv[2:]
    print(f"{torch.cuda.get_device_name(0)} ({smi_name_power()}); package from {tree}; "
          f"generation batch of {images} images", flush=True)
    for name in argv or list(VARIANTS):
        print(json.dumps(run_variant(name, tree, images)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
