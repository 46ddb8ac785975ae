#!/usr/bin/env python3
"""Time edited copies of the port's flash and group-norm kernels on one NVIDIA H100.

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
training step at batch 4 (flash backward, dK/dV and dQ):

  base                   the kernels as they are;
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
  gn_no_cluster          one block a span at every shape;
  gn_clusters_x2         clusters that take a launch up to two blocks an SM, not one;
  bwd_no_exp             the backward's exponentials replaced by the identity;
  bwd_loads_and_s_only   only its tile loads and S product left (no dP, no RS
                         products, no exponentials): the supply floor;
  bwd_one_warpgroup      one consumer warpgroup a block in both backward kernels;
  bwd_two_stages         a ring of two stages in both.

One JSON line per variant: {"variant": ..., "fwd": {shape: ms}, "fwd_batch_ms",
"fwd_worst", "gn": {shape: ms}, "gn_batch_ms", "gn_worst", "bwd": {shape:
[dK/dV ms, dQ ms]}, "bwd_step_ms", "bwd_worst", "build_s", "spills", "warnings"}
(the keys of the kernels it times).
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

_FWD, _GN, _BWD = "flash_fwd.cu", "groupnorm.cu", "flash_bwd.cu"
KERNELS = {_FWD: "fwd", _GN: "gn", _BWD: "bwd"}
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


def _warpgroups(at40, at80):
    """The forward with `at40` and `at80` consumer warpgroups a block at D = 40 and 80."""
    return (_FWD, _WGS, _WGS.replace("nd == 40 ? 4 : nd == 80 ? 2",
                                     f"nd == 40 ? {at40} : nd == 80 ? {at80}"))


VARIANTS = {  # name: [(source in csrc/, old, new), ...]; every `old` is replaced
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
}


def copy_package(dest, edits, tree: str = REPO) -> str:
    """Copy agenda_tpu_torch/ of `tree` into `dest` (without its build) and make
    each edit (source in csrc/, old, new) there, replacing every `old`; raise
    if an `old` is not in its source. Returns the package's copy."""
    copy = os.path.join(str(dest), "agenda_tpu_torch")
    shutil.copytree(os.path.join(tree, "agenda_tpu_torch"), copy,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
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
print(json.dumps(out))
"""


def generation_shapes(images: int) -> dict:
    """The shapes of a generation batch of `images` images (the lists above are at 2)."""
    def scale(shape):
        return (shape[0] * images // 2, *shape[1:])

    return {"fwd": [(scale(s), n) for s, n in FWD_SHAPES],
            "gn": [(scale(s), eps, act, n) for s, eps, act, n in GN_SHAPES],
            "bwd": BWD_SHAPES}


def run_variant(name: str, tree: str, images: int) -> dict:
    edits = VARIANTS[name]
    kernels = sorted({KERNELS[src] for src, _, _ in edits}) or sorted(KERNELS.values())
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
