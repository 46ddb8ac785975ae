#!/usr/bin/env python3
"""Time edited copies of the flash backward kernels on one NVIDIA H100.

    python3 flash_bwd_variants.py [variant ...]

Each variant is a copy of agenda_tpu_torch/ in a temporary directory with a
few lines of csrc/flash_bwd.cu replaced; a child process builds the copy and
times its dK/dV and dQ kernels (CUDA-graph replay, as chip_smoke.py does) at
the training shapes (4, 4096, 8, 40), (4, 1024, 8, 80) and (4, 256, 8, 160),
and reports how far they are from the plain versions (worst |grad - ref| over
the limit 0.05 rms(ref) + 0.016 |ref|; a variant that drops work fails it).
Variants that remove work say what that work costs:

  base              the kernels as they are;
  no_exp            exponentials replaced by the identity;
  loads_and_s_only  only the tile loads and the S product left (no dP, no
                    RS products, no exponentials): the supply floor;
  one_warpgroup     one consumer warpgroup a block at every head dim;
  two_stages        a ring of two stages in both kernels.

One JSON line per variant: {"variant": ..., "<shape>": [dK/dV ms, dQ ms,
pair ms], "worst_<S>": ratio, "build_s": ..., "spills": [...]}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160)]
_OFF = "if (p.S < 0) "  # a condition that is false at run time keeps the operands live
_DROP = {product: ("      " + product, "      " + _OFF + product) for product in (
    "WgmmaRS<ND, 1>::run(dq, pa[kk]", "WgmmaRS<ND, 1>::run(dv, pa[kk]",
    "WgmmaRS<ND, 1>::run(dk, pb[kk]", "WgmmaSS<BK>::run(dp, ", "WgmmaSS<BQ>::run(dpt, ")}
_NO_EXP = ("exp2_ftz(s", "(s")
VARIANTS = {
    "base": [],
    "no_exp": [_NO_EXP],
    "loads_and_s_only": list(_DROP.values()) + [_NO_EXP],
    "one_warpgroup": [
        ("constexpr int dkv_warpgroups(int nd) { return nd > 80 ? 1 : 2; }",
         "constexpr int dkv_warpgroups(int nd) { return 1; }"),
        ("constexpr int dq_warpgroups(int nd) { return nd > 80 ? 1 : nd > 40 ? 2 : 3; }",
         "constexpr int dq_warpgroups(int nd) { return 1; }")],
    "two_stages": [
        ("static constexpr int kStages = 3;                // ring",
         "static constexpr int kStages = 2;                // ring"),
        ("static constexpr int kStages = ND > 80 ? 2 : 3;  // ring",
         "static constexpr int kStages = 2;  // ring")],
}

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
import torch
from agenda_tpu_torch.kernels import _build, flash as fl
from chip_smoke import FLASH_ATOL_RMS, FLASH_RTOL, time_ms
lib = _build.load_library()
out = {"build_s": round(lib.build_seconds, 1),
       "spills": [line.strip() for line in lib.log.splitlines()
                  if "spill stores" in line and not line.strip().startswith("0 bytes")]}
for shape in json.loads(sys.argv[3]):
    shape = tuple(shape)
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v, do = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(4))
    o, lse = fl.flash_attention_fwd(q, k, v)
    delta = fl.flash_delta(o, do)
    got = (*fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
           fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))
    want = (*fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta),
            fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta))
    worst = 0.0
    for x, ref in zip(got, want):
        ref = ref.float()
        limit = FLASH_ATOL_RMS * ref.square().mean().sqrt() + FLASH_RTOL * ref.abs()
        worst = max(worst, ((x.float() - ref).abs() / limit).max().item())
    out[f"worst_{shape[1]}"] = round(worst, 4)
    del got, want
    a = time_ms(lambda: fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta))[0]
    b = time_ms(lambda: fl.flash_attention_bwd_dq(q, k, v, do, lse, delta))[0]
    out[str(shape)] = [round(a, 4), round(b, 4), round(a + b, 4)]
print(json.dumps(out))
"""


def run_variant(name: str) -> dict:
    with tempfile.TemporaryDirectory(prefix=f"flash_bwd_{name}_") as tmp:
        shutil.copytree(os.path.join(REPO, "agenda_tpu_torch"),
                        os.path.join(tmp, "agenda_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = os.path.join(tmp, "agenda_tpu_torch", "csrc", "flash_bwd.cu")
        with open(src) as f:
            text = f.read()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in flash_bwd.cu")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
        run = subprocess.run([sys.executable, "-c", CHILD, tmp, REPO, json.dumps(SHAPES)],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"variant {name} failed:\n{run.stderr[-3000:]}")
        return {"variant": name, **json.loads(run.stdout.splitlines()[-1])}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs the card", file=sys.stderr)
        return 2
    from chip_smoke import smi_name_power

    print(f"{torch.cuda.get_device_name(0)} ({smi_name_power()})", flush=True)
    for name in argv or list(VARIANTS):
        print(json.dumps(run_variant(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
