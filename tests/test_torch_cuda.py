"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
neither jax nor agenda_tpu, so it also runs on the card's machine, where
JAX is not installed (``tests/conftest.py`` imports jax, hence
``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import agenda_tpu_torch
from agenda_tpu_torch.kernels.flash import flash_attention_fwd, flash_attention_reference
from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference

# flash output, elementwise: |out - ref| <= FLASH_ATOL_RMS * rms(ref) + FLASH_RTOL * |ref|
# (both sides round to bf16; P is rounded to bf16 before P V). rms(ref) falls as
# 1/sqrt(S) here, so the limit scales with it. As in chip_smoke.py.
FLASH_ATOL_RMS, FLASH_RTOL = 0.05, 1.6e-2
FLASH_TOL_LSE = 1e-3  # f32 logsumexp from bf16 q, k
GN_ATOL, GN_RTOL = 2e-2, 1.6e-2  # about two bf16 ulps of the output


def _assert_flash_close(out, ref):
    ref = ref.float()
    rms = ref.square().mean().sqrt()
    assert bool(((out.float() - ref).abs() <= FLASH_ATOL_RMS * rms + FLASH_RTOL * ref.abs()).all())


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the H100: pytest -m cuda)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 8, 80), (2, 1000, 8, 40), (1, 77, 3, 24),
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


# Broken copies of csrc/flash_fwd.cu that the flash limit must fail: each
# touches only P V, which the logsumexp check cannot see.
FLASH_MUTATIONS = {
    "v_from_other_stage": ("const __nv_bfloat16* Vt = Vs + stage * BK * ROW;",
                           "const __nv_bfloat16* Vt = Vs + (stage ^ 1) * BK * ROW;"),
    "drop_16_keys_of_a_column_tile": (
        "mma_bf16(o[n + 1], pa[kk], bv[2], bv[3]);",
        "if (kk + n > 0) mma_bf16(o[n + 1], pa[kk], bv[2], bv[3]);"),
    "drop_last_key_tile": ("    // O += P V on this warp's columns;",
                           "    if (j + 1 == n_tiles) continue;\n    // O += P V on this warp's columns;"),
}
# the main path's flash shapes and chip_smoke.py's two ragged ones
FLASH_LIMIT_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                      (2, 4096, 1, 512), (2, 1000, 8, 40), (1, 333, 2, 264)]
_WORST_ERROR_OVER_LIMIT = """
import json, torch
from agenda_tpu_torch.kernels.flash import flash_attention_fwd, flash_attention_reference
worst = {}
for shape in %r:
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(3))
    ref = flash_attention_reference(q, k, v)[0].float()
    diff = (flash_attention_fwd(q, k, v)[0].float() - ref).abs()
    limit = %r * ref.square().mean().sqrt() + %r * ref.abs()
    worst[str(shape)] = (diff / limit).max().item()
print(json.dumps(worst))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", sorted(FLASH_MUTATIONS))
def test_flash_limit_fails_broken_kernels(mutation, tmp_path):
    """Build a broken copy of the package in tmp_path; the limit must fail it at every shape."""
    _need_cuda()
    copy = tmp_path / "agenda_tpu_torch"
    shutil.copytree(Path(agenda_tpu_torch.__file__).parent, copy,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = copy / "csrc" / "flash_fwd.cu"
    old, new = FLASH_MUTATIONS[mutation]
    text = src.read_text()
    assert text.count(old) == 1
    src.write_text(text.replace(old, new))
    script = _WORST_ERROR_OVER_LIMIT % (FLASH_LIMIT_SHAPES, FLASH_ATOL_RMS, FLASH_RTOL)
    run = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert run.returncode == 0, run.stderr
    worst = json.loads(run.stdout.splitlines()[-1])
    print(f"{mutation}: worst |out - ref| / limit per shape {worst}")
    assert all(not r <= 1.0 for r in worst.values()), worst  # NaN fails too


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
    with pytest.raises(ValueError):  # H*W not a multiple of 8
        group_norm_act(x[:, :, :7, :7].contiguous(), w, b, 32, 1e-5)
