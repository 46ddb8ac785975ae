"""The PyTorch port stands alone: no jax, flax or agenda_tpu, and no CPU fallback.

- A fresh interpreter imports the port, writes a tiny pipeline with the
  port's own fabricator and runs the port's CLI on the CPU; afterwards
  ``jax``, ``flax`` and ``agenda_tpu`` are absent from ``sys.modules``.
  Another does the same for the labelling CLIs (``det_test`` on a
  fabricated detector and tiles, then ``select_threshold``).
- No source file of the port, nor the tools at the root of the repo
  (``chip_smoke.py`` and the kernel-variant timer), imports them.
- Asking for CUDA without a GPU raises; ``chip_smoke.py`` exits non-zero and
  prints no result without a card, and outside a checkout.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "agenda_tpu_torch"
FORBIDDEN = ("jax", "flax", "agenda_tpu")

_DRIVE = r"""
import os, sys
from agenda_tpu_torch.io.fabricate import fabricate_pipeline, write_learned_embeds
from agenda_tpu_torch.cli import data_generation
d = sys.argv[1]
_, _, text = fabricate_pipeline(os.path.join(d, "p"), tiny=True, seed=1)
write_learned_embeds(os.path.join(d, "e.bin"), text.hidden_size)
data_generation.main(["--device", "cpu", "--pretrained-model-path", os.path.join(d, "p"),
    "--learnable-tokens-embedding-path", os.path.join(d, "e.bin"),
    "--save-dir", os.path.join(d, "out"), "--num-images", "2", "--batch-size", "2",
    "--num-inference-steps", "2", "--resolution", "32", "--word_token_heatmaps", "cars"])
assert len(os.listdir(os.path.join(d, "out", "images"))) == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "agenda_tpu"))
print("FORBIDDEN", bad)
"""


_DRIVE_LABELS = r"""
import json, os, sys
from agenda_tpu_torch.cli import det_test, select_threshold
from agenda_tpu_torch.detect.fabricate import fabricate_detector, write_square_set
d = sys.argv[1]
write_square_set(os.path.join(d, "data"), 6, seed=1)
config, ckpt = fabricate_detector(os.path.join(d, "work"), img_size=64, batch_size=4, seed=1)
recs = det_test.main(["--device", "cpu", "--config", config, "--checkpoint", ckpt,
                      "--test-root", os.path.join(d, "data"), "--test-ann", "ann.json",
                      "--out", os.path.join(d, "pred.pkl")])
assert len(recs) == 6
select_threshold.main(["--prediction_pkl", os.path.join(d, "pred.pkl"),
                       "--result-out", os.path.join(d, "result.json"), "--emit-pseudo-coco",
                       "--out-dir", d])
assert "threshold" in json.load(open(os.path.join(d, "result.json")))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "agenda_tpu"))
print("FORBIDDEN", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_runs_without_importing_jax_or_agenda_tpu(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DRIVE, str(tmp_path)], cwd=str(tmp_path),
                         env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def test_labelling_runs_without_importing_jax_or_agenda_tpu(tmp_path):
    """det_test and select_threshold of the port, on the CPU, in a fresh interpreter."""
    out = subprocess.run([sys.executable, "-c", _DRIVE_LABELS, str(tmp_path)],
                         cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax_flax_or_agenda_tpu():
    files = sorted(PORT.rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "kernel_variants.py")]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    from agenda_tpu_torch._device import resolve_device
    from agenda_tpu_torch.cli.data_generation import main

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--pretrained-model-path", str(tmp_path / "absent"),
              "--save-dir", str(tmp_path / "out")])


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                           capture_output=True, text=True, timeout=120,
                           env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert alone.returncode != 0 and '"ok"' not in alone.stdout


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    from agenda_tpu_torch.kernels.flash import flash_attention_fwd
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    before = (flash_attention_fwd.launches, group_norm_act.launches)
    q = torch.randn(1, 16, 2, 8)
    flash_attention_fwd(q, q, q)
    group_norm_act(torch.randn(1, 4, 3, 3), torch.ones(4), torch.zeros(4), 2, 1e-5, "silu")
    assert (flash_attention_fwd.launches, group_norm_act.launches) == before  # no kernel ran
    with pytest.raises(ValueError):
        flash_attention_fwd(q.to("meta"), q.to("meta"), q.to("meta"))
