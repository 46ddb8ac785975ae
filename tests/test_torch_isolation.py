"""The PyTorch port stands alone: no jax, flax or agenda_tpu, and no CPU fallback.

- A fresh interpreter imports the port, writes a tiny pipeline with the
  port's own fabricator and runs the port's CLI on the CPU; afterwards
  ``jax``, ``flax`` and ``agenda_tpu`` are absent from ``sys.modules``.
  Another does the same for the detector CLIs (``det_train`` for an
  epoch on fabricated tiles, ``det_test`` on a fabricated detector, then
  ``select_threshold``).
  A third drives ``refine_label`` on fabricated tiles and a dry run of the
  port's ``pipeline`` over its whole DAG; ``PIL`` stays absent too.
- No source file of the port, nor the tools at the root of the repo
  (``chip_smoke.py`` and the kernel-variant timer), imports them, nor
  Pillow; the detector drive runs without importing Pillow.
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
FORBIDDEN = ("jax", "flax", "agenda_tpu", "PIL")  # the card's machine has no Pillow

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
from agenda_tpu_torch.cli import det_test, det_train, select_threshold
from agenda_tpu_torch.detect.configs import DatasetSpec, preset
from agenda_tpu_torch.detect.fabricate import fabricate_detector, write_square_set
d = sys.argv[1]
write_square_set(os.path.join(d, "data"), 6, seed=1)
run = preset("synthetic_heatmap", "yolov8", [DatasetSpec(os.path.join(d, "data"), "ann.json")],
             img_scale=(64, 64), max_gt=8)
run.to_json(os.path.join(d, "run.json"))
det_train.main(["--device", "cpu", "--config", os.path.join(d, "run.json"), "--max-epochs", "1",
                "--batch-size", "4", "--work-dir", os.path.join(d, "trained")])
assert os.path.exists(os.path.join(d, "trained", "latest.safetensors"))
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
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "agenda_tpu", "PIL"))
print("FORBIDDEN", bad)
"""


_DRIVE_REFINE = r"""
import json, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)  # beside the suite's other test processes
from agenda_tpu_torch.cli import pipeline, refine_label
from agenda_tpu_torch.utils.png import write_png
d = sys.argv[1]
rng = np.random.default_rng(0)
os.makedirs(os.path.join(d, "images"))
records = []
for i in range(4):
    write_png(os.path.join(d, "images", f"{i}.png"), rng.integers(0, 256, (112, 112, 3), np.uint8))
    records.append({"img_path": f"{i}.png", "pred_instances": {
        "scores": np.array([0.9, 0.5, 0.2]), "labels": np.zeros(3, np.int64),
        "bboxes": np.array([[30, 30, 72, 72], [0, 0, 42, 42], [70, 70, 112, 112]], np.float32)}})
with open(os.path.join(d, "pred.pkl"), "wb") as f:
    pickle.dump(records, f)
out = refine_label.main(["--device", "cpu", "--prediction_pkl", os.path.join(d, "pred.pkl"),
    "--synthetic_image_base_path", os.path.join(d, "images"),
    "--json_save_path", os.path.join(d, "refined.json"),
    "--checkpoint_save_path", os.path.join(d, "clf"), "--num_epochs", "1",
    "--crop_size", "32", "--train_batch_size", "4", "--test_batch_size", "4"])
assert out["n_train"] == 8 and out["n_test"] == 4
assert len(json.load(open(os.path.join(d, "refined.json")))["annotations"]) >= 4
pipeline.main(["--init", os.path.join(d, "cfg.json")])
pipeline.main(["--config", os.path.join(d, "cfg.json"), "--dry-run", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib", "agenda_tpu", "PIL"))
print("FORBIDDEN", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread: tests/torch_threads.py says why
    return env


def test_port_runs_without_importing_jax_or_agenda_tpu(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DRIVE, str(tmp_path)], cwd=str(tmp_path),
                         env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def test_labelling_runs_without_importing_jax_or_agenda_tpu(tmp_path):
    """det_train, det_test and select_threshold of the port, on the CPU, in a fresh
    interpreter."""
    out = subprocess.run([sys.executable, "-c", _DRIVE_LABELS, str(tmp_path)],
                         cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def test_refine_and_pipeline_run_without_importing_jax_or_pillow(tmp_path):
    """refine_label on the CPU and a dry run of the orchestrator, in a fresh
    interpreter."""
    out = subprocess.run([sys.executable, "-c", _DRIVE_REFINE, str(tmp_path)],
                         cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[dry-run] refine: agenda_tpu_torch.cli.refine_label" in out.stdout
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
