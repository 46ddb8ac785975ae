"""The composed bench's stage-3 labeler: a YOLOv8n quick-trained on the
procedural heatmap domain, with its F1-max threshold, cached on disk.

Counterpart of ``agenda_tpu/detect/bench_labeler.py``. A random-weight
detector labels generated heatmap stacks with noise, so the bench trains the
tiny YOLOv8 at the Synthetic_Heatmap 128-px geometry on
``io/procedural.py``'s domain (48 tiles, seed 0), calibrates the F1-max
confidence threshold on a held-out 16-tile domain (seed 7) with
``cli/select_threshold``, and caches the weights (the JAX runner's
checkpoint layout, ``detect/runner.py::save_variables``) and a meta JSON
with the JAX package's keys. A cache is taken only when its model, epochs
and domain fingerprint match: the fingerprint is the sha1 of the port's own
``io/procedural.py``, so a JAX package's cache is never taken for the
port's.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import tempfile
from typing import Any, Dict, Tuple

META = "stack_labeler_meta.json"
CKPT = "stack_labeler.safetensors"

MODEL_KW = dict(img_size=128, max_gt=8)
DOMAIN_KW = dict(noise=10, p_dim=0.05, p_spurious=0.1)
TRAIN_TILES, VAL_TILES = 48, 16
TRAIN_SEED, VAL_SEED = 0, 7


def domain_fingerprint() -> str:
    """sha1 (16 hex digits) of the domain builder's source: a changed
    training distribution invalidates a cached labeler and threshold."""
    from agenda_tpu_torch.io import procedural

    return hashlib.sha1(inspect.getsource(procedural).encode()).hexdigest()[:16]


def prepare_stack_labeler(cache_dir: str, *, retrain: bool = False, epochs: int = 30,
                          log=print, device: Any = None) -> Tuple[Any, Dict, float]:
    """-> (family, variables, F1-max threshold); trains and caches on a miss.
    ``device``: where the detector trains and predicts (the card by
    default); the variables come back on the CPU."""
    from agenda_tpu_torch.detect.families import build_family
    from agenda_tpu_torch.detect.runner import load_variables, save_variables

    os.makedirs(cache_dir, exist_ok=True)
    meta_path = os.path.join(cache_dir, META)
    ckpt_path = os.path.join(cache_dir, CKPT)
    fam = build_family("yolov8", model=dict(MODEL_KW))
    domain_sha = domain_fingerprint()

    if not retrain and os.path.exists(meta_path) and os.path.exists(ckpt_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if (meta.get("model_kw") == MODEL_KW and meta.get("epochs") == epochs
                and meta.get("domain_sha") == domain_sha):
            log(f"# stack labeler: cached (thr={meta['threshold']:.3f} ap={meta['ap']:.3f})")
            return fam, load_variables(ckpt_path, fam), float(meta["threshold"])

    from agenda_tpu_torch.cli import select_threshold
    from agenda_tpu_torch.detect.dataset import CocoDetDataset
    from agenda_tpu_torch.detect.runner import DetectorRunner, RunnerConfig
    from agenda_tpu_torch.io.procedural import make_heatmap_domain

    log(f"# stack labeler: quick-training yolov8-128 on the procedural heatmap domain "
        f"({epochs} epochs)...")
    with tempfile.TemporaryDirectory(prefix="bench_lab_") as root:
        tr = os.path.join(root, "train")
        va = os.path.join(root, "val")
        make_heatmap_domain(tr, TRAIN_TILES, seed=TRAIN_SEED, **DOMAIN_KW)
        make_heatmap_domain(va, VAL_TILES, seed=VAL_SEED, **DOMAIN_KW)
        train_ds = CocoDetDataset(tr, "ann.json", "daam_stack_heatmaps/",
                                  img_scale=(128, 128), max_gt=8, train=True)
        val_ds = CocoDetDataset(va, "ann.json", "daam_stack_heatmaps/",
                                img_scale=(128, 128), max_gt=8, train=False)
        work = os.path.join(root, "work")
        os.makedirs(work)
        cfg = RunnerConfig(output_dir=work, max_epochs=epochs,
                           batch_size=2, lr=0.01, val_interval=1000, warmup_iters=20,
                           log_interval=100, lr_milestones=(0.7,))
        runner = DetectorRunner(fam, cfg, device="cuda" if device is None else device)
        variables = runner.train(train_ds)
        pkl = os.path.join(root, "val_pred.pkl")
        runner.test(variables, val_ds, out_pkl=pkl)
        res = select_threshold.main(["--prediction_pkl", pkl])
        variables = {k: v.detach().cpu() for k, v in variables.items()}
        save_variables(ckpt_path, variables, family=fam)
        with open(meta_path, "w") as f:
            json.dump({"threshold": res["threshold"], "ap": res["ap"], "f1_max": res["f1_max"],
                       "model_kw": MODEL_KW, "epochs": epochs, "domain_sha": domain_sha}, f)
        log(f"# stack labeler: trained (val AP {res['ap']:.3f}, F1-max thr "
            f"{res['threshold']:.3f}) -> cached in {cache_dir}")
        return fam, variables, float(res["threshold"])
