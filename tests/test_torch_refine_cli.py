"""The port's ``refine_label`` CLI against the JAX package's, from shared weights.

One fabricated, seeded ResNet-50 in torchvision's layout (a 1-logit fc,
batch-norm statistics measured on the crops, the fc bias set so that the
logits straddle 0) is passed to both CLIs as ``--pretrained_backbone``; 12
fabricated 112x112 PNGs carry predictions in every bucket; 2 epochs,
``--crop_size 32``, batch 8, ``--lr 1e-6``. Compared: the logged accuracy
and F1 of each epoch, the two checkpoints (the same keys; every value
within 2e-3 of its tensor's rms), and the refined COCO (equal; a test crop
whose logit lies within LOGIT_TOL of 0 may differ, and the count is
reported). Then each package's checkpoint loads into the other's ResNet-50.

Why lr 1e-6, not the recipe's 4e-4: the gradients of a ReLU/max-pool network
are discontinuous where a gate sits at 0, and f32 rounding flips such gates
differently in XLA and oneDNN (at f32 either package's gradients lie up to
0.32 of their rms from its own float64 ones, ``test_torch_refine.py``). Adam
turns every flipped small gradient into a full lr step, so at 4e-4 the two
CLIs part within a few steps. At 1e-6 each parameter can move at most
2e-5 over the run's 10 steps, and what the comparison sees is what the CLI
does: the rng stream (flips, shuffle), the padded batches (their pad rows
move the batch statistics), the checkpoints and the bucket assembly. One
step at the recipe's lr is held to the JAX step in float64 by
``test_torch_refine.py::test_classifier_step_matches_jax``.
"""

import json
import logging
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from agenda_tpu.cli import refine_label as jax_cli
from agenda_tpu.models.resnet import ResNet50 as JaxResNet50
from agenda_tpu_torch.annotate import refine
from agenda_tpu_torch.annotate.classifier import classifier_logits
from agenda_tpu_torch.cli import refine_label as port_cli
from agenda_tpu_torch.io.safetensors_io import load_file
from agenda_tpu_torch.models.resnet import (ResNet50, init_resnet_, normalize_imagenet,
                                            resnet_from_flax)
from test_torch_refine import write_refine_set

CROP, LR, EPOCHS = 32, 1e-6, 2
CKPT_TOL_RMS = 2e-3  # every checkpoint value, of its tensor's rms
LOGIT_TOL = 1e-3  # |logit| below which a test crop may go either way
# eval logits of one package's checkpoint in the other's ResNet-50, of their
# rms: XLA's and oneDNN's f32 convolutions through 53 layers at 32 px read
# 0.7e-4 to 1.4e-4 apart (oneDNN's one-thread and many-thread algorithms
# alone 2.9e-5)
CROSS_TOL_RMS = 5e-4
NAMES = ("resnet_best_accuracy.safetensors", "resnet_best_f1.safetensors")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores, where torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fabricate_backbone(path: str, crops: np.ndarray, seed: int = 11) -> None:
    """A seeded ResNet-50 in torchvision's layout: flax's init, batch-norm
    scale and bias drawn away from 1 and 0, running statistics measured on
    ``crops`` (one train-mode pass with momentum 1), the fc bias moved so
    that the median eval logit over ``crops`` is 0."""
    model = ResNet50(num_classes=1)
    g = torch.Generator().manual_seed(seed)
    init_resnet_(model, g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
                mod.bias.copy_((torch.rand(mod.bias.shape, generator=g) - 0.5) * 0.4)
                mod.momentum = 1.0
        x = torch.from_numpy(crops).float() / 255.0
        model.train()(normalize_imagenet(x).permute(0, 3, 1, 2))  # momentum 1: batch statistics
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.momentum = 0.1
        logits = classifier_logits(model, x, torch.float32)
        model.fc.bias.sub_(logits.median())
    torch.save(model.state_dict(), path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("refine_cli"))
    img_dir, pkl, records = write_refine_set(root)
    data = refine.construct_data(records, 0.75, 0.35, 0.05, rgb_image_base_path=img_dir)
    crops = refine.resize_crops(data.train_crops + data.test_crops, CROP)
    backbone = os.path.join(root, "resnet50_torchvision.pth")
    fabricate_backbone(backbone, crops)
    common = ["--prediction_pkl", pkl, "--synthetic_image_base_path", img_dir,
              "--num_epochs", str(EPOCHS), "--crop_size", str(CROP), "--train_batch_size", "8",
              "--test_batch_size", "8", "--lr", str(LR), "--pretrained_backbone", backbone]
    out = {"root": root, "data": data}
    out["port"] = port_cli.main(common + [
        "--json_save_path", os.path.join(root, "port.json"),
        "--checkpoint_save_path", os.path.join(root, "port_ckpt"), "--device", "cpu"])
    logger = logging.getLogger("agenda_tpu.refine_label")
    records_seen = []
    handler = logging.Handler()
    handler.emit = records_seen.append
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        jax_cli.main(common + ["--json_save_path", os.path.join(root, "jax.json"),
                               "--checkpoint_save_path", os.path.join(root, "jax_ckpt")])
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    out["jax_log"] = [r.getMessage() for r in records_seen]
    return out


def test_cli_logs_the_same_accuracy_and_f1_each_epoch(runs):
    port = runs["port"]
    assert port["n_train"] == 48 and port["n_test"] == 24 and port["steps"] == 2 * 6
    want = [m for m in runs["jax_log"] if m.startswith("Epoch")]
    got = [f"Epoch {h['epoch']}: Train Accuracy: {h['accuracy']:.4f}, Train f1: {h['f1']:.4f}"
           for h in port["history"]]
    assert got == want
    accs = [float(re.search(r"Accuracy: ([0-9.]+)", m).group(1)) for m in want]
    assert all(0.0 < a < 1.0 for a in accs)  # the logits straddle 0: not one class for all


def test_cli_checkpoints_agree(runs):
    for name in NAMES:
        got = load_file(os.path.join(runs["root"], "port_ckpt", name))
        want = load_file(os.path.join(runs["root"], "jax_ckpt", name))
        assert set(got) == set(want) and len(got) == 161 + 106
        worst = max(float((got[k] - want[k]).abs().max() / want[k].pow(2).mean().sqrt())
                    for k in want)
        assert worst <= CKPT_TOL_RMS, (name, worst)


def test_cli_refined_coco_agrees(runs):
    root, data = runs["root"], runs["data"]
    with open(os.path.join(root, "port.json")) as f:
        got = json.load(f)
    with open(os.path.join(root, "jax.json")) as f:
        want = json.load(f)
    model = ResNet50(num_classes=1)
    sd = resnet_from_flax({k: v.numpy() for k, v in load_file(
        os.path.join(root, "port_ckpt", NAMES[1])).items()})
    model.load_state_dict(sd, strict=False)
    x = torch.from_numpy(refine.resize_crops(data.test_crops, CROP)).float() / 255.0
    logits = classifier_logits(model, x, torch.float32).numpy()
    near_zero = int((np.abs(logits) < LOGIT_TOL).sum())
    print(f"test crops with |logit| < {LOGIT_TOL}: {near_zero} of {len(logits)}; "
          f"kept {runs['port']['kept']}")
    assert 0 < runs["port"]["kept"] < len(data.test_crops)
    assert got["images"] == want["images"] and got["categories"] == want["categories"]
    if near_zero == 0:
        assert got == want
    else:
        assert abs(len(got["annotations"]) - len(want["annotations"])) <= near_zero
    ids = [a["image_id"] for a in got["annotations"]]
    assert ids == sorted(ids) and [a["id"] for a in got["annotations"]] == list(range(len(ids)))


def test_checkpoints_load_across_packages(runs):
    """The port's checkpoint drives the JAX ResNet-50 and the JAX one the
    port's: eval logits within CROSS_TOL_RMS of their rms either way."""
    root, data = runs["root"], runs["data"]
    x = refine.resize_crops(data.train_crops[:8], CROP).astype(np.float32) / 255.0
    jm = JaxResNet50(num_classes=1)
    for side in ("port_ckpt", "jax_ckpt"):
        flat = {k: v.numpy() for k, v in load_file(os.path.join(root, side, NAMES[1])).items()}
        nested = traverse_util.unflatten_dict({tuple(k.split(".")): jnp.asarray(v)
                                               for k, v in flat.items()})
        want = np.asarray(jm.apply({"params": nested["params"],
                                    "batch_stats": nested["batch_stats"]},
                                   (jnp.asarray(x) - jnp.asarray([0.485, 0.456, 0.406]))
                                   / jnp.asarray([0.229, 0.224, 0.225]), train=False))[:, 0]
        model = ResNet50(num_classes=1)
        model.load_state_dict(resnet_from_flax(flat), strict=False)
        got = classifier_logits(model, torch.from_numpy(x), torch.float32).numpy()
        assert np.abs(got - want).max() <= CROSS_TOL_RMS * np.sqrt(np.mean(want ** 2)), side
