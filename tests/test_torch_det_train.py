"""Parity of the port's YOLOv8 training (agenda_tpu_torch.detect) with agenda_tpu.

Both packages run on the CPU in f32 on the same seeded inputs, YOLOv8n at
64 px, ``max_gt`` 8, batch 4:

- ``task_aligned_assign`` on random layouts and on a symmetric one (a fresh
  head: every point scores alike and predicts the same box, GT boxes
  centred between anchor points, so mirror points tie at the k-th place),
  with padded invalid GT: ``fg_mask``, ``assigned_gt`` and the labels equal,
  the target scores within 1e-6;
- ``yolov8_loss`` from the same head outputs and batch: the loss and its
  three parts within 1e-5 relative, its gradient with respect to every
  head output within 1e-4 of that output's rms;
- one train step of the whole model from the same weights, moments and
  batch: the loss, every parameter's gradient, the update of the yolo SGD,
  the new batch statistics (flax's biased running variance: torch's
  unbiased one lies outside the limit at the 2x2 level) and the EMA;
- five steps of the yolo SGD (momentum warmup, an epoch boundary) and of
  the plain SGD (clipping, a milestone) against the optax chains, at 1e-6;
- the CLI: ``det_train --device cpu`` over both recipes with validation,
  its files, the JAX package's ``load_variables`` and ``predict_fn`` on the
  port's ``latest.safetensors``, a resume at the next epoch and step; the
  ``synthetic_target`` preset's ``ConcatDataset``; every family's presets
  and ``config.json`` both ways (``test_presets_and_config_json_match_jax_both_ways``,
  one case a stage and family); ``test_det_train_refusals``: ``--pretrained``
  runs on a fabricated mmyolo checkpoint, every family builds from its
  preset, AdamW is the runner's optimizer for ``adamw``, CUDA without a GPU
  raises (``--device-aug`` runs: tests/test_torch_device_aug.py; the other
  families' training and import: tests/test_torch_det_families.py and
  tests/test_torch_det_import.py).

The whole-model gradients are held within GRAD_TOL_RMS of their rms: at the
2x2 level a batch-norm channel's statistics come from 16 values, and there
the JAX package's f32 step (its batch variance as E[x^2] - E[x]^2) is itself
4.9e-3 of the rms away from a float64 run of the port on the same weights
and batch, the port's f32 step 5.9e-4 (both at ``head_box2_2``, measured
with this test's inputs); the limit is 3x the reference's own error. The
update of the SGD and the EMA's move follow the gradients: 4.8e-4 of their
rms was read, the limit is UPDATE_TOL_RMS.
"""

import dataclasses
import json
import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agenda_tpu.detect.assign import task_aligned_assign as jax_tal
from agenda_tpu.detect.configs import DatasetSpec as JaxSpec
from agenda_tpu.detect.configs import DetectionConfig as JaxConfig
from agenda_tpu.detect.configs import preset as jax_preset
from agenda_tpu.detect.dataset import ConcatDataset as JaxConcat
from agenda_tpu.detect.families import build_family as jax_build_family
from agenda_tpu.detect.ops import anchor_points as jax_anchor_points
from agenda_tpu.detect.runner import RunnerConfig as JaxRunnerConfig
from agenda_tpu.detect.runner import load_variables as jax_load_variables
from agenda_tpu.detect.runner import make_optimizer as jax_make_optimizer
from agenda_tpu.detect.runner import save_variables as jax_save_variables
from agenda_tpu.detect.yolov8 import YOLOv8Config as JaxYOLOv8Config
from agenda_tpu.detect.yolov8 import yolov8_loss as jax_yolov8_loss
from agenda_tpu_torch.detect.assign import task_aligned_assign
from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig, preset
from agenda_tpu_torch.detect.dataset import ConcatDataset
from agenda_tpu_torch.detect.fabricate import (calibrate_batch_norm, fabricate_detector,
                                               write_mm_checkpoint, write_square_set)
from agenda_tpu_torch.detect.families import build_family
from agenda_tpu_torch.detect.optim import (DetectorAdamW, DetectorSGD, make_optimizer,
                                           trace_from_flax)
from agenda_tpu_torch.detect.runner import (SIDECAR, DetectorRunner, RunnerConfig,
                                            load_variables, read_checkpoint)
from agenda_tpu_torch.detect.flax_layout import flax_to_state_dict, state_dict_to_flax
from agenda_tpu_torch.detect.yolov8 import YOLOv8Config, yolov8_loss
from test_torch_native import native_library  # noqa: F401 (the fixture)

IMG, MAX_GT, B = 64, 8, 4
LOSS_RTOL = 1e-5
HEAD_GRAD_TOL_RMS = 1e-4
GRAD_TOL_RMS = 1.5e-2  # see the module docstring
UPDATE_TOL_RMS = 1.5e-3
STATS_RTOL, STATS_ATOL = 1e-4, 1e-6
OPT_TOL = 1e-6
BOX_TOL, SCORE_TOL = 0.05, 1e-4  # detections, as tests/test_torch_detect.py derives


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _flatten(tree, prefix):
    return {prefix + "." + ".".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(seed, b=B, img=IMG):
    """Images in [0, 1] and 1-4 GT boxes an image, padded to MAX_GT."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((b, MAX_GT, 4), np.float32)
    valid = np.zeros((b, MAX_GT), bool)
    for i in range(b):
        n = int(rng.integers(1, 5))
        xy = rng.uniform(0, img - 24, (n, 2))
        gt[i, :n] = np.concatenate([xy, np.minimum(xy + rng.uniform(6, 30, (n, 2)), img)], 1)
        valid[i, :n] = True
    return {"image": rng.uniform(0, 1, (b, img, img, 3)).astype(np.float32),
            "gt_boxes": gt, "gt_valid": valid}


@pytest.fixture(scope="module")
def model():
    """The port's seeded init with batch-norm statistics measured on noise,
    and the same weights as a flax variables tree."""
    fam = build_family("yolov8", model=dict(img_size=IMG, max_gt=MAX_GT))
    gen = torch.Generator().manual_seed(0)
    state = calibrate_batch_norm(fam, fam.init_variables(gen),
                                 torch.rand(8, IMG, IMG, 3, generator=gen))
    jfam = jax_build_family("yolov8", model=dict(img_size=IMG, max_gt=MAX_GT))
    jvars = _nest({k: jnp.asarray(v) for k, v in state_dict_to_flax(state).items()})
    return fam, state, jfam, jvars


# ---------------------------------------------------------------------------
# TAL
# ---------------------------------------------------------------------------


def _tal_both(scores, pred, points, gt, valid):
    labels = np.zeros(valid.shape, np.int32)
    want = jax.vmap(jax_tal, in_axes=(0, 0, None, 0, 0, 0))(
        jnp.asarray(scores), jnp.asarray(pred), jnp.asarray(points), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(valid))
    got = task_aligned_assign(_t(scores), _t(pred), _t(points), _t(gt),
                              _t(labels).long(), _t(valid))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_tal_equal(want, got):
    (wfg, wgt, wts, wlb), (fg, agt, ts, lb) = want, got
    np.testing.assert_array_equal(fg, wfg)
    np.testing.assert_array_equal(agt, wgt)
    np.testing.assert_array_equal(lb, wlb)
    np.testing.assert_allclose(ts, wts, rtol=0, atol=1e-6)
    assert fg.sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tal_matches_jax_on_random_layouts(seed):
    rng = np.random.default_rng(seed)
    points, strides = jax_anchor_points([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    n = len(points)
    scores = rng.uniform(0.01, 0.99, (B, n, 1)).astype(np.float32)
    half = rng.uniform(2, 3, (B, n, 2)) * strides[None, :, None]
    pred = np.concatenate([points - half, points + half], -1).astype(np.float32)
    batch = _batch(seed + 10)
    batch["gt_boxes"][:, -1] = [20.0, 20.0, 40.0, 40.0]  # an invalid row with a real box
    _assert_tal_equal(*_tal_both(scores, pred, points, batch["gt_boxes"], batch["gt_valid"]))


def test_tal_matches_jax_on_ties():
    """A fresh head: every point scores sigmoid(-log 99) and predicts
    7.5 bins a side; boxes centred between anchor points, so the points of
    each mirror pair tie in IoU and in the metric, at the k-th place too."""
    points, strides = jax_anchor_points([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    n = len(points)
    scores = np.full((B, n, 1), 1 / (1 + math.exp(math.log(99))), np.float32)
    half = (7.5 * strides)[:, None]
    pred = np.concatenate([points - half, points + half], -1)[None].repeat(B, 0)
    gt = np.zeros((B, MAX_GT, 4), np.float32)
    valid = np.zeros((B, MAX_GT), bool)
    centred = [[16, 16, 48, 48], [0, 0, 32, 32], [24, 8, 40, 56], [32, 32, 64, 64]]
    for i in range(B):
        gt[i, :i + 1] = centred[:i + 1]
        valid[i, :i + 1] = True
    want, got = _tal_both(scores, pred.astype(np.float32), points, gt, valid)
    _assert_tal_equal(want, got)
    # the layout has ties at the top-k boundary: the 10th and 11th metrics of a GT
    from agenda_tpu_torch.detect.ops import box_iou

    metric = (torch.from_numpy(scores[0]) ** 0.5) * box_iou(
        _t(pred[0]).float(), _t(gt[0])) ** 6.0
    top = torch.sort(metric[:, 0], descending=True).values
    assert top[9] == top[10] > 0


# ---------------------------------------------------------------------------
# the v8 loss
# ---------------------------------------------------------------------------


def test_yolov8_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    outs = []
    for s in (8, 16, 32):
        h = IMG // s
        outs.append((rng.normal(0, 2, (B, h, h, 1)).astype(np.float32),
                     rng.normal(0, 2, (B, h, h, 64)).astype(np.float32)))
    batch = _batch(4)
    jcfg = JaxYOLOv8Config(img_size=IMG, max_gt=MAX_GT)

    def jax_loss(o):
        loss, parts = jax_yolov8_loss(o, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        return loss, parts

    (want, wparts), wgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        [(jnp.asarray(c), jnp.asarray(b)) for c, b in outs])
    touts = [(_t(c).requires_grad_(True), _t(b).requires_grad_(True)) for c, b in outs]
    loss, parts = yolov8_loss(touts, {k: _t(v) for k, v in batch.items()},
                              YOLOv8Config(img_size=IMG, max_gt=MAX_GT))
    grads = torch.autograd.grad(loss, [t for pair in touts for t in pair])
    assert loss.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    for k in ("cls", "iou", "dfl"):
        assert parts[k].item() == pytest.approx(float(wparts[k]), rel=LOSS_RTOL), k
    assert float(wparts["iou"]) > 0.1 and float(wparts["dfl"]) > 0.1  # boxes are assigned
    for g, w in zip(grads, [t for pair in wgrads for t in pair]):
        w = np.asarray(w)
        rms = float(np.sqrt(np.mean(w * w)))
        assert rms > 0
        assert np.abs(g.numpy() - w).max() <= HEAD_GRAD_TOL_RMS * rms


# ---------------------------------------------------------------------------
# one train step of the whole model; the optimizers over five steps
# ---------------------------------------------------------------------------


def _yolo_cfg(**kw):
    """The presets' yolo SGD at a lr and warmup where a few steps move the weights."""
    base = dict(yolo_optimizer=True, lr=0.01, momentum=0.937, nesterov=True,
                weight_decay=0.0005, lr_factor=0.01, max_epochs=10, warmup_mim_iter=2,
                warmup_epochs=0.0, clip_grad_norm=None, ema_decay=0.9998, batch_size=B)
    base.update(kw)
    return base


def _rel_rms_err(got, want):
    want = np.asarray(want)
    rms = float(np.sqrt(np.mean(want * want)))
    return float(np.abs(np.asarray(got) - want).max()) / max(rms, 1e-30)


def test_train_step_matches_jax(model):
    fam, state, jfam, jvars = model
    cfg = _yolo_cfg()
    tx, _ = jax_make_optimizer(JaxRunnerConfig(**cfg), steps_per_epoch=2, total_bs=B)
    params, stats = jvars["params"], jvars["batch_stats"]
    # moments from three updates on random gradients, so the step starts mid-run
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1, p.shape), jnp.float32), params)
        _, opt_state = tx.update(g, opt_state, params)
    gstep = 3
    ema0 = jax.tree.map(lambda p: p + jnp.asarray(rng.normal(0, 0.01, p.shape), jnp.float32),
                        params)
    batch = _batch(6)

    def lf(p):
        loss, (metrics, new_bs) = jfam.loss_fn({"params": p, "batch_stats": stats}, batch, None)
        return loss, (metrics, new_bs)

    (jloss, (jparts, jstats)), jgrads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    updates, _ = tx.update(jgrads, opt_state, params)
    jnew = optax.apply_updates(params, updates)
    d = cfg["ema_decay"] * (1.0 - jnp.exp(-(jnp.float32(gstep) + 1.0) / 2000.0))
    jema = jax.tree.map(lambda e, p: e * d + (1.0 - d) * p, ema0, jnew)

    runner = DetectorRunner(fam, RunnerConfig(**cfg), device="cpu")
    opt = DetectorSGD(runner.cfg, steps_per_epoch=2, total_bs=B)
    ema_t = flax_to_state_dict(_flatten(ema0, "params"))
    train = runner.init_train_state(opt, state, ema=ema_t)
    traces = [s.inner_state.inner_state[0].trace for s in opt_state[1:]]
    for trace in traces:
        for k, v in trace_from_flax(_flatten(trace, "params")).items():
            train.opt.trace[k].copy_(v)
    train.opt.count = gstep
    tbatch = {k: _t(v) for k, v in batch.items()}
    # the gradients, as the step computes them
    loss, _, _ = fam.loss_fn({**train.params, **train.stats, **train.counters}, tbatch)
    names = list(train.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [train.params[k] for k in names])))
    before = {k: v.detach().clone() for k, v in train.params.items()}
    metrics = runner.make_train_step(opt)(train, tbatch, gstep)

    assert float(metrics["loss"]) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for k in ("cls", "iou", "dfl"):
        assert float(metrics[k]) == pytest.approx(float(jparts[k]), rel=LOSS_RTOL), k
    want = flax_to_state_dict(_flatten(jgrads, "params"))
    errs = {k: _rel_rms_err(grads[k], want[k]) for k in names}
    assert max(errs.values()) <= GRAD_TOL_RMS, max(errs.items(), key=lambda kv: kv[1])
    new = flax_to_state_dict(_flatten(jnew, "params"))
    for k in names:
        assert _rel_rms_err(train.params[k].detach() - before[k],
                            new[k] - before[k]) <= UPDATE_TOL_RMS, k
    # the EMA moves by (1 - d)(p' - e): held as the update is
    want_ema = flax_to_state_dict(_flatten(jema, "params"))
    for k in names:
        assert _rel_rms_err(train.ema[k] - ema_t[k], want_ema[k] - ema_t[k]) <= UPDATE_TOL_RMS, k
    want_stats = flax_to_state_dict(_flatten(jstats, "batch_stats"))
    for k, v in train.stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)
    # torch's own running variance (the unbiased batch variance) fails that
    # limit at the 2x2 level: 16 values a channel, a 1/15 larger batch term
    k, n = "neck_p5.cv2.bn.running_var", B * 2 * 2
    old = state[k].numpy()
    batch_var = (want_stats[k].numpy() - 0.97 * old) / 0.03
    unbiased = 0.97 * old + 0.03 * batch_var * n / (n - 1)
    assert not np.allclose(unbiased, want_stats[k].numpy(), rtol=STATS_RTOL, atol=STATS_ATOL)


_TREE = {"stem": {"conv": {"kernel": (3, 3, 3, 8)}, "bn": {"scale": (8,), "bias": (8,)}},
         "head_box3_0": {"kernel": (1, 1, 8, 4), "bias": (4,)}}


@pytest.mark.parametrize("kind", ["yolo", "plain"])
def test_sgd_matches_optax_over_five_steps(kind):
    """yolo: warmup over steps 0-2 (the momentum ramps), epochs of 2 steps;
    plain: clipping at norm 1, warmup over 2 steps, milestones at steps 2 and 4."""
    if kind == "yolo":
        cfg = _yolo_cfg(warmup_mim_iter=3, lr=0.05)
    else:
        cfg = dict(lr=0.05, momentum=0.9, nesterov=False, weight_decay=0.01,
                   clip_grad_norm=1.0, warmup_iters=2, lr_milestones=(0.25, 0.5),
                   max_epochs=4, batch_size=B)
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: jnp.asarray(rng.normal(0, 1, s), jnp.float32), _TREE,
                          is_leaf=lambda s: isinstance(s, tuple))
    tx, _ = jax_make_optimizer(JaxRunnerConfig(**cfg), steps_per_epoch=2, total_bs=B)
    opt_state = tx.init(params)
    opt = DetectorSGD(RunnerConfig(**cfg), steps_per_epoch=2, total_bs=B)
    ours = {k: v for k, v in flax_to_state_dict(_flatten(params, "params")).items()
            if not k.endswith("num_batches_tracked")}
    state = opt.init(ours)
    for _ in range(5):
        g = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 3, p.shape), jnp.float32), params)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.update(trace_from_flax(_flatten(g, "params")), state, ours)
        want = flax_to_state_dict(_flatten(params, "params"))
        for k, v in ours.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=OPT_TOL,
                                       err_msg=k)
    assert state.count == 5


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_port_reads_a_jax_trainer_checkpoint_with_ema(model, tmp_path):
    """The JAX det_train's latest.safetensors holds ``ema_params`` beside
    ``params`` and ``batch_stats`` (every yolov8 preset trains with EMA):
    ``load_variables`` (det_test's reader) takes the params and statistics,
    as the JAX det_test does, and ``read_checkpoint`` the EMA too."""
    fam, state, _, jvars = model
    ema = jax.tree.map(lambda p: p * 0.5, jvars["params"])
    path = str(tmp_path / "latest.safetensors")
    jax_save_variables(path, {**jvars, "ema_params": ema})
    got = load_variables(path)
    fam.check_variables(got)
    for k in fam.param_names + fam.stat_names:
        np.testing.assert_array_equal(got[k].numpy(), state[k].numpy(), err_msg=k)
    variables, got_ema = read_checkpoint(path)
    assert set(got_ema) == set(fam.param_names)
    for k in fam.param_names:
        np.testing.assert_array_equal(got_ema[k].numpy(), state[k].numpy() * 0.5, err_msg=k)


def _assert_same_detections(boxes, scores, want_boxes, want_scores):
    """One to one within BOX_TOL and SCORE_TOL (near-tied scores may trade slots)."""
    assert boxes.shape == want_boxes.shape
    free = np.ones(len(want_scores), bool)
    for b, s in zip(boxes, scores):
        hit = free & (np.abs(want_scores - s) <= SCORE_TOL) & (
            np.abs(want_boxes - b).max(axis=1) <= BOX_TOL)
        assert hit.any(), f"no match for {b} ({s})"
        free[np.argmax(hit)] = False


def _read_metrics(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "loss" in r], [r for r in rows if "bbox_mAP" in r]


def test_det_train_cli_trains_validates_and_resumes(tmp_path, caplog):
    """3 epochs of 2 steps with close_mosaic_epochs=1: the mix recipe in
    epochs 0-1, stage 2 in epoch 2; validation after epochs 1 and 2. The run
    starts from calibrated weights (a weights-only resume from a file that is
    not latest), so the heads see the image and the detections compared
    with the JAX package's are not decided by ties."""
    from agenda_tpu_torch.cli import det_train

    root = str(tmp_path)
    train, val = os.path.join(root, "train"), os.path.join(root, "val")
    write_square_set(train, 8, seed=1)
    write_square_set(val, 4, seed=2)
    _, init = fabricate_detector(os.path.join(root, "init"), img_size=IMG, batch_size=B)
    os.rename(init, os.path.join(root, "init", "calibrated.safetensors"))
    cfg = preset("synthetic_heatmap", "yolov8", [DatasetSpec(train, "ann.json")],
                 val=DatasetSpec(val, "ann.json"), img_scale=(IMG, IMG), max_gt=MAX_GT)
    cfg.runner.close_mosaic_epochs, cfg.runner.log_interval = 1, 1
    # the biases' warmup lr starts at 0.1, which saturates the scores of so
    # short a run (every detection at 1.0 is a tie for NMS); keep it at the lr
    cfg.runner.warmup_bias_lr = cfg.runner.lr
    config = os.path.join(root, "run.json")
    cfg.to_json(config)
    work = os.path.join(root, "work")
    args = ["--config", config, "--device", "cpu", "--work-dir", work, "--batch-size", str(B)]
    with caplog.at_level(logging.INFO, logger="agenda_tpu_torch.detect"):
        det_train.main(args + ["--max-epochs", "3", "--resume",
                               os.path.join(root, "init", "calibrated.safetensors")])
    switches = [r for r in caplog.records if "mosaic-close" in r.getMessage()]
    assert len(switches) == 1
    for name in ("config.json", "metrics.jsonl", "latest.safetensors", SIDECAR,
                 "best_bbox_mAP.safetensors", "best_bbox_mAP_50.safetensors"):
        assert os.path.exists(os.path.join(work, name)), name
    steps, vals = _read_metrics(os.path.join(work, "metrics.jsonl"))
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5, 6]
    assert [r["epoch"] for r in steps] == [0, 0, 1, 1, 2, 2]
    assert all(math.isfinite(r[k]) for r in steps for k in ("loss", "cls", "iou", "dfl"))
    assert [r["epoch"] for r in vals] == [1, 2]
    assert JaxConfig.from_json(os.path.join(work, "config.json")).runner.close_mosaic_epochs == 1

    # the JAX package reads the port's checkpoint and predicts as the port does
    latest = os.path.join(work, "latest.safetensors")
    jv = jax_load_variables(latest)
    assert set(jv) == {"params", "batch_stats", "ema_params"}
    variables, ema = read_checkpoint(latest)
    assert ema is not None and set(ema) == set(build_family("yolov8").param_names)
    jfam = jax_build_family("yolov8", model=dict(img_size=IMG, max_gt=MAX_GT))
    fam = build_family("yolov8", model=dict(img_size=IMG, max_gt=MAX_GT))
    x = np.random.default_rng(8).uniform(0, 1, (4, IMG, IMG, 3)).astype(np.float32)
    jb, js, jvalid = jax.jit(jfam.predict_fn)(jv, x)
    pb, ps, pvalid = fam.predict_fn(load_variables(latest), _t(x))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    assert int(pvalid.sum()) > 4
    for i in range(4):
        keep = pvalid[i].numpy()
        _assert_same_detections(pb[i].numpy()[keep], ps[i].numpy()[keep],
                                np.asarray(jb)[i][keep], np.asarray(js)[i][keep])

    # resume from latest: the next epoch and step, the moments restored
    det_train.main(args + ["--max-epochs", "4", "--resume", latest])
    steps, vals = _read_metrics(os.path.join(work, "metrics.jsonl"))
    assert [r["step"] for r in steps][6:] == [7, 8]
    assert [r["epoch"] for r in steps][6:] == [3, 3]
    assert [r["epoch"] for r in vals] == [1, 2, 3]


@pytest.mark.usefixtures("native_library")
def test_synthetic_target_preset_builds_the_concat_dataset(tmp_path):
    a, b = str(tmp_path / "cars"), str(tmp_path / "empty")
    write_square_set(a, 5, seed=1)
    write_square_set(b, 3, seed=2)
    specs = [(a, "ann.json"), (b, "ann.json")]
    kw = dict(img_scale=(IMG, IMG), max_gt=MAX_GT)
    ds = preset("synthetic_target", "yolov8", [DatasetSpec(*s) for s in specs],
                **kw).build_train_dataset()
    jds = jax_preset("synthetic_target", "yolov8", [JaxSpec(*s) for s in specs],
                     **kw).build_train_dataset()
    assert isinstance(ds, ConcatDataset) and isinstance(jds, JaxConcat)
    assert len(ds) == len(jds) == 8 and ds.datasets[1].aug.mixup_mosaic_pre
    for i in (7, 0, 5):
        got, want = ds[i], jds[i]
        np.testing.assert_array_equal(got["gt_valid"], want["gt_valid"])
        assert np.abs(got["gt_boxes"] - want["gt_boxes"]).max() <= 1e-5
        assert np.abs(got["image"] - want["image"]).max() * 255 <= 1.0


DETECTORS = {"yolov8": ("yolov8", "yolov8n", "yolov8s"), "yolov5": ("yolov5", "yolov5m", "yolov5s"),
             "faster-rcnn": ("faster-rcnn", "faster_rcnn"), "vitdet": ("vitdet",)}


@pytest.mark.parametrize("family", sorted(DETECTORS))
@pytest.mark.parametrize("stage", ["real_source", "synthetic_heatmap", "synthetic_target"])
def test_presets_and_config_json_match_jax_both_ways(tmp_path, stage, family):
    for detector in DETECTORS[family]:
        ours = preset(stage, detector, [DatasetSpec("r", "a.json")],
                      val=DatasetSpec("v", "b.json"), output_dir="w")
        want = jax_preset(stage, detector, [JaxSpec("r", "a.json")],
                          val=JaxSpec("v", "b.json"), output_dir="w")
        assert dataclasses.asdict(ours) == dataclasses.asdict(want)
        paths = [str(tmp_path / name) for name in ("ours.json", "want.json")]
        ours.to_json(paths[0])
        want.to_json(paths[1])
        with open(paths[0]) as f, open(paths[1]) as g:
            assert json.load(f) == json.load(g)
        # each package parses the other's file as its own, field by field
        for load in (JaxConfig.from_json, DetectionConfig.from_json):
            assert dataclasses.asdict(load(paths[0])) == dataclasses.asdict(load(paths[1]))


def test_det_train_refusals(tmp_path):
    from agenda_tpu_torch.cli import det_train

    root = str(tmp_path)
    write_square_set(root, 2)
    base = ["--preset", "synthetic_heatmap", "--train-root", root, "--train-ann", "ann.json",
            "--work-dir", os.path.join(root, "work"), "--device", "cpu"]
    # --pretrained runs: a fabricated mmyolo checkpoint, its 80-class heads skipped
    pth = os.path.join(root, "coco.pth")
    write_mm_checkpoint(pth, "yolov8")
    det_train.main(base + ["--pretrained", pth, "--max-epochs", "1", "--batch-size", "2"])
    with open(os.path.join(root, "work", "config.json")) as f:
        assert json.load(f)["pretrained"] == pth
    # every family of the JAX package builds from its preset
    for detector, family in (("faster-rcnn", "FasterRCNNFamily"), ("yolov5", "YOLOv5Family"),
                             ("vitdet", "ViTDetFamily")):
        cfg = preset("synthetic_heatmap", detector, [DatasetSpec(root, "ann.json")])
        assert type(cfg.build_family()).__name__ == family
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            det_train.main(base[:-2])
    # AdamW (with layer decay) is the runner's optimizer for adamw; SGD refuses it
    assert isinstance(make_optimizer(RunnerConfig(optimizer="adamw", layer_decay_rate=0.7),
                                     steps_per_epoch=1), DetectorAdamW)
    with pytest.raises(ValueError, match="adamw"):
        DetectorSGD(RunnerConfig(optimizer="adamw"), steps_per_epoch=1)
