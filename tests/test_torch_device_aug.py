"""Parity of the port's device augmentation (agenda_tpu_torch.detect.device_aug)
with agenda_tpu's, on the CPU.

The planners draw the host pipeline's random numbers in its order, so for
the same dataset and generator the packed plans must agree: the integer and
boolean fields bit for bit, the float fields within BOX_TOL (the port's
``affine_matrix`` is a closed form, the JAX package's a matrix chain), the
scratch slab of host-rendered passthrough samples (the port's numpy warp,
median, CLAHE and HSV against Pillow's warp and the native HSV) within
SLAB_TOL of a level. Recipes: real_source's mix, a mix recipe with every
photometric op likely (the passthrough slab), stage 2 after the runner's
switch, plain, the synthetic_target ``ConcatDataset`` through
``ConcatAugPlanner``, and LSJ (112-px tiles to 128 px).

The render is held to the JAX ``render_batch`` on the same packed arrays
and dataset tensor, in 8-bit levels: the geometry with the tails off (both
forms; mixup on and off; flips and clips) within GEOM_TOL, the JAX
package's own separable-against-gather limit; the tails on identical input
within TAIL_TOL; the whole render by its mean (RENDER_MEAN_TOL) and the
share of values more than half a level apart (RENDER_FAR_SHARE: HSV's
sector choice can flip at a tie). The port's separable form is held to its
gather form within GEOM_TOL, and its render to its own ``render_host`` with
the JAX test's limits (tests/test_device_aug.py). LSJ's render is held to
the JAX one within one level with at most LSJ_DIFF_SHARE of the values
apart (one of its two roundings can flip at .5).

Then the planner's choice (``_make_planner``, and the host path with a
warning where it declines), ``PlanPrefetcher`` (workers spawned after torch
ran in the parent: plans equal to the serial ones, None from
``stop_epoch``), two steps of ``DetectorRunner.train(device_aug=True)`` in
each package from one checkpoint at 128 px (the first logged loss and its
parts within LOSS_RTOL, the second within STEP2_RTOL: f32 noise in the
batch norms of a batch of 4 grows step by step), and the port's
``det_train --device-aug --device-aug-workers 2``: a run cut by an error at
the mosaic-close switch closes its pool, and its resume logs the
uninterrupted run's loss at that step.
"""

import dataclasses
import json
import logging
import math
import multiprocessing
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agenda_tpu.parallel.mesh as jax_mesh
from agenda_tpu.detect import augment as ja
from agenda_tpu.detect import device_aug as JD
from agenda_tpu.detect.configs import DatasetSpec as JaxSpec
from agenda_tpu.detect.configs import preset as jax_preset
from agenda_tpu.detect.dataset import CocoDetDataset as JaxDataset
from agenda_tpu.detect.dataset import ConcatDataset as JaxConcat
from agenda_tpu.detect.runner import DetectorRunner as JaxRunner
from agenda_tpu_torch.detect import augment as pa
from agenda_tpu_torch.detect import device_aug as PD
from agenda_tpu_torch.detect.configs import DatasetSpec, preset
from agenda_tpu_torch.detect.dataset import CocoDetDataset, ConcatDataset
from agenda_tpu_torch.detect.fabricate import fabricate_detector, write_square_set
from agenda_tpu_torch.detect.runner import DetectorRunner
from test_torch_native import native_library  # noqa: F401 (the fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the JAX side of every pixel comparison takes the native resize
pytestmark = pytest.mark.usefixtures("native_library")

BOX_TOL = 1e-5  # plan float fields (inverse maps, clips, HSV gains, boxes)
SLAB_TOL = 1e-3  # the passthrough slab, levels
GEOM_TOL = 2e-3  # levels: tails off; and the separable form against the gather
TAIL_TOL = 1e-3  # levels: blur, gray, HSV on identical input
RENDER_MEAN_TOL, RENDER_FAR_SHARE = 1e-3, 1e-4  # the whole render: mean |d|; share > 0.5
LSJ_DIFF_SHARE = 1e-3  # LSJ: values that differ (by at most one level)
LOSS_RTOL, STEP2_RTOL = 1e-5, 1e-3
IMG, MAX_GT, SLOTS, B = 64, 8, 4, 48


def _every_op(mod):
    """A mix recipe with mixup at 0.5 and every photometric op likely."""
    return dataclasses.replace(mod.mix_stage_aug(0.5, True), blur_prob=0.3,
                               median_blur_prob=0.1, to_gray_prob=0.3, clahe_prob=0.1)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_aug")
    a, b = str(root / "a"), str(root / "b")
    write_square_set(a, 48, seed=3)
    write_square_set(b, 16, seed=4)
    return a, b


def _datasets(sets, recipe, img=IMG):
    """(port dataset, JAX dataset) of one recipe over the same tiles."""
    a, b = sets
    if recipe in ("mix", "stage2", "concat"):
        stage = "synthetic_target" if recipe == "concat" else "real_source"
        roots = (a, b) if recipe == "concat" else (a,)
        kw = dict(img_scale=(img, img), max_gt=MAX_GT)
        ds = preset(stage, "yolov8", [DatasetSpec(r, "ann.json") for r in roots],
                    **kw).build_train_dataset()
        jds = jax_preset(stage, "yolov8", [JaxSpec(r, "ann.json") for r in roots],
                         **kw).build_train_dataset()
        if recipe == "stage2":
            DetectorRunner._apply_stage2_aug(None, ds)
            JaxRunner._apply_stage2_aug(None, jds)
        return ds, jds
    make = {"mix_every_op": _every_op, "plain": lambda m: m.plain_aug(),
            "lsj": lambda m: m.lsj_aug()}[recipe]
    size = 128 if recipe == "lsj" else img  # LSJ: 112-px tiles to 128 px
    return (CocoDetDataset(a, "ann.json", img_scale=(size, size), max_gt=MAX_GT, train=True,
                           aug=make(pa)),
            JaxDataset(a, "ann.json", img_scale=(size, size), max_gt=MAX_GT, train=True,
                       aug=make(ja)))


def _planners(sets, recipe, img=IMG):
    ds, jds = _datasets(sets, recipe, img)
    (pp, why), (jp, jwhy) = DetectorRunner._make_planner(ds), JaxRunner._make_planner(jds)
    assert pp is not None and jp is not None, (why, jwhy)
    assert type(pp).__name__ == type(jp).__name__
    return pp, jp


def _assert_packed_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert np.abs(g - w).max() <= BOX_TOL, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


RECIPES = ["mix", "mix_every_op", "stage2", "plain", "concat", "lsj"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_plans_match_jax(sets, recipe):
    pp, jp = _planners(sets, recipe)
    n = len(pp.ds) if recipe != "concat" else int(pp._offsets[-1])
    idx = np.random.default_rng(0).integers(0, n, B)
    packed, scratch, plans = pp.plan_batch(idx, np.random.default_rng(11), MAX_GT, SLOTS)
    jpacked, jscratch, _ = jp.plan_batch(idx, np.random.default_rng(11), MAX_GT, SLOTS)
    _assert_packed_equal(packed, jpacked)
    assert packed["gt_valid"].any()
    np.testing.assert_array_equal(pp.dataset_tensor(), jp.dataset_tensor())
    assert np.abs(scratch - jscratch).max() <= SLAB_TOL
    if recipe == "mix_every_op":  # the slab and every tail are exercised
        assert (packed["pass_slot"] >= 0).sum() >= 2 and packed["mix"].any()
        assert set(packed["blur_k"]) >= {0, 3, 5, 7} and packed["gray"].any()
    if recipe == "concat":  # each sample's tiles stay within its part
        n_a = int(pp._offsets[1])
        for i, p in zip(idx, plans):
            part = (p.branches[0].idxs >= n_a) if i >= n_a else (p.branches[0].idxs < n_a)
            assert part.all()


@pytest.fixture(scope="module")
def every_op(sets):
    """Plans of the every-op recipe (mixup, flips, clips, blurs, gray, HSV,
    passthrough) and the dataset tensor."""
    pp, _ = _planners(sets, "mix_every_op")
    packed, scratch, plans = pp.plan_batch(np.arange(B) % 48, np.random.default_rng(5),
                                           MAX_GT, SLOTS)
    return pp, packed, scratch, plans, pp.dataset_tensor()


def _port_render(data, scratch, packed, separable=True, hw=(IMG, IMG)):
    return PD.render_batch(torch.from_numpy(data), torch.from_numpy(scratch),
                           {k: torch.from_numpy(v) for k, v in packed.items()}, hw,
                           separable=separable).numpy() * 255.0


def _jax_render(data, scratch, packed, has_mix=True, separable=True, hw=(IMG, IMG)):
    return np.asarray(JD.render_batch(jnp.asarray(data), jnp.asarray(scratch),
                                      {k: jnp.asarray(v) for k, v in packed.items()}, hw,
                                      has_mix=has_mix, separable=separable)) * 255.0


def _tails_off(packed):
    return {**packed, "blur_k": np.zeros_like(packed["blur_k"]),
            "gray": np.zeros_like(packed["gray"]), "hsv_on": np.zeros_like(packed["hsv_on"]),
            "pass_slot": np.full_like(packed["pass_slot"], -1)}


@pytest.mark.parametrize("separable", [True, False], ids=["separable", "gather"])
@pytest.mark.parametrize("recipe", ["mix_every_op", "stage2"])
def test_render_geometry_matches_jax(sets, every_op, recipe, separable):
    """Tails off: mosaic, affine, mixup (has_mix True with mixed samples;
    False on stage-2 plans, which mix none), flips and clips."""
    if recipe == "mix_every_op":
        _, packed, scratch, _, data = every_op
    else:
        pp, _ = _planners(sets, recipe)
        packed, scratch, _ = pp.plan_batch(np.arange(B) % 48, np.random.default_rng(6),
                                           MAX_GT, SLOTS)
        data = pp.dataset_tensor()
    packed = _tails_off(packed)
    has_mix = bool(packed["mix"].any())
    assert has_mix == (recipe == "mix_every_op") and packed["flip"].any()
    if has_mix:
        assert (packed["clip"][:, 1] < IMG).any()  # mixup's pasted region is clipped
    got = _port_render(data, scratch, packed, separable)
    want = _jax_render(data, scratch, packed, has_mix, separable)
    assert np.abs(got - want).max() <= GEOM_TOL


def test_tails_match_jax_on_identical_input(sets):
    """Identity geometry (the plain recipe, no flip: the render is the
    tile), then each tail on its own samples: box blur 3, 5, 7, gray, HSV
    (random gains, the tiles' integer levels give channel ties)."""
    pp, _ = _planners(sets, "plain")
    packed, scratch, _ = pp.plan_batch(np.arange(B), np.random.default_rng(1), MAX_GT, SLOTS)
    data = pp.dataset_tensor()
    packed["flip"][:] = False
    np.testing.assert_array_equal(_port_render(data, scratch, packed), data[:B].astype(np.float32))
    rng = np.random.default_rng(2)
    packed["blur_k"][:] = np.tile([3, 5, 7, 0, 0, 0], B // 6)
    packed["gray"][:] = np.tile([False, False, False, True, False, True], B // 6)
    packed["hsv_on"][:] = np.tile([False, False, False, False, True, True], B // 6)
    packed["hsv_gains"] = (rng.uniform(-1, 1, (B, 3)) * [5, 30, 30]).astype(np.float32)
    got, want = _port_render(data, scratch, packed), _jax_render(data, scratch, packed)
    assert np.abs(got - want).max() <= TAIL_TOL


def test_render_matches_jax_and_its_gather_form(every_op):
    _, packed, scratch, _, data = every_op
    sep, gat = _port_render(data, scratch, packed), _port_render(data, scratch, packed, False)
    assert np.abs(sep - gat).max() <= GEOM_TOL
    for got, separable in ((sep, True), (gat, False)):
        d = np.abs(got - _jax_render(data, scratch, packed, separable=separable))
        assert d.mean() <= RENDER_MEAN_TOL and (d > 0.5).mean() <= RENDER_FAR_SHARE


def test_render_matches_its_host_oracle(sets):
    """The real_source recipe at 128 px: Pillow's 8-bit warp against the
    render's float bilinear, and the passthrough samples exact."""
    pp, _ = _planners(sets, "mix", img=128)
    rng = np.random.default_rng(7)
    packed, scratch, plans = pp.plan_batch(rng.integers(0, 48, 24), rng, MAX_GT, 3)
    forced = [i for i in (0, 1) if packed["pass_slot"][i] < 0]  # two passthrough samples
    packed["pass_slot"][forced] = len(scratch) + np.arange(len(forced))
    scratch = np.concatenate([scratch, [pp.render_host(plans[i]) for i in forced]])
    got = _port_render(pp.dataset_tensor(), scratch, packed, hw=(128, 128))
    host = np.stack([pp.render_host(p) for p in plans])
    d = np.abs(got - host)
    assert d.mean() < 0.8 and (d > 2).mean() < 0.01
    passed = packed["pass_slot"] >= 0
    assert passed.sum() >= 2
    np.testing.assert_allclose(got[passed], host[passed], atol=0.01)


def test_concat_renders_the_mixed_samples(sets):
    """The concat stage's mixup pixels: the port renders each mixed
    sample's second branch (it picks the rows from the plans), as the host
    oracle does. The JAX runner passes ``has_mix`` from ``train_dataset.aug``,
    which a ConcatDataset lacks, so its render drops them (ROADMAP.md §C)."""
    pp, _ = _planners(sets, "concat")
    _, jds = _datasets(sets, "concat")
    for part in pp.parts:  # every sample mixes
        part.ds.aug = pa.mix_stage_aug(1.0, True)
    rng = np.random.default_rng(3)
    packed, scratch, plans = pp.plan_batch(rng.integers(0, 64, B), rng, MAX_GT, SLOTS)
    packed = _tails_off(packed)
    data = pp.dataset_tensor()
    got = _port_render(data, scratch, packed)
    assert packed["mix"].all()
    assert np.abs(got - _jax_render(data, scratch, packed, has_mix=True)).max() <= GEOM_TOL
    assert getattr(jds, "aug", None) is None  # the JAX runner's recipe_has_mix reads False
    dropped = _jax_render(data, scratch, packed, has_mix=False)
    assert np.abs(got - dropped).mean() > 10.0


def test_lsj_render_matches_jax_and_its_host_oracle(sets):
    pp, _ = _planners(sets, "lsj")
    packed, scratch, plans = pp.plan_batch(np.arange(32), np.random.default_rng(1), MAX_GT, 1)
    data = pp.dataset_tensor()
    assert data.shape == (48, 112, 112, 3) and packed["lsj_flip"].any()
    got = PD.render_lsj_batch(torch.from_numpy(data),
                              {k: torch.from_numpy(v) for k, v in packed.items()},
                              (128, 128), (112, 112)).numpy() * 255.0
    want = np.asarray(JD.render_lsj_batch(jnp.asarray(data),
                                          {k: jnp.asarray(v) for k, v in packed.items()},
                                          (128, 128), (112, 112))) * 255.0
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d > 0).mean() <= LSJ_DIFF_SHARE
    d = np.abs(got - np.stack([pp.render_host(p) for p in plans]))
    assert d.mean() < 0.6 and (d > 2).mean() < 0.01


def test_make_planner_choices_match_jax(sets, monkeypatch):
    for recipe in RECIPES:
        _planners(sets, recipe)  # same planner class on both sides
    ds, jds = _datasets(sets, "lsj")
    a, b = sets
    cases = [(ConcatDataset([ds, ds]), JaxConcat([jds, jds]))]  # LSJ over a concat
    for d in (ds, jds):  # a tile whose COCO size differs
        d.images[3] = {**d.images[3], "width": 100}
    cases.append((ds, jds))
    monkeypatch.setenv("AGENDA_TORCH_IMG_CACHE_MB", "0")
    monkeypatch.setenv("AGENDA_TPU_IMG_CACHE_MB", "0")
    cases.append(_datasets(sets, "mix"))
    for ours, theirs in cases:
        (p, why), (jp, jwhy) = DetectorRunner._make_planner(ours), JaxRunner._make_planner(theirs)
        assert p is None and jp is None
        assert why == jwhy.replace("AGENDA_TPU_IMG_CACHE_MB", "AGENDA_TORCH_IMG_CACHE_MB")


def test_declined_recipe_warns_and_trains_on_the_host(sets, tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("AGENDA_TORCH_IMG_CACHE_MB", "0")
    cfg = preset("real_source", "yolov8", [DatasetSpec(sets[1], "ann.json")],
                 img_scale=(IMG, IMG), max_gt=MAX_GT, output_dir=str(tmp_path))
    cfg.runner = dataclasses.replace(cfg.runner, batch_size=8, max_epochs=1, device_aug=True)
    runner = DetectorRunner(cfg.build_family(), cfg.runner, device="cpu")
    with caplog.at_level(logging.WARNING, logger="agenda_tpu_torch.detect"):
        runner.train(cfg.build_train_dataset())
    assert runner.aug_path == "host"
    assert any("device_aug requested but unsupported (tile cache disabled" in r.getMessage()
               for r in caplog.records)


def test_plan_prefetcher_matches_serial(sets):
    """Workers spawned after torch ran in the parent: epochs 0-1 equal to
    the serial plans to the bit; epochs 2-3 (at and past stop_epoch) None."""
    from agenda_tpu_torch.data.datasets import DataLoader

    torch.manual_seed(0)
    torch.randn(256, 256) @ torch.randn(256, 256)  # torch's thread pool is up
    pp, _ = _planners(sets, "mix_every_op")
    tiles = pp.dataset_tensor()
    loader = DataLoader(range(48), 16, shuffle=True, seed=3, num_workers=0, pad_to_full=True)
    base = 7_000_019
    pre = PD.PlanPrefetcher(pp, loader.batches_for_epoch, base, MAX_GT, SLOTS, workers=2,
                            tiles=tiles, stop_epoch=2)
    try:
        got = [pre.epoch_batches(e) for e in range(4)]
    finally:
        pre.close()
    assert got[2] is None and got[3] is None
    assert not multiprocessing.active_children() and not os.path.exists(pre._path)
    for epoch in range(2):
        serial = list(PD.epoch_plans(pp, loader.batches_for_epoch(epoch),
                                     np.random.default_rng(base + epoch), MAX_GT, SLOTS))
        assert len(got[epoch]) == len(serial) == 3
        for (p_s, s_s), (p_w, s_w) in zip(serial, got[epoch]):
            for k in p_s:
                np.testing.assert_array_equal(p_s[k], p_w[k], err_msg=k)
            assert (s_s is None) == (s_w is None)
            if s_s is not None:
                np.testing.assert_array_equal(s_s, s_w)
    assert any(s is not None for _, s in got[0] + got[1])  # passthrough slabs came back


def _losses(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def test_two_device_aug_steps_match_jax(sets, tmp_path):
    """One epoch of 2 steps at batch 4, 128 px, from one checkpoint (not
    named latest: a weights-only start on both sides); the JAX runner on
    one device, so its batch is the port's."""
    train = str(tmp_path / "train")
    write_square_set(train, 8, seed=1)
    _, init = fabricate_detector(str(tmp_path / "init"), img_size=128, batch_size=4)
    common = str(tmp_path / "init" / "common.safetensors")
    os.rename(init, common)

    def config(make, spec, out):
        cfg = make("synthetic_heatmap", "yolov8", [spec(train, "ann.json")],
                   img_scale=(128, 128), max_gt=MAX_GT, output_dir=str(tmp_path / out))
        cfg.runner.batch_size, cfg.runner.max_epochs, cfg.runner.log_interval = 4, 1, 1
        cfg.runner.close_mosaic_epochs, cfg.runner.device_aug = 0, True
        cfg.runner.warmup_bias_lr = cfg.runner.lr  # a step the size of the others
        os.makedirs(cfg.runner.output_dir, exist_ok=True)
        return cfg

    jcfg = config(jax_preset, JaxSpec, "jax")
    one = jax_mesh.make_mesh(devices=jax.devices()[:1])
    with mock.patch.object(jax_mesh, "make_mesh", lambda: one):
        JaxRunner(jcfg.build_family(), jcfg.runner).train(jcfg.build_train_dataset(),
                                                          resume=common)
    cfg = config(preset, DatasetSpec, "port")
    runner = DetectorRunner(cfg.build_family(), cfg.runner, device="cpu")
    runner.train(cfg.build_train_dataset(), resume=common)
    assert runner.aug_path == "device"
    got, want = _losses(tmp_path / "port" / "metrics.jsonl"), _losses(tmp_path / "jax" /
                                                                        "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for (g, w), rtol in zip(zip(got, want), (LOSS_RTOL, STEP2_RTOL)):
        for k in ("loss", "cls", "iou", "dfl"):
            assert g[k] == pytest.approx(w[k], rel=rtol), (g["step"], k)


def test_det_train_device_aug_workers_cut_and_resumed(sets, tmp_path):
    """3 epochs of 2 steps with close_mosaic_epochs=1: epochs 0-1 planned by
    2 workers, epoch 2 (stage 2) serially. A second run stopped by an error
    at the switch closes its pool; resumed from its latest, it logs the
    uninterrupted run's steps 5 and 6."""
    from agenda_tpu_torch.cli import det_train

    cfg = preset("synthetic_heatmap", "yolov8", [DatasetSpec(sets[1], "ann.json")],
                 img_scale=(IMG, IMG), max_gt=MAX_GT)
    cfg.runner.close_mosaic_epochs, cfg.runner.log_interval = 1, 1
    config = str(tmp_path / "run.json")
    cfg.to_json(config)

    def run(work, *extra):
        det_train.main(["--config", config, "--device", "cpu", "--work-dir", str(tmp_path / work),
                        "--batch-size", "8", "--max-epochs", "3", "--device-aug",
                        "--device-aug-workers", "2", *extra])
        return _losses(tmp_path / work / "metrics.jsonl")

    whole = run("whole")
    assert [r["step"] for r in whole] == [1, 2, 3, 4, 5, 6]
    assert all(math.isfinite(r[k]) for r in whole for k in ("loss", "cls", "iou", "dfl"))

    class Cut(Exception):
        pass

    with mock.patch.object(DetectorRunner, "_apply_stage2_aug", side_effect=Cut):
        with pytest.raises(Cut):
            run("cut")
    assert not multiprocessing.active_children()
    latest = str(tmp_path / "cut" / "latest.safetensors")
    resumed = run("cut", "--resume", latest)
    assert [r["step"] for r in resumed] == [1, 2, 3, 4, 5, 6]
    assert resumed[4:] == [{**r, "sps": s["sps"]} for r, s in zip(whole[4:], resumed[4:])]
