"""Parity of the port's detector prediction path (agenda_tpu_torch.detect) with agenda_tpu.

Both packages run on the CPU in f32 on the same seeded inputs:

- ``box_iou``, ``nms`` (the golden case of ``tests/test_detect.py`` and
  random boxes with tied scores: equal indices), the batched-over-images
  NMS against one image at a time, ``batched_nms``, ``anchor_points``;
- YOLOv8 from a JAX-initialized checkpoint (``init_variables`` ->
  ``save_variables`` -> the port's ``load_variables``): as initialized,
  the per-level head outputs within 1e-4; with its batch-norm parameters
  redrawn and statistics measured on data (every layer counts, a swapped
  name shows), heads within 2e-4, ``yolov8_predict``'s ``valid`` equal and
  its detections matched one to one within what that moves them (boxes
  0.05 px, scores 1e-4). At the JAX init every anchor scores 0.01 to within
  1e-8, so NMS there is decided by rounding and is not compared;
- the eval dataset and its resize: the uniform-size device path equals
  JAX's ``item_u8`` + ``predict_u8`` resize exactly, the tile-by-tile path
  is within one level of its host path;
- ``det_test`` CLI to CLI on 12 tiles of 112 px (the calibrated
  checkpoint): equal ``img_path``, GT and labels, predictions within the
  calibrated tolerances above.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agenda_tpu.detect import ops as jops
from agenda_tpu.detect.configs import DatasetSpec as JaxSpec
from agenda_tpu.detect.configs import DetectionConfig as JaxConfig
from agenda_tpu.detect.configs import preset as jax_preset
from agenda_tpu.detect.families import build_family as jax_build_family
from agenda_tpu.detect.runner import RunnerConfig as JaxRunnerConfig
from agenda_tpu.detect.runner import load_variables as jax_load_variables
from agenda_tpu.detect.runner import save_variables as jax_save_variables
from agenda_tpu_torch.detect import ops
from agenda_tpu_torch.detect.configs import DetectionConfig
from agenda_tpu_torch.detect.families import build_family
from agenda_tpu_torch.detect.runner import (DetectorRunner, RunnerConfig, load_variables,
                                            save_variables)
from agenda_tpu_torch.utils.png import write_png
from test_torch_native import native_library  # noqa: F401 (the fixture)

# At unit-scale activations (the calibrated checkpoint) XLA's and oneDNN's
# f32 convolutions differ by up to HEAD_TOL in the logits. A DFL box edge
# moves by at most HEAD_TOL * 7.5 bins * stride 32 = 0.048 px under that, and
# a score by at most HEAD_TOL / 4. Boxes in px of the model's input (the
# records scale them back to the tile, by 112 / IMG).
HEAD_TOL, BOX_TOL, SCORE_TOL = 2e-4, 0.05, 1e-4
IMG = 64  # the model tests' img_size


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_boxes(rng, n, span=100.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_box_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 37), _random_boxes(rng, 23)
    a[3] = [5, 5, 5, 9]  # zero area
    b[4] = a[0]  # identical box
    want = np.asarray(jops.box_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ops.box_iou(_t(a), _t(b)).numpy(), want, rtol=0, atol=1e-6)


def test_nms_golden_matches_jax():
    boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                        [21, 21, 31, 31], [50, 50, 60, 60]], np.float32)
    scores = np.asarray([0.9, 0.8, 0.95, 0.3, 0.5], np.float32)
    for kw, want in ((dict(), {0, 2, 4}), (dict(max_outputs=2), [2, 0]),
                     (dict(score_threshold=0.6), {0, 2})):
        keep, valid = ops.nms(_t(boxes), _t(scores), 0.5, **kw)
        kept = keep.numpy()[valid.numpy()]
        assert (list(kept) if isinstance(want, list) else set(kept.tolist())) == want
        jk, jv = jops.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, **kw)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seed,n,k,iou,score_thr", [
    (0, 60, None, 0.5, -np.inf), (1, 120, 40, 0.3, 0.2), (2, 84, 84, 0.7, 0.001),
    (3, 200, 150, 0.5, 0.15)])
def test_nms_tied_scores_matches_jax(seed, n, k, iou, score_thr):
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, n, span=60.0)
    scores = rng.choice(np.asarray([0.05, 0.1, 0.3, 0.5, 0.9], np.float32), n)  # many ties
    keep, valid = ops.nms(_t(boxes), _t(scores), iou, k, score_thr)
    jk, jv = jops.nms(jnp.asarray(boxes), jnp.asarray(scores), iou, k, score_thr)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


def test_nms_images_equals_one_image_at_a_time():
    rng = np.random.default_rng(4)
    boxes = np.stack([_random_boxes(rng, 50, span=50.0) for _ in range(5)])
    scores = rng.choice(np.asarray([0.1, 0.2, 0.6], np.float32), (5, 50))
    keep, valid = ops.nms_images(_t(boxes), _t(scores), 0.5, 30, 0.15)
    assert keep.shape == valid.shape == (5, 30)
    for i in range(5):
        ki, vi = ops.nms(_t(boxes[i]), _t(scores[i]), 0.5, 30, 0.15)
        np.testing.assert_array_equal(keep[i].numpy(), ki.numpy())
        np.testing.assert_array_equal(valid[i].numpy(), vi.numpy())
        assert (keep[i][~valid[i]] == 0).all()  # invalid slots point at 0


def test_batched_nms_matches_jax():
    rng = np.random.default_rng(5)
    boxes = _random_boxes(rng, 80, span=40.0)
    scores = rng.uniform(0, 1, 80).astype(np.float32)
    labels = rng.integers(0, 3, 80)
    keep, valid = ops.batched_nms(_t(boxes), _t(scores), _t(labels), 0.5, 50)
    jk, jv = jops.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                              0.5, 50)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


def test_anchor_points_match_jax():
    for sizes, strides in (([(16, 16), (8, 8), (4, 4)], (8, 16, 32)), ([(2, 3), (1, 1)], (8, 16))):
        for got, want in zip(ops.anchor_points(sizes, strides), jops.anchor_points(sizes, strides)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def test_neck_upsample_and_pool_match_jax():
    """F.interpolate(scale_factor=2, nearest) == jax.image.resize nearest at 2x;
    the SPPF pool pads with -inf as flax's max_pool."""
    import flax.linen as fnn
    import torch.nn.functional as F

    x = np.random.default_rng(6).normal(size=(2, 5, 3, 4)).astype(np.float32) - 3.0  # NHWC
    up = jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), "nearest")
    got = F.interpolate(_t(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(up))
    pool = fnn.max_pool(jnp.asarray(x), (5, 5), strides=(1, 1), padding=((2, 2), (2, 2)))
    got = F.max_pool2d(_t(x).permute(0, 3, 1, 2), 5, 1, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(pool))


# ---------------------------------------------------------------------------
# YOLOv8 from a JAX checkpoint
# ---------------------------------------------------------------------------


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """Two YOLOv8n checkpoints written by the JAX runner, both from one JAX
    ``init_variables``: "init" as it is (batch-norm statistics 0 and 1,
    under which each SiLU about halves the signal, so the heads see
    activations of 1e-6 and score every anchor alike), and "calibrated":
    batch-norm scales, biases and the heads' biases redrawn, then the
    running statistics measured on seeded noise by the port's
    ``calibrate_batch_norm``, so that every layer counts in the heads and a
    swapped name shows."""
    from agenda_tpu_torch.detect.fabricate import calibrate_batch_norm
    from agenda_tpu_torch.detect.flax_layout import flax_to_state_dict, state_dict_to_flax

    fam = jax_build_family("yolov8", model=dict(img_size=IMG))
    init = jax.device_get(jax.jit(fam.init_variables)(jax.random.key(0)))
    flat = {col + "." + ".".join(p.key for p in path): np.asarray(leaf)
            for col, tree in init.items()
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    rng = np.random.default_rng(7)
    redrawn = {}
    for k, v in flat.items():
        if k.endswith("bn.scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("bn.bias"):
            v = rng.normal(0, 0.2, v.shape)
        elif k.endswith(".bias"):
            v = v + rng.normal(0, 0.5, v.shape)
        redrawn[k] = np.asarray(v, np.float32)
    port = build_family("yolov8", model=dict(img_size=IMG))
    images = torch.rand(16, IMG, IMG, 3, generator=torch.Generator().manual_seed(7))
    calibrated = state_dict_to_flax(
        calibrate_batch_norm(port, flax_to_state_dict(redrawn), images))
    out = {}
    for name, variables in (("init", init), ("calibrated", _nest(calibrated))):
        path = str(tmp_path_factory.mktemp("yolo_ckpt") / "latest.safetensors")
        jax_save_variables(path, variables)
        out[name] = (fam, variables, path)
    return out


@pytest.fixture(scope="module")
def jax_checkpoint(jax_checkpoints):
    return jax_checkpoints["calibrated"]


def test_checkpoint_maps_both_ways(jax_checkpoint, tmp_path):
    fam, variables, path = jax_checkpoint
    port = build_family("yolov8", model=dict(img_size=IMG))
    state = load_variables(path)
    port.check_variables(state)
    assert state["stem.conv.weight"].shape == (16, 3, 3, 3)  # OIHW from HWIO
    np.testing.assert_array_equal(state["c2f_1.m_0.cv1.bn.running_var"].numpy(),
                                  variables["batch_stats"]["c2f_1"]["m_0"]["cv1"]["bn"]["var"])
    np.testing.assert_array_equal(state["head_cls3_2.bias"].numpy(),
                                  variables["params"]["head_cls3_2"]["bias"])
    # the port writes the JAX layout: the JAX runner reads it back bit for bit
    save_variables(str(tmp_path / "port.safetensors"), state)
    back = jax_load_variables(str(tmp_path / "port.safetensors"))
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for key, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), want)
    # a name the map does not know raises
    from agenda_tpu_torch.detect.flax_layout import flax_to_state_dict

    with pytest.raises(KeyError):
        flax_to_state_dict({"params.stem.conv.gamma": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        flax_to_state_dict({"opt.0001": np.zeros(3, np.float32)})


def test_yolov8s_names_and_shapes_match_jax():
    """The width-0.5 model maps name for name (shapes from a JAX trace)."""
    fam = jax_build_family("yolov8s", model=dict(img_size=IMG))
    shapes = jax.eval_shape(fam.init_variables, jax.random.key(0))
    flat = {".".join([col] + [p.key for p in path]): np.zeros(leaf.shape, np.float32)
            for col, tree in shapes.items()
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    from agenda_tpu_torch.detect.flax_layout import flax_to_state_dict

    build_family("yolov8s", model=dict(img_size=IMG)).check_variables(flax_to_state_dict(flat))


# the JAX init's near-constant heads within 1e-4; the calibrated
# checkpoint's within the limits derived above
@pytest.mark.parametrize("name,head_tol", [("init", 1e-4), ("calibrated", HEAD_TOL)])
def test_yolov8_heads_and_predict_match_jax(jax_checkpoints, name, head_tol):
    fam, variables, path = jax_checkpoints[name]
    port = build_family("yolov8", model=dict(img_size=IMG))
    state = load_variables(path)
    x = np.random.default_rng(8).uniform(0, 1, (4, IMG, IMG, 3)).astype(np.float32)

    outs = jax.jit(lambda v, im: fam.model.apply(v, im, train=False))(variables, x)
    ours = port.forward(state, _t(x))
    assert len(ours) == 3
    for (c, b), (pc, pb) in zip(outs, ours):
        assert pc.shape == c.shape and pb.shape == b.shape
        np.testing.assert_allclose(pc.numpy(), np.asarray(c), rtol=0, atol=head_tol)
        np.testing.assert_allclose(pb.numpy(), np.asarray(b), rtol=0, atol=head_tol)
    if name == "init":
        # every anchor scores 0.01 to within 1e-8 here, so which of two
        # overlapping boxes NMS keeps is decided by rounding: predictions are
        # compared at the calibrated checkpoint only
        return
    assert float(np.asarray(outs[0][0]).std()) > 0.1  # the heads see the image

    jb, js, jv = jax.jit(fam.predict_fn)(variables, x)
    pb, ps, pv = port.predict_fn(state, _t(x))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pv.shape == (4, 84) and int(pv.sum()) > 4  # K = min(300, N)
    for i in range(4):
        keep = pv[i].numpy()
        _assert_same_detections(pb[i].numpy()[keep], ps[i].numpy()[keep],
                                np.asarray(jb)[i][keep], np.asarray(js)[i][keep],
                                BOX_TOL, SCORE_TOL)


# ---------------------------------------------------------------------------
# the eval dataset, its resize, and det_test
# ---------------------------------------------------------------------------


def _write_tiles(root, sizes, seed=0, n_boxes=2):
    """PNG tiles of the given (w, h) sizes with boxes, and their COCO file."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    images, anns = [], []
    for i, (w, h) in enumerate(sizes):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        for _ in range(n_boxes):
            x0, y0 = int(rng.integers(0, w - 30)), int(rng.integers(0, h - 30))
            img[y0:y0 + 30, x0:x0 + 30] = rng.integers(150, 255, 3)
            anns.append({"id": len(anns), "image_id": i, "category_id": 1, "iscrowd": 0,
                         "bbox": [float(x0), float(y0), 30.0, 30.0], "area": 900.0})
        write_png(os.path.join(root, "images", f"{i}.png"), img)
        images.append({"id": i, "file_name": f"{i}.png", "width": w, "height": h})
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump({"categories": [{"id": 1, "name": "small"}], "images": images,
                   "annotations": anns}, f)


@pytest.mark.usefixtures("native_library")
def test_eval_dataset_and_resize_match_jax(tmp_path):
    from agenda_tpu.data.device_resize import resize_weights as jax_resize_weights
    from agenda_tpu.detect.dataset import CocoDetDataset as JaxDataset
    from agenda_tpu_torch.data.device_resize import resize_levels, resize_weights
    from agenda_tpu_torch.detect.dataset import CocoDetDataset

    root = str(tmp_path)
    _write_tiles(root, [(112, 112)] * 3 + [(100, 90), (140, 120)], seed=1)
    jds = JaxDataset(root, "ann.json", img_scale=(128, 128), max_gt=8, train=False)
    ds = CocoDetDataset(root, "ann.json", img_scale=(128, 128), max_gt=8)
    assert len(ds) == 5 and ds.source_size() is None
    for i in range(5):
        a, b = jds.item_u8(i), ds.item_u8(i)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert ds.file_name(i) == jds.file_name(i) == f"{i}.png"
        # the eval __getitem__ (host resize): within one level of JAX's host path
        ga, gb = jds[i], ds[i]
        assert list(ga) == list(gb)
        assert np.abs(gb["image"] * 255 - ga["image"] * 255).max() <= 1.0 + 1e-3
        for k in ("gt_boxes", "gt_valid", "image_id", "scale_back"):
            np.testing.assert_array_equal(gb[k], ga[k], err_msg=k)
    # training is ported, its LSJ recipe (the ViTDet stage) too: LSJ's train
    # items on these tiles of three sizes against the JAX package's
    from agenda_tpu.detect.augment import lsj_aug as jax_lsj_aug
    from agenda_tpu_torch.detect.augment import lsj_aug

    jtrain = JaxDataset(root, "ann.json", img_scale=(128, 128), max_gt=8, train=True,
                        aug=jax_lsj_aug())
    train = CocoDetDataset(root, "ann.json", img_scale=(128, 128), max_gt=8, train=True,
                           aug=lsj_aug())
    for i in (0, 3, 4, 3):
        ga, gb = jtrain[i], train[i]
        np.testing.assert_array_equal(gb["gt_valid"], ga["gt_valid"])
        assert np.abs(gb["gt_boxes"] - ga["gt_boxes"]).max() <= 1e-5
        assert np.abs(gb["image"] * 255 - ga["image"] * 255).max() <= 1.0

    # the uniform path: JAX's predict_u8 resize, exactly
    np.testing.assert_array_equal(resize_weights(112, 128, "bilinear"),
                                  jax_resize_weights(112, 128, "bilinear"))
    u8 = np.stack([ds.item_u8(i)["image_u8"] for i in range(3)])
    wy = wx = jax_resize_weights(112, 128, "bilinear")
    xj = jnp.einsum("Ww,bhwc->bhWc", wx, jnp.asarray(u8).astype(jnp.float32))
    xj = jnp.einsum("Hh,bhwc->bHwc", wy, xj)
    want = np.asarray(jnp.round(jnp.clip(xj, 0.0, 255.0)) / 255.0)
    got = resize_levels(_t(u8), _t(wy), _t(wx)) / 255.0
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_config(root, batch_size=4, img=IMG, detector="yolov8"):
    spec = JaxSpec(root, "ann.json")
    return JaxConfig(detector=detector, train_datasets=[spec], test_dataset=spec,
                     img_scale=(img, img), max_gt=8,
                     runner=JaxRunnerConfig(output_dir=os.path.join(root, "work"),
                                            batch_size=batch_size))


def _assert_same_detections(boxes, scores, want_boxes, want_scores, box_tol, score_tol):
    """One to one within box_tol and score_tol. Scores closer than the float
    noise of the two packages (1e-8 at the JAX init) may come out in either
    order, so each detection is matched, not each slot."""
    assert boxes.shape == want_boxes.shape
    free = np.ones(len(want_scores), bool)
    for b, s in zip(boxes, scores):
        hit = free & (np.abs(want_scores - s) <= score_tol) & (
            np.abs(want_boxes - b).max(axis=1) <= box_tol)
        j = int(np.argmin(np.abs(want_boxes - b).max(axis=1) + np.abs(want_scores - s)))
        assert hit.any(), f"no match for {b} ({s}); nearest {want_boxes[j]} ({want_scores[j]})"
        free[np.argmax(hit)] = False


def _assert_records_match(ours, want):
    assert len(ours) == len(want)
    n_valid = 0
    for r, w in zip(ours, want):
        assert r["img_path"] == w["img_path"]
        for k in ("bboxes", "labels"):
            np.testing.assert_array_equal(r["gt_instances"][k], w["gt_instances"][k])
        assert r["gt_instances"]["bboxes"].dtype == w["gt_instances"]["bboxes"].dtype
        rp, wp = r["pred_instances"], w["pred_instances"]
        assert rp["bboxes"].shape == wp["bboxes"].shape
        np.testing.assert_array_equal(rp["labels"], wp["labels"])
        _assert_same_detections(rp["bboxes"], rp["scores"], wp["bboxes"], wp["scores"],
                                BOX_TOL * 112 / IMG, SCORE_TOL)  # boxes scaled to the tile
        n_valid += len(rp["scores"])
    assert n_valid > len(want)


@pytest.mark.usefixtures("native_library")
def test_det_test_cli_matches_jax(jax_checkpoint, tmp_path):
    """det_test CLI to CLI: 12 tiles of 112 px, batch 4 (the last batch
    full, then a set of 10: the last batch padded)."""
    from agenda_tpu.cli import det_test as jax_det_test
    from agenda_tpu.annotate.records import load_predictions as jax_load
    from agenda_tpu_torch.cli import det_test

    _, _, ckpt = jax_checkpoint
    root = str(tmp_path)
    _write_tiles(root, [(112, 112)] * 12, seed=2)
    cfg_path = os.path.join(root, "config.json")
    _jax_config(root).to_json(cfg_path)
    args = ["--config", cfg_path, "--checkpoint", ckpt, "--test-root", root,
            "--test-ann", "ann.json"]
    want = jax_det_test.main(args + ["--out", os.path.join(root, "jax.pkl")])
    ours = det_test.main(args + ["--out", os.path.join(root, "port.pkl"), "--device", "cpu"])
    _assert_records_match(ours, want)
    _assert_records_match(jax_load(os.path.join(root, "port.pkl")), want)

    # a ragged set: 10 tiles in batches of 4 pads the last batch
    with open(os.path.join(root, "ann.json")) as f:
        coco = json.load(f)
    coco["images"] = coco["images"][:10]
    with open(os.path.join(root, "ann10.json"), "w") as f:
        json.dump(coco, f)
    cfg = DetectionConfig.from_json(cfg_path)
    ds = cfg.build_eval_dataset(type(cfg.test_dataset)(root, "ann10.json"))
    recs = DetectorRunner(cfg.build_family(), cfg.runner, device="cpu").test(
        load_variables(ckpt), ds)
    _assert_records_match(recs, want[:10])


def test_runner_resizes_tiles_of_mixed_sizes_one_by_one(jax_checkpoint, tmp_path):
    """A set whose tiles differ in size goes tile by tile through the
    half-up resize (within one level of JAX's host path, shown above): the
    runner's records equal a prediction over the eval items' images."""
    from agenda_tpu_torch.detect.dataset import CocoDetDataset

    _, _, ckpt = jax_checkpoint
    root = str(tmp_path)
    _write_tiles(root, [(112, 112), (96, 120), (140, 100)], seed=3)
    ds = CocoDetDataset(root, "ann.json", img_scale=(IMG, IMG), max_gt=8)
    assert ds.source_size() is None
    port = build_family("yolov8", model=dict(img_size=IMG))
    state = load_variables(ckpt)
    recs = DetectorRunner(port, RunnerConfig(batch_size=2), device="cpu").test(state, ds)
    images = torch.stack([_t(ds[i]["image"]) for i in range(3)] + [_t(ds[2]["image"])])
    boxes, scores, valid = port.predict_fn(state, images)
    for i, r in enumerate(recs):
        keep = (valid[i] & (scores[i] > 0)).numpy()
        sb = ds[i]["scale_back"]
        np.testing.assert_array_equal(r["pred_instances"]["bboxes"], boxes[i].numpy()[keep] * sb)
        np.testing.assert_array_equal(r["pred_instances"]["scores"], scores[i].numpy()[keep])
        assert r["img_path"] == os.path.join(root, "images", f"{i}.png")


def test_config_json_from_jax_parses(tmp_path):
    """A det_train preset's config.json (every RunnerConfig and AugConfig
    field) parses unchanged and round-trips."""
    cfg = jax_preset("synthetic_heatmap", "yolov8s", [JaxSpec(str(tmp_path), "a.json")],
                     test=JaxSpec(str(tmp_path), "t.json"))
    p = str(tmp_path / "config.json")
    cfg.to_json(p)
    ours = DetectionConfig.from_json(p)
    assert ours.runner.batch_size == 192 and ours.detector == "yolov8s"
    assert ours.aug.mosaic and ours.aug.hsv and ours.runner.yolo_optimizer
    fam = ours.build_family()
    assert fam.config.width == 0.5 and fam.config.img_size == 128
    ours.to_json(str(tmp_path / "again.json"))
    with open(p) as f, open(tmp_path / "again.json") as g:
        assert json.load(f) == json.load(g)
    # the other families' configs parse and build too
    for name, family in (("faster-rcnn", "FasterRCNNFamily"), ("yolov5", "YOLOv5Family"),
                         ("vitdet", "ViTDetFamily")):
        jax_preset("synthetic_heatmap", name, [JaxSpec(str(tmp_path), "a.json")]).to_json(p)
        fam = DetectionConfig.from_json(p).build_family()
        assert type(fam).__name__ == family and fam.config.img_size == 128
        assert type(build_family(name)).__name__ == family


def test_det_test_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    from agenda_tpu_torch.cli import det_test

    root = str(tmp_path)
    cfg_path = os.path.join(root, "config.json")
    _jax_config(root).to_json(cfg_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        det_test.main(["--config", cfg_path, "--checkpoint", os.path.join(root, "absent")])
