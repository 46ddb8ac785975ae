"""Parity of the port's train-time augmentation (agenda_tpu_torch.detect.augment
and the train side of its dataset) with agenda_tpu and with Pillow.

The port runs without Pillow and without the JAX package's native library.
Every random draw comes from the same ``numpy.random.Generator`` in the same
order, so boxes must be equal (within 1e-5 px, where float32 box arithmetic
meets them). Images are held within one 8-bit level (``LEVEL_TOL``), and the
share of differing pixels is reported:

- Pillow's ``transform(AFFINE, BILINEAR, fillcolor)`` and its 8-bit
  ``resize(BILINEAR)`` are reproduced to the bit on random matrices and
  sizes, fully out-of-range and edge-touching warps included; the host tile
  resize equals the JAX package's own host resize (the native library
  here);
- HSV: the reference runs its native f32 pass, the port the numpy formulas
  the reference keeps beside it (float64 after the gains), within 1e-3 of
  a level; the median, box blur, gray and CLAHE equal;
- mosaic, mixup, the affine, flip: equal boxes, images within one level;
- ``CocoDetDataset.__getitem__`` in train mode for the mix recipe (YOLOv8's,
  with YOLOv5MixUp), a mix recipe with every photometric op likely, the
  stage-2 recipe and the plain one, over several indices and two epochs of
  calls, and a ``ConcatDataset``: equal GT and ``gt_valid``, images within
  one level; the LSJ recipe's train items (112-px tiles to 128 px) likewise.
"""

import dataclasses
import math

import numpy as np
import pytest
from PIL import Image

from agenda_tpu.data import native_image
from agenda_tpu.detect import augment as ja
from agenda_tpu.detect.dataset import CocoDetDataset as JaxDataset
from agenda_tpu.detect.dataset import ConcatDataset as JaxConcat
from agenda_tpu_torch.detect import augment as pa
from agenda_tpu_torch.detect.dataset import CocoDetDataset, ConcatDataset, resize_u8_host
from agenda_tpu_torch.detect.fabricate import write_square_set
from test_torch_native import native_library  # noqa: F401 (the fixture)

# the JAX side of every pixel comparison takes the native resize
pytestmark = pytest.mark.usefixtures("native_library")

LEVEL_TOL = 1.0  # images, in 8-bit levels
BOX_TOL = 1e-5  # boxes, px
HSV_TOL = 1e-3  # the native f32 HSV pass against the numpy formulas, levels


def _pil_warp(img, inv, out_size):
    return np.asarray(Image.fromarray(img).transform(
        out_size, Image.AFFINE, data=tuple(inv[:2].ravel()), resample=Image.BILINEAR,
        fillcolor=(114,) * 3))


def _random_matrices(rng, n):
    """Input->output matrices: the recipes' scale + translate (separable),
    rotated and sheared ones, ones that map the source fully out of the
    output, and an exact 2x / 0.5x that puts sample points on pixel edges."""
    for t in range(n):
        kind = t % 4
        if kind == 0:
            m = ja.affine_matrix(rng, (256, 256), (128, 128), scaling_ratio_range=(0.1, 1.9))
        elif kind == 1:
            th, sc = rng.uniform(-1, 1), rng.uniform(0.3, 2.5)
            m = np.array([[sc * math.cos(th), -sc * math.sin(th), rng.uniform(-100, 100)],
                          [sc * math.sin(th), sc * math.cos(th), rng.uniform(-100, 100)],
                          [0, 0, 1.0]])
            m[0, 1] += rng.uniform(-0.3, 0.3)  # shear
        elif kind == 2:
            m = ja.affine_matrix(rng, (256, 256), (128, 128), scaling_ratio_range=(0.5, 1.5))
            m[int(rng.integers(2)), 2] += rng.choice([-1, 1]) * 1e4  # nothing lands inside
        else:
            s = float(rng.choice([0.5, 2.0]))
            m = np.array([[s, 0, float(rng.integers(-3, 4))], [0, s, float(rng.integers(-3, 4))],
                          [0, 0, 1.0]])
        yield kind, m


def test_warp_equals_pillow():
    rng = np.random.default_rng(0)
    n_out = 0
    for kind, m in _random_matrices(rng, 48):
        h, w = (256, 256) if kind != 1 else tuple(int(v) for v in rng.integers(5, 200, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        out_size = (128, 128) if kind != 1 else tuple(int(v) for v in rng.integers(5, 160, 2))
        inv = ja.affine_inverse(m)
        want = _pil_warp(img, inv, out_size)
        got = pa.warp_affine_u8(img, inv, out_size)
        np.testing.assert_array_equal(got, want, err_msg=f"kind {kind}")
        n_out += bool((want == 114).all())
    assert n_out >= 12  # the out-of-range cases really are all fill


def test_resizes_equal_pillow_and_the_jax_host_resize():
    rng = np.random.default_rng(1)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(3, 200, 2))
        oh, ow = (int(v) for v in rng.integers(1, 260, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(pa.resize_bilinear_pil(img, ow, oh), want)
    # the tile cache's resize: the JAX package's host path (its native
    # library here, else Pillow within one level), 112 -> 128 and 112 -> 64
    for size in ((112, 112, 128, 128), (112, 112, 64, 64), (90, 140, 128, 128),
                 (512, 384, 128, 128)):
        h, w, oh, ow = size
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want, _ = JaxDataset._resize(None, img.astype(np.float32), np.zeros((0, 4)), ow, oh)
        got = resize_u8_host(img, ow, oh).astype(np.float32)
        if native_image.available():
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= LEVEL_TOL


def test_photometric_ops_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
    img[:8] = 40.0  # gray rows: the HSV's diff == 0 branch
    img[8:16, :, 1] = img[8:16, :, 0]  # ties of max between channels
    for seed in range(6):
        want = ja.hsv_jitter(img, np.random.default_rng(seed))
        got = pa.hsv_jitter(img, np.random.default_rng(seed))
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= HSV_TOL
    for k in (3, 5, 7):
        np.testing.assert_array_equal(pa.median_blur_k(img, k), ja.median_blur_k(img, k))
        np.testing.assert_array_equal(pa.box_blur_k(img, k), ja.box_blur_k(img, k))
    for fn in ("blur", "median_blur"):
        np.testing.assert_array_equal(getattr(pa, fn)(img, np.random.default_rng(3)),
                                      getattr(ja, fn)(img, np.random.default_rng(3)))
    np.testing.assert_array_equal(pa.to_gray(img), ja.to_gray(img))
    np.testing.assert_array_equal(pa.clahe(img), ja.clahe(img))


def _tiles(rng, n, size):
    out = []
    for _ in range(n):
        img = rng.integers(0, 60, (size, size, 3)).astype(np.float32)
        xy = rng.uniform(0, size - 30, (int(rng.integers(0, 4)), 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 30, xy.shape)], 1).astype(np.float32)
        for x0, y0, x1, y1 in boxes.astype(int):
            img[y0:y1, x0:x1] = rng.integers(150, 255, 3)
        out.append((img, boxes.reshape(-1, 4)))
    return out


def _assert_pair(got, want, what):
    (gi, gb), (wi, wb) = got, want
    assert gb.shape == wb.shape, what
    if len(wb):
        assert np.abs(gb - wb).max() <= BOX_TOL, what
    assert gi.shape == wi.shape and gi.dtype == wi.dtype, what
    assert np.abs(gi - wi).max() <= LEVEL_TOL, what


def test_geometry_matches_jax():
    rng = np.random.default_rng(4)
    tiles = _tiles(rng, 6, 64)
    load = lambda i: (tiles[i][0].copy(), tiles[i][1].copy())  # noqa: E731
    for seed in range(8):
        want = ja.mosaic(load, seed % 6, 6, np.random.default_rng(seed), (64, 64))
        got = pa.mosaic(load, seed % 6, 6, np.random.default_rng(seed), (64, 64))
        _assert_pair(got, want, f"mosaic {seed}")
        canvas, boxes = want
        for kw in ({}, {"max_aspect_ratio": 100.0},
                   {"max_rotate_degree": 10.0, "max_shear_degree": 5.0}):
            w = ja.random_affine(canvas, boxes, np.random.default_rng(seed), (64, 64),
                                 scaling_ratio_range=(0.1, 1.9), **kw)
            g = pa.random_affine(canvas, boxes, np.random.default_rng(seed), (64, 64),
                                 scaling_ratio_range=(0.1, 1.9), **kw)
            _assert_pair(g, w, f"affine {seed} {kw}")
        img2, boxes2 = tiles[(seed + 1) % 6]
        w = ja.mixup(tiles[0][0], tiles[0][1], img2, boxes2, np.random.default_rng(seed))
        g = pa.mixup(tiles[0][0], tiles[0][1], img2, boxes2, np.random.default_rng(seed))
        _assert_pair(g, w, f"mixup {seed}")
        _assert_pair(pa.flip_horizontal(*tiles[seed % 6]), ja.flip_horizontal(*tiles[seed % 6]),
                     "flip")
    m = ja.affine_matrix(np.random.default_rng(9), (128, 128), (64, 64), 10.0, 5.0)
    np.testing.assert_array_equal(
        pa.affine_matrix(np.random.default_rng(9), (128, 128), (64, 64), 10.0, 5.0), m)
    np.testing.assert_array_equal(pa.affine_inverse(m), ja.affine_inverse(m))
    np.testing.assert_array_equal(pa.affine_boxes(tiles[1][1], m, (64, 64)),
                                  ja.affine_boxes(tiles[1][1], m, (64, 64)))


def test_recipes_match_jax():
    for name in ("mix_stage_aug", "plain_aug"):
        assert (dataclasses.asdict(getattr(pa, name)())
                == dataclasses.asdict(getattr(ja, name)()))
    yolo = ja.mix_stage_aug(0.1, True)
    assert dataclasses.asdict(pa.stage2_aug(pa.mix_stage_aug(0.1, True))) \
        == dataclasses.asdict(ja.stage2_aug(yolo))


def _with_every_photometric_op(mod):
    return dataclasses.replace(mod.mix_stage_aug(1.0, True), blur_prob=0.3,
                               median_blur_prob=0.3, to_gray_prob=0.3, clahe_prob=0.3)


RECIPES = {
    "mix": lambda mod: mod.mix_stage_aug(mixup_prob=0.1, mixup_mosaic_pre=True),
    "mix_every_op": _with_every_photometric_op,
    "stage2": lambda mod: mod.stage2_aug(mod.mix_stage_aug(0.1, True)),
    "plain": lambda mod: mod.plain_aug(),
}


@pytest.fixture(scope="module")
def tile_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_tiles")
    a, b = str(root / "a"), str(root / "b")
    write_square_set(a, 10, seed=3)
    write_square_set(b, 6, seed=4)
    return a, b


def _compare_items(ds, jds, order):
    worst, differing = 0.0, []
    for i in order:
        want, got = jds[i], ds[i]
        assert list(got) == list(want)
        for k in ("gt_boxes", "gt_valid", "image_id", "scale_back"):
            assert got[k].dtype == want[k].dtype, k
            if k == "gt_boxes":
                assert np.abs(got[k] - want[k]).max() <= BOX_TOL, (i, k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        d = np.abs(got["image"] * 255.0 - want["image"] * 255.0)
        worst = max(worst, float(d.max()))
        differing.append(float((d > 0).mean()))
    return worst, float(np.mean(differing))


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_train_dataset_matches_jax(tile_sets, recipe):
    root = tile_sets[0]
    size = 128 if recipe == "mix" else 64  # the pipeline's 128 px once, else small
    jds = JaxDataset(root, "ann.json", img_scale=(size, size), max_gt=8, train=True,
                     aug=RECIPES[recipe](ja))
    ds = CocoDetDataset(root, "ann.json", img_scale=(size, size), max_gt=8, train=True,
                        aug=RECIPES[recipe](pa))
    # two epochs of calls: the per-call seed moves on, so an index's second
    # draw differs from its first
    order = [3, 0, 7, 9, 5, 3] * 2
    worst, share = _compare_items(ds, jds, order)
    print(f"{recipe}: max |d| {worst:.2e} levels, {100 * share:.2f}% of pixels differ")
    assert worst <= LEVEL_TOL
    assert ds._aug_calls == jds._aug_calls == len(order)


def test_concat_dataset_matches_jax(tile_sets):
    a, b = tile_sets
    mix = RECIPES["mix"]
    jds = JaxConcat([JaxDataset(r, "ann.json", img_scale=(64, 64), max_gt=8, train=True,
                                aug=mix(ja)) for r in (a, b)])
    ds = ConcatDataset([CocoDetDataset(r, "ann.json", img_scale=(64, 64), max_gt=8,
                                       train=True, aug=mix(pa)) for r in (a, b)])
    assert len(ds) == len(jds) == 16 and ds.max_gt == 8
    worst, share = _compare_items(ds, jds, [0, 15, 9, 10, 4, 12])
    print(f"concat: max |d| {worst:.2e} levels, {100 * share:.2f}% of pixels differ")
    assert worst <= LEVEL_TOL


def test_eval_items_and_the_lsj_refusal(tile_sets):
    """The eval items, and the LSJ train items (the recipe once refused):
    the flip before the resize, Pillow's resize, the crop and the pad."""
    root = tile_sets[0]
    jds = JaxDataset(root, "ann.json", img_scale=(64, 64), max_gt=8, train=False)
    ds = CocoDetDataset(root, "ann.json", img_scale=(64, 64), max_gt=8, train=False)
    worst, _ = _compare_items(ds, jds, range(len(ds)))
    assert worst == 0.0  # the same host resize
    assert dataclasses.asdict(pa.lsj_aug()) == dataclasses.asdict(ja.lsj_aug())
    jds = JaxDataset(root, "ann.json", img_scale=(128, 128), max_gt=8, train=True,
                     aug=ja.lsj_aug())
    ds = CocoDetDataset(root, "ann.json", img_scale=(128, 128), max_gt=8, train=True,
                        aug=pa.lsj_aug())
    worst, share = _compare_items(ds, jds, [3, 0, 7, 9, 5, 3] * 2)
    print(f"lsj: max |d| {worst:.2e} levels, {100 * share:.2f}% of pixels differ")
    assert worst <= LEVEL_TOL
    assert ds._aug_calls == jds._aug_calls == 12
