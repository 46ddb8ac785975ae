"""The port's host libraries (``agenda_tpu_torch/data/native_image.py``,
``agenda_tpu_torch/detect/native.py``) against the JAX package's native
ones and against the port's own plain versions, on the CPU.

- The decode is held bit for bit to ``agenda_tpu.data.native_image.decode``
  on files Pillow writes here (PNG: RGB, gray, gray + alpha, RGBA, palette,
  palette + tRNS, 16-bit, and an Adam7 file, which Pillow does not write;
  JPEG: baseline 4:2:0 and 4:4:4, progressive, gray), as are the header,
  the resize, the HSV pass and the median. The committed fixtures
  (``tests/data/images``, read on the card) still equal the JAX decode.
- The datasets read JPEG: ``BaseDataset`` within one level of the JAX
  package's Pillow path (``tests/test_native_image.py``'s tolerance for a
  JPEG decode), ``CocoDetDataset`` bit for bit against ``load_rgb``.
- The matchers equal the numpy ones and the JAX package's on seeded boxes,
  with empty sets, ties and IoUs exactly at the threshold.
"""

import io
import json
import os
import sys
import time

import numpy as np
import pytest
from PIL import Image

from agenda_tpu.data import datasets as jdatasets
from agenda_tpu.data import native_image as jni
from agenda_tpu.detect import coco_eval as jcoco
from agenda_tpu.detect import native as jnative
from agenda_tpu.annotate import threshold as jthreshold
from agenda_tpu_torch.annotate import threshold as tthreshold
from agenda_tpu_torch.data import datasets as tdatasets
from agenda_tpu_torch.data import native_image as tni
from agenda_tpu_torch.detect import augment as taug
from agenda_tpu_torch.detect import coco_eval as tcoco
from agenda_tpu_torch.detect import native as tnative
from agenda_tpu_torch.detect.dataset import CocoDetDataset
from agenda_tpu_torch.utils import host_build
from test_torch_native import native_library  # noqa: F401 (the fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_image_fixtures as fixtures  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "images")
LEVEL_TOL = 1  # tests/test_native_image.py:58-59: a JPEG decode against Pillow's


def _encode(im, fmt, **kw):
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _forms():
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 256, (23, 31, 3), np.uint8)
    out = {
        "png_rgb": _encode(Image.fromarray(rgb), "PNG"),
        "png_gray": _encode(Image.fromarray(rgb[..., 0]), "PNG"),
        "png_gray_alpha": _encode(Image.fromarray(rgb[..., :2], "LA"), "PNG"),
        "png_rgba": _encode(Image.fromarray(np.dstack([rgb, rgb[..., :1]]), "RGBA"), "PNG"),
    }
    for name, data in fixtures.forms().items():
        out[os.path.splitext(name)[0]] = data
    return out


FORMS = _forms()


@pytest.fixture(scope="module")
def jax_matchers():
    """The JAX package's matcher library, loaded past a failure that
    another worker's build left cached (as ``native_library`` does)."""
    t0 = time.monotonic()
    while True:
        jnative._load.cache_clear()
        if jnative.available():
            return
        if time.monotonic() - t0 > 120:
            pytest.fail("the JAX package's native/libagenda_native.so did not load")
        time.sleep(0.5)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_decode_is_the_jax_decode_bit_for_bit(native_library, name):  # noqa: F811
    data = FORMS[name]
    assert tni.read_header(data) == jni.read_header(data)
    got = tni.decode(data)
    assert got.dtype == np.uint8 and got.shape[2] == 3
    np.testing.assert_array_equal(got, jni.decode(data))


def test_committed_fixtures_are_the_jax_decode(native_library, tmp_path):  # noqa: F811
    npys = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".npy"))
    assert len(npys) == 8
    for npy in npys:
        stem = npy[:-4]
        path = os.path.join(FIXTURES, stem + (".jpg" if stem.startswith("jpeg") else ".png"))
        with open(path, "rb") as f:
            data = f.read()
        want = np.load(os.path.join(FIXTURES, npy))
        np.testing.assert_array_equal(jni.decode(data), want, err_msg=stem)
        np.testing.assert_array_equal(tni.load_rgb(path), want, err_msg=stem)
        # the extension does not decide: the same bytes under another name
        other = str(tmp_path / (stem + ".bin"))
        with open(other, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(tni.load_rgb(other), want, err_msg=stem)
        assert tni.image_size(other) == (want.shape[1], want.shape[0])
    np.testing.assert_array_equal(np.load(os.path.join(FIXTURES, "png_interlaced.npy")),
                                  fixtures._rgb(2))  # Adam7 put back in place
    tile = os.path.join(FIXTURES, "png_tile_512.png")
    from agenda_tpu_torch.utils.png import read_rgb

    np.testing.assert_array_equal(tni.load_rgb(tile), read_rgb(tile))


def test_host_passes_are_the_jax_passes(native_library):  # noqa: F811
    rng = np.random.RandomState(3)
    for (h, w), (oh, ow) in (((112, 112), (64, 64)), ((37, 53), (64, 64)),
                             ((14, 14), (112, 112)), ((16, 16), (16, 16))):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(tni.resize_bilinear(img, ow, oh),
                                      jni.resize_bilinear(img, ow, oh))
    img = rng.uniform(0, 255, (37, 41, 3)).astype(np.float32)
    img[0, :5] = 128.0
    img[1, :3] = np.eye(3) * 255
    for gains in ((3.0, 20.0, -15.0), (-4.9, -29.0, 29.0), (0.0, 0.0, 0.0), (179.0, 255.0, -255.0)):
        got, want = img.copy(), img.copy()
        assert tni.hsv_jitter_inplace(got, *gains) and jni.hsv_jitter_inplace(want, *gains)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(taug.hsv_apply(img, gains), got)
        ref = taug.hsv_apply_reference(img, gains)  # the numpy formulas: half a level
        assert np.abs(got - ref).max() <= 0.51 and np.abs(got - ref).mean() < 0.01
    q = rng.randint(0, 256, (29, 33, 3), np.uint8)
    for k in (1, 3, 5, 7):
        got = tni.median_blur_u8(q, k)
        np.testing.assert_array_equal(got, jni.median_blur_u8(q, k))
        np.testing.assert_array_equal(got.astype(np.float32), taug.median_blur_reference(q, k))
    with pytest.raises(ValueError, match="must be odd"):
        tni.median_blur_u8(q, 4)


def test_truncated_and_non_images_raise_naming_the_path(tmp_path):
    cases = {"cut.png": FORMS["png_rgb"][: len(FORMS["png_rgb"]) // 2],
             "cut.jpg": FORMS["jpeg_420"][:20],
             "text.png": b"not an image at all\n" * 4,
             "empty.jpg": b""}
    for name, data in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=path):
            tni.load_rgb(path)
    with pytest.raises(ValueError, match=str(tmp_path / "text.png")):
        tni.image_size(str(tmp_path / "text.png"))


def test_without_the_codec_headers_pngs_take_the_stdlib_reader(tmp_path, monkeypatch):
    """A machine without the libpng and libjpeg headers: an 8-bit PNG reads
    through utils/png.py; a JPEG, or a PNG form that reader refuses, raises
    naming the missing library; sizes come from the PNG header."""
    missing = host_build.MissingHeaders("codecs", ("png.h", "jpeglib.h"))
    monkeypatch.setattr(tni, "_codecs_missing", lambda: missing)
    paths = {}
    for name in ("png_rgb", "png_gray", "png_palette", "jpeg_420"):
        paths[name] = str(tmp_path / name)
        with open(paths[name], "wb") as f:
            f.write(FORMS[name])
    np.testing.assert_array_equal(tni.load_rgb(paths["png_rgb"]), jni.decode(FORMS["png_rgb"]))
    np.testing.assert_array_equal(tni.load_rgb(paths["png_gray"]), jni.decode(FORMS["png_gray"]))
    with pytest.raises(ValueError, match="libpng"):
        tni.load_rgb(paths["png_palette"])
    with pytest.raises(ValueError, match="libjpeg"):
        tni.load_rgb(paths["jpeg_420"])
    with pytest.raises(ValueError, match="libjpeg"):
        tni.image_size(paths["jpeg_420"])
    assert tni.image_size(paths["png_palette"]) == (fixtures.W, fixtures.H)
    msg = str(missing)
    assert "libpng (png.h)" in msg and "libjpeg (jpeglib.h)" in msg


def test_host_build_probes_headers_and_raises_with_the_compiler_output(tmp_path, monkeypatch):
    cxx = host_build.find_cxx()
    assert host_build.missing_headers(cxx, ["stdint.h", "no_such_header_1234.h"]) == (
        "no_such_header_1234.h",)
    src = tmp_path / "broken.cc"
    src.write_text("int f( {\n")
    monkeypatch.setattr(host_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(host_build.BuildError, match="broken.cc"):
        host_build._build("broken", host_build.Spec(("broken.cc",)), str(tmp_path / "x.so"))
    assert not os.path.exists(tmp_path / "x.so")
    assert [p for p in os.listdir(tmp_path / "build")] == []  # no temporary left behind
    with pytest.raises(host_build.MissingHeaders, match="no_such_header_1234.h"):
        host_build._build("probe", host_build.Spec(("broken.cc",), headers=(
            "no_such_header_1234.h",)), str(tmp_path / "y.so"))


def test_a_cached_library_that_does_not_load_is_built_again(tmp_path, monkeypatch):
    """A build directory copied from another machine: the cached file does
    not load, so the library is built anew in its place."""
    (tmp_path / "ok.cc").write_text('extern "C" int seven() { return 7; }\n')
    monkeypatch.setattr(host_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    spec = host_build.Spec(("ok.cc",))
    monkeypatch.setitem(host_build.LIBRARIES, "probe", spec)
    os.makedirs(tmp_path / "build")
    out = tmp_path / "build" / f"libagenda_probe_{host_build._digest(spec)}.so"
    out.write_bytes(b"not a shared library")
    host_build._load.cache_clear()
    try:
        lib = host_build.load("probe")
        assert lib.build_seconds > 0 and lib.function("seven", [])() == 7
    finally:
        host_build._load.cache_clear()


def _write_jpeg_set(root, sizes):
    os.makedirs(root)
    rng = np.random.RandomState(8)
    prompts = {}
    for i, (h, w) in enumerate(sizes):
        img = fixtures._rgb(20 + i, h, w)
        Image.fromarray(img).save(os.path.join(root, f"{i}.jpg"), "JPEG", quality=int(
            rng.randint(70, 95)))
        prompts[f"{i}.jpg"] = "an aerial view image with cars"
    with open(os.path.join(root, "train.json"), "w") as f:
        json.dump(prompts, f)


def _tokenizer(prompt):
    return np.zeros(77, np.int64)


def test_base_dataset_reads_a_jpeg_set_as_jax(tmp_path, native_library):  # noqa: F811
    mixed, uniform = str(tmp_path / "mixed"), str(tmp_path / "uniform")
    _write_jpeg_set(mixed, [(40, 48), (48, 40), (37, 53)])
    _write_jpeg_set(uniform, [(40, 48)] * 3)
    tm = tdatasets.BaseDataset(mixed, "train.json", 32, _tokenizer)
    jm = jdatasets.BaseDataset(mixed, "train.json", 32, _tokenizer)
    assert tm.source_size is None
    for i in range(3):
        got, want = tm[i]["pixel_values"], jm[i]["pixel_values"]
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got - want).max() <= LEVEL_TOL * 2 / 255 + 1e-6  # [-1, 1]: a level is 2/255
    tu = tdatasets.BaseDataset(uniform, "train.json", 32, _tokenizer)
    ju = jdatasets.BaseDataset(uniform, "train.json", 32, _tokenizer, device_resize=True)
    assert tu.source_size == ju.source_size == (48, 40)
    for i in range(3):
        np.testing.assert_array_equal(tu[i]["pixel_u8"], ju[i]["pixel_u8"])


def test_coco_dataset_reads_jpeg_tiles_as_jax_load_rgb(tmp_path, native_library):  # noqa: F811
    root = str(tmp_path / "coco")
    _write_jpeg_set(os.path.join(root, "images"), [(64, 64), (64, 64), (48, 64)])
    images = [{"id": i, "file_name": f"{i}.jpg", "width": 64, "height": 64} for i in range(3)]
    anns = [{"id": 0, "image_id": 0, "category_id": 1, "bbox": [4, 4, 20, 20], "area": 400,
             "iscrowd": 0}]
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "small"}]}, f)
    ds = CocoDetDataset(root, "ann.json", img_scale=(64, 64), max_gt=8)
    for i in range(3):
        path = os.path.join(root, "images", f"{i}.jpg")
        np.testing.assert_array_equal(ds._decode(i), jni.load_rgb(path))


def _box_sets(rng):
    """(preds, gts) pairs: random integer boxes (ties and exact IoUs), empty
    sets, duplicates, and pairs built at IoU exactly 0.5."""
    def boxes(n):
        xy = rng.randint(0, 12, (n, 2))
        wh = rng.randint(1, 6, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float64)

    sets = [(boxes(0), boxes(0)), (boxes(5), boxes(0)), (boxes(0), boxes(4))]
    for _ in range(40):
        sets.append((boxes(rng.randint(1, 14)), boxes(rng.randint(1, 7))))
    gt = np.array([[0, 0, 2, 1], [4, 4, 8, 8]], np.float64)
    at_half = np.array([[0, 0, 1, 1], [0, 0, 1, 1], [4, 4, 8, 6], [4, 4, 8, 8]], np.float64)
    sets.append((at_half, gt))  # IoUs 0.5, 0.5 (a tie), 0.5 and 1.0
    return sets


def test_matchers_equal_numpy_and_the_jax_library(jax_matchers):
    rng = np.random.RandomState(11)
    thrs = jcoco.IOU_THRS
    for preds, gts in _box_sets(rng):
        n = len(preds)
        got = tnative.match_image_greedy(preds, gts, thrs)
        assert got.shape == (len(thrs), n)
        np.testing.assert_array_equal(got, jnative.match_image_greedy(preds, gts, thrs))
        np.testing.assert_array_equal(
            got, tcoco._match_image(preds, -np.arange(n, dtype=np.float64), gts, thrs, n))
        for thr in (0.5, 0.3, 0.75):
            got = tnative.match_first_greedy(preds, gts, thr)
            np.testing.assert_array_equal(got, jnative.match_first_greedy(preds, gts, thr))
            np.testing.assert_array_equal(got, tnative.match_first_greedy_reference(preds, gts,
                                                                                    thr))
            got = tnative.match_per_gt_greedy(preds, gts, thr)
            np.testing.assert_array_equal(got, jnative.match_per_gt_greedy(preds, gts, thr))
            np.testing.assert_array_equal(got, tthreshold.match_per_gt_reference(preds, gts, thr))
            for keep in (1, 3, 100):
                got = tnative.nms_sorted(preds, thr, keep)
                np.testing.assert_array_equal(got, jnative.nms_sorted(preds, thr, keep))
                np.testing.assert_array_equal(got, tnative.nms_sorted_reference(preds, thr, keep))
    at_half, gt = _box_sets(rng)[-1]  # an IoU of exactly 0.5 matches; the first pred wins
    assert tnative.match_per_gt_greedy(at_half, gt, 0.5).tolist() == [True, False, True, False]
    assert tnative.match_first_greedy(at_half, gt, 0.5).tolist() == [True, False, True, False]
    assert tnative.match_image_greedy(at_half, gt, [0.5]).tolist() == [[True, False, True, False]]


def test_coco_map_and_threshold_matching_equal_jax(jax_matchers):
    rng = np.random.RandomState(12)
    sets = _box_sets(rng)
    scores = [rng.choice([0.9, 0.5, 0.5, 0.2], len(p)) for p, _ in sets]  # tied scores
    gts, dets = [g for _, g in sets], [p for p, _ in sets]
    assert tcoco.coco_map(gts, dets, scores) == jcoco.coco_map(gts, dets, scores)
    records = [{"gt_instances": {"bboxes": g}, "pred_instances": {"bboxes": p, "scores": s}}
               for (p, g), s in zip(sets, scores)]
    for got, want in zip(tthreshold.match_predictions(records),
                         jthreshold.match_predictions(records)):
        np.testing.assert_array_equal(got, want)
