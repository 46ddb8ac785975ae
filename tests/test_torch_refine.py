"""Parity of the port's refine classifier (agenda_tpu_torch) with agenda_tpu.

Both packages run on the CPU in f32 on the same seeded inputs:

- ResNet-50 through ``resnet_from_flax``: with ``stage_sizes=(1,1,1,1)``
  at batch 4 (64 px, and 61 px where the paddings' edges fall otherwise),
  the eval logits, the train-mode logits and the new batch statistics; the
  full (3,4,6,3) at batch 2, 64 px, the eval logits; the ``features=True``
  pyramid; ``resnet_to_flax`` inverts ``resnet_from_flax`` key for key;
- one classifier step (6 real rows padded to 8) from the same weights: the
  loss, the batch statistics and the parameters after Adam;
- the crops: Pillow's ``crop`` and default (BICUBIC) ``resize`` bit for
  bit at every crop size that ``complete_edge_boxes`` gives at 112x112,
  resized to 224 and to 64; ``construct_data``'s buckets, COCO dicts and
  crops equal the JAX package's;
- the rng stream: three epochs of flip draws and batch orders equal the
  JAX CLI's, and the port's ``CropFeed`` batches equal its
  ``crops_to_array`` rows bit for bit.

The two CLIs are compared in ``test_torch_refine_cli.py``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from PIL import Image

from agenda_tpu.annotate import classifier as jclf
from agenda_tpu.annotate import refine as jrefine
from agenda_tpu.models.resnet import ResNet50 as JaxResNet50
from agenda_tpu_torch.annotate import classifier as clf
from agenda_tpu_torch.annotate import refine
from agenda_tpu_torch.annotate.boxes import complete_edge_boxes
from agenda_tpu_torch.models.resnet import ResNet50, resnet_from_flax, resnet_to_flax
from agenda_tpu_torch.utils.png import write_png

# f32 logits of XLA's and oneDNN's convolutions through 17-53 layers of
# batch norm at unit-scale activations: 1e-4 of their rms in eval mode. In
# train mode the 4x4 and 2x2 levels of a batch of 4 normalise over 16-64
# values a channel, which amplifies the rounding noise: 1e-3.
EVAL_TOL_RMS, TRAIN_TOL_RMS = 1e-4, 1e-3
STATS_TOL = 1e-5  # new running statistics (0.9 old + 0.1 batch), absolute, at O(1) values
FEAT_TOL_RMS = 1e-4
# One classifier step runs in float64 on both sides: at f32 each package's
# gradients lie up to 0.32 of their rms from its own float64 ones at this
# init (train-mode batch norm over the padded batch), so f32 against f32
# would compare rounding; in float64 the two agree to 2.5e-6 of the rms.
# Adam's first update is lr g / (|g| + eps): the parameters then agree to a
# small share of lr except where |g| is near eps (counted and reported).
LR = 4e-4
STEP_TOL_LR = 1e-4  # |p_port - p_jax| <= 1e-4 lr where |g| >= NEAR_EPS
NEAR_EPS = 1e-6
LOSS_RTOL = 1e-6  # the BCE runs in f32 on both sides, on the f64 logits cast to f32
STEP_STATS_TOL = 1e-10  # float64 running statistics, absolute


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores, where torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_flat_from_numpy(model: JaxResNet50, size: int, seed: int) -> dict:
    """Seeded numpy weights in the JAX checkpoint's flat layout, shaped by
    ``jax.eval_shape`` (no JAX init): lecun-scaled kernels, batch-norm
    scale/bias and running statistics drawn away from 1 and 0."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(seed)
    flat = {}
    for col in ("params", "batch_stats"):
        for path, s in traverse_util.flatten_dict(shapes[col]).items():
            leaf, shape = path[-1], s.shape
            if leaf == "kernel":
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            elif leaf == "scale":
                v = rng.uniform(0.5, 1.5, shape)
            elif leaf == "bias" or leaf == "mean":
                v = rng.uniform(-0.2, 0.2, shape)
            else:  # var
                v = rng.uniform(0.5, 1.5, shape)
            flat[".".join((col,) + path)] = v.astype(np.float32)
    return flat


def flax_variables(flat: dict) -> dict:
    nested = traverse_util.unflatten_dict({tuple(k.split(".")): jnp.asarray(v)
                                           for k, v in flat.items()})
    return {"params": nested["params"], "batch_stats": nested["batch_stats"]}


def port_model(flat: dict, stage_sizes=(3, 4, 6, 3)) -> ResNet50:
    model = ResNet50(num_classes=1, stage_sizes=stage_sizes)
    missing, unexpected = model.load_state_dict(resnet_from_flax(flat), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.sqrt(np.mean(want ** 2)))


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size", [64, 61])
def test_small_resnet_matches_jax_eval_and_train(size):
    jm = JaxResNet50(num_classes=1, stage_sizes=(1, 1, 1, 1))
    flat = flax_flat_from_numpy(jm, size, seed=size)
    variables = flax_variables(flat)
    x = np.random.default_rng(1).standard_normal((4, size, size, 3)).astype(np.float32)
    model = port_model(flat, (1, 1, 1, 1))

    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(nchw(x)).numpy()
    assert rel_rms(got, want) <= EVAL_TOL_RMS, rel_rms(got, want)

    want_t, state = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_t = model.train()(nchw(x)).numpy()
    assert rel_rms(got_t, want_t) <= TRAIN_TOL_RMS, rel_rms(got_t, want_t)
    new_stats = {".".join(("batch_stats",) + k): np.asarray(v) for k, v in
                 traverse_util.flatten_dict(state["batch_stats"]).items()}
    port_stats = resnet_to_flax(model.state_dict())
    assert set(new_stats) <= set(port_stats)
    worst = max(float(np.abs(port_stats[k] - v).max()) for k, v in new_stats.items())
    assert worst <= STATS_TOL, worst


def test_full_resnet50_matches_jax_eval():
    jm = JaxResNet50(num_classes=1)
    flat = flax_flat_from_numpy(jm, 64, seed=3)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(flax_variables(flat), jnp.asarray(x), train=False))
    model = port_model(flat)
    assert len(model.state_dict()) == 320  # torchvision's resnet50 keys
    with torch.no_grad():
        got = model.eval()(nchw(x)).numpy()
    assert got.shape == (2, 1) and got.dtype == np.float32
    assert rel_rms(got, want) <= EVAL_TOL_RMS, rel_rms(got, want)


def test_feature_pyramid_matches_jax():
    jm = JaxResNet50(num_classes=1, stage_sizes=(1, 1, 1, 1))
    flat = flax_flat_from_numpy(jm, 64, seed=4)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jm.apply(flax_variables(flat), jnp.asarray(x), train=False, features=True)
    with torch.no_grad():
        got = port_model(flat, (1, 1, 1, 1)).eval()(nchw(x), features=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.permute(0, 2, 3, 1).shape) == w.shape
        assert rel_rms(g.permute(0, 2, 3, 1).numpy(), w) <= FEAT_TOL_RMS


def test_resnet_flax_keys_round_trip():
    jm = JaxResNet50(num_classes=1)
    flat = flax_flat_from_numpy(jm, 32, seed=5)
    back = resnet_to_flax(port_model(flat).state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="unexpected"):
        resnet_from_flax({"params.fc.weight": np.zeros((1, 2), np.float32)})


def test_classifier_step_matches_jax():
    """One step in float64, 6 real rows padded to 8 with copies of row 0,
    from the same weights: the loss, the new batch statistics (the pad rows
    move them in both), the parameters after Adam within 1e-4 lr where
    |g| >= 1e-6, and every parameter moved by at most lr."""
    size = 64
    jm = JaxResNet50(num_classes=1, stage_sizes=(1, 1, 1, 1), dtype=jnp.float64)
    flat = flax_flat_from_numpy(JaxResNet50(num_classes=1, stage_sizes=(1, 1, 1, 1)), size, 6)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (6, size, size, 3))
    y = np.array([1, 0, 1, 1, 0, 0], np.int32)
    images, labels, mask, bb = next(jclf.batches_padded(x, y, 8, False, rng))
    assert list(bb) == [0, 1, 2, 3, 4, 5, 0, 0]

    with jax.enable_x64(True):
        variables = {col: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
                     for col, tree in flax_variables(flat).items()}
        tx = optax.adam(LR)
        state = jclf.ClassifierState(variables["params"], variables["batch_stats"],
                                     tx.init(variables["params"]), jnp.zeros((), jnp.int32))
        new_state, jloss = jclf.make_classifier_train_step(jm, tx)(
            state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask))
        grads = {".".join(("params",) + k): np.asarray(v) / 0.1 for k, v in  # mu = 0.1 g
                 traverse_util.flatten_dict(new_state.opt_state[0].mu).items()}
        jflat = {".".join((col,) + k): np.asarray(v) for col, tree in
                 (("params", new_state.params), ("batch_stats", new_state.batch_stats))
                 for k, v in traverse_util.flatten_dict(tree).items()}
        jloss = float(jloss)

    model = port_model(flat, (1, 1, 1, 1)).double()
    ptx = clf.make_adam(LR)
    opt_state = ptx.init(dict(model.named_parameters()))
    pstep = clf.make_classifier_train_step(model, ptx, torch.float64)
    ploss = float(pstep(opt_state, torch.from_numpy(images), torch.from_numpy(labels).double(),
                        torch.from_numpy(mask).double()))
    assert abs(ploss - jloss) <= LOSS_RTOL * abs(jloss), (ploss, jloss)
    pflat = resnet_to_flax(model.state_dict())
    assert set(pflat) == set(jflat)

    near_eps, worst = 0, 0.0
    for k, want in jflat.items():
        got = pflat[k]
        if k.startswith("batch_stats"):
            assert np.abs(got - want).max() <= STEP_STATS_TOL, k
            continue
        ok = np.abs(grads[k]) >= NEAR_EPS
        near_eps += int((~ok).sum())
        if ok.any():
            worst = max(worst, float(np.abs(got - want)[ok].max()) / LR)
        assert np.all(np.abs(got - flat[k]) <= 1.0001 * LR), k  # one Adam step moves <= lr
    n = sum(v.size for k, v in jflat.items() if k.startswith("params"))
    print(f"params within {worst:.2e} lr where |g| >= {NEAR_EPS}; "
          f"{near_eps} of {n} elements have |g| < {NEAR_EPS}")
    assert worst <= STEP_TOL_LR
    assert near_eps <= 0.01 * n


def sweep_boxes() -> np.ndarray:
    """Detector-style boxes (42.36-px squares, clipped to the image) whose
    centres sweep 112x112 in half-pixel steps, the edges and corners too."""
    c = np.arange(-8.0, 120.0, 0.5)
    xc, yc = np.meshgrid(c, c)
    xc, yc = xc.ravel(), yc.ravel()
    half = 42.36 / 2
    return np.clip(np.stack([xc - half, yc - half, xc + half, yc + half], 1), 0, 112)


def test_crops_and_resize_equal_pillow_bit_for_bit():
    rgb = np.random.default_rng(8).integers(0, 256, (112, 112, 3), dtype=np.uint8)
    pil = Image.fromarray(rgb)
    full = complete_edge_boxes(sweep_boxes(), (112, 112), 42.36, mode="extend")
    r = np.round(full).astype(int)  # half to even, as Python's round
    _, first = np.unique(np.stack([r[:, 3] - r[:, 1], r[:, 2] - r[:, 0]], 1), axis=0,
                         return_index=True)
    assert len(first) > 100, len(first)  # the edges give many sizes
    differ = []
    for i in first:
        box = tuple(float(v) for v in full[i])
        crop = refine.crop_pil(rgb, box)
        want = pil.crop(box)
        if not np.array_equal(crop, np.asarray(want)):
            differ.append((box, "crop"))
        for size in (224, 64):
            if not np.array_equal(refine.resize_crops([crop], size)[0],
                                  np.asarray(want.resize((size, size)))):
                differ.append((box, size))
    assert not differ, differ[:5]


def test_degenerate_boxes_behave_as_pillow():
    """A box with right < left (or lower < upper) raises as Pillow's crop
    does: the reference's refine_label stops there too (edge completion
    inverts a detector box that ends left of the image). A box that rounds
    to zero width crops empty and resizes to zeros, as Pillow's does."""
    rgb = np.random.default_rng(9).integers(0, 256, (112, 112, 3), dtype=np.uint8)
    pil = Image.fromarray(rgb)
    for box in [(0.0, 55.64, -27.66, 98.0), (10.0, 111.64, 52.36, 111.0)]:
        with pytest.raises(ValueError) as want:
            pil.crop(box)
        with pytest.raises(ValueError) as got:
            refine.crop_pil(rgb, box)
        assert str(got.value) == str(want.value)
    for box in [(10.2, 5.0, 10.4, 50.0), (3.0, 7.6, 40.0, 8.4), (111.6, 0.0, 111.8, 42.0)]:
        want = pil.crop(box)
        crop = refine.crop_pil(rgb, box)
        assert crop.shape == np.asarray(want).shape and crop.size == 0
        np.testing.assert_array_equal(refine.resize_crops([crop, crop], 64),
                                      np.stack([np.asarray(want.resize((64, 64)))] * 2))


def write_refine_set(root: str, n_images: int = 12, size: int = 112, seed: int = 0):
    """``n_images`` random RGB PNGs and a prediction pkl whose scores fill
    every bucket (top-1, >= pos, < neg, the band, < hard-neg) with boxes in
    the middle, on the edges and in the corners."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    records = []
    for i in range(n_images):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        write_png(os.path.join(img_dir, f"{i}.png"), img)
        n = 7
        xc = rng.uniform(-5, size + 5, n)
        yc = rng.uniform(-5, size + 5, n)
        boxes = np.clip(np.stack([xc - 21.18, yc - 21.18, xc + 21.18, yc + 21.18], 1), 0, size)
        scores = np.sort(np.array([0.95, rng.uniform(0.75, 0.9), rng.uniform(0.4, 0.7),
                                   rng.uniform(0.4, 0.7), rng.uniform(0.05, 0.3),
                                   rng.uniform(0.06, 0.34), 0.01]))[::-1]
        records.append({"img_path": f"some/where/{i}.png",
                        "pred_instances": {"bboxes": boxes.astype(np.float32),
                                           "scores": scores.astype(np.float32),
                                           "labels": np.zeros(n, np.int64)}})
    records.append({"img_path": "some/where/0.png", "pred_instances": {
        "bboxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
        "labels": np.zeros(0, np.int64)}})
    pkl = os.path.join(root, "pred.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(records, f)
    return img_dir, pkl, records


def test_construct_data_matches_jax(tmp_path):
    img_dir, _, records = write_refine_set(str(tmp_path))
    want = jrefine.construct_data(records, 0.75, 0.35, 0.05, rgb_image_base_path=img_dir)
    got = refine.construct_data(records, 0.75, 0.35, 0.05, rgb_image_base_path=img_dir)
    assert got.train_labels == want.train_labels
    assert 0 < sum(got.train_labels) < len(got.train_labels) and got.test_crops
    assert got.annotations_coco == want.annotations_coco
    assert got.test_anns == want.test_anns
    for ours, theirs in ((got.train_crops, want.train_crops), (got.test_crops, want.test_crops)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(refine.crops_to_array(got.train_crops, 32),
                                  jrefine.crops_to_array(want.train_crops, 32))
    pos = [a["id"] for a in got.test_anns[::2]]
    assert (refine.append_positive_test_annotations(got.annotations_coco, got.test_anns, pos)
            == jrefine.append_positive_test_annotations(want.annotations_coco,
                                                        want.test_anns, pos))
    preds = np.random.default_rng(0).integers(0, 2, 50)
    labels = np.random.default_rng(1).integers(0, 2, 50)
    assert refine.macro_f1_binary(preds, labels) == jrefine.macro_f1_binary(preds, labels)


def test_rng_stream_and_feed_equal_the_jax_cli(tmp_path):
    """Three epochs as the JAX CLI draws them (a flip a crop inside
    ``crops_to_array``, then ``batches_padded``'s shuffle) and as the port
    draws them (``rng.random(N)``, then ``padded_index_batches``): the same
    batch orders, and the feed's batches equal the JAX arrays' rows bit for
    bit, pad rows included."""
    img_dir, _, records = write_refine_set(str(tmp_path))
    jdata = jrefine.construct_data(records, 0.75, 0.35, 0.05, rgb_image_base_path=img_dir)
    data = refine.construct_data(records, 0.75, 0.35, 0.05, rgb_image_base_path=img_dir)
    n, bs, size = len(data.train_crops), 8, 32
    y = np.asarray(data.train_labels, np.int32)
    feed = clf.CropFeed(refine.resize_crops(data.train_crops, size), torch.device("cpu"))
    rng_j, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        aug = jrefine.crops_to_array(jdata.train_crops, size, hflip_rng=rng_j)
        jbatches = list(jclf.batches_padded(aug, y, bs, True, rng_j))
        feed.set_flips(rng_p.random(n) < 0.5)
        pbatches = list(clf.padded_index_batches(n, bs, True, rng_p))
        assert len(jbatches) == len(pbatches) == -(-n // bs)
        for (imgs, labels, mask, bb), (pb, real) in zip(jbatches, pbatches):
            np.testing.assert_array_equal(pb, bb)
            np.testing.assert_array_equal(mask, (np.arange(bs) < real).astype(np.float32))
            x, rows = feed.batch(pb)
            np.testing.assert_array_equal(x.numpy(), imgs)
            np.testing.assert_array_equal(y[rows.numpy()], labels)
    assert rng_j.random() == rng_p.random()  # the streams end in the same place
