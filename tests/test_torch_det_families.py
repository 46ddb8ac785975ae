"""Parity of the port's Faster R-CNN, YOLOv5 and ViTDet (and their box ops,
assigners and AdamW) with agenda_tpu, on the CPU.

Both packages run the same numpy-seeded weights and batch at the JAX tests'
tiny sizes (``tests/test_detect.py``): Faster R-CNN at 64 px with nms_pre
256, 64 proposals and 64 RPN and RCNN samples; YOLOv5s at 64 px; ViTDet
64 wide, 2 blocks of 2 heads, windows of 2 on block 0, drop path 0. The
samplers' uniforms are the JAX package's own draws from the keys its loss
splits (rpn/rcnn(/drop path), then one key an image, then positives and
negatives), passed to the port.

Tolerances:

- box codecs and anchors: 1e-6 absolute at pixel-sized values (f32 rounding
  of the same formula); ``grid_anchors`` equal;
- RoIAlign: ROI_TOL_RMS of the output's rms, ROI_GRAD_TOL_RMS of the
  gradient's (the port sums the same weights on the same texels in another
  order, as two small matrix products; a texel's gradient sums up to a few
  hundred samples: 5.7e-6 of the rms was read);
- assigners: equal (the same comparisons on the same IoUs);
- every family's train step runs in float64 on both sides: a fresh
  ResNet-50 in train mode is chaotic in f32 (``tests/test_torch_refine.py``);
  YOLOv5s's 2x2 level normalises over 8 values a channel in train mode at
  batch 2 (f32 readings of 1.7e-2 of the rms, where YOLOv8n's test allows
  1.5e-2 at batch 4); ViTDet's box head sums its first convolution's
  kernel gradient with heavy cancellation (the port's f32 reading lies
  6e-2 of the rms from its own float64 one, the JAX package's 6e-6:
  summation order). The heads return f32 in both packages, so the loss
  agrees to STEP64_LOSS_RTOL and the gradients to STEP64_GRAD_TOL_RMS of
  each tensor's rms; the new batch statistics to STATS_TOL;
- the forward on calibrated weights: FWD_TOL_RMS of each output's rms;
  prediction: the same valid slots, boxes within BOX_TOL px and scores
  within SCORE_TOL, matched one to one (the RPN's largest anchors are 512
  px, so a delta's 1e-5 difference moves a proposal's edge by a few
  thousandths of a pixel: 2.9e-3 px was read);
- AdamW with layer decay: ADAMW_TOL over five steps against the optax chain.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agenda_tpu.detect import assign as jassign
from agenda_tpu.detect import ops as jops
from agenda_tpu.detect.families import build_family as jax_build_family
from agenda_tpu.detect.faster_rcnn import FasterRCNN as JaxFasterRCNN
from agenda_tpu.detect.yolov5 import YOLOv5 as JaxYOLOv5
from agenda_tpu.detect.runner import RunnerConfig as JaxRunnerConfig
from agenda_tpu.detect.runner import make_optimizer as jax_make_optimizer
from agenda_tpu.io.diffusers_io import _flatten, _nest
from agenda_tpu_torch.detect import assign, ops
from agenda_tpu_torch.detect.fabricate import calibrate_batch_norm
from agenda_tpu_torch.detect.families import build_family
from agenda_tpu_torch.detect.optim import DetectorAdamW, layer_decay_scale
from agenda_tpu_torch.detect.runner import RunnerConfig
from agenda_tpu_torch.detect.vitdet import drop_path
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

IMG, MAX_GT, B = 64, 8, 2
FRCNN = dict(img_size=IMG, max_gt=MAX_GT, nms_pre=256, num_proposals=64, rpn_sample=64,
             rcnn_sample=64)
YOLOV5S = dict(img_size=IMG, max_gt=MAX_GT)
VITDET = dict(img_size=IMG, max_gt=MAX_GT, embed_dim=64, vit_depth=2, vit_heads=2, window_size=2,
              window_block_indexes=(0,), drop_path_rate=0.0, nms_pre=128, num_proposals=32,
              rpn_sample=32, rcnn_sample=32)
CODEC_TOL = 1e-6
ROI_TOL_RMS, ROI_GRAD_TOL_RMS = 1e-6, 2e-5
STEP64_LOSS_RTOL, STEP64_GRAD_TOL_RMS = 1e-6, 1e-5
STATS_TOL = 1e-5
FWD_TOL_RMS = 1e-4
BOX_TOL, SCORE_TOL = 1e-2, 1e-4
ADAMW_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six files at once on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _boxes(rng, n):
    """n random boxes (12-32 px) inside the image, xyxy."""
    wh = rng.uniform(12, 32, (n, 2))
    xy = rng.uniform(0, IMG - wh)
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _batch(seed=0):
    """Noise with bright rectangles on the GT boxes; 1-3 valid GT of MAX_GT."""
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 0.3, (B, IMG, IMG, 3)).astype(np.float32)
    gt = np.zeros((B, MAX_GT, 4), np.float32)
    valid = np.zeros((B, MAX_GT), bool)
    for i in range(B):
        n = int(rng.integers(1, 4))
        gt[i, :n] = _boxes(rng, n)
        valid[i, :n] = True
        for x1, y1, x2, y2 in gt[i, :n].astype(int):
            image[i, y1:y2, x1:x2] = rng.uniform(0.6, 1.0, 3)
    return {"image": image, "gt_boxes": gt, "gt_valid": valid}


def _numpy_weights(jvars, seed):
    """Every leaf of ``jvars`` drawn from numpy: kernels N(0, 1/fan_in),
    biases and the rel-pos tables N(0, 0.1^2), norms 1 + N(0, 0.1^2),
    pos_embed N(0, 0.02^2), means N(0, 0.1^2), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in jvars.items():
        for path, v in _flatten(tree).items():
            leaf, shape = path[-1], tuple(v.shape)
            if leaf == "kernel":
                a = rng.normal(0, 1, shape) / math.sqrt(np.prod(shape[:-1]))
            elif leaf == "scale":
                a = 1 + 0.1 * rng.normal(0, 1, shape)
            elif leaf == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif leaf == "pos_embed":
                a = 0.02 * rng.normal(0, 1, shape)
            else:
                a = 0.1 * rng.normal(0, 1, shape)
            out[f"{col}." + ".".join(path)] = a.astype(np.float32)
    return out


def _jax_vars(flat, dtype=np.float32):
    cols = {}
    for k, v in flat.items():
        col, rest = k.split(".", 1)
        cols.setdefault(col, {})[tuple(rest.split("."))] = jnp.asarray(np.asarray(v, dtype))
    return {col: _nest(d) for col, d in cols.items()}


def _families(name, model):
    jfam = jax_build_family(name, model=dict(model))
    fam = build_family(name, model=dict(model))
    return jfam, fam


def _weights(jfam, fam, seed=0, calibrate=False):
    """Numpy-seeded weights as (flax flat, port state_dict); ``calibrate``
    measures the batch-norm statistics on noise (the port's fabricator), so
    the eval-mode heads see the image."""
    shapes = jax.eval_shape(jfam.init_variables, jax.random.key(0))  # traced, not run
    flat = _numpy_weights(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), seed)
    state = fam.from_flax(flat)
    if calibrate:
        noise = torch.from_numpy(np.random.default_rng(seed + 1).uniform(
            0, 1, (8, IMG, IMG, 3)).astype(np.float32))
        state = calibrate_batch_norm(fam, state, noise)
        flat = fam.to_flax(state)
    return flat, state


def _unsaturated(fam, flat, kernels):
    """The calibrated trunks feed the score layers activations of a few
    units, and N(0, 1/fan_in) kernels there put logits past 17, where every
    score rounds to 1.0 in f32 and NMS turns on ties, in either package:
    those kernels a hundredth of that (scores up to 0.97 here)."""
    flat = dict(flat)
    for k in kernels:
        flat[k] = flat[k] * 0.01
    return flat, fam.from_flax(flat)


def _two_stage_draws(rng_key, n_anchors, n_rois, three: bool):
    """The uniforms the JAX two-stage loss draws, in the port's keys."""
    keys = jax.random.split(rng_key, 3) if three else jax.random.split(rng_key)

    def per_image(k, n):
        def one(key):
            k_pos, k_neg = jax.random.split(key)
            return jax.random.uniform(k_pos, (n,)), jax.random.uniform(k_neg, (n,))
        pos, neg = jax.vmap(one)(jax.random.split(k, B))
        return _t(np.asarray(pos)), _t(np.asarray(neg))

    rpn_pos, rpn_neg = per_image(keys[0], n_anchors)
    rcnn_pos, rcnn_neg = per_image(keys[1], n_rois)
    return {"rpn_pos": rpn_pos, "rpn_neg": rpn_neg, "rcnn_pos": rcnn_pos, "rcnn_neg": rcnn_neg}


def _port_step(fam, state, batch, dtype, draws=None):
    """The port's loss, its parts, its gradients (flax names) and new stats."""
    state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    params = {k: state[k].clone().requires_grad_(True) for k in fam.param_names}
    tb = {"image": _t(batch["image"], dtype), "gt_boxes": _t(batch["gt_boxes"]),
          "gt_valid": _t(batch["gt_valid"])}
    variables = {**state, **params}
    if draws is None:
        loss, parts, stats = fam.loss_fn(variables, tb)
    else:
        loss, parts, stats = fam.loss_with_draws(variables, tb, draws)
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    return (float(loss), {k: float(v) for k, v in parts.items()}, fam.to_flax(grads),
            fam.to_flax({**{k: v.detach() for k, v in stats.items()}}))


def _jax_step(jfam, flat, batch, rng):
    jv = _jax_vars(flat, np.asarray(0.0, jnp.zeros(()).dtype).dtype)

    def lf(p):
        loss, (metrics, bs) = jfam.loss_fn({"params": p, "batch_stats": jv.get("batch_stats", {})},
                                           {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        return loss, (metrics, bs)

    (loss, (metrics, bs)), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(jv["params"])
    g = {"params." + ".".join(k): np.asarray(v) for k, v in _flatten(grads).items()}
    s = {"batch_stats." + ".".join(k): np.asarray(v) for k, v in _flatten(bs).items()}
    return float(loss), {k: float(v) for k, v in metrics.items()}, g, s


def _compare_step(port, want, loss_rtol, grad_tol, parts):
    loss, got_parts, grads, stats = port
    jloss, jparts, jgrads, jstats = want
    assert abs(loss - jloss) <= loss_rtol * abs(jloss), (loss, jloss)
    for k in parts:
        assert abs(got_parts[k] - jparts[k]) <= loss_rtol * max(abs(jparts[k]), 1e-3), \
            (k, got_parts[k], jparts[k])
    assert set(grads) == set(jgrads)
    worst = max((_rel(grads[k], jgrads[k]), k) for k in jgrads if np.any(jgrads[k]))
    assert worst[0] <= grad_tol, worst
    assert set(stats) == set(jstats)
    for k in jstats:
        assert np.abs(stats[k] - jstats[k]).max() <= STATS_TOL, k


def _assert_same_detections(got, want):
    (boxes, scores, valid), (jb, js, jvalid) = got, want
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert int(valid.sum()) > 0
    for i in range(valid.shape[0]):
        keep = valid[i].numpy()
        b, s = boxes[i].numpy()[keep], scores[i].numpy()[keep]
        wb, ws = np.asarray(jb)[i][keep], np.asarray(js)[i][keep]
        free = np.ones(len(ws), bool)
        for bb, ss in zip(b, s):
            hit = free & (np.abs(ws - ss) <= SCORE_TOL) & (np.abs(wb - bb).max(axis=1) <= BOX_TOL)
            assert hit.any(), f"no match for {bb} ({ss})"
            free[np.argmax(hit)] = False


# ---------------------------------------------------------------------------
# box ops and assigners
# ---------------------------------------------------------------------------


def test_box_codecs_and_anchors_match_jax():
    rng = np.random.default_rng(0)
    anchors, gt = _boxes(rng, 64), _boxes(rng, 64)
    gt[:4, 2:] = gt[:4, :2]  # degenerate boxes: the 1e-4 clamps
    stds = (0.1, 0.1, 0.2, 0.2)
    got = ops.encode_deltas(_t(anchors), _t(gt), stds=stds).numpy()
    want = np.asarray(jops.encode_deltas(anchors, gt, stds=stds))
    assert np.abs(got - want).max() <= CODEC_TOL * 1e4  # log(1e-4 / w) of the degenerate
    np.testing.assert_allclose(got[4:], want[4:], atol=CODEC_TOL, rtol=0)
    deltas = rng.normal(0, 2, (64, 4)).astype(np.float32)  # some beyond wh_ratio_clip
    for kw in ({}, {"max_shape": (IMG, IMG), "stds": stds}):
        got = ops.decode_deltas(_t(anchors), _t(deltas), **kw).numpy()
        want = np.asarray(jops.decode_deltas(anchors, deltas, **kw))
        assert np.abs(got - want).max() <= CODEC_TOL * max(1.0, np.abs(want).max())
    for args in (((16, 16), 4, (8.0,), (0.5, 1.0, 2.0)), ((3, 5), 16, (4.0, 8.0), (1.0,), 0.5)):
        np.testing.assert_array_equal(ops.grid_anchors(*args), jops.grid_anchors(*args))


def test_roi_align_and_its_gradient_match_jax():
    """Two images' 16-px P2 maps, RoIs partly outside the map and tiny ones."""
    rng = np.random.default_rng(1)
    feats = rng.normal(0, 1, (2, 16, 16, 8)).astype(np.float32)
    rois = np.concatenate([_boxes(rng, 6), np.asarray([[-8, -8, 20, 20], [60, 60, 80, 90],
                                                       [10, 10, 10.0005, 30]], np.float32)])
    rois = np.stack([rois, rois[::-1]]) / 4.0
    cot = rng.normal(0, 1, (2, 9, 7, 7, 8)).astype(np.float32)

    def jfn(f):
        out = jax.vmap(lambda f1, r: jops.roi_align(f1, r, 7))(f, rois)
        return jnp.sum(out * cot), out

    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(feats)
    f = _t(feats).requires_grad_(True)
    got = ops.roi_align(f, _t(rois), 7)
    (grad,) = torch.autograd.grad((got * _t(cot)).sum(), [f])
    assert _rel(got.detach().numpy(), want) <= ROI_TOL_RMS
    assert _rel(grad.numpy(), jgrad) <= ROI_GRAD_TOL_RMS


def test_max_iou_assign_matches_jax_and_rescues_in_gt_order():
    rng = np.random.default_rng(2)
    anchors = _boxes(rng, 200)
    gt = np.stack([_boxes(rng, MAX_GT) for _ in range(3)])
    valid = rng.uniform(size=(3, MAX_GT)) < 0.7
    # image 2: GT 1 and 3 share their best anchor; the later one keeps it
    gt[2, 1] = anchors[5] + np.asarray([0, 0, 3, 3], np.float32)
    gt[2, 3] = anchors[5] + np.asarray([0, 0, 4, 4], np.float32)
    valid[2, [1, 3]] = True
    for pos, neg, mpi in ((0.7, 0.3, 0.3), (0.5, 0.5, 1.1)):
        got_a, got_l = assign.max_iou_assign(_t(anchors), _t(gt), _t(valid), pos, neg, mpi)
        for i in range(3):
            want_a, want_l = jassign.max_iou_assign(anchors, gt[i], valid[i], pos, neg, mpi)
            np.testing.assert_array_equal(got_a[i].numpy(), np.asarray(want_a))
            np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(want_l))
    # two GT boxes whose best anchor is anchor 0: the later GT keeps it
    anchors = np.asarray([[0, 0, 10, 10], [40, 40, 50, 50], [20, 0, 30, 10]], np.float32)
    gt = np.asarray([[[0, 0, 10, 12], [40, 40, 52, 52], [0, 0, 12, 10], [0, 0, 1, 1]]],
                    np.float32)
    valid = np.asarray([[True, True, True, False]])
    got_a, got_l = assign.max_iou_assign(_t(anchors), _t(gt), _t(valid), 0.99, 0.01, 0.0)
    want_a, want_l = jassign.max_iou_assign(anchors, gt[0], valid[0], 0.99, 0.01, 0.0)
    np.testing.assert_array_equal(got_a[0].numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_l[0].numpy(), np.asarray(want_l))
    assert got_a[0].tolist() == [2, 1, -1] and got_l[0].tolist() == [1, 1, 0]


def test_random_sample_matches_jax_on_its_draws():
    rng = np.random.default_rng(3)
    n = 300
    for n_pos in (3, 100):  # positives scarce (negatives top up) and plentiful
        labels = np.full((2, n), -1, np.int32)
        for i in range(2):
            idx = rng.permutation(n)
            labels[i, idx[:n_pos]] = 1
            labels[i, idx[n_pos:n_pos + 150]] = 0
        keys = jax.random.split(jax.random.key(n_pos), 2)
        for i in range(2):
            want = jassign.random_sample(jnp.asarray(labels[i]), keys[i], 64, 0.25)
            k_pos, k_neg = jax.random.split(keys[i])
            u_pos = _t(np.asarray(jax.random.uniform(k_pos, (n,))))[None]
            u_neg = _t(np.asarray(jax.random.uniform(k_neg, (n,))))[None]
            got = assign.random_sample(_t(labels[i:i + 1]).long(), u_pos, u_neg, 64, 0.25)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------


def test_faster_rcnn_forward_matches_jax():
    """Eval mode on calibrated weights: every RPN output and the box head on
    the image's GT boxes as RoIs."""
    jfam, fam = _families("faster-rcnn", FRCNN)
    flat, state = _weights(jfam, fam, calibrate=True)
    batch = _batch(1)
    jv = _jax_vars(flat)
    jpyr, jrpn = jfam.model.apply(jv, batch["image"], train=False, method=JaxFasterRCNN.extract)
    jcls, jreg = jfam.model.apply(jv, jpyr[0], batch["gt_boxes"], method=JaxFasterRCNN.roi_forward)
    with torch.no_grad():
        pyr, rpn = fam._extract(state, _t(batch["image"]))
        cls, reg = torch.func.functional_call(fam.model, state, (pyr[0],),
                                              {"rois": _t(batch["gt_boxes"])})
    for (c, d), (jc, jd) in zip(rpn, jrpn):
        assert _rel(c.numpy(), jc) <= FWD_TOL_RMS and _rel(d.numpy(), jd) <= FWD_TOL_RMS
    assert _rel(cls.numpy(), jcls) <= FWD_TOL_RMS and _rel(reg.numpy(), jreg) <= FWD_TOL_RMS


def test_faster_rcnn_loss_and_gradient_match_jax_in_float64():
    jfam, fam = _families("faster-rcnn", FRCNN)
    flat, state = _weights(jfam, fam)
    batch = _batch(2)
    key = jax.random.key(7)
    n_rois = FRCNN["num_proposals"] + MAX_GT
    with jax.enable_x64(True):
        jfam.model = JaxFasterRCNN(jfam.config, dtype=jnp.float64)
        draws = _two_stage_draws(key, fam.anchors_np.shape[0], n_rois, three=False)
        want = _jax_step(jfam, flat, batch, key)
    got = _port_step(fam, state, batch, torch.float64, draws)
    assert draws["rpn_pos"].dtype == torch.float64
    _compare_step(got, want, STEP64_LOSS_RTOL, STEP64_GRAD_TOL_RMS,
                  ("rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg"))
    assert min(got[1].values()) > 0  # every term is live


def test_faster_rcnn_predict_matches_jax():
    jfam, fam = _families("faster-rcnn", dict(FRCNN, score_thr=0.0))
    flat, state = _weights(jfam, fam, calibrate=True)
    flat, state = _unsaturated(fam, flat, ["params.box_head.cls.kernel"])
    x = _batch(3)["image"]
    want = jax.jit(jfam.predict_fn)(_jax_vars(flat), x)
    _assert_same_detections(fam.predict_fn(state, _t(x)), want)


def test_yolov5_forward_loss_gradient_and_predict_match_jax():
    jfam, fam = _families("yolov5s", YOLOV5S)
    flat, state = _weights(jfam, fam, calibrate=True)
    flat, state = _unsaturated(fam, flat, [f"params.head_{i}.kernel" for i in range(3)])
    batch = _batch(4)
    jheads = jfam.model.apply(_jax_vars(flat), batch["image"], train=False)
    heads = fam.forward(state, _t(batch["image"]))
    for h, jh in zip(heads, jheads):
        assert _rel(h.numpy(), jh) <= FWD_TOL_RMS
    with jax.enable_x64(True):
        model = jfam.model
        jfam.model = JaxYOLOv5(jfam.config, dtype=jnp.float64)
        want = _jax_step(jfam, flat, batch, None)
        jfam.model = model
    got = _port_step(fam, state, batch, torch.float64)
    _compare_step(got, want, STEP64_LOSS_RTOL, STEP64_GRAD_TOL_RMS, ("box", "obj", "n_match"))
    assert got[1]["n_match"] > 0
    want = jax.jit(jfam.predict_fn)(_jax_vars(flat), batch["image"])
    _assert_same_detections(fam.predict_fn(state, _t(batch["image"])), want)


def test_yolov5_targets_take_the_highest_gt_index():
    """Two GT boxes on one cell and anchor: the max-scatter keeps GT 1."""
    from agenda_tpu.detect.yolov5 import _level_targets
    from agenda_tpu_torch.detect.yolov5 import DEFAULT_ANCHORS, level_targets

    gt = np.zeros((1, 4, 4), np.float32)
    gt[0, 0] = [10, 10, 50, 50]
    gt[0, 1] = [11, 11, 51, 49]
    gt[0, 2] = [60, 0, 100, 41]
    valid = np.asarray([[True, True, True, False]])
    anchors = np.asarray(DEFAULT_ANCHORS[1], np.float32)
    got = level_targets(_t(gt), _t(valid), _t(anchors), 16, 8, 4.0)[0].numpy()
    tmask, want = _level_targets(gt[0], valid[0], jnp.asarray(anchors), 16, 8, 4.0)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got == 1).any() and not (got == 0).any()


def test_vitdet_forward_loss_gradient_and_predict_match_jax():
    from agenda_tpu.detect.vitdet import ViTDet as JaxViTDet

    jfam, fam = _families("vitdet", VITDET)
    flat, state = _weights(jfam, fam)
    batch = _batch(5)
    jv = _jax_vars(flat)
    _, jrpn = jfam.model.apply(jv, batch["image"], train=False, method=JaxViTDet.extract)
    with torch.no_grad():
        _, rpn = fam._extract(state, _t(batch["image"]))
    for (c, d), (jc, jd) in zip(rpn, jrpn):
        assert _rel(c.numpy(), jc) <= FWD_TOL_RMS and _rel(d.numpy(), jd) <= FWD_TOL_RMS
    key = jax.random.key(9)
    n_rois = VITDET["num_proposals"] + MAX_GT
    with jax.enable_x64(True):
        model = jfam.model
        jfam.model = JaxViTDet(jfam.config, dtype=jnp.float64)
        draws = _two_stage_draws(key, fam.anchors_np.shape[0], n_rois, three=True)
        want = _jax_step(jfam, flat, batch, key)
        jfam.model = model
    got = _port_step(fam, state, batch, torch.float64, draws)
    _compare_step(got, want, STEP64_LOSS_RTOL, STEP64_GRAD_TOL_RMS,
                  ("rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg"))
    assert set(got[2]) >= {"params.backbone.block_0.rel_pos_h", "params.backbone.pos_embed"}
    jpred = dataclasses.replace(jfam.config, score_thr=0.0)
    jfam.config = jpred
    fam.config = dataclasses.replace(fam.config, score_thr=0.0)
    want = jax.jit(jfam.predict_fn)(jv, batch["image"])
    _assert_same_detections(fam.predict_fn(state, _t(batch["image"])), want)


def test_drop_path_keeps_and_scales_per_sample():
    x = torch.ones(4000, 1, 1, 3)
    out = drop_path(x, 0.25, torch.Generator().manual_seed(0))
    kept = out[:, 0, 0, 0] > 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    assert (out == out[:, :, :, :1]).all()  # one draw a sample
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert drop_path(x, 0.0, None) is x
    with pytest.raises(ValueError):
        drop_path(x, 0.1, None)
    # in train mode the ViT blocks draw it from the step's generator
    _, fam = _families("vitdet", dict(VITDET, drop_path_rate=0.5))
    state = fam.init_variables(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in _batch(6).items()}
    a = fam.loss_fn(state, batch, torch.Generator().manual_seed(3))[0]
    b = fam.loss_fn(state, batch, torch.Generator().manual_seed(3))[0]
    c = fam.loss_fn(state, batch, torch.Generator().manual_seed(4))[0]
    assert float(a) == float(b) != float(c)


def test_adamw_with_layer_decay_matches_optax_over_five_steps():
    """ViTDet-tiny's backbone and RPN parameters (every layer id: the patch
    and position embeddings, the blocks, the final norm, outside the
    backbone), five steps with clipping on (35), layer decay 0.7 over 2
    layers, decay 0.1 on the >1-d parameters, a warmup lr; and plain AdamW."""
    jfam, fam = _families("vitdet", VITDET)
    flat, state = _weights(jfam, fam)
    params = {k: state[k].clone() for k in fam.param_names if k.startswith(("backbone.", "rpn."))}
    flat = fam.to_flax(params)
    for layer_decay in (0.7, None):
        kw = dict(optimizer="adamw", lr=1e-3, weight_decay=0.1, layer_decay_rate=layer_decay,
                  layer_decay_layers=2, warmup_iters=3, clip_grad_norm=35.0)
        tx, _ = jax_make_optimizer(JaxRunnerConfig(**kw), steps_per_epoch=5)
        tx_update = jax.jit(tx.update)
        jparams = _jax_vars(flat)["params"]
        jstate = tx.init(jparams)
        opt = DetectorAdamW(RunnerConfig(**kw), steps_per_epoch=5)
        p = {k: v.clone() for k, v in params.items()}
        st = opt.init(p)
        rng = np.random.default_rng(11)
        for step in range(5):
            scale = 100.0 if step == 1 else 1.0  # step 1 clips
            g = {k: _t(rng.normal(0, scale, tuple(v.shape)).astype(np.float32))
                 for k, v in p.items()}
            jg = _jax_vars(fam.to_flax(g))["params"]
            upd, jstate = tx_update(jg, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            opt.update(g, st, p)
        got = fam.to_flax(p)
        want = {"params." + ".".join(k): np.asarray(v) for k, v in _flatten(jparams).items()}
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= ADAMW_TOL, (layer_decay, k)
    assert layer_decay_scale("backbone.pos_embed", 0.7, 2) == 0.7 ** 3
    assert layer_decay_scale("backbone.block_1.qkv.weight", 0.7, 2) == 0.7
    assert layer_decay_scale("backbone.norm.weight", 0.7, 2) == 1.0
    assert layer_decay_scale("rpn.rpn_conv.weight", 0.7, 2) == 1.0
