"""The port's mmdet/mmyolo importer, checkpoints and detector CLIs against agenda_tpu.

- The importer (``agenda_tpu_torch/io/torch_import.py``) on the mm key
  schemas ``tests/test_torch_import.py`` writes out (its own helpers build
  them here), for Faster R-CNN, YOLOv5, YOLOv8 and ViTDet: the same
  imported, shape-skipped, unmatched and missing names as the JAX
  importer's, in order, and the same values once the port's variables are
  mapped back to flax names (equal: the same transposes of the same
  arrays; ViTDet's resized ``pos_embed`` within POS_EMBED_TOL, its
  rel-pos tables within REL_POS_TOL). The port's fabricated checkpoints
  (``detect/fabricate.py::mm_checkpoint``) carry that schema, plus the
  80-class COCO heads.
- ``load_torch_checkpoint`` reads an mm-style ``.pth`` (a ``state_dict``
  container, DDP ``module.`` prefixes) with ``weights_only=True`` and a
  ``.safetensors``; ``_resize_pos_embed`` equals the JAX importer's, which
  calls Pillow, to POS_EMBED_TOL.
- Checkpoints cross both ways for every family: the JAX runner's
  ``save_variables`` read by the port's ``read_checkpoint`` through the
  family's converter (equal), and the port's ``save_variables`` read by the
  JAX ``load_variables`` (equal, EMA included).
- ``det_train --pretrained`` then ``--resume`` and ``det_test`` through the
  port's CLIs on the CPU for faster-rcnn, yolov5, yolov5s and vitdet on a
  fabricated checkpoint: the import report equals the JAX importer's on the
  same file, the run writes its files and resumes at the next epoch, and
  the JAX package reads its ``latest.safetensors``.

POS_EMBED_TOL: the two resizes sum the same float64 taps in another order
and both round to f32 after each pass, so they agree to the last bit but
for a rounding that lands on a tie: 1 ulp of the values (2e-9 at 0.02).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from agenda_tpu.detect.families import build_family as jax_build_family
from agenda_tpu.detect.runner import load_variables as jax_load_variables
from agenda_tpu.detect.runner import save_variables as jax_save_variables
from agenda_tpu.io.diffusers_io import _flatten
from agenda_tpu.io.torch_import import _resize_pos_embed as jax_resize_pos_embed
from agenda_tpu.io.torch_import import import_detector_weights as jax_import
from agenda_tpu.io.torch_import import load_torch_checkpoint as jax_load_checkpoint
from agenda_tpu_torch.detect.fabricate import mm_checkpoint, write_mm_checkpoint, write_square_set
from agenda_tpu_torch.detect.families import build_family
from agenda_tpu_torch.detect.runner import read_checkpoint, save_variables
from agenda_tpu_torch.io.safetensors_io import save_file
from agenda_tpu_torch.io.torch_import import (_resize_pos_embed, import_detector_weights,
                                              load_torch_checkpoint)
from test_torch_import import _conv_torch, _convmodule, _invert_csp, _invert_resnet, _seq
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = {"img_size": 64, "max_gt": 8}
VIT = dict(SMALL, embed_dim=64, vit_depth=2, vit_heads=2, window_size=2,
           window_block_indexes=(0,))
TINY = {  # the CLI drives: the JAX tests' sizes
    "faster-rcnn": dict(SMALL, nms_pre=256, num_proposals=64, rpn_sample=64, rcnn_sample=64),
    "yolov5": dict(SMALL), "yolov5s": dict(SMALL),
    "vitdet": dict(VIT, nms_pre=128, num_proposals=32, rpn_sample=32, rcnn_sample=32),
}
KEYS = {"faster-rcnn": "faster-rcnn", "yolov5": "yolov5", "yolov5s": "yolov5",
        "yolov8": "yolov8", "vitdet": "vitdet"}
POS_EMBED_TOL = 1.2e-7  # relative: 1 ulp
REL_POS_TOL = 1e-7  # both interpolate in float64; the JAX importer keeps float64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six files at once on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_vars(name, model, seed=None):
    """The JAX family's variables in the shapes its init makes (traced, not
    run): zeros, or N(0, 1) from numpy with ``seed``."""
    fam = jax_build_family(name, model=dict(model))
    shapes = jax.eval_shape(fam.init_variables, jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (np.zeros(s.shape, np.float32) if seed is None else
                                   rng.normal(0, 1, s.shape).astype(np.float32)), shapes)


def _schema(name, variables):
    """The mm state dict ``tests/test_torch_import.py`` writes for the family."""
    fp = dict(_flatten(variables["params"]))
    fb = dict(_flatten(variables.get("batch_stats", {})))
    sd = {}
    if name == "faster-rcnn":
        sd = _invert_resnet(fp, fb)
        for i in range(4):
            for mm, ours in ((f"neck.lateral_convs.{i}.conv", f"lateral_{i}"),
                             (f"neck.fpn_convs.{i}.conv", f"fpn_{i}")):
                sd[mm + ".weight"] = _conv_torch(fp[("fpn", ours, "kernel")].shape)
                sd[mm + ".bias"] = _seq(fp[("fpn", ours, "bias")].shape)
        for i, fc in ((0, "fc1"), (1, "fc2")):
            n_in, n_out = fp[("box_head", fc, "kernel")].shape
            sd[f"roi_head.bbox_head.shared_fcs.{i}.weight"] = _seq((n_out, n_in))
            sd[f"roi_head.bbox_head.shared_fcs.{i}.bias"] = _seq((n_out,))
    if name in ("faster-rcnn", "vitdet"):
        for mm, ours in (("rpn_head.rpn_conv", "rpn_conv"), ("rpn_head.rpn_cls", "rpn_cls"),
                         ("rpn_head.rpn_reg", "rpn_reg")):
            sd[mm + ".weight"] = _conv_torch(fp[("rpn", ours, "kernel")].shape)
            sd[mm + ".bias"] = _seq(fp[("rpn", ours, "bias")].shape)
    if name == "faster-rcnn":
        sd["roi_head.bbox_head.fc_cls.weight"] = _seq((81, 1024))
        sd["roi_head.bbox_head.fc_cls.bias"] = _seq((81,))
        sd["roi_head.bbox_head.fc_reg.weight"] = _seq((320, 1024))
        sd["roi_head.bbox_head.fc_reg.bias"] = _seq((320,))
    if name in ("yolov5", "yolov8"):
        style, csp = ("v5", "c3") if name == "yolov5" else ("v8", "c2f")
        sd.update(_convmodule("backbone.stem", fp, fb, ("stem",)))
        for s in range(1, 5):
            sd.update(_convmodule(f"backbone.stage{s}.0", fp, fb, (f"down{s}",)))
            sd.update(_invert_csp(f"backbone.stage{s}.1", fp, fb, (f"{csp}_{s}",), style))
        sd.update(_convmodule("backbone.stage4.2.conv1", fp, fb, ("sppf", "cv1")))
        sd.update(_convmodule("backbone.stage4.2.conv2", fp, fb, ("sppf", "cv2")))
    if name == "yolov5":
        sd.update(_convmodule("neck.reduce_layers.2", fp, fb, ("reduce5",)))
        sd.update(_invert_csp("neck.top_down_layers.0.0", fp, fb, ("neck_c3_1",), "v5"))
        sd.update(_convmodule("neck.top_down_layers.0.1", fp, fb, ("reduce4",)))
        sd.update(_invert_csp("neck.top_down_layers.1", fp, fb, ("neck_c3_2",), "v5"))
        sd.update(_convmodule("neck.downsample_layers.0", fp, fb, ("neck_down3",)))
        sd.update(_invert_csp("neck.bottom_up_layers.0", fp, fb, ("neck_c3_3",), "v5"))
        sd.update(_convmodule("neck.downsample_layers.1", fp, fb, ("neck_down4",)))
        sd.update(_invert_csp("neck.bottom_up_layers.1", fp, fb, ("neck_c3_4",), "v5"))
        for i in range(3):
            cin = fp[(f"head_{i}", "kernel")].shape[2]
            sd[f"bbox_head.head_module.convs_pred.{i}.weight"] = _seq((255, cin, 1, 1))
            sd[f"bbox_head.head_module.convs_pred.{i}.bias"] = _seq((255,))
    if name == "yolov8":
        for mm, ours in (("neck.top_down_layers.0", "neck_p4"), ("neck.top_down_layers.1", "neck_p3"),
                         ("neck.bottom_up_layers.0", "neck_p4b"),
                         ("neck.bottom_up_layers.1", "neck_p5")):
            sd.update(_invert_csp(mm, fp, fb, (ours,), "v8"))
        sd.update(_convmodule("neck.downsample_layers.0", fp, fb, ("neck_down3",)))
        sd.update(_convmodule("neck.downsample_layers.1", fp, fb, ("neck_down4",)))
        for i in range(3):
            for kind, ours in (("cls", "cls"), ("reg", "box")):
                for j in (1, 2):
                    sd.update(_convmodule(f"bbox_head.head_module.{kind}_preds.{i}.{j - 1}",
                                          fp, fb, (f"head_{ours}{j}_{i}",)))
            sd[f"bbox_head.head_module.reg_preds.{i}.2.weight"] = _conv_torch(
                fp[(f"head_box3_{i}", "kernel")].shape)
            sd[f"bbox_head.head_module.reg_preds.{i}.2.bias"] = _seq(
                fp[(f"head_box3_{i}", "bias")].shape)
            cin = fp[(f"head_cls3_{i}", "kernel")].shape[2]
            sd[f"bbox_head.head_module.cls_preds.{i}.2.weight"] = _seq((80, cin, 1, 1))
            sd[f"bbox_head.head_module.cls_preds.{i}.2.bias"] = _seq((80,))
    if name == "vitdet":
        sd["backbone.patch_embed.projection.weight"] = _conv_torch(
            fp[("backbone", "patch_embed", "kernel")].shape)
        sd["backbone.patch_embed.projection.bias"] = _seq(
            fp[("backbone", "patch_embed", "bias")].shape)
        sd["backbone.pos_embed"] = _seq((1, 14 * 14 + 1, fp[("backbone", "pos_embed")].shape[-1]))
        for i in range(2):
            b, pre = ("backbone", f"block_{i}"), f"backbone.blocks.{i}"
            for mm, ours in (("ln1", "norm1"), ("ln2", "norm2")):
                sd[f"{pre}.{mm}.weight"] = _seq(fp[b + (ours, "scale")].shape)
                sd[f"{pre}.{mm}.bias"] = _seq(fp[b + (ours, "bias")].shape)
            for mm, ours in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                             ("ffn.layers.0.0", "fc1"), ("ffn.layers.1", "fc2")):
                n_in, n_out = fp[b + (ours, "kernel")].shape
                sd[f"{pre}.{mm}.weight"] = _seq((n_out, n_in))
                sd[f"{pre}.{mm}.bias"] = _seq(fp[b + (ours, "bias")].shape)
            hd = fp[b + ("rel_pos_h",)].shape[1]
            sd[f"{pre}.attn.rel_pos_h"] = _seq((127, hd))
            sd[f"{pre}.attn.rel_pos_w"] = _seq((127, hd))
        sd["backbone.ln1.weight"] = _seq(fp[("backbone", "norm", "scale")].shape)
        sd["backbone.ln1.bias"] = _seq(fp[("backbone", "norm", "bias")].shape)
    return sd


def _flat(variables):
    return {col + "." + ".".join(k): np.asarray(v)
            for col, tree in variables.items() for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("name", ["faster-rcnn", "yolov5", "yolov8", "vitdet"])
def test_importer_matches_jax_on_the_mm_schemas(name):
    model = VIT if name == "vitdet" else SMALL
    jv = _jax_vars(name, model)
    sd = _schema(name, jv)
    jnew, jrep = jax_import(jv, sd, name)
    fam = build_family(name, model=dict(model))
    state = fam.init_variables(torch.Generator().manual_seed(0))
    new, rep = import_detector_weights(fam, state, sd, name)
    for field in ("imported", "skipped_shape", "unmatched", "missing_target"):
        assert getattr(rep, field) == getattr(jrep, field), field
    assert rep.filled == jrep.filled and len(rep.imported) > 30
    assert not rep.unmatched and not rep.missing_target
    fam.check_variables(new)
    got, want = fam.to_flax(new), _flat(jnew)
    for col, *path in sorted(rep.filled):
        k = ".".join([col] + path)
        if path[-1] == "pos_embed":
            assert np.abs(got[k] - want[k]).max() <= POS_EMBED_TOL * np.abs(want[k]).max()
        elif path[-1].startswith("rel_pos"):
            np.testing.assert_allclose(got[k], want[k], rtol=REL_POS_TOL, atol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the fabricated checkpoint carries the same schema, with the COCO heads
    fab = mm_checkpoint(fam, name, seed=0)
    extra = {k for k in set(fab) - set(sd) if not k.endswith("num_batches_tracked")}
    assert set(sd) <= set(fab)
    assert all(k.startswith("roi_head.bbox_head.fc_") for k in extra), sorted(extra)[:4]
    for k in sd:
        if not k.endswith("pos_embed"):
            assert fab[k].shape == sd[k].shape, k


def test_load_torch_checkpoint_pth_and_safetensors(tmp_path):
    sd = {"backbone.conv1.weight": torch.arange(64 * 3 * 7 * 7, dtype=torch.float32
                                                ).reshape(64, 3, 7, 7),
          "backbone.bn1.running_var": torch.ones(64),
          "backbone.bn1.num_batches_tracked": torch.tensor(100)}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": sd, "meta": {"mmdet_version": "3.0", "epoch": 12}}, path)
    for got in (load_torch_checkpoint(path), jax_load_checkpoint(path)):
        assert set(got) == set(sd)
        np.testing.assert_array_equal(got["backbone.conv1.weight"], sd["backbone.conv1.weight"])
    torch.save({"module.backbone.bn1.weight": torch.ones(4)}, str(tmp_path / "d.pth"))
    assert set(load_torch_checkpoint(str(tmp_path / "d.pth"))) == {"backbone.bn1.weight"}
    save_file({k: v for k, v in sd.items()}, str(tmp_path / "c.safetensors"))
    got = load_torch_checkpoint(str(tmp_path / "c.safetensors"))
    assert set(got) == set(sd) and int(got["backbone.bn1.num_batches_tracked"]) == 100


@pytest.mark.parametrize("grid,target", [(14, 4), (14, 8), (14, 20), (8, 8)])
def test_resize_pos_embed_equals_pillow(grid, target):
    rng = np.random.default_rng(grid * target)
    arr = rng.normal(0, 0.02, (1, grid * grid + 1, 16)).astype(np.float32)  # with a cls token
    got = _resize_pos_embed(arr, (1, target, target, 16))
    want = jax_resize_pos_embed(arr, (1, target, target, 16))
    assert got.shape == want.shape == (1, target, target, 16)
    assert np.abs(got - want).max() <= POS_EMBED_TOL * np.abs(want).max()


@pytest.mark.parametrize("name", ["faster-rcnn", "yolov5s", "vitdet"])
def test_checkpoints_cross_load_with_the_jax_runner(tmp_path, name):
    model = VIT if name == "vitdet" else SMALL
    jv = _jax_vars(name, model, seed=4)
    jax_save_variables(str(tmp_path / "jax.safetensors"), jv)
    fam = build_family(name, model=dict(model))
    state, ema = read_checkpoint(str(tmp_path / "jax.safetensors"), fam)
    fam.check_variables(state)
    assert ema is None
    got = fam.to_flax(state)
    assert set(got) == set(_flat(jv))
    for k, v in _flat(jv).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the port's file, with an EMA, read by the JAX runner
    params = {k: state[k] * 0.5 for k in fam.param_names}
    save_variables(str(tmp_path / "port.safetensors"), state, params, family=fam)
    back = jax_load_variables(str(tmp_path / "port.safetensors"))
    assert set(back) == {c for c in jv if _flatten(jv[c])} | {"ema_params"}
    flat = _flat(back)
    for k, v in fam.to_flax(state).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    for k, v in fam.to_flax(params).items():
        np.testing.assert_array_equal(flat["ema_" + k], v, err_msg=k)


@pytest.mark.parametrize("name", ["faster-rcnn", "yolov5", "yolov5s", "vitdet"])
def test_det_train_pretrained_resume_and_det_test_cli(tmp_path, name):
    from agenda_tpu_torch.cli import det_test, det_train
    from agenda_tpu_torch.detect.configs import DatasetSpec, preset
    from agenda_tpu_torch.detect.runner import DetectorRunner

    root = str(tmp_path)
    write_square_set(os.path.join(root, "tr"), 4, seed=1)
    write_square_set(os.path.join(root, "va"), 2, seed=2)
    model = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY[name].items()
             if k not in ("img_size", "max_gt")}
    cfg = preset("real_source", name, [DatasetSpec(os.path.join(root, "tr"), "ann.json")],
                 val=DatasetSpec(os.path.join(root, "va"), "ann.json"), img_scale=(64, 64),
                 max_gt=8, model=model)
    cfg.runner.lr = 1e-5  # a fresh trunk at the presets' lr runs away in 2 steps
    cfg.runner.log_interval = 1
    config = os.path.join(root, "run.json")
    cfg.to_json(config)
    pth = os.path.join(root, "coco.pth")
    sd = write_mm_checkpoint(pth, name, seed=3, **TINY[name])
    reports = []
    train = DetectorRunner.train

    def spy(self, *a, **k):
        out = train(self, *a, **k)
        reports.append(self.import_report)
        return out

    work = os.path.join(root, "work")
    args = ["--device", "cpu", "--config", config, "--work-dir", work, "--batch-size", "2",
            "--pretrained", pth]
    DetectorRunner.train = spy
    try:
        det_train.main(args + ["--max-epochs", "1"])
        det_train.main(args + ["--max-epochs", "2", "--resume",
                               os.path.join(work, "latest.safetensors")])
    finally:
        DetectorRunner.train = train
    jv = _jax_vars(name, TINY[name])
    _, jrep = jax_import(jv, jax_load_checkpoint(pth), KEYS[name])
    for rep in reports:
        assert rep.imported == jrep.imported and rep.skipped_shape == jrep.skipped_shape
        assert rep.unmatched == jrep.unmatched and len(rep.skipped_shape) >= 4
    assert set(k for k, _, _ in reports[0].skipped_shape) <= {
        k for k in sd if "fc_cls" in k or "fc_reg" in k or "convs_pred" in k}
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4] and [r["epoch"] for r in steps] == [0, 0, 1, 1]
    assert all(np.isfinite(r["loss"]) for r in steps)
    assert [r["epoch"] for r in rows if "bbox_mAP" in r] == [0, 1]
    with open(os.path.join(work, "config.json")) as f:
        assert json.load(f)["pretrained"] == pth
    latest = os.path.join(work, "latest.safetensors")
    assert set(jax_load_variables(latest)) >= {"params"}
    recs = det_test.main(["--device", "cpu", "--config", os.path.join(work, "config.json"),
                          "--checkpoint", latest, "--test-root", os.path.join(root, "va"),
                          "--test-ann", "ann.json", "--out", os.path.join(root, "pred.pkl")])
    assert len(recs) == 2 and os.path.exists(os.path.join(root, "pred.pkl"))
