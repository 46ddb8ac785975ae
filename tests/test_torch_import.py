"""torch-checkpoint importer golden tests.

Each test enumerates the mm/torchvision key schema for one detector family
(written out explicitly here — this doubles as documentation of the expected
checkpoint layout), synthesizes a state dict with those keys shaped like the
source checkpoints (COCO class counts on the heads), imports it, and asserts:

- every backbone/neck/tower tensor lands in the right flax leaf with the
  right layout transform (value goldens via transposition);
- class-count-dependent head tensors are shape-skipped, like mmengine's
  non-strict load_from (Real_Source/faster-rcnn.py:37);
- coverage of the importable modules is 100%.
"""

import numpy as np
import pytest

from agenda_tpu.detect.families import build_family
from agenda_tpu.io.diffusers_io import _flatten
from agenda_tpu.io.torch_import import (
    import_detector_weights,
    load_torch_checkpoint,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _variables(name):
    import jax

    fam = build_family(name, model={"img_size": 64, "max_gt": 8}, predict={})
    return fam.init_variables(jax.random.key(0))


def _seq(shape):
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape) / 1000.0


# ---- inverse enumerations (flax tree -> expected torch keys) ---------------


def _conv_torch(kernel_shape):
    """flax HWIO kernel shape -> torch OIHW array."""
    h, w, i, o = kernel_shape
    return _seq((o, i, h, w))


def _invert_resnet(flat_params, flat_bs, prefix="backbone"):
    """Emit torchvision/mmdet-style resnet keys for our backbone subtree."""
    sd = {}
    for path, v in flat_params.items():
        if path[0] != prefix:
            continue
        mods = list(path[1:-1])
        leaf = path[-1]
        tmods = []
        for m in mods:
            if m.startswith("layer") and "_" in m:
                a, b = m.split("_")
                tmods += [a, b]
            elif m.startswith("downsample_"):
                tmods += ["downsample", m.split("_")[1]]
            else:
                tmods.append(m)
        tkey = f"{prefix}." + ".".join(tmods)
        if leaf == "kernel":
            sd[tkey + ".weight"] = _conv_torch(v.shape)
        elif leaf == "scale":
            sd[tkey + ".weight"] = _seq(v.shape)
        elif leaf == "bias":
            sd[tkey + ".bias"] = _seq(v.shape)
    for path, v in flat_bs.items():
        if path[0] != prefix:
            continue
        mods = list(path[1:-1])
        tmods = []
        for m in mods:
            if m.startswith("layer") and "_" in m:
                a, b = m.split("_")
                tmods += [a, b]
            elif m.startswith("downsample_"):
                tmods += ["downsample", m.split("_")[1]]
            else:
                tmods.append(m)
        tkey = f"{prefix}." + ".".join(tmods)
        leaf = "running_mean" if path[-1] == "mean" else "running_var"
        sd[tkey + "." + leaf] = _seq(v.shape)
    return sd


def _convmodule(tkey, flat_params, flat_bs, fpath):
    """ConvModule (conv+bn) at flax path `fpath` -> mm keys '{tkey}.conv/bn.*'."""
    sd = {}
    k = flat_params[fpath + ("conv", "kernel")]
    sd[tkey + ".conv.weight"] = _conv_torch(k.shape)
    sd[tkey + ".bn.weight"] = _seq(flat_params[fpath + ("bn", "scale")].shape)
    sd[tkey + ".bn.bias"] = _seq(flat_params[fpath + ("bn", "bias")].shape)
    sd[tkey + ".bn.running_mean"] = _seq(flat_bs[fpath + ("bn", "mean")].shape)
    sd[tkey + ".bn.running_var"] = _seq(flat_bs[fpath + ("bn", "var")].shape) + 1.0
    return sd


# ---- faster-rcnn ------------------------------------------------------------


def test_import_faster_rcnn_mmdet_schema():
    variables = _variables("faster-rcnn")
    fp = dict(_flatten(variables["params"]))
    fb = dict(_flatten(variables.get("batch_stats", {})))

    sd = _invert_resnet(fp, fb)
    for i in range(4):
        for mm, ours in ((f"neck.lateral_convs.{i}.conv", f"lateral_{i}"),
                         (f"neck.fpn_convs.{i}.conv", f"fpn_{i}")):
            sd[mm + ".weight"] = _conv_torch(fp[("fpn", ours, "kernel")].shape)
            sd[mm + ".bias"] = _seq(fp[("fpn", ours, "bias")].shape)
    for mm, ours in (("rpn_head.rpn_conv", "rpn_conv"),
                     ("rpn_head.rpn_cls", "rpn_cls"),
                     ("rpn_head.rpn_reg", "rpn_reg")):
        sd[mm + ".weight"] = _conv_torch(fp[("rpn", ours, "kernel")].shape)
        sd[mm + ".bias"] = _seq(fp[("rpn", ours, "bias")].shape)
    # shared fcs: torch stores (out, in) with NCHW-flattened in
    in1, out1 = fp[("box_head", "fc1", "kernel")].shape
    sd["roi_head.bbox_head.shared_fcs.0.weight"] = _seq((out1, in1))
    sd["roi_head.bbox_head.shared_fcs.0.bias"] = _seq((out1,))
    in2, out2 = fp[("box_head", "fc2", "kernel")].shape
    sd["roi_head.bbox_head.shared_fcs.1.weight"] = _seq((out2, in2))
    sd["roi_head.bbox_head.shared_fcs.1.bias"] = _seq((out2,))
    # COCO heads: 80 classes + bg, class-specific regression -> must be skipped
    sd["roi_head.bbox_head.fc_cls.weight"] = _seq((81, 1024))
    sd["roi_head.bbox_head.fc_cls.bias"] = _seq((81,))
    sd["roi_head.bbox_head.fc_reg.weight"] = _seq((320, 1024))
    sd["roi_head.bbox_head.fc_reg.bias"] = _seq((320,))

    new_vars, report = import_detector_weights(variables, sd, "faster-rcnn")

    assert not report.unmatched, report.unmatched[:5]
    assert not report.missing_target, report.missing_target[:5]
    skipped = {k for k, _, _ in report.skipped_shape}
    assert skipped == {"roi_head.bbox_head.fc_cls.weight",
                       "roi_head.bbox_head.fc_cls.bias",
                       "roi_head.bbox_head.fc_reg.weight",
                       "roi_head.bbox_head.fc_reg.bias"}
    for mod in ("backbone", "fpn", "rpn"):
        assert report.coverage(variables, (mod,)) == 1.0, mod

    nf = dict(_flatten(new_vars["params"]))
    nb = dict(_flatten(new_vars["batch_stats"]))
    # conv layout golden: OIHW -> HWIO
    np.testing.assert_allclose(
        nf[("backbone", "conv1", "kernel")],
        sd["backbone.conv1.weight"].transpose(2, 3, 1, 0))
    # bn stats land in batch_stats
    np.testing.assert_allclose(
        nb[("backbone", "bn1", "var")], sd["backbone.bn1.running_var"])
    # fc2 is a plain transpose
    np.testing.assert_allclose(
        nf[("box_head", "fc2", "kernel")],
        sd["roi_head.bbox_head.shared_fcs.1.weight"].T)
    # fc1 un-flattens NCHW (256,7,7) -> NHWC before transposing
    w = sd["roi_head.bbox_head.shared_fcs.0.weight"]
    expect = w.reshape(out1, 256, 7, 7).transpose(0, 2, 3, 1).reshape(out1, -1).T
    np.testing.assert_allclose(nf[("box_head", "fc1", "kernel")], expect)
    # COCO cls head untouched (keeps init values)
    np.testing.assert_allclose(nf[("box_head", "cls", "kernel")],
                               fp[("box_head", "cls", "kernel")])


# ---- yolov5 -----------------------------------------------------------------


def _invert_csp(tkey, flat_params, flat_bs, fpath, style):
    """CSPLayer (v5) / CSPLayerWithTwoConv (v8) -> mm keys."""
    sd = {}
    if style == "v5":
        pairs = [("main_conv", ("cv1",)), ("short_conv", ("cv2",)),
                 ("final_conv", ("cv3",))]
    else:
        pairs = [("main_conv", ("cv1",)), ("final_conv", ("cv2",))]
    for mm, ours in pairs:
        sd.update(_convmodule(f"{tkey}.{mm}", flat_params, flat_bs, fpath + ours))
    n = 0
    while True:
        inner = fpath + ((f"m_{n}_cv1",) if style == "v5" else (f"m_{n}", "cv1"))
        if inner + ("conv", "kernel") not in flat_params:
            break
        for cv, mmname in (("cv1", "conv1"), ("cv2", "conv2")):
            ours = fpath + ((f"m_{n}_{cv}",) if style == "v5" else (f"m_{n}", cv))
            sd.update(_convmodule(f"{tkey}.blocks.{n}.{mmname}",
                                  flat_params, flat_bs, ours))
        n += 1
    return sd


def test_import_yolov5_mmyolo_schema():
    variables = _variables("yolov5")
    fp = dict(_flatten(variables["params"]))
    fb = dict(_flatten(variables["batch_stats"]))

    sd = {}
    sd.update(_convmodule("backbone.stem", fp, fb, ("stem",)))
    for s in range(1, 5):
        sd.update(_convmodule(f"backbone.stage{s}.0", fp, fb, (f"down{s}",)))
        sd.update(_invert_csp(f"backbone.stage{s}.1", fp, fb, (f"c3_{s}",), "v5"))
    sd.update(_convmodule("backbone.stage4.2.conv1", fp, fb, ("sppf", "cv1")))
    sd.update(_convmodule("backbone.stage4.2.conv2", fp, fb, ("sppf", "cv2")))
    sd.update(_convmodule("neck.reduce_layers.2", fp, fb, ("reduce5",)))
    sd.update(_invert_csp("neck.top_down_layers.0.0", fp, fb, ("neck_c3_1",), "v5"))
    sd.update(_convmodule("neck.top_down_layers.0.1", fp, fb, ("reduce4",)))
    sd.update(_invert_csp("neck.top_down_layers.1", fp, fb, ("neck_c3_2",), "v5"))
    sd.update(_convmodule("neck.downsample_layers.0", fp, fb, ("neck_down3",)))
    sd.update(_invert_csp("neck.bottom_up_layers.0", fp, fb, ("neck_c3_3",), "v5"))
    sd.update(_convmodule("neck.downsample_layers.1", fp, fb, ("neck_down4",)))
    sd.update(_invert_csp("neck.bottom_up_layers.1", fp, fb, ("neck_c3_4",), "v5"))
    # COCO heads: 3 anchors x (5 + 80) = 255 channels vs our 18 -> skipped
    for i in range(3):
        cin = fp[(f"head_{i}", "kernel")].shape[2]
        sd[f"bbox_head.head_module.convs_pred.{i}.weight"] = _seq((255, cin, 1, 1))
        sd[f"bbox_head.head_module.convs_pred.{i}.bias"] = _seq((255,))

    new_vars, report = import_detector_weights(variables, sd, "yolov5")
    assert not report.unmatched, report.unmatched[:5]
    assert not report.missing_target, report.missing_target[:5]
    assert len(report.skipped_shape) == 6  # 3 head convs x (weight, bias)
    for mod in ("stem", "down1", "c3_1", "sppf", "reduce5", "neck_c3_1",
                "neck_down3", "neck_c3_4"):
        assert report.coverage(variables, (mod,)) == 1.0, mod

    nf = dict(_flatten(new_vars["params"]))
    np.testing.assert_allclose(
        nf[("c3_2", "m_1_cv2", "conv", "kernel")],
        sd["backbone.stage2.1.blocks.1.conv2.conv.weight"].transpose(2, 3, 1, 0))


# ---- yolov8 -----------------------------------------------------------------


def test_import_yolov8_mmyolo_schema():
    variables = _variables("yolov8")
    fp = dict(_flatten(variables["params"]))
    fb = dict(_flatten(variables["batch_stats"]))

    sd = {}
    sd.update(_convmodule("backbone.stem", fp, fb, ("stem",)))
    for s in range(1, 5):
        sd.update(_convmodule(f"backbone.stage{s}.0", fp, fb, (f"down{s}",)))
        sd.update(_invert_csp(f"backbone.stage{s}.1", fp, fb, (f"c2f_{s}",), "v8"))
    sd.update(_convmodule("backbone.stage4.2.conv1", fp, fb, ("sppf", "cv1")))
    sd.update(_convmodule("backbone.stage4.2.conv2", fp, fb, ("sppf", "cv2")))
    for mm, ours in (("neck.top_down_layers.0", "neck_p4"),
                     ("neck.top_down_layers.1", "neck_p3"),
                     ("neck.bottom_up_layers.0", "neck_p4b"),
                     ("neck.bottom_up_layers.1", "neck_p5")):
        sd.update(_invert_csp(mm, fp, fb, (ours,), "v8"))
    sd.update(_convmodule("neck.downsample_layers.0", fp, fb, ("neck_down3",)))
    sd.update(_convmodule("neck.downsample_layers.1", fp, fb, ("neck_down4",)))
    # head towers: two ConvModules + a final plain conv per branch per level
    for i in range(3):
        for kind, ours in (("cls", "cls"), ("reg", "box")):
            sd.update(_convmodule(f"bbox_head.head_module.{kind}_preds.{i}.0",
                                  fp, fb, (f"head_{ours}1_{i}",)))
            sd.update(_convmodule(f"bbox_head.head_module.{kind}_preds.{i}.1",
                                  fp, fb, (f"head_{ours}2_{i}",)))
        # final convs: reg (4*reg_max) matches; cls is 80-class -> skipped
        bshape = fp[(f"head_box3_{i}", "kernel")].shape
        sd[f"bbox_head.head_module.reg_preds.{i}.2.weight"] = _conv_torch(bshape)
        sd[f"bbox_head.head_module.reg_preds.{i}.2.bias"] = _seq(
            fp[(f"head_box3_{i}", "bias")].shape)
        cin = fp[(f"head_cls3_{i}", "kernel")].shape[2]
        sd[f"bbox_head.head_module.cls_preds.{i}.2.weight"] = _seq((80, cin, 1, 1))
        sd[f"bbox_head.head_module.cls_preds.{i}.2.bias"] = _seq((80,))

    new_vars, report = import_detector_weights(variables, sd, "yolov8")
    assert not report.unmatched, report.unmatched[:5]
    assert not report.missing_target, report.missing_target[:5]
    assert len(report.skipped_shape) == 6  # 3 levels x cls final (w, b)
    for mod in ("stem", "c2f_3", "sppf", "neck_p4", "neck_p5", "neck_down4",
                "head_box1_0", "head_box3_2", "head_cls2_1"):
        assert report.coverage(variables, (mod,)) == 1.0, mod
    nf = dict(_flatten(new_vars["params"]))
    np.testing.assert_allclose(
        nf[("head_box3_1", "kernel")],
        sd["bbox_head.head_module.reg_preds.1.2.weight"].transpose(2, 3, 1, 0))


# ---- vitdet -----------------------------------------------------------------


def test_import_vitdet_mmdet_schema():
    variables = _variables("vitdet")
    fp = dict(_flatten(variables["params"]))

    sd = {}
    pk = fp[("backbone", "patch_embed", "kernel")].shape
    sd["backbone.patch_embed.projection.weight"] = _conv_torch(pk)
    sd["backbone.patch_embed.projection.bias"] = _seq(
        fp[("backbone", "patch_embed", "bias")].shape)
    # MAE-style pos_embed with cls token on a 14x14 grid -> resized to ours
    c = fp[("backbone", "pos_embed")].shape[-1]
    sd["backbone.pos_embed"] = _seq((1, 14 * 14 + 1, c))
    n_blocks = sum(1 for p in fp if p[0] == "backbone" and p[1].startswith("block_")
                   and p[2:] == ("qkv", "kernel"))
    assert n_blocks >= 2
    for i in range(n_blocks):
        b = ("backbone", f"block_{i}")
        pre = f"backbone.blocks.{i}"
        for mm, ours in (("ln1", "norm1"), ("ln2", "norm2")):
            sd[f"{pre}.{mm}.weight"] = _seq(fp[b + (ours, "scale")].shape)
            sd[f"{pre}.{mm}.bias"] = _seq(fp[b + (ours, "bias")].shape)
        for mm, ours in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                         ("ffn.layers.0.0", "fc1"), ("ffn.layers.1", "fc2")):
            i_, o_ = fp[b + (ours, "kernel")].shape
            sd[f"{pre}.{mm}.weight"] = _seq((o_, i_))
            sd[f"{pre}.{mm}.bias"] = _seq(fp[b + (ours, "bias")].shape)
        # decomposed rel-pos tables, stored at the 1024px-training length
        # (2*64-1=127) -> must interpolate down to our grid/window extent
        if b + ("rel_pos_h",) in fp:
            hd = fp[b + ("rel_pos_h",)].shape[1]
            sd[f"{pre}.attn.rel_pos_h"] = _seq((127, hd))
            sd[f"{pre}.attn.rel_pos_w"] = _seq((127, hd))
    sd["backbone.ln1.weight"] = _seq(fp[("backbone", "norm", "scale")].shape)
    sd["backbone.ln1.bias"] = _seq(fp[("backbone", "norm", "bias")].shape)
    # mask-rcnn rpn rides along (same mmdet names as faster-rcnn)
    for mm, ours in (("rpn_head.rpn_conv", "rpn_conv"),
                     ("rpn_head.rpn_cls", "rpn_cls"),
                     ("rpn_head.rpn_reg", "rpn_reg")):
        sd[mm + ".weight"] = _conv_torch(fp[("rpn", ours, "kernel")].shape)
        sd[mm + ".bias"] = _seq(fp[("rpn", ours, "bias")].shape)

    new_vars, report = import_detector_weights(variables, sd, "vitdet")
    assert not report.unmatched, report.unmatched[:5]
    assert not report.missing_target, report.missing_target[:5]
    assert not report.skipped_shape, report.skipped_shape[:5]
    assert report.coverage(variables, ("backbone",)) == 1.0
    assert report.coverage(variables, ("rpn",)) == 1.0

    nf = dict(_flatten(new_vars["params"]))
    # qkv linear transpose golden
    i_, o_ = fp[("backbone", "block_0", "qkv", "kernel")].shape
    np.testing.assert_allclose(
        nf[("backbone", "block_0", "qkv", "kernel")],
        sd["backbone.blocks.0.attn.qkv.weight"].T)
    # pos_embed was grid-resized (shape matches, values finite + nonzero)
    pe = nf[("backbone", "pos_embed")]
    assert pe.shape == fp[("backbone", "pos_embed")].shape
    assert np.isfinite(pe).all() and np.abs(pe).sum() > 0


# ---- real torch round-trip --------------------------------------------------


def test_load_torch_checkpoint_real_pth(tmp_path):
    """Round-trip through actual torch serialization (torch is CPU-importable
    in this environment) with an mm-style state_dict container."""
    torch = pytest.importorskip("torch")
    sd = {
        "backbone.conv1.weight": torch.arange(64 * 3 * 7 * 7,
                                              dtype=torch.float32).reshape(64, 3, 7, 7),
        "backbone.bn1.weight": torch.ones(64),
        "backbone.bn1.running_mean": torch.zeros(64),
        "backbone.bn1.num_batches_tracked": torch.tensor(100),
    }
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": sd, "meta": {"mmdet_version": "3.0"}}, path)
    loaded = load_torch_checkpoint(path)
    assert set(loaded) == set(sd)
    np.testing.assert_allclose(loaded["backbone.conv1.weight"],
                               sd["backbone.conv1.weight"].numpy())

    # DDP 'module.' prefixes are stripped
    torch.save({"module.backbone.bn1.weight": torch.ones(4)}, str(tmp_path / "d.pth"))
    loaded = load_torch_checkpoint(str(tmp_path / "d.pth"))
    assert "backbone.bn1.weight" in loaded
