"""Parity of the port's annotation half (agenda_tpu_torch.annotate and its CLIs) with agenda_tpu.

CLI to CLI on the same seeded inputs: ``postprocess_heatmap`` (PNGs
pixel-identical; the JAX CLI writes with Pillow, the port with its own PNG
codec), ``build_empty_annotation``, ``convert_pseudo_ann``,
``evaluate_pseudo_ann`` and ``select_threshold`` (``--result-out``,
``--table-out``, ``--emit-pseudo-coco`` with and without
``--thresh-conf``): equal files. ``--plot`` and ``--visualize-samples``
raise in the port. The library functions (threshold selection, COCO mAP,
edge completion, torch-pickled records) agree with the JAX package's, whose
matchers here are its ctypes ones while the port's are numpy.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from agenda_tpu.annotate import boxes as jboxes
from agenda_tpu.annotate import records as jrecords
from agenda_tpu.annotate import threshold as jthreshold
from agenda_tpu.detect import coco_eval as jcoco_eval
from agenda_tpu_torch.annotate import boxes, records, threshold
from agenda_tpu_torch.detect import coco_eval


def _records(seed, n_images=24, with_gt=True):
    """Prediction records as det_test writes them: GT boxes and scored
    predictions near them (some far), in 112-px coordinates."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        g = int(rng.integers(0, 4)) if with_gt else 0
        xy = rng.uniform(-10, 100, (g, 2))
        gt = np.concatenate([xy, xy + 42.36], 1).astype(np.float32)
        p = int(rng.integers(0, 6))
        far = rng.uniform(0, 112, (p, 2))
        far = np.concatenate([far, far + 30], 1)
        near = gt[rng.integers(0, g, p)] + rng.normal(0, 4, (p, 4)) if g else far
        pred = np.where(rng.uniform(size=(p, 1)) < 0.6, near, far).astype(np.float32)
        scores = rng.choice(np.asarray([0.2, 0.5, 0.7, 0.9], np.float32), p)  # ties
        out.append({
            "img_path": f"/data/images/{i}.png",
            "gt_instances": {"bboxes": gt, "labels": np.zeros(g, np.int64)},
            "pred_instances": {"bboxes": pred, "scores": scores,
                               "labels": np.zeros(p, np.int64)},
        })
    return out


def test_threshold_selection_matches_jax():
    recs = _records(0)
    got = threshold.match_predictions(recs)
    want = jthreshold.match_predictions(recs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    table = threshold.pr_f1_table(*got)
    jtable = jthreshold.pr_f1_table(*want)
    for k in table:
        np.testing.assert_array_equal(table[k], jtable[k])
    assert threshold.average_precision_101(table["precision"], table["recall"]) == \
        jthreshold.average_precision_101(jtable["precision"], jtable["recall"])
    assert threshold.select_f1_max_threshold(recs) == jthreshold.select_f1_max_threshold(recs)
    np.testing.assert_array_equal(threshold.prediction_ious(recs),
                                  jthreshold.prediction_ious(recs))


def test_coco_map_numpy_matcher_matches_jax():
    recs = _records(1, n_images=30)
    assert coco_eval.evaluate_records(recs) == jcoco_eval.evaluate_records(recs)
    assert coco_eval.evaluate_records(recs, max_dets=2) == \
        jcoco_eval.evaluate_records(recs, max_dets=2)
    empty = _records(2, with_gt=False)
    assert coco_eval.evaluate_records(empty) == jcoco_eval.evaluate_records(empty)


@pytest.mark.parametrize("mode", ["extend", "clamp"])
def test_edge_completion_matches_jax(mode):
    rng = np.random.default_rng(3)
    xy = rng.uniform(-20, 110, (50, 2))
    b = np.concatenate([xy, xy + rng.uniform(10, 45, (50, 2))], 1)
    np.testing.assert_array_equal(boxes.complete_edge_boxes(b, mode=mode),
                                  jboxes.complete_edge_boxes(b, mode=mode))
    np.testing.assert_array_equal(boxes.iou_matrix_xyxy(b[:20], b[10:]),
                                  jboxes.iou_matrix_xyxy(b[:20], b[10:]))


def test_records_read_torch_pickled_tensors(tmp_path):
    """Reference prediction.pkl files hold torch tensors (mmdet's --out)."""
    recs = _records(4, n_images=5)
    as_torch = [{"img_path": r["img_path"], "img_id": i, "ori_shape": (112, 112),
                 "gt_instances": {k: torch.from_numpy(v) for k, v in r["gt_instances"].items()},
                 "pred_instances": {k: torch.from_numpy(v)
                                    for k, v in r["pred_instances"].items()}}
                for i, r in enumerate(recs)]
    path = str(tmp_path / "prediction.pkl")
    torch.save(as_torch, path)
    got, want = records.load_predictions(path), jrecords.load_predictions(path)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["img_id"] == w["img_id"]
        for inst in ("gt_instances", "pred_instances"):
            for k in w[inst]:
                assert isinstance(g[inst][k], np.ndarray)
                np.testing.assert_array_equal(g[inst][k], w[inst][k])
    # the saver writes plain numpy pickles the JAX loader reads
    records.save_predictions(got, str(tmp_path / "again.pkl"))
    with open(tmp_path / "again.pkl", "rb") as f:
        assert len(pickle.load(f)) == 5


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


def _heatmap_tree(root, names, seed):
    rng = np.random.default_rng(seed)
    for word in ("cars", "new_token_v0", "new_token_v2"):
        d = os.path.join(root, f"daam_{word}_heatmaps")
        os.makedirs(d, exist_ok=True)
        for name in names:
            Image.fromarray(rng.integers(0, 256, (112, 112)).astype(np.uint8)).save(
                os.path.join(d, name))


def test_postprocess_heatmap_cli_matches_jax(tmp_path):
    from agenda_tpu.cli import postprocess_heatmap as jax_cli
    from agenda_tpu_torch.cli import postprocess_heatmap

    names = ["0.png", "2.png", "10.png", "1.png"]  # numeric order is not lexical
    for sub in ("jax", "port"):
        _heatmap_tree(str(tmp_path / sub), names, seed=5)
    args = ["--object-heatmap-path", "daam_cars_heatmaps",
            "--fg-heatmap-path", "daam_new_token_v0_heatmaps",
            "--bg-heatmap-path", "daam_new_token_v2_heatmaps",
            "--stack-heatmap-save-path", "daam_stack_heatmaps",
            "--inv-heatmap-save-path", "daam_new_token_v2_inv_heatmaps"]
    jax_cli.main(["--save-dir", str(tmp_path / "jax")] + args)
    postprocess_heatmap.main(["--save-dir", str(tmp_path / "port")] + args)
    for sub, mode, shape in (("daam_stack_heatmaps", "RGB", (112, 112, 3)),
                             ("daam_new_token_v2_inv_heatmaps", "L", (112, 112))):
        want_dir, got_dir = tmp_path / "jax" / sub, tmp_path / "port" / sub
        assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == sorted(names)
        for name in names:
            want, got = Image.open(want_dir / name), Image.open(got_dir / name)
            assert got.mode == want.mode == mode
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            assert np.asarray(got).shape == shape


def test_build_empty_annotation_cli_matches_jax(tmp_path):
    from agenda_tpu.cli import build_empty_annotation as jax_cli
    from agenda_tpu_torch.cli import build_empty_annotation

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in (3, 0, 12, 1):
        Image.fromarray(np.zeros((112, 112, 3), np.uint8)).save(img_dir / f"{i}.png")
    template = {"categories": [{"id": 1, "name": "small"}],
                "images": [{"id": 7, "file_name": "x.png", "width": 112, "height": 112,
                            "license": 0}], "annotations": []}
    with open(tmp_path / "template.json", "w") as f:
        json.dump(template, f)
    for cli, out in ((jax_cli, "jax.json"), (build_empty_annotation, "port.json")):
        cli.main(["--image-dir", str(img_dir), "--save-dir", str(tmp_path / out),
                  "--coco-dir", str(tmp_path / "template.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert [im["file_name"] for im in json.load(open(tmp_path / "port.json"))["images"]] == \
        ["0.png", "1.png", "3.png", "12.png"]


def _pred_coco(seed):
    rng = np.random.default_rng(seed)
    images = [{"id": i, "file_name": f"{i}.png", "width": 112, "height": 112}
              for i in range(10)]
    anns = []
    for i in range(10):
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(-15, 100, 2)
            w, h = rng.uniform(20, 45, 2)
            anns.append({"id": len(anns), "image_id": i, "category_id": 1, "iscrowd": 0,
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "area": float(w * h), "score": float(rng.uniform())})
    return {"categories": [{"id": 1, "name": "small"}], "images": images, "annotations": anns}


def test_convert_and_evaluate_pseudo_ann_clis_match_jax(tmp_path, capsys):
    from agenda_tpu.cli import convert_pseudo_ann as jax_convert
    from agenda_tpu.cli import evaluate_pseudo_ann as jax_evaluate
    from agenda_tpu_torch.cli import convert_pseudo_ann, evaluate_pseudo_ann

    with open(tmp_path / "pred.json", "w") as f:
        json.dump(_pred_coco(6), f)
    with open(tmp_path / "gt.json", "w") as f:
        json.dump(_pred_coco(7), f)
    for cli, out in ((jax_convert, "jax.json"), (convert_pseudo_ann, "port.json")):
        cli.main(["--pred_file", str(tmp_path / "pred.json"),
                  "--pseudo_pred_file", str(tmp_path / out)])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()

    capsys.readouterr()
    args = ["--ground_truth_file", str(tmp_path / "gt.json"),
            "--pseudo_pred_file", str(tmp_path / "port.json")]
    want = jax_evaluate.main(args)
    want_out = capsys.readouterr().out
    got = evaluate_pseudo_ann.main(args)
    assert got == want and capsys.readouterr().out == want_out
    assert "Precision @ IoU 0.5" in want_out


def test_select_threshold_cli_matches_jax(tmp_path, capsys):
    from agenda_tpu.cli import select_threshold as jax_cli
    from agenda_tpu_torch.cli import select_threshold

    recs = _records(8, n_images=40)
    jrecords.save_predictions(recs, str(tmp_path / "pred_real.pkl"))
    jrecords.save_predictions(_records(9, n_images=16, with_gt=False),
                              str(tmp_path / "pred_syn.pkl"))
    outs = {}
    for tag, cli in (("jax", jax_cli), ("port", select_threshold)):
        d = tmp_path / tag
        (d / "f1").mkdir(parents=True)  # the CLI writes into an existing --out-dir
        (d / "syn").mkdir()
        capsys.readouterr()
        result = cli.main(["--prediction_pkl", str(tmp_path / "pred_real.pkl"),
                           "--table-out", str(d / "table.json"),
                           "--result-out", str(d / "result.json"),
                           "--emit-pseudo-coco", "--out-dir", str(d / "f1")])
        thr = json.load(open(d / "result.json"))["threshold"]
        cli.main(["--prediction_pkl", str(tmp_path / "pred_syn.pkl"), "--emit-pseudo-coco",
                  "--out-dir", str(d / "syn"), "--detector-tag", "yolov8",
                  "--dataset-tag", "SynLINZ-STACKDAAMHeatMaps", "--thresh-conf", str(thr)])
        outs[tag] = (result, capsys.readouterr().out.replace(str(d), "<dir>"))
    assert outs["port"] == outs["jax"]
    assert 0 < outs["jax"][0]["threshold"] < 1
    for rel in ("table.json", "result.json"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for sub in ("f1", "syn"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert len(names) == 1 and "ConfThresh" in names[0]
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        assert (tmp_path / "port" / sub / names[0]).read_bytes() == \
            (tmp_path / "jax" / sub / names[0]).read_bytes()


@pytest.mark.parametrize("flag", ["--plot", "--visualize-samples"])
def test_select_threshold_figures_raise(tmp_path, flag):
    from agenda_tpu_torch.cli import select_threshold

    jrecords.save_predictions(_records(10, n_images=3), str(tmp_path / "p.pkl"))
    with pytest.raises(NotImplementedError, match="matplotlib"):
        select_threshold.main(["--prediction_pkl", str(tmp_path / "p.pkl"),
                               flag, str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
