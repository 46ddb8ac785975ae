"""The port's pipeline orchestrator (agenda_tpu_torch.cli.pipeline) against agenda_tpu's.

- For one ``PipelineConfig`` (and its ``skip_full_finetune`` and
  ``device_aug`` variants) the port's ``build_stages`` equals the JAX
  package's stage for stage: name, module, argv without the port's
  ``--device`` pair, outputs, ``done_glob``, note; ``--device`` ends the
  argv of exactly the stages whose CLIs take it.
- ``--init`` writes the same template; ``--list`` and ``--dry-run`` print
  the same lines but for the module prefix and the ``--device`` flag; an
  unknown config key, stage or ``--from-stage`` is rejected; a run on cuda
  without a GPU raises before any stage runs.
- The tiny chain end to end on the CPU with the port's own fixtures
  (``io/fabricate.py``'s tiny pipeline, ``detect/fabricate.py``'s square
  tiles): up to ``label_synthetic_target``, a resume that runs nothing, the
  target predictions doctored to fill the refine buckets, then
  ``--from-stage refine`` through ``evaluate``; every stage leaves its
  marker and its manifest line, and nothing of ``agenda_tpu`` is called.
"""

import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from agenda_tpu.cli import pipeline as jpl
from agenda_tpu_torch.cli import pipeline as pl

EXTRA_ARGS = {
    "finetune_sd": ["--train_batch_size", "1", "--checkpointing_steps", "100",
                    "--report_to", "jsonl"],
    "token_stage1": ["--train_batch_size", "1", "--checkpointing_steps", "100",
                     "--report_to", "jsonl"],
    "token_stage2": ["--train_batch_size", "1", "--checkpointing_steps", "100",
                     "--report_to", "jsonl"],
    "generate_source": ["--batch-size", "4", "--num-inference-steps", "2"],
    "generate_target": ["--batch-size", "4", "--num-inference-steps", "2"],
    "generate_target_nocars": ["--batch-size", "4", "--num-inference-steps", "2"],
    "det_real_source": ["--max-epochs", "1", "--batch-size", "2"],
    "det_synthetic_heatmap": ["--max-epochs", "1", "--batch-size", "2"],
    "det_synthetic_target": ["--max-epochs", "1", "--batch-size", "2"],
    "refine": ["--num_epochs", "1", "--train_batch_size", "8", "--test_batch_size", "8",
               "--crop_size", "32"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores, where torch's default of one thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls, root, **kw):
    return cls(
        work_dir=os.path.join(root, "run"),
        base_model=os.path.join(root, "pipe"),
        dataset_folder=os.path.join(root, "ds"),
        train_json="data.json",
        num_images=4,
        sd_steps=1, token_steps_stage1=1, token_steps_stage2=1,
        resolution=32, image_size=112,
        detector="yolov8",
        real_train_root=os.path.join(root, "real"),
        real_train_ann="ann.json",
        real_target_test_root=os.path.join(root, "real"),
        real_target_test_ann="ann.json",
        thresh_conf=0.0,
        extra_args=EXTRA_ARGS,
        **kw,
    )


def _without_device(argv):
    out, i = [], 0
    while i < len(argv):
        if argv[i] == "--device":
            i += 2
            continue
        out.append(argv[i])
        i += 1
    return out


@pytest.mark.parametrize("variant", [{}, {"skip_full_finetune": True}, {"device_aug": True}])
def test_build_stages_equals_jax(tmp_path, variant):
    root = str(tmp_path)
    want = jpl.build_stages(_cfg(jpl.PipelineConfig, root, **variant))
    got = pl.build_stages(_cfg(pl.PipelineConfig, root, **variant), "cuda")
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert (g.module, g.outputs, g.done_glob, g.note) == (w.module, w.outputs, w.done_glob,
                                                              w.note)
        assert _without_device(g.argv) == w.argv
        takes = g.module in ("finetune_sd", "finetune_sd_token", "data_generation",
                             "det_train", "det_test", "refine_label")
        assert (g.argv[-2:] == ["--device", "cuda"]) == takes, g.name
    assert [s.argv for s in pl.build_stages(_cfg(pl.PipelineConfig, root, **variant))] == [
        s.argv for s in want]
    assert len(got) == (20 if variant.get("skip_full_finetune") else 21)


def test_config_fields_equal_jax_and_unknown_keys_rejected(tmp_path):
    assert ([(f.name, f.default) for f in dataclasses.fields(pl.PipelineConfig)
             if f.name != "extra_args"]
            == [(f.name, f.default) for f in dataclasses.fields(jpl.PipelineConfig)
                if f.name != "extra_args"])
    port_tpl, jax_tpl = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    pl.main(["--init", port_tpl])
    jpl.main(["--init", jax_tpl])
    with open(port_tpl) as f, open(jax_tpl) as g:
        assert json.load(f) == json.load(g)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"work_dir": "x", "no_such_key": 1}, f)
    with pytest.raises(ValueError, match="no_such_key"):
        pl.PipelineConfig.from_json(bad)


def test_list_and_dry_run_equal_jax(tmp_path, capsys):
    root = str(tmp_path)
    path = str(tmp_path / "cfg.json")
    _cfg(pl.PipelineConfig, root).to_json(path)
    outs = {}
    for name, mod, extra in (("port", pl, ["--device", "cpu"]), ("jax", jpl, [])):
        for flags in (["--list"], ["--dry-run"], ["--dry-run", "--from-stage", "refine",
                                                  "--until-stage", "det_synthetic_target"]):
            mod.main(["--config", path, *flags, *extra])
            outs[name, tuple(flags)] = capsys.readouterr().out
    for flags in (("--list",), ("--dry-run",), ("--dry-run", "--from-stage", "refine",
                                                "--until-stage", "det_synthetic_target")):
        got = outs["port", flags].replace("agenda_tpu_torch.cli.", "agenda_tpu.cli.")
        got = got.replace(" --device cpu", "")
        assert got == outs["jax", flags]
    dry = outs["port", ("--dry-run",)]
    assert dry.count("--device cpu") == 14  # 3 fine-tunes, 3 generations, 3 det_train,
    # 4 det_test and refine_label
    assert "[dry-run] refine: agenda_tpu_torch.cli.refine_label" in dry
    with pytest.raises(SystemExit):
        pl.main(["--config", path, "--stages", "nope"])
    with pytest.raises(SystemExit):
        pl.main(["--config", path, "--from-stage", "nope"])


def test_run_on_cuda_without_a_gpu_raises_before_any_stage(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    path = str(tmp_path / "cfg.json")
    _cfg(pl.PipelineConfig, str(tmp_path)).to_json(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.main(["--config", path, "--stages", "stack_source"])
    assert not os.path.exists(os.path.join(str(tmp_path), "run", "pipeline_manifest.jsonl"))


def make_chain_fixtures(root: str) -> None:
    """The port's tiny pipeline, two prompt tiles, and a 4-tile real set
    with GT, as ``tests/test_pipeline_cli.py`` builds them for the JAX one."""
    from agenda_tpu_torch.detect.fabricate import write_square_set
    from agenda_tpu_torch.io.fabricate import fabricate_pipeline
    from agenda_tpu_torch.utils.png import write_png

    fabricate_pipeline(os.path.join(root, "pipe"), tiny=True, seed=0)
    rng = np.random.default_rng(0)
    ds = os.path.join(root, "ds")
    os.makedirs(ds, exist_ok=True)
    prompts = {}
    for i in range(2):
        write_png(os.path.join(ds, f"img{i}.png"), rng.integers(0, 256, (64, 64, 3), np.uint8))
        prompts[f"img{i}.png"] = "an aerial view image with cars in utah"
    with open(os.path.join(ds, "data.json"), "w") as f:
        json.dump(prompts, f)
    write_square_set(os.path.join(root, "real"), 4, seed=1)


def doctor_target_predictions(path: str) -> None:
    """Give every target record scores in every refine bucket (a fresh tiny
    detector's scores do not span them)."""
    with open(path, "rb") as f:
        records = pickle.load(f)
    for r in records:
        r["pred_instances"] = {
            "scores": np.array([0.9, 0.5, 0.2, 0.6, 0.01]),
            "labels": np.zeros(5, np.int64),
            "bboxes": np.array([[30, 30, 72, 72], [0, 0, 42, 42], [60, 60, 100, 100],
                                [80, 5, 112, 47], [10, 70, 52, 112]], np.float32),
        }
    with open(path, "wb") as f:
        pickle.dump(records, f)


def test_tiny_chain_end_to_end_on_the_cpu(tmp_path):
    root = str(tmp_path)
    make_chain_fixtures(root)
    cfg = _cfg(pl.PipelineConfig, root)
    path = os.path.join(root, "cfg.json")
    cfg.to_json(path)
    run = ["--config", path, "--device", "cpu"]

    pl.main(run + ["--until-stage", "label_synthetic_target"])
    wd = cfg.work_dir
    manifest = os.path.join(wd, "pipeline_manifest.jsonl")
    with open(manifest) as f:
        first = [json.loads(line) for line in f]
    names = [s.name for s in pl.build_stages(cfg)]
    assert [e["stage"] for e in first] == names[: names.index("label_synthetic_target") + 1]
    assert all(e["argv"][-2:] == ["--device", "cpu"] for e in first
               if e["stage"].startswith(("finetune", "token", "generate", "det_", "test_",
                                         "label_")))
    assert os.path.exists(os.path.join(wd, "sd-finetune", "model_index.json"))
    assert len(os.listdir(os.path.join(wd, "Synthetic", "LINZ-with-cars", "images"))) == 4
    assert os.path.isdir(os.path.join(wd, "Synthetic", "UGRC-with-cars", "daam_stack_heatmaps"))
    assert glob.glob(os.path.join(wd, "Synthetic", "LINZ-with-cars",
                                  "annotations_coco_FakeBBoxes*Pseudo-*.json"))
    pred_tgt = os.path.join(wd, "work_dirs", "yolov8_synthetic_heatmap",
                            "prediction_syn_target.pkl")
    assert os.path.exists(pred_tgt)

    # resume: every stage is done, nothing runs
    pl.main(run + ["--until-stage", "label_synthetic_target"])
    with open(manifest) as f:
        assert sum(1 for _ in f) == len(first)

    doctor_target_predictions(pred_tgt)
    pl.main(run + ["--from-stage", "refine"])
    refined = glob.glob(os.path.join(wd, "Synthetic", "UGRC-with-cars", "*Clf-Refine.json"))
    assert len(refined) == 1
    with open(refined[0]) as f:
        coco = json.load(f)
    assert coco["categories"] == [{"id": 1, "name": "small"}]
    labels = [a["label"] for a in coco["annotations"]]
    assert labels.count(1) == 4  # each target image's top-1 (0.9)
    assert set(labels) <= {1, -1}
    ids = [a["image_id"] for a in coco["annotations"]]
    assert ids == sorted(ids)
    with open(os.path.join(wd, "work_dirs", "yolov8_synthetic_target",
                           "prediction_real_target.pkl"), "rb") as f:
        assert len(pickle.load(f)) == 4
    with open(manifest) as f:
        entries = [json.loads(line) for line in f]
    assert [e["stage"] for e in entries] == names
    assert all(e["seconds"] >= 0 for e in entries)
    assert sorted(os.listdir(os.path.join(wd, ".stage_done"))) == sorted(names)
