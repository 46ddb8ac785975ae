"""CLI: end-to-end AGenDA pipeline orchestrator over the port's own CLIs.

Counterpart of ``agenda_tpu/cli/pipeline.py``: the same ``PipelineConfig``
JSON (unknown keys are rejected), the same 21-stage DAG (names, order,
argv, sentinels, ``done_glob`` and the runtime placeholders), the same
completion markers, ``--trust-outputs``, ``--list``, ``--dry-run``,
``--stages``, ``--from-stage``, ``--until-stage``, ``--force`` and
``pipeline_manifest.jsonl``. Each stage runs in-process through
``agenda_tpu_torch.cli.<module>.main(argv)``; nothing of ``agenda_tpu`` is
imported. ``--device {cuda,cpu}`` (default cuda) is appended to the argv of
the stages whose CLIs take it (``finetune_sd``, ``finetune_sd_token``,
``data_generation``, ``det_train``, ``det_test``, ``refine_label``); with
cuda and no GPU those stages raise. Under ``torchrun --nproc_per_node N``
every rank runs the stages that split over ranks (``MESH_MODULES``: the
fine-tunes, generation, detector training and labelling, the JAX package's
mesh call sites) and rank 0 alone runs the others and writes the markers
and the manifest, the ranks meeting after each stage.

    python -m agenda_tpu_torch.cli.pipeline --init my_run.json      # write template
    python -m agenda_tpu_torch.cli.pipeline --config my_run.json --list
    python -m agenda_tpu_torch.cli.pipeline --config my_run.json             # run all
    python -m agenda_tpu_torch.cli.pipeline --config my_run.json --device cpu \
        --until-stage label_synthetic_target
    python -m agenda_tpu_torch.cli.pipeline --config my_run.json --from-stage refine

Stages (in order, each mapping to one reference command):

  finetune_sd            full SD fine-tune on both domains    (gen README:8-11)
  token_stage1           learnable tokens + UNet, attn reg    (gen README:14-19)
  token_stage2           frozen embeddings, UNet only         (gen README:21-26)
  generate_source        source-style images + heatmaps       (gen README:32-43)
  generate_target        target-style images + heatmaps       (gen README:45-56)
  generate_target_nocars target-style background-only images  (gen README:58-67)
  stack_source           (obj, fg, 255-bg) heatmap stacking   (gen README:79-86)
  stack_target           same for the target domain           (gen README:69-78)
  empty_ann_*            images-only COCO for the 3 sets      (ann README:15-21)
  det_real_source        detector #1 on real source GT        (ann README:5-8)
  test_real_source       test on real source test set (GT)    (ann README:10-12)
  threshold_source       F1-max threshold from the real test  (ann README:26)
  label_synthetic_source label synthetic source images        (ann README:14-25)
  pseudo_source          pseudo COCO at the chosen threshold  (ann README:26)
  det_synthetic_heatmap  detector #2 on source heatmap stacks (ann README:28-34)
  label_synthetic_target label target heatmap stacks          (ann README:36-39)
  refine                 crop-classifier label refinement     (ann README:40-50)
  det_synthetic_target   final detector on target images      (ann README:52-58)
  evaluate               test on real target + P/R vs GT      (ann README:52)

Each stage is skipped when the orchestrator recorded its completion and
its sentinel outputs exist (resume; ``--force`` re-runs). Per-stage extra
flags ride the config's ``extra_args`` map; ``pipeline_manifest.jsonl`` in
the work dir records every stage run (argv, wall seconds).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class PipelineConfig:
    # -- layout --------------------------------------------------------------
    work_dir: str = "runs/agenda"
    # -- generation side -----------------------------------------------------
    base_model: str = "CompVis/stable-diffusion-v1-4"  # diffusers-layout dir
    dataset_folder: str = "Data"            # real images for SD fine-tuning
    train_json: str = "train_data.json"     # {filename: prompt} (gen README:5)
    source_name: str = "LINZ"
    target_name: str = "UGRC"
    object_word: str = "cars"
    source_phrase: str = "New Zealand"      # token init word #3 -> new_token_v2
    target_phrase: str = "Utah"             # token init word #2 -> new_token_v1
    num_images: int = 10000                 # per synthetic set (gen README:41)
    sd_steps: int = 15000                   # finetune_sd.sh:5
    token_steps_stage1: int = 9000          # finetune_sd_token.sh:6
    token_steps_stage2: int = 4500          # finetune_sd_token_stage2.sh:6
    resolution: int = 512
    image_size: int = 112
    skip_full_finetune: bool = False        # start token stages from base_model
    # -- annotation side -----------------------------------------------------
    detector: str = "yolov8"
    real_train_root: str = "Data/Real/LINZ/train"
    real_train_ann: str = "annotations_coco_FakeBBoxes:42.36px_ForIoU:0.500.json"
    real_val_root: Optional[str] = None     # defaults to real_train_root
    real_val_ann: Optional[str] = None
    # source test split WITH GT: the F1-max threshold is selected from real
    # test-set predictions, then applied to synthetic (ann README:10-26)
    real_test_root: Optional[str] = None    # defaults to real_val/real_train
    real_test_ann: Optional[str] = None
    real_target_test_root: str = "Data/Real/UGRC/test"
    real_target_test_ann: str = "annotations_coco_FakeBBoxes:42.36px_ForIoU:0.500.json"
    thresh_conf: Optional[float] = None     # None = F1-max from threshold_source
    device_aug: bool = False                # render detector aug on chip
    pos_thresh: float = 0.75                # ann README:47-49
    neg_thresh: float = 0.35
    hard_neg_thresh: float = 0.05
    # -- per-stage extra CLI flags, e.g. {"det_real_source": ["--batch-size", "8"]}
    extra_args: Dict[str, List[str]] = dataclasses.field(default_factory=dict)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown pipeline config keys: {sorted(unknown)}")
        return cls(**raw)


@dataclasses.dataclass
class Stage:
    name: str
    module: str                  # agenda_tpu_torch.cli.<module>.main(argv)
    argv: List[str]
    outputs: List[str]           # sentinels: skip when all exist (files or dirs)
    note: str = ""
    done_glob: Optional[str] = None  # alternative sentinel: any glob match


def _latest(pattern: str) -> Optional[str]:
    """Newest match by the trailing integer in the name (step counters)."""
    hits = glob.glob(pattern)
    if not hits:
        return None

    def step_of(p):
        digits = "".join(c for c in os.path.basename(p) if c.isdigit())
        return int(digits) if digits else -1

    return max(hits, key=step_of)


def _token_model_dir(stage_dir: str) -> str:
    """Model path produced by a token fine-tune stage: the newest
    ``full_model_step_N`` export (finetune_sd_token.py:164-187 semantics), or
    the stage dir itself when it carries a pipeline export."""
    hit = _latest(os.path.join(stage_dir, "full_model_step_*"))
    if hit:
        return hit
    if os.path.exists(os.path.join(stage_dir, "model_index.json")):
        return stage_dir
    # stage not run yet: report the path the stage WILL produce (dry-run)
    return os.path.join(stage_dir, "full_model_step_<N>")


def _learned_embeds(stage_dir: str, steps: int) -> str:
    exact = os.path.join(stage_dir, f"learned_embeds_steps_{steps}.bin")
    if os.path.exists(exact):
        return exact
    return _latest(os.path.join(stage_dir, "learned_embeds_steps_*.bin")) or exact


# the stage CLIs that take --device
DEVICE_MODULES = ("finetune_sd", "finetune_sd_token", "data_generation", "det_train",
                  "det_test", "refine_label")
# the stages every rank of a multi-card run takes part in
MESH_MODULES = ("finetune_sd", "finetune_sd_token", "data_generation", "det_train", "det_test")


def build_stages(cfg: PipelineConfig, device: Optional[str] = None) -> List[Stage]:
    """The DAG of ``agenda_tpu/cli/pipeline.py::build_stages``; with ``device``,
    ``--device <device>`` ends the argv of the stages in DEVICE_MODULES."""
    wd = cfg.work_dir
    syn = os.path.join(wd, "Synthetic")
    src_set = os.path.join(syn, f"{cfg.source_name}-with-cars")
    tgt_set = os.path.join(syn, f"{cfg.target_name}-with-cars")
    tgt_bg_set = os.path.join(syn, f"{cfg.target_name}-without-cars")
    sd_dir = os.path.join(wd, "sd-finetune")
    tok1 = os.path.join(wd, "token-stage-one")
    tok2 = os.path.join(wd, "token-stage-two")
    det_wd = os.path.join(wd, "work_dirs")

    token_base = cfg.base_model if cfg.skip_full_finetune else sd_dir
    stage1_model = _token_model_dir(tok1)
    stage2_model = _token_model_dir(tok2)
    embeds = _learned_embeds(tok1, cfg.token_steps_stage1)
    init_tokens = [cfg.object_word, cfg.target_phrase, cfg.source_phrase]
    # initialize_token order fixes the token ids (finetune_sd_token.sh:18):
    # v0 = object/fg, v1 = target bg phrase, v2 = source bg phrase — the
    # postprocess commands pick the matching bg map (gen README:69-86).
    prompt_src = f"An aerial view image with {{}} {cfg.object_word} in {{}} {cfg.source_phrase}"
    prompt_tgt = f"An aerial view image with {{}} {cfg.object_word} in {{}} {cfg.target_phrase}"
    prompt_tgt_bg = f"An aerial view image in {{}} {cfg.target_phrase}"

    rs_dir = os.path.join(det_wd, f"{cfg.detector}_real_source")
    sh_dir = os.path.join(det_wd, f"{cfg.detector}_synthetic_heatmap")
    st_dir = os.path.join(det_wd, f"{cfg.detector}_synthetic_target")
    pred_real_src = os.path.join(rs_dir, "prediction_real_source.pkl")
    thr_result = os.path.join(rs_dir, "threshold_result.json")
    pred_syn_src = os.path.join(rs_dir, "prediction_syn_source.pkl")
    pred_syn_tgt = os.path.join(sh_dir, "prediction_syn_target.pkl")
    pred_real_tgt = os.path.join(st_dir, "prediction_real_target.pkl")
    thr_table = os.path.join(rs_dir, "threshold_table.json")
    refined_ann = os.path.join(
        tgt_set,
        "annotations_coco_FakeBBoxes:42.36px_ForIoU:0.500_"
        f"Pseudo-{cfg.detector}-Syn{cfg.target_name}-STACKDAAMHeatMaps-Clf-Refine.json",
    )

    stages: List[Stage] = []

    if not cfg.skip_full_finetune:
        stages.append(Stage(
            "finetune_sd", "finetune_sd",
            ["--pretrained_model_name_or_path", cfg.base_model,
             "--dataset_folder", cfg.dataset_folder,
             "--json_file_name", cfg.train_json,
             "--max_train_steps", str(cfg.sd_steps),
             "--train_batch_size", "32", "--learning_rate", "1e-6",
             "--snr_gamma", "5", "--checkpointing_steps", "400",
             "--checkpoints_total_limit", "3",
             "--resolution", str(cfg.resolution),
             "--output_dir", sd_dir],
            [os.path.join(sd_dir, "model_index.json")],
            "finetune_sd.sh hyperparameters"))

    stages.append(Stage(
        "token_stage1", "finetune_sd_token",
        ["--pretrained_model_name_or_path", token_base,
         "--dataset_folder", cfg.dataset_folder,
         "--json_file_name", cfg.train_json,
         "--max_train_steps", str(cfg.token_steps_stage1),
         "--train_batch_size", "4", "--learning_rate", "5e-7",
         "--snr_gamma", "5", "--checkpointing_steps", "300",
         "--checkpoints_total_limit", "3",
         "--resolution", str(cfg.resolution),
         "--output_dir", tok1,
         "--object_token", "new_token", "--n_object_embedding", "1",
         "--initialize_token", *init_tokens,
         "--reg_weight", "0.5",
         "--train_token", "--with_cross_attn_reg", "--train_unet"],
        [os.path.join(tok1, f"learned_embeds_steps_{cfg.token_steps_stage1}.bin")],
        "finetune_sd_token.sh hyperparameters"))

    stages.append(Stage(
        "token_stage2", "finetune_sd_token",
        ["--pretrained_model_name_or_path", stage1_model,
         "--dataset_folder", cfg.dataset_folder,
         "--json_file_name", cfg.train_json,
         "--max_train_steps", str(cfg.token_steps_stage2),
         "--train_batch_size", "4", "--learning_rate", "5e-7",
         "--snr_gamma", "5", "--checkpointing_steps", "300",
         "--checkpoints_total_limit", "3",
         "--resolution", str(cfg.resolution),
         "--output_dir", tok2,
         "--object_token", "new_token", "--n_object_embedding", "1",
         "--initialize_token", *init_tokens,
         "--reg_weight", "0.5",
         "--train_unet", "--with_cross_attn_reg",
         "--embedding_path", embeds],
        [os.path.join(tok2, f"full_model_step_{cfg.token_steps_stage2}")],
        "finetune_sd_token_stage2.sh hyperparameters"))

    def gen_stage(name, save_dir, prompt, heatmaps):
        argv = ["--pretrained-model-path", stage2_model,
                "--learnable-tokens-embedding-path", embeds,
                "--initialize_token", *init_tokens,
                "--save-dir", save_dir, "--prompt", prompt,
                "--num-images", str(cfg.num_images),
                "--image-size", str(cfg.image_size),
                "--resolution", str(cfg.resolution)]
        if heatmaps:
            argv += ["--word_token_heatmaps", cfg.object_word,
                     "--store_learnable_token_heatmaps"]
        return Stage(name, "data_generation", argv,
                     [os.path.join(save_dir, "images")],
                     "data_generation/README.md generation commands")

    stages.append(gen_stage("generate_source", src_set, prompt_src, True))
    stages.append(gen_stage("generate_target", tgt_set, prompt_tgt, True))
    stages.append(gen_stage("generate_target_nocars", tgt_bg_set, prompt_tgt_bg, False))

    # bg token: v1 = target phrase, v2 = source phrase (README:69-86)
    for name, save_dir, bg in (("stack_source", src_set, "new_token_v2"),
                               ("stack_target", tgt_set, "new_token_v1")):
        stages.append(Stage(
            name, "postprocess_heatmap",
            ["--save-dir", save_dir,
             "--object-heatmap-path", f"daam_{cfg.object_word}_heatmaps",
             "--fg-heatmap-path", "daam_new_token_v0_heatmaps",
             "--bg-heatmap-path", f"daam_{bg}_heatmaps",
             "--stack-heatmap-save-path", "daam_stack_heatmaps",
             "--inv-heatmap-save-path", f"daam_{bg}_inv_heatmaps"],
            [os.path.join(save_dir, "daam_stack_heatmaps")],
            "postprocess_heatmap stacking"))

    # empty annotations for the unlabeled synthetic sets (ann README:15-21)
    real_ann_path = (cfg.real_train_ann if os.path.isabs(cfg.real_train_ann)
                     else os.path.join(cfg.real_train_root, cfg.real_train_ann))
    for tag, save_dir in (("source", src_set), ("target", tgt_set),
                          ("target_nocars", tgt_bg_set)):
        stages.append(Stage(
            f"empty_ann_{tag}", "build_empty_annotation",
            ["--image-dir", os.path.join(save_dir, "images"),
             "--save-dir", os.path.join(save_dir, "annotations_coco_Empty.json"),
             "--coco-dir", real_ann_path],
            [os.path.join(save_dir, "annotations_coco_Empty.json")],
            "build_empty_annotation.py"))

    stages.append(Stage(
        "det_real_source", "det_train",
        ["--preset", "real_source", "--detector", cfg.detector,
         "--train-root", cfg.real_train_root, "--train-ann", cfg.real_train_ann,
         "--val-root", cfg.real_val_root or cfg.real_train_root,
         "--val-ann", cfg.real_val_ann or cfg.real_train_ann,
         "--work-dir", rs_dir],
        [os.path.join(rs_dir, "latest.safetensors")],
        "detector #1 (ann README:8)"))

    test_root = cfg.real_test_root or cfg.real_val_root or cfg.real_train_root
    test_ann = cfg.real_test_ann or cfg.real_val_ann or cfg.real_train_ann
    stages.append(Stage(
        "test_real_source", "det_test",
        ["--config", os.path.join(rs_dir, "config.json"),
         "--checkpoint", os.path.join(rs_dir, "latest.safetensors"),
         "--test-root", test_root, "--test-ann", test_ann,
         "--out", pred_real_src],
        [pred_real_src], "real source test with GT (ann README:10-12)"))

    stages.append(Stage(
        "threshold_source", "select_threshold",
        ["--prediction_pkl", pred_real_src,
         "--table-out", thr_table, "--result-out", thr_result],
        [thr_result],
        "F1-max threshold from real test predictions (ann README:26)"))

    stages.append(Stage(
        "label_synthetic_source", "det_test",
        ["--config", os.path.join(rs_dir, "config.json"),
         "--checkpoint", os.path.join(rs_dir, "latest.safetensors"),
         "--test-root", src_set, "--test-ann", "annotations_coco_Empty.json",
         "--out", pred_syn_src],
        [pred_syn_src], "label synthetic source (ann README:22-25)"))

    stages.append(Stage(
        "pseudo_source", "select_threshold",
        ["--prediction_pkl", pred_syn_src, "--emit-pseudo-coco",
         "--out-dir", src_set, "--detector-tag", cfg.detector,
         "--dataset-tag", f"Syn{cfg.source_name}-STACKDAAMHeatMaps",
         "--image-size", str(cfg.image_size),
         "--thresh-conf", "__THRESH_SOURCE__"],
        [],  # output name embeds the runtime threshold -> glob sentinel
        "pseudo COCO at the chosen threshold (ann README:26)",
        done_glob=os.path.join(
            src_set, "annotations_coco_FakeBBoxes*Pseudo-*.json")))

    stages.append(Stage(
        "det_synthetic_heatmap", "det_train",
        ["--preset", "synthetic_heatmap", "--detector", cfg.detector,
         "--train-root", src_set,
         "--train-ann", "__PSEUDO_SOURCE__",  # resolved at run time
         "--train-prefix", "daam_stack_heatmaps/",
         "--work-dir", sh_dir],
        [os.path.join(sh_dir, "latest.safetensors")],
        "detector #2 on heatmap stacks (ann README:28-34)"))

    stages.append(Stage(
        "label_synthetic_target", "det_test",
        ["--config", os.path.join(sh_dir, "config.json"),
         "--checkpoint", os.path.join(sh_dir, "latest.safetensors"),
         "--test-root", tgt_set, "--test-ann", "annotations_coco_Empty.json",
         "--test-prefix", "daam_stack_heatmaps/",
         "--out", pred_syn_tgt],
        [pred_syn_tgt], "label target heatmap stacks (ann README:36-39)"))

    stages.append(Stage(
        "refine", "refine_label",
        ["--prediction_pkl", pred_syn_tgt,
         "--synthetic_image_base_path", os.path.join(tgt_set, "images"),
         "--json_save_path", refined_ann,
         "--checkpoint_save_path", os.path.join(sh_dir, "heatmap-clf"),
         "--pos_thresh", str(cfg.pos_thresh),
         "--neg_thresh", str(cfg.neg_thresh),
         "--hard_neg_thresh", str(cfg.hard_neg_thresh)],
        [refined_ann], "crop-classifier refinement (ann README:42-50)"))

    stages.append(Stage(
        "det_synthetic_target", "det_train",
        ["--preset", "synthetic_target", "--detector", cfg.detector,
         "--train-root", tgt_set, "--train-ann", os.path.abspath(refined_ann),
         "--train-root", tgt_bg_set, "--train-ann", "annotations_coco_Empty.json",
         "--val-root", cfg.real_target_test_root,
         "--val-ann", cfg.real_target_test_ann,
         "--work-dir", st_dir],
        [os.path.join(st_dir, "latest.safetensors")],
        "final detector (ann README:52-58)"))

    stages.append(Stage(
        "evaluate", "det_test",
        ["--config", os.path.join(st_dir, "config.json"),
         "--checkpoint", os.path.join(st_dir, "latest.safetensors"),
         "--test-root", cfg.real_target_test_root,
         "--test-ann", cfg.real_target_test_ann,
         "--out", pred_real_tgt],
        [pred_real_tgt], "test on real target (ann README:52)"))

    if cfg.device_aug:
        for s in stages:
            if s.module == "det_train":
                s.argv.append("--device-aug")
    for s in stages:
        s.argv += cfg.extra_args.get(s.name, [])
        if device is not None and s.module in DEVICE_MODULES:
            s.argv += ["--device", device]
    return stages


def _resolve_runtime_args(stage: Stage, cfg: PipelineConfig) -> List[str]:
    """Substitute placeholders that only exist after earlier stages ran."""
    argv = list(stage.argv)
    if "__PSEUDO_SOURCE__" in argv:
        src_set = os.path.join(cfg.work_dir, "Synthetic",
                               f"{cfg.source_name}-with-cars")
        hits = glob.glob(os.path.join(
            src_set, "annotations_coco_FakeBBoxes*Pseudo-*.json"))
        if not hits:
            raise FileNotFoundError(
                f"no pseudo COCO under {src_set} — run pseudo_source first")
        # newest by mtime: the filename digits encode box size/threshold,
        # not a counter, so a --force re-run at a new threshold must win
        hit = max(hits, key=os.path.getmtime)
        argv[argv.index("__PSEUDO_SOURCE__")] = os.path.abspath(hit)
    if "__THRESH_SOURCE__" in argv:
        if cfg.thresh_conf is not None:
            thr = cfg.thresh_conf
        else:
            result_path = os.path.join(
                cfg.work_dir, "work_dirs", f"{cfg.detector}_real_source",
                "threshold_result.json")
            if not os.path.exists(result_path):
                raise FileNotFoundError(
                    f"{result_path} missing — run threshold_source first "
                    "(or set thresh_conf in the pipeline config)")
            with open(result_path) as f:
                thr = json.load(f)["threshold"]
        argv[argv.index("__THRESH_SOURCE__")] = str(thr)
    return argv


def _marker(cfg: PipelineConfig, name: str) -> str:
    return os.path.join(cfg.work_dir, ".stage_done", name)


def _done(stage: Stage, cfg: PipelineConfig, trust_outputs: bool = False) -> bool:
    """A stage is done when the orchestrator recorded its completion (marker
    written AFTER main() returned). Output sentinels alone are not enough —
    most stages create their output dirs/checkpoints at START or mid-run
    (generation makedirs images/ before sampling; det_train writes
    latest.safetensors every epoch), so an interrupted stage would otherwise
    be skipped as done and feed partial outputs downstream. ``trust_outputs``
    restores sentinel-only skipping for chains begun outside the
    orchestrator."""
    if not trust_outputs and not os.path.exists(_marker(cfg, stage.name)):
        return False
    if stage.done_glob is not None:
        return bool(glob.glob(stage.done_glob))
    return bool(stage.outputs) and all(os.path.exists(o) for o in stage.outputs)


def run_stage(stage: Stage, cfg: PipelineConfig) -> None:
    import importlib

    mod = importlib.import_module(f"agenda_tpu_torch.cli.{stage.module}")
    mod.main(_resolve_runtime_args(stage, cfg))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AGenDA pipeline orchestrator.")
    p.add_argument("--config", type=str, default=None, help="PipelineConfig JSON.")
    p.add_argument("--init", type=str, default=None, metavar="PATH",
                   help="Write a template config to PATH and exit.")
    p.add_argument("--list", action="store_true",
                   help="List stages with done/pending status and exit.")
    p.add_argument("--dry-run", action="store_true",
                   help="Print every stage's resolved argv without running.")
    p.add_argument("--stages", type=str, default=None,
                   help="Comma-separated subset of stages to run.")
    p.add_argument("--from-stage", type=str, default=None,
                   help="Start at this stage (inclusive).")
    p.add_argument("--until-stage", type=str, default=None,
                   help="Stop after this stage (inclusive).")
    p.add_argument("--force", action="store_true",
                   help="Run selected stages even when their outputs exist.")
    p.add_argument("--trust-outputs", action="store_true",
                   help="Treat existing stage outputs as done even without "
                        "this orchestrator's completion markers (for chains "
                        "begun by running the CLIs manually). Default "
                        "requires the marker, so interrupted stages re-run.")
    p.add_argument("--device", type=str, choices=("cuda", "cpu"), default="cuda",
                   help="Device of the stages that run a model (default the card).")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.init:
        PipelineConfig().to_json(args.init)
        print(f"wrote template config to {args.init}")
        return 0
    if not args.config:
        raise SystemExit("--config (or --init) is required")
    cfg = PipelineConfig.from_json(args.config)
    stages = build_stages(cfg, args.device)
    names = [s.name for s in stages]

    selected = set(names)
    if args.stages:
        req = [s.strip() for s in args.stages.split(",") if s.strip()]
        unknown = set(req) - set(names)
        if unknown:
            raise SystemExit(f"unknown stages {sorted(unknown)}; have {names}")
        selected = set(req)
    if args.from_stage:
        if args.from_stage not in names:
            raise SystemExit(f"unknown --from-stage {args.from_stage}")
        selected &= set(names[names.index(args.from_stage):])
    if args.until_stage:
        if args.until_stage not in names:
            raise SystemExit(f"unknown --until-stage {args.until_stage}")
        selected &= set(names[: names.index(args.until_stage) + 1])

    if args.list:
        for s in stages:
            mark = "done   " if _done(s, cfg, args.trust_outputs) else "pending"
            sel = " " if s.name in selected else "-"
            print(f"{sel} [{mark}] {s.name:24s} {s.note}")
        return 0

    mesh = None
    if not args.dry_run:
        from agenda_tpu_torch.parallel.mesh import barrier, make_mesh

        mesh = make_mesh(device=args.device)  # no GPU with cuda: raise before any stage runs
    main_rank = mesh is None or mesh.is_main
    os.makedirs(cfg.work_dir, exist_ok=True)
    os.makedirs(os.path.join(cfg.work_dir, ".stage_done"), exist_ok=True)
    manifest = os.path.join(cfg.work_dir, "pipeline_manifest.jsonl")
    for s in stages:
        if s.name not in selected:
            continue
        if _done(s, cfg, args.trust_outputs) and not args.force:
            sentinel = s.outputs[0] if s.outputs else s.done_glob
            print(f"[skip] {s.name}: complete ({sentinel})")
            continue
        if args.dry_run:
            try:
                argv_show = _resolve_runtime_args(s, cfg)
            except FileNotFoundError:
                argv_show = s.argv  # upstream stage hasn't run yet
            print(f"[dry-run] {s.name}: agenda_tpu_torch.cli.{s.module} "
                  + " ".join(argv_show))
            continue
        print(f"[run ] {s.name} ...", flush=True)
        t0 = time.time()
        # re-resolve glob-dependent inputs now that earlier stages ran
        fresh = build_stages(cfg, args.device)
        stage = next(x for x in fresh if x.name == s.name)
        if main_rank or stage.module in MESH_MODULES:
            run_stage(stage, cfg)
        barrier(mesh)
        if not main_rank:
            continue
        with open(_marker(cfg, s.name), "w") as f:
            f.write(str(time.time()))
        with open(manifest, "a") as f:
            f.write(json.dumps({
                "ts": time.time(), "stage": s.name,
                "argv": _resolve_runtime_args(stage, cfg),
                "seconds": round(time.time() - t0, 2),
            }) + "\n")
        print(f"[done] {s.name} ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
