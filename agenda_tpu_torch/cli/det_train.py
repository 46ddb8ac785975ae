"""CLI: detector training (== ``mmdetection/tools/train.py <config>``).

Counterpart of ``agenda_tpu/cli/det_train.py``: the same flags plus
``--device {cuda,cpu}`` (default cuda; with cuda and no GPU it raises) and
``--dist-backend``. Under ``torchrun --nproc_per_node N`` it trains data
parallel over the N ranks, ``--batch-size`` a rank (the global batch is N
times it, as the JAX runner's is ``batch_size x dp``).

    python -m agenda_tpu_torch.cli.det_train --config run.json
    python -m agenda_tpu_torch.cli.det_train --preset synthetic_heatmap --detector yolov8 \\
        --train-root data/train --train-ann ann.json \\
        --val-root data/val --val-ann ann.json --work-dir work_dirs/yolov8_heatmap

A JSON config (``DetectionConfig``) is the reproducible artifact; the preset
flags generate one and save it next to the checkpoints. Every family
trains (``--detector faster-rcnn | yolov5 | yolov5s | yolov8 | yolov8s |
vitdet``), with the augmentation on the host or, with ``--device-aug``,
rendered on the device from the host's plans (``--device-aug-workers``
processes build them ahead). ``--pretrained`` starts from an mmdet/mmyolo
checkpoint (``.pth`` or ``.safetensors``), as the reference's ``load_from``:
the class-count heads are skipped by shape.
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Detector training.")
    p.add_argument("--config", type=str, default=None, help="DetectionConfig JSON.")
    p.add_argument("--preset", type=str, default=None,
                   choices=["real_source", "synthetic_heatmap", "synthetic_target"])
    p.add_argument("--detector", type=str, default="yolov8")
    p.add_argument("--train-root", type=str, action="append", default=None)
    p.add_argument("--train-ann", type=str, action="append", default=None)
    p.add_argument("--train-prefix", type=str, action="append", default=None)
    p.add_argument("--val-root", type=str, default=None)
    p.add_argument("--val-ann", type=str, default=None)
    p.add_argument("--val-prefix", type=str, default="images/")
    p.add_argument("--work-dir", type=str, default="work_dirs/run")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--pretrained", type=str, default=None,
                   help="mmdet/mmyolo checkpoint (.pth or .safetensors) to initialize from "
                        "(the reference's load_from).")
    p.add_argument("--auto-scale-lr", action="store_true",
                   help="Scale the lr by the batch size over the config's base_batch_size.")
    p.add_argument("--device-aug", action="store_true",
                   help="Render the train augmentations on the device from a resident dataset "
                        "tensor (the host draws the random numbers and does the box math); a "
                        "recipe the planner cannot express takes the host pipeline.")
    p.add_argument("--device-aug-workers", type=int, default=0,
                   help="Worker processes that build future epochs' device-aug plans "
                        "(identical to the serial ones). 0 = serial.")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, choices=("cuda", "cpu"), default="cuda",
                   help="Train on the card (default) or on the CPU.")
    p.add_argument("--dist-backend", type=str, choices=("nccl", "gloo"), default=None,
                   help="The process group's backend under torchrun (default: nccl on the "
                        "card, gloo on the CPU; gloo puts several ranks on one card).")
    return p.parse_args(argv)


def main(argv=None):
    from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig, preset
    from agenda_tpu_torch.detect.runner import DetectorRunner
    from agenda_tpu_torch.parallel.mesh import make_mesh

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    args = parse_args(argv)
    mesh = make_mesh(device=args.device, backend=args.dist_backend)

    if args.config:
        cfg = DetectionConfig.from_json(args.config)
    else:
        if not (args.preset and args.train_root and args.train_ann):
            raise ValueError("Provide --config or (--preset --train-root --train-ann)")
        prefixes = args.train_prefix or ["images/"] * len(args.train_root)
        train = [DatasetSpec(r, a, pf)
                 for r, a, pf in zip(args.train_root, args.train_ann, prefixes)]
        val = (DatasetSpec(args.val_root, args.val_ann, args.val_prefix)
               if args.val_root else None)
        cfg = preset(args.preset, args.detector, train, val=val, output_dir=args.work_dir)
    if args.max_epochs is not None:
        cfg.runner.max_epochs = args.max_epochs
    if args.batch_size is not None:
        cfg.runner.batch_size = args.batch_size
    if args.lr is not None:
        cfg.runner.lr = args.lr
    if args.pretrained is not None:
        cfg.pretrained = args.pretrained
    if args.auto_scale_lr:
        cfg.runner.auto_scale_lr = True
    if args.device_aug:
        cfg.runner.device_aug = True
    if args.device_aug_workers:
        cfg.runner.device_aug_workers = args.device_aug_workers
    cfg.runner.seed = args.seed
    cfg.runner.output_dir = args.work_dir if args.work_dir else cfg.runner.output_dir

    os.makedirs(cfg.runner.output_dir, exist_ok=True)
    if mesh.is_main:
        cfg.to_json(os.path.join(cfg.runner.output_dir, "config.json"))

    family = cfg.build_family()
    runner = DetectorRunner(family, cfg.runner, mesh=mesh)
    train_ds = cfg.build_train_dataset()
    val_ds = cfg.build_eval_dataset(cfg.val_dataset) if cfg.val_dataset else None
    return runner.train(train_ds, val_ds, resume=args.resume, pretrained=cfg.pretrained)


if __name__ == "__main__":
    main()
