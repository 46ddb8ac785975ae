"""CLI: detector inference -> prediction records
(== ``mmdetection/tools/test.py <config> <ckpt> --out prediction.pkl``).

Counterpart of ``agenda_tpu/cli/det_test.py``: the same flags plus
``--device {cuda,cpu}`` (default cuda; with cuda and no GPU it raises).
Labels a dataset with a trained detector, writing the pickled per-image
records the annotation stage reads (threshold selection, pseudo-COCO
conversion), and prints bbox mAP/mAP50/mAP75 when the set has
annotations. The checkpoint is the JAX ``det_train``'s
``latest.safetensors`` (or one the port wrote in the same layout).

    python -m agenda_tpu_torch.cli.det_test --config work/config.json \\
        --checkpoint work/latest.safetensors --test-root data --test-ann ann.json \\
        --out pred.pkl
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Detector test / labeling.")
    p.add_argument("--config", type=str, required=True, help="DetectionConfig JSON.")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="variables .safetensors (latest/best_* from det_train).")
    p.add_argument("--out", type=str, default=None, help="prediction.pkl output path.")
    p.add_argument("--test-root", type=str, default=None,
                   help="Override the config's test dataset root.")
    p.add_argument("--test-ann", type=str, default=None)
    p.add_argument("--test-prefix", type=str, default="images/")
    p.add_argument("--device", type=str, choices=("cuda", "cpu"), default="cuda",
                   help="Run on the card (default) or on the CPU.")
    return p.parse_args(argv)


def main(argv=None):
    from agenda_tpu_torch._device import resolve_device
    from agenda_tpu_torch.detect.coco_eval import evaluate_records
    from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig
    from agenda_tpu_torch.detect.runner import DetectorRunner, load_variables

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = DetectionConfig.from_json(args.config)
    spec = cfg.test_dataset
    if args.test_root:
        spec = DatasetSpec(args.test_root, args.test_ann, args.test_prefix)
    if spec is None:
        raise ValueError("No test dataset in config; pass --test-root/--test-ann")

    family = cfg.build_family()
    runner = DetectorRunner(family, cfg.runner, device=device)
    dataset = cfg.build_eval_dataset(spec)
    variables = load_variables(args.checkpoint)
    records = runner.test(variables, dataset, out_pkl=args.out)

    if any(len(r["gt_instances"]["bboxes"]) for r in records):
        res = evaluate_records(records)
        print({k: round(v, 4) for k, v in res.items()})
    if args.out:
        print(f"wrote {len(records)} records to {args.out}")
    return records


if __name__ == "__main__":
    main()
