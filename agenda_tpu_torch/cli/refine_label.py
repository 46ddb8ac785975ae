"""CLI: pseudo-label refinement with a ResNet-50 crop classifier.

Counterpart of ``agenda_tpu/cli/refine_label.py`` (the reference's
``data_annotation/refine_label.py:242-279``): the same flags and defaults
plus ``--device {cuda,cpu}`` (default cuda; with cuda and no GPU it
raises). It writes ``resnet_best_accuracy.safetensors`` and
``resnet_best_f1.safetensors`` in the JAX CLI's flat layout
(``params.<flax path>``, ``batch_stats.<flax path>``) and the refined COCO
JSON. Evaluation runs on the training crops, as the reference's does (it
has no held-out split, ``refine_label.py:301-303``).

One ``numpy`` generator seeded with ``--seed`` serves every draw, in the JAX
CLI's order: each epoch draws one flip a training crop (in order), then
shuffles once. The crops are cut and resized once (Pillow's BICUBIC, in
numpy), kept as uint8 in pinned host memory, and each batch is gathered,
uploaded, flipped and scaled on the card (``annotate/classifier.CropFeed``).

    python -m agenda_tpu_torch.cli.refine_label --prediction_pkl pred.pkl \\
        --synthetic_image_base_path Synthetic/UGRC-with-cars/images \\
        --json_save_path refined.json --checkpoint_save_path clf/
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

logger = logging.getLogger("agenda_tpu_torch.refine_label")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pseudo-label refinement.")
    p.add_argument("--prediction_pkl", type=str, help="prediction file path")
    p.add_argument("--synthetic_image_base_path", type=str, help="image path")
    p.add_argument("--json_save_path", type=str, help="prediction json save path")
    p.add_argument("--checkpoint_save_path", type=str, help="classifier checkpoint save path")
    p.add_argument("--pos_thresh", type=float, default=0.75)
    p.add_argument("--neg_thresh", type=float, default=0.35)
    p.add_argument("--hard_neg_thresh", type=float, default=0.05)
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=80)
    p.add_argument("--train_batch_size", type=int, default=256)
    p.add_argument("--test_batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrained_backbone", type=str, default=None,
                   help="torchvision resnet50 .pth/.safetensors for ImageNet init "
                        "(the reference uses pretrained=True, refine_label.py:326; "
                        "without network access supply the file explicitly).")
    p.add_argument("--device", type=str, choices=("cuda", "cpu"), default="cuda",
                   help="Run on the card (default) or on the CPU.")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from agenda_tpu_torch._device import resolve_device
    from agenda_tpu_torch.annotate.classifier import (
        CropFeed,
        default_compute_dtype,
        init_classifier,
        make_adam,
        make_classifier_train_step,
        padded_index_batches,
        predict,
    )
    from agenda_tpu_torch.annotate.coco import save_coco
    from agenda_tpu_torch.annotate.records import load_predictions
    from agenda_tpu_torch.annotate.refine import (
        append_positive_test_annotations,
        construct_data,
        macro_f1_binary,
        resize_crops,
    )
    from agenda_tpu_torch.io.resnet_import import load_torchvision_resnet50
    from agenda_tpu_torch.io.safetensors_io import save_file
    from agenda_tpu_torch.models.resnet import resnet_to_flax

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    dtype = default_compute_dtype(device)
    logger.info("device %s, compute dtype %s", device, dtype)
    os.makedirs(args.checkpoint_save_path, exist_ok=True)

    t0 = time.perf_counter()
    records = load_predictions(args.prediction_pkl)
    data = construct_data(records, args.pos_thresh, args.neg_thresh, args.hard_neg_thresh,
                          rgb_image_base_path=args.synthetic_image_base_path)
    t_crop = time.perf_counter()
    train_feed = CropFeed(resize_crops(data.train_crops, args.crop_size), device)
    test_feed = CropFeed(resize_crops(data.test_crops, args.crop_size), device)
    t_resize = time.perf_counter()
    n_train, n_test = len(train_feed), len(test_feed)
    logger.info("crops: %d train (%d pos), %d unlabeled", n_train, sum(data.train_labels), n_test)
    train_y = np.asarray(data.train_labels, np.int32)
    labels_dev = train_feed.upload(train_y.astype(np.float32))

    rng_np = np.random.default_rng(args.seed)
    tx = make_adam(args.lr)
    model, opt_state = init_classifier(torch.Generator().manual_seed(args.seed), tx, device,
                                       num_classes=args.num_classes)
    if args.pretrained_backbone:
        load_torchvision_resnet50(model, args.pretrained_backbone, args.num_classes)
        logger.info("initialized backbone from %s", args.pretrained_backbone)
    train_step = make_classifier_train_step(model, tx, dtype)
    mask_rows = torch.arange(args.train_batch_size, device=device)

    def save_ckpt(name, state_dict):
        save_file(resnet_to_flax(state_dict), os.path.join(args.checkpoint_save_path, name))

    def predictions(feed):
        """Predictions (len(feed),) bool on the host over padded test batches."""
        out = []
        for bb, real in padded_index_batches(len(feed), args.test_batch_size, False, rng_np):
            images, _ = feed.batch(bb)
            out.append(predict(model, images, dtype)[:real])
        return torch.cat(out).cpu().numpy() if out else np.zeros(0, bool)

    best_acc = best_f1 = 0.0
    best_state_f1 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    history, epoch_s, steps = [], [], 0
    for epoch in range(args.num_epochs if n_train else 0):
        t_epoch = time.perf_counter()
        # Random hflip augmentation per epoch (refine_label.py:291), then one shuffle.
        train_feed.set_flips(rng_np.random(n_train) < 0.5)
        for bb, real in padded_index_batches(n_train, args.train_batch_size, True, rng_np):
            images, rows = train_feed.batch(bb)
            train_step(opt_state, images, labels_dev[rows], (mask_rows < real).float())
            steps += 1
        train_feed.set_flips(None)
        preds = predictions(train_feed).astype(np.int32)
        acc = float(np.mean(preds == train_y))
        f1 = macro_f1_binary(preds, train_y)
        epoch_s.append(time.perf_counter() - t_epoch)
        history.append({"epoch": epoch, "accuracy": acc, "f1": f1})
        logger.info("Epoch %d: Train Accuracy: %.4f, Train f1: %.4f", epoch, acc, f1)
        if acc > best_acc:
            best_acc = acc
            save_ckpt("resnet_best_accuracy.safetensors", model.state_dict())
        if f1 > best_f1:
            best_f1 = f1
            best_state_f1 = {k: v.detach().clone() for k, v in model.state_dict().items()}
            save_ckpt("resnet_best_f1.safetensors", best_state_f1)

    # Test with the best-F1 weights (refine_label.py:351-353).
    model.load_state_dict(best_state_f1)
    keep = predictions(test_feed)
    pos_ids = [int(i) for i in np.flatnonzero(keep)]
    coco = append_positive_test_annotations(data.annotations_coco, data.test_anns, pos_ids)
    save_coco(coco, args.json_save_path)
    logger.info("kept %d/%d unlabeled crops; wrote %s", len(pos_ids), n_test,
                args.json_save_path)
    return {"history": history, "kept": len(pos_ids), "n_train": n_train, "n_test": n_test,
            "steps": steps, "epoch_seconds": epoch_s, "dtype": str(dtype),
            "crop_seconds": t_crop - t0, "resize_seconds": t_resize - t_crop,
            "n_crops": n_train + n_test}


if __name__ == "__main__":
    main()
