"""CLI: full SD UNet fine-tuning on the card.

Counterpart of ``agenda_tpu/cli/finetune_sd.py``: the same flags with the
same defaults (``:35-111``), plus ``--device {cuda,cpu}`` (default cuda;
with cuda and no GPU it raises), the same loop and cadences, validation
from the EMA shadow through the port's pipeline, and the final diffusers
export. What differs:

- one process drives one card; ``--fsdp`` above 1 raises (multi-GPU is not
  ported yet);
- ``--gradient_accumulation_steps`` k averages k micro-batches' gradients
  into one update (optax ``MultiSteps`` semantics); the global step counts
  updates, and every cadence keys off it;
- bf16 compute under autocast on the card, f32 on the CPU; the kernels take
  bf16, so ``--mixed_precision no`` raises on the card;
- ``--use_8bit_adam`` selects the fused int8 AdamW kernel;
  the JAX package's TPU opt-outs (AGENDA_TPU_NO_FUSED_ADAMW,
  AGENDA_TPU_NO_DONATE) are not inherited;
- each micro-batch's draws come from a ``torch.Generator`` seeded with
  (seed, micro-batch count), so a resumed run draws what an uninterrupted
  one would (the JAX package folds its step into its key the same way);
  the stream itself is the port's own;
- training images are PNG (read without Pillow).

    python -m agenda_tpu_torch.cli.finetune_sd --pretrained_model_name_or_path <dir> \\
        --dataset_folder Data --json_file_name train.json --resolution 512 \\
        --train_batch_size 4 --max_train_steps 15000 --use_8bit_adam --use_ema
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time

import numpy as np

logger = logging.getLogger("agenda_tpu_torch.finetune_sd")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Full SD fine-tuning (PyTorch, one card).")
    p.add_argument("--input_perturbation", type=float, default=0,
                   help="The scale of input perturbation. Recommended 0.1.")
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None, required=True)
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--variant", type=str, default=None)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--validation_prompts", type=str, default=None, nargs="+")
    p.add_argument("--output_dir", type=str, default="sd-model-finetuned")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--init_resolution", type=int, default=112)
    p.add_argument("--dataset_folder", type=str, default=None)
    p.add_argument("--json_file_name", type=str, default=None)
    p.add_argument("--train_batch_size", type=int, default=16,
                   help="Batch size (per device) for the training dataloader.")
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--scale_lr", action="store_true", default=False)
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--allow_tf32", action="store_true")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--offload_ema", action="store_true")
    p.add_argument("--foreach_ema", action="store_true")
    p.add_argument("--non_ema_revision", type=str, default=None)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-08)
    p.add_argument("--max_grad_norm", default=1.0, type=float)
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16"])
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    p.add_argument("--noise_offset", type=float, default=0)
    p.add_argument("--validation_steps", type=int, default=100)
    p.add_argument("--tracker_project_name", type=str, default="text2image-fine-tune")
    p.add_argument("--fsdp", type=int, default=1,
                   help="Parameter-sharding degree; only 1 (one card) is ported.")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Write a torch.profiler trace of the training loop here.")
    p.add_argument("--cache_latents", action="store_true", default=True,
                   help="Encode every image's VAE latent moments once and sample them in "
                        "the step (the same result: only the sample must be fresh). On by "
                        "default.")
    p.add_argument("--no_cache_latents", dest="cache_latents", action="store_false",
                   help="Encode the pixels in every step.")
    p.add_argument("--device", type=str, choices=("cuda", "cpu"), default="cuda",
                   help="Run on the card (default) or on the CPU.")
    args = p.parse_args(argv)
    if args.dataset_folder is None or args.json_file_name is None:
        raise ValueError("Need either a dataset name or a data json file.")
    return args


def _seed_for(seed: int, step: int) -> int:
    """The generator seed of one step: a function of (seed, step) only."""
    return (seed * 1_000_003 + step) % (2 ** 63)


def batch_to_device(batch, dev):
    """A host numpy batch -> device tensors (token ids as int64)."""
    import torch

    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "input_ids":
            t = t.long()
        out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out


def main(argv=None):
    import torch

    from agenda_tpu_torch._device import compute_dtype, resolve_device
    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.data.datasets import BaseDataset, DataLoader
    from agenda_tpu_torch.data.device_resize import resize_weights
    from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
    from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline, _build
    from agenda_tpu_torch.io.diffusers_io import load_pipeline, save_pipeline
    from agenda_tpu_torch.models.clip_text import CLIPTextModel
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train.checkpoint import (
        AsyncCheckpointer,
        find_resume_checkpoint,
        load_checkpoint,
    )
    from agenda_tpu_torch.train.finetune_sd import LossConfig, init_train_state, make_train_step
    from agenda_tpu_torch.train.latent_cache import (
        LatentMomentsDataset,
        precompute_latent_moments,
    )
    from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer
    from agenda_tpu_torch.train.trackers import Tracker
    from agenda_tpu_torch.utils.profiling import StepTimer, maybe_profile

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    if args.fsdp > 1:
        raise NotImplementedError("--fsdp > 1 (multi-GPU) is not ported yet; see ROADMAP.md")
    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.mixed_precision == "no":
        raise NotImplementedError("the flash and GroupNorm kernels take bf16: "
                                  "--mixed_precision no runs only with --device cpu")
    for flag in ("allow_tf32", "enable_xformers_memory_efficient_attention", "push_to_hub",
                 "offload_ema", "foreach_ema"):
        if getattr(args, flag):
            logger.info("flag --%s accepted for compatibility (no-op here)", flag)

    os.makedirs(args.output_dir, exist_ok=True)
    seed = args.seed if args.seed is not None else 0
    bundle = load_pipeline(args.pretrained_model_name_or_path)
    sc = bundle.scheduler_config or {}
    schedule = make_schedule(
        num_train_timesteps=sc.get("num_train_timesteps", 1000),
        beta_start=sc.get("beta_start", 0.00085),
        beta_end=sc.get("beta_end", 0.012),
        beta_schedule=sc.get("beta_schedule", "scaled_linear"),
        prediction_type=args.prediction_type or sc.get("prediction_type", "epsilon"),
        steps_offset=sc.get("steps_offset", 1),
    )
    frozen_dtype = compute_dtype(dev)
    with torch.device("meta"):
        unet = UNet2DConditionModel(bundle.unet_config)
    unet.load_state_dict({k: v.to(dev, torch.float32, copy=True)
                          for k, v in bundle.unet_state.items()}, strict=True, assign=True)
    unet.train()
    unet.gradient_checkpointing = args.gradient_checkpointing
    vae = _build(AutoencoderKL, bundle.vae_config, bundle.vae_state, dev, frozen_dtype)
    text_encoder = _build(CLIPTextModel, bundle.text_config, bundle.text_state, dev,
                          frozen_dtype)
    for m in (vae, text_encoder):
        m.requires_grad_(False)
    tokenizer = CLIPTokenizer.from_pretrained(bundle.tokenizer_dir)

    dataset = BaseDataset(args.dataset_folder, args.json_file_name, args.resolution, tokenizer)
    if args.max_train_samples:
        dataset.data = dataset.data[: args.max_train_samples]
    resize_w = None
    if dataset.source_size is not None:
        sw, sh = dataset.source_size
        resize_w = (resize_weights(sh, args.resolution, "lanczos"),
                    resize_weights(sw, args.resolution, "lanczos"))
        logger.info("device resize: %dx%d uint8 tiles -> %d^2 on %s", sw, sh, args.resolution,
                    dev)
    global_bs = args.train_batch_size
    workers = max(1, args.dataloader_num_workers)
    loader = DataLoader(dataset, global_bs, shuffle=True, seed=seed, num_workers=workers,
                        pad_to_full=True)
    steps_per_epoch = math.ceil(len(loader) / args.gradient_accumulation_steps)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
    args.num_train_epochs = math.ceil(args.max_train_steps / steps_per_epoch)

    lr = args.learning_rate
    if args.scale_lr:
        lr = lr * args.gradient_accumulation_steps * args.train_batch_size
    lr_fn = lr_schedule(args.lr_scheduler, lr, args.lr_warmup_steps, args.max_train_steps)
    tx = make_optimizer(lr_fn, args.adam_beta1, args.adam_beta2, args.adam_weight_decay,
                        args.adam_epsilon, args.max_grad_norm, args.gradient_accumulation_steps,
                        use_8bit_adam=args.use_8bit_adam)
    state = init_train_state(unet, tx, args.use_ema)

    initial_step = 0
    if args.resume_from_checkpoint:
        found = find_resume_checkpoint(args.output_dir, args.resume_from_checkpoint)
        if found is None:
            logger.info("Checkpoint '%s' does not exist. Starting a new training run.",
                        args.resume_from_checkpoint)
        else:
            initial_step, path = found
            logger.info("Resuming from checkpoint %s", path)
            state = load_checkpoint(path, state)

    if args.cache_latents:
        moments = precompute_latent_moments(vae, dataset, batch_size=global_bs,
                                            resize_weights=resize_w, device=dev,
                                            log_fn=logger.info)
        dataset = LatentMomentsDataset(dataset, moments)
        # the same loader settings give the same epoch shuffle
        loader = DataLoader(dataset, global_bs, shuffle=True, seed=seed, num_workers=workers,
                            pad_to_full=True)

    loss_cfg = LossConfig(snr_gamma=args.snr_gamma, noise_offset=args.noise_offset,
                          input_perturbation=args.input_perturbation,
                          prediction_type=args.prediction_type)
    step_fn = make_train_step(unet, vae, text_encoder, schedule, tx, loss_cfg, args.use_ema,
                              resize_weights=resize_w)
    tracker = Tracker(os.path.join(args.output_dir, args.logging_dir), args.report_to,
                      config=vars(args))
    generator = torch.Generator(device=dev)

    logger.info("***** Running training *****")
    logger.info("  Num examples = %d", len(dataset))
    logger.info("  Num Epochs = %d", args.num_train_epochs)
    logger.info("  Batch size = %d", global_bs)
    logger.info("  Total optimization steps = %d", args.max_train_steps)
    logger.info("  Device = %s, optimizer = %s", dev,
                "fused int8 AdamW" if tx.fused else "AdamW")

    def run_validation(step):
        # from the EMA shadow when enabled, as the reference swaps it in
        src = state.ema.params if (args.use_ema and state.ema is not None) else state.params
        val_unet = _build(UNet2DConditionModel, bundle.unet_config,
                          {k: v.detach().clone() for k, v in src.items()}, dev, frozen_dtype)
        pipe = StableDiffusionPipeline(unet=val_unet, vae=vae, text_encoder=text_encoder,
                                       tokenizer=tokenizer, schedule=schedule, device=dev,
                                       scheduler_type="pndm",
                                       latent_hw=bundle.unet_config.sample_size)
        for prompt in args.validation_prompts:
            imgs, _ = pipe(prompt, seeds=list(range(4)), num_inference_steps=20,
                           height=args.resolution, width=args.resolution)
            tracker.log_images(f"validation/{prompt}", imgs, step)
        del pipe, val_unet

    # global_step counts optimizer updates: with --gradient_accumulation_steps
    # k, k micro-batches advance it once, and the checkpoint, validation and
    # max_train_steps cadences key off it (agenda_tpu/cli/finetune_sd.py:315-342)
    global_step = initial_step
    accum = args.gradient_accumulation_steps
    micro_in_step = 0
    losses, grad_norms = [], []
    timer = StepTimer()
    t0 = time.perf_counter()
    with maybe_profile(args.profile_dir), AsyncCheckpointer() as ckpt_writer:
        done = False
        # a resumed run goes on where checkpoint-N left the data
        first_epoch, skip = divmod(initial_step * accum, len(loader))
        for epoch in range(first_epoch, args.num_train_epochs):
            if done:
                break
            for batch in loader.iter_from(epoch, skip if epoch == first_epoch else 0):
                generator.manual_seed(_seed_for(seed, state.step))
                state, metrics = step_fn(state, batch_to_device(batch, dev),
                                         generator=generator)
                losses.append(metrics["loss"])
                grad_norms.append(metrics["grad_norm"])
                micro_in_step += 1
                if micro_in_step < accum:
                    continue  # mid-accumulation: no update happened
                micro_in_step = 0
                global_step += 1
                sps = timer.tick()
                if global_step % 10 == 0 or global_step <= 3:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["lr"] = float(lr_fn(global_step))
                    m["steps_per_sec"] = sps
                    m["images_per_sec"] = sps * global_bs * accum
                    tracker.log(m, global_step)
                    logger.info("step %d: loss=%.5f (%.2f img/s)", global_step, m["loss"],
                                m["images_per_sec"])
                if global_step % args.checkpointing_steps == 0:
                    ckpt_writer.save(args.output_dir, global_step, bundle.unet_config, state,
                                     args.checkpoints_total_limit)
                    logger.info("Saving state to %s/checkpoint-%d (async)", args.output_dir,
                                global_step)
                if args.validation_prompts and global_step % args.validation_steps == 0:
                    run_validation(global_step)
                if global_step >= args.max_train_steps:
                    done = True
                    break
    seconds = time.perf_counter() - t0

    final = state.ema.params if (args.use_ema and state.ema is not None) else state.params
    save_pipeline(args.output_dir, bundle.unet_config,
                  {k: v.detach().cpu() for k, v in final.items()}, bundle.vae_config,
                  bundle.vae_state, bundle.text_config, bundle.text_state,
                  tokenizer_dir=bundle.tokenizer_dir, scheduler_config=bundle.scheduler_config)
    logger.info("Saved pipeline to %s", args.output_dir)
    tracker.close()
    steps = global_step - initial_step
    return {"steps": steps, "seconds": seconds, "images": steps * global_bs * accum,
            "losses": [float(x) for x in losses], "grad_norms": [float(x) for x in grad_norms],
            "device": str(dev), "global_step": global_step, "micro_batches": state.step,
            "ema_step": None if state.ema is None else int(state.ema.step)}


if __name__ == "__main__":
    main()
