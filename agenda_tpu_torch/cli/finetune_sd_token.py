"""CLI: learnable-token + UNet fine-tuning with cross-attention regularization.

Counterpart of ``agenda_tpu/cli/finetune_sd_token.py``: the same flags with
the same defaults and mutual-exclusion rules, plus ``--device {cuda,cpu}``
(default cuda; with cuda and no GPU it raises); the same two-invocation
workflow (stage 1 ``--train_token --with_cross_attn_reg --train_unet``;
stage 2 ``--embedding_path ... --train_unet --with_cross_attn_reg``) and the
same artifacts: ``learned_embeds_steps_N.bin`` and ``full_model_step_N/``
pipeline exports (with the extended token table and the tokenizer's added
tokens). What differs, as in the port's ``cli/finetune_sd.py``:

- one process drives one card; under ``torchrun --nproc_per_node N`` the N
  ranks train data parallel as ``cli/finetune_sd.py``'s do (global batch
  ``--train_batch_size x dp``, split over dp alone when the world does not
  divide it, each sample with its single-process draws,
  gradients summed before the UNet's clip, ``--scale_lr`` by the world
  size, rank 0 writing every artifact); ``--fsdp f`` only sets dp = N / f,
  since the JAX CLI replicates the token state (its ``:303``);
  ``--dist-backend`` names the backend;
- bf16 compute under autocast on the card, f32 on the CPU;
  ``--mixed_precision no`` computes in f32 on both (the UNet, the frozen
  VAE and text encoder, validation), with TF32 off and the f32 kernels on
  the card, as the JAX CLI computes in f32 under it (its ``:170``);
- ``--use_8bit_adam`` selects the fused int8 AdamW kernel, also under
  ``--gradient_accumulation_steps`` (the JAX package switches to its unfused
  chain there);
- the draws of each micro-batch and the initial embedding come from
  ``torch.Generator`` streams seeded from ``--seed``: the port's own streams;
- training images are PNG (read without Pillow).

    python -m agenda_tpu_torch.cli.finetune_sd_token --pretrained_model_name_or_path <dir> \\
        --dataset_folder Data --json_file_name train.json --train_batch_size 4 \\
        --snr_gamma 5 --reg_weight 0.5 --object_token new_token \\
        --initialize_token cars Utah "New Zealand" --train_token --with_cross_attn_reg \\
        --train_unet --output_dir stage-one
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import time

import numpy as np

logger = logging.getLogger("agenda_tpu_torch.finetune_sd_token")

TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Token/UNet fine-tuning (PyTorch, one card).")
    p.add_argument("--pretrained_model_name_or_path", type=str, default=None, required=True)
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--tokenizer_name", type=str, default=None)
    p.add_argument("--dataset_folder", type=str, default=None)
    p.add_argument("--json_file_name", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="text-inversion-model")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--sample_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--learning_rate", type=float, default=2e-6)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--scale_lr", action="store_true", default=False)
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-08)
    p.add_argument("--max_grad_norm", default=1.0, type=float)
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--allow_tf32", action="store_true")
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--validation_prompts", type=str, default=None, nargs="+")
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--validation_steps", type=int, default=100)
    p.add_argument("--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16"])
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    p.add_argument("--set_grads_to_none", action="store_true")
    p.add_argument("--offset_noise", action="store_true", default=False)
    p.add_argument("--skip_save_text_encoder", action="store_true", required=False)
    p.add_argument("--validation_images", required=False, default=None, nargs="+")
    p.add_argument("--class_labels_conditioning", required=False, default=None)
    p.add_argument("--embedding_path", type=str, default=None)
    p.add_argument("--train_token", action="store_true", required=False, default=False)
    p.add_argument("--train_unet", action="store_true", required=False, default=False)
    p.add_argument("--object_token", type=str, default="sks")
    p.add_argument("--n_object_embedding", type=int, default=1)
    p.add_argument("--initialize_token", type=str, default=None, nargs="+")
    p.add_argument("--train_cross_attn", action="store_true", default=False)
    p.add_argument("--with_cross_attn_reg", default=False, action="store_true")
    p.add_argument("--reg_weight", type=float, default=1.0)
    p.add_argument("--only_save_checkpoint", action="store_true", default=False)
    p.add_argument("--load_from_checkpoint", type=str, default=None)
    p.add_argument("--tracker_project_name", type=str, default="tensorboard")
    p.add_argument("--fsdp", type=int, default=1,
                   help="The mesh's fsdp axis (dp = world / fsdp); the token state stays "
                        "replicated, as in the JAX CLI.")
    p.add_argument("--dist-backend", type=str, choices=("nccl", "gloo"), default=None,
                   help="The process group's backend under torchrun (default: nccl on the "
                        "card, gloo on the CPU; gloo puts several ranks on one card).")
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

    # the reference's mutual-exclusion rules (finetune_sd_token.py:551-564)
    if args.dataset_folder is None or args.json_file_name is None:
        raise ValueError("Need either a dataset name or a data json file.")
    if not (args.train_token or args.train_unet or args.train_cross_attn):
        raise ValueError(
            "choose something to train! `--train_token`, `--train_cross_attn` or `--train_unet`")
    if args.train_unet and args.train_cross_attn:
        raise ValueError("`--train_unet` cannot be used with `--train_cross_attn`")
    if (args.initialize_token is None or len(args.initialize_token) == 0) \
            and not args.embedding_path:
        raise ValueError("You must specify at least one token for initialization.")
    if args.load_from_checkpoint is not None and args.resume_from_checkpoint is not None:
        raise ValueError("`--load_from_checkpoint` cannot be used with `--resume_from_checkpoint`")
    return args


def extend_token_table(table: np.ndarray, token_ids, seed: int, rows=None) -> np.ndarray:
    """The (vocab, C) table grown to hold ``token_ids`` (new rows N(0, 0.02)
    from ``np.random.RandomState(seed)``, resize_token_embeddings' role), with
    ``rows`` (stage 2's loaded embeddings) written at their ids."""
    need = max(token_ids) + 1
    if need > table.shape[0]:
        extra = np.random.RandomState(seed).normal(0, 0.02, (need - table.shape[0],
                                                             table.shape[1]))
        table = np.concatenate([table, extra.astype(table.dtype)], axis=0)
    else:
        table = table.copy()
    if rows is not None:
        for tid, row in zip(token_ids, rows):
            table[tid] = row
    return table


def main(argv=None):
    import torch

    from agenda_tpu_torch._device import compute_dtype
    from agenda_tpu_torch.cli.finetune_sd import _seed_for, batch_to_device
    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.data.datasets import DataLoader, TokenDataset
    from agenda_tpu_torch.data.device_resize import resize_weights
    from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
    from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline, _build
    from agenda_tpu_torch.io.diffusers_io import load_pipeline, load_unet, save_pipeline
    from agenda_tpu_torch.io.learned_embeds import (
        load_learned_embeddings,
        save_learned_embeddings,
    )
    from agenda_tpu_torch.models.clip_text import CLIPTextModel
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.parallel.mesh import barrier, make_mesh, replicate
    from agenda_tpu_torch.train.checkpoint import (
        AsyncCheckpointer,
        find_resume_checkpoint,
        load_optimizer_state,
        snapshot_token_state,
    )
    from agenda_tpu_torch.train.finetune_sd_token import (
        TokenLossConfig,
        init_token_train_state,
        make_token_train_step,
        merge_params,
    )
    from agenda_tpu_torch.train.latent_cache import (
        LatentMomentsDataset,
        precompute_latent_moments,
    )
    from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer
    from agenda_tpu_torch.train.trackers import NullTracker, Tracker
    from agenda_tpu_torch.utils.profiling import StepTimer, maybe_profile

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    mesh = make_mesh(dp=-1, fsdp=args.fsdp, device=args.device, backend=args.dist_backend)
    dev = mesh.device
    for flag in ("allow_tf32", "enable_xformers_memory_efficient_attention", "push_to_hub",
                 "set_grads_to_none"):
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
        prediction_type=sc.get("prediction_type", "epsilon"),
        steps_offset=sc.get("steps_offset", 1),
    )
    frozen_dtype = compute_dtype(dev, args.mixed_precision)  # f32 under "no", as in JAX
    tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer_name or bundle.tokenizer_dir)

    # the new tokens: stage 1's embeddings, or object_token_v{i} names
    # (finetune_sd_token.py:637-669)
    loaded_embeds = None
    if args.embedding_path is not None:
        embeds = load_learned_embeddings(args.embedding_path)
        object_tokens = list(embeds)
        loaded_embeds = np.stack([embeds[t] for t in object_tokens])
    else:
        object_tokens = [f"{args.object_token}_v{i}" for i in range(len(args.initialize_token))]
    tokenizer.add_tokens(object_tokens)
    object_token_ids = tokenizer.convert_tokens_to_ids(object_tokens)
    table = extend_token_table(bundle.text_state[TOKEN_TABLE].numpy(), object_token_ids, seed,
                               loaded_embeds)
    text_cfg = dataclasses.replace(bundle.text_config, vocab_size=table.shape[0])
    text_state = {**bundle.text_state, TOKEN_TABLE: torch.from_numpy(table)}

    unet_cfg, unet_state = bundle.unet_config, bundle.unet_state
    if args.load_from_checkpoint:
        if os.path.exists(args.load_from_checkpoint):
            logger.info("Loading from checkpoint %s", args.load_from_checkpoint)
            unet_cfg, unet_state = load_unet(args.load_from_checkpoint)
        else:
            logger.info("Checkpoint '%s' does not exist. Starting a new training run.",
                        args.load_from_checkpoint)
    # resume: the UNet, the learned rows, the optimizer and the step of checkpoint-N
    initial_step, resume_path, resume_embedding = 0, None, None
    if args.resume_from_checkpoint:
        found = find_resume_checkpoint(args.output_dir, args.resume_from_checkpoint)
        if found is None:
            logger.info("Checkpoint '%s' does not exist. Starting a new training run.",
                        args.resume_from_checkpoint)
        else:
            initial_step, resume_path = found
            logger.info("Resuming from checkpoint %s", resume_path)
            unet_cfg, unet_state = load_unet(resume_path)
            bin_path = os.path.join(resume_path, f"learned_embeds_steps_{initial_step}.bin")
            if args.train_token and os.path.exists(bin_path):
                rows = load_learned_embeddings(bin_path)
                resume_embedding = np.stack([rows[t] for t in object_tokens])

    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_cfg)
    unet.load_state_dict({k: v.to(dev, torch.float32, copy=True) for k, v in unet_state.items()},
                         strict=True, assign=True)
    unet.train()
    unet.gradient_checkpointing = args.gradient_checkpointing
    vae = _build(AutoencoderKL, bundle.vae_config, bundle.vae_state, dev, frozen_dtype)
    # the token table stays f32 (cast_for_compute keeps embedding tables f32)
    text_encoder = _build(CLIPTextModel, text_cfg, text_state, dev, frozen_dtype)
    for m in (vae, text_encoder):
        m.requires_grad_(False)

    dataset = TokenDataset(args.dataset_folder, args.json_file_name, args.resolution, tokenizer,
                           word_tokens=args.initialize_token, new_tokens=object_tokens)
    resize_w = None
    if dataset.source_size is not None:
        sw, sh = dataset.source_size
        resize_w = (resize_weights(sh, args.resolution, "bilinear"),
                    resize_weights(sw, args.resolution, "bilinear"))
        logger.info("device resize: %dx%d uint8 tiles -> %d^2 (bilinear) on %s", sw, sh,
                    args.resolution, dev)
    global_bs = args.train_batch_size * mesh.dp
    mesh = mesh.for_batch(global_bs)  # over dp alone when the world does not divide it
    rows = mesh.rows(global_bs) if mesh.world > 1 else None
    workers = max(1, args.dataloader_num_workers)
    loader = DataLoader(dataset, global_bs, shuffle=True, seed=seed, num_workers=workers,
                        pad_to_full=True, rows=rows)
    steps_per_epoch = math.ceil(len(loader) / args.gradient_accumulation_steps)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
    args.num_train_epochs = math.ceil(args.max_train_steps / steps_per_epoch)

    lr = args.learning_rate
    if args.scale_lr:
        lr = lr * args.gradient_accumulation_steps * args.train_batch_size * mesh.size
    lr_fn = lr_schedule(args.lr_scheduler, lr, args.lr_warmup_steps, args.max_train_steps,
                        args.lr_num_cycles, args.lr_power)
    tx = make_optimizer(lr_fn, args.adam_beta1, args.adam_beta2, args.adam_weight_decay,
                        args.adam_epsilon, max_grad_norm=None,  # the step clips the UNet only
                        gradient_accumulation_steps=args.gradient_accumulation_steps,
                        use_8bit_adam=args.use_8bit_adam)
    state = init_token_train_state(
        unet, tx, args.train_token, args.train_unet, args.train_cross_attn,
        n_tokens=len(object_tokens), hidden_size=text_cfg.hidden_size,
        generator=torch.Generator(device=dev).manual_seed(seed),
        init_embedding=resume_embedding)
    replicate(state.opt_params().values(), mesh)
    if resume_path is not None:
        state.step = int(load_optimizer_state(resume_path, state.opt_state)["step"])

    if args.cache_latents:
        moments = precompute_latent_moments(vae, dataset, batch_size=global_bs,
                                            resize_weights=resize_w, device=dev,
                                            log_fn=logger.info)
        dataset = LatentMomentsDataset(dataset, moments)
        # the same loader settings give the same epoch shuffle
        loader = DataLoader(dataset, global_bs, shuffle=True, seed=seed, num_workers=workers,
                            pad_to_full=True, rows=rows)

    loss_cfg = TokenLossConfig(snr_gamma=args.snr_gamma, offset_noise=args.offset_noise,
                               with_cross_attn_reg=args.with_cross_attn_reg,
                               reg_weight=args.reg_weight,
                               n_object_embedding=args.n_object_embedding,
                               train_token=args.train_token, max_grad_norm=args.max_grad_norm)
    step_fn = make_token_train_step(unet, vae, text_encoder, schedule, tx, loss_cfg,
                                    resize_weights=resize_w, mesh=mesh, dtype=frozen_dtype)
    tracker = (Tracker(os.path.join(args.output_dir, args.logging_dir), args.report_to,
                       config=vars(args)) if mesh.is_main else NullTracker())
    if not mesh.is_main:
        logger.setLevel(logging.WARNING)
    generator = torch.Generator(device=dev)

    logger.info("***** Running training *****")
    logger.info("  Num examples = %d", len(dataset))
    logger.info("  Total optimization steps = %d", args.max_train_steps)
    logger.info("  Batch size = %d, gradient accumulation = %d", global_bs,
                args.gradient_accumulation_steps)
    logger.info("  train_token=%s train_unet=%s train_cross_attn=%s reg=%s; device %s",
                args.train_token, args.train_unet, args.train_cross_attn,
                args.with_cross_attn_reg, dev)

    def current_unet_state():
        params = merge_params(state.unet_trainable, state.unet_frozen)
        return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}

    def current_text_state():
        """The text encoder's state with the learned rows in its table."""
        t = table.copy()
        if state.embedding is not None:
            t[object_token_ids] = state.embedding.detach().cpu().numpy()
        return {**text_state, TOKEN_TABLE: torch.from_numpy(t)}

    def run_validation(step):
        val_unet = _build(UNet2DConditionModel, unet_cfg, current_unet_state(), dev,
                          frozen_dtype)
        val_text = _build(CLIPTextModel, text_cfg, current_text_state(), dev, frozen_dtype)
        pipe = StableDiffusionPipeline(unet=val_unet, vae=vae, text_encoder=val_text,
                                       tokenizer=tokenizer, schedule=schedule, device=dev,
                                       scheduler_type="pndm", latent_hw=unet_cfg.sample_size)
        for prompt in args.validation_prompts:
            present = [nt for it, nt in zip(args.initialize_token or [], object_tokens)
                       if it in prompt]
            formatted = prompt.format(*present)
            imgs, _ = pipe(formatted, seeds=list(range(args.num_validation_images)),
                           num_inference_steps=20, height=args.resolution,
                           width=args.resolution)
            tracker.log_images(f"validation/{formatted}", imgs, step)
        del pipe, val_unet, val_text

    # global_step counts optimizer updates: k micro-batches advance it once
    # under --gradient_accumulation_steps k, and the checkpoint, validation
    # and max_train_steps cadences key off it (finetune_sd_token.py:1095-1110)
    global_step = initial_step
    accum = args.gradient_accumulation_steps
    micro_in_step = 0
    losses, attn_losses = [], []
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
                attn_losses.append(metrics["attn_loss"])
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
                    tracker.log(m, global_step)
                    logger.info("step %d: loss=%.5f attn=%.5f fg=%.5f bg=%.5f", global_step,
                                m["loss"], m["attn_loss"], m["fg_loss"], m["bg_loss"])
                if global_step % args.checkpointing_steps == 0 and mesh.is_main:
                    ckpt_writer.save_snapshot(args.output_dir, global_step, unet_cfg,
                                              snapshot_token_state(state, object_tokens),
                                              args.checkpoints_total_limit)
                    logger.info("Saving state to %s/checkpoint-%d (async)", args.output_dir,
                                global_step)
                if (args.validation_prompts and global_step % args.validation_steps == 0
                        and mesh.is_main):
                    run_validation(global_step)
                if global_step >= args.max_train_steps:
                    done = True
                    break
    seconds = time.perf_counter() - t0

    # final artifacts (finetune_sd_token.py:1175-1187), rank 0's
    if args.train_token and mesh.is_main:
        save_learned_embeddings(
            object_tokens, state.embedding.detach().cpu().numpy(),
            os.path.join(args.output_dir, f"learned_embeds_steps_{global_step}.bin"))
    if (not args.only_save_checkpoint and (args.train_unet or args.train_cross_attn)
            and mesh.is_main):
        save_path = os.path.join(args.output_dir, f"full_model_step_{global_step}")
        if not os.path.exists(save_path):
            save_pipeline(save_path, unet_cfg, current_unet_state(), bundle.vae_config,
                          bundle.vae_state, text_cfg, current_text_state(),
                          tokenizer_dir=bundle.tokenizer_dir,
                          scheduler_config=bundle.scheduler_config, tokenizer=tokenizer)
            logger.info("Saved pipeline to %s", save_path)
    tracker.close()
    barrier(mesh)
    steps = global_step - initial_step
    return {"steps": steps, "seconds": seconds, "global_step": global_step,
            "micro_batches": state.step, "losses": [float(x) for x in losses],
            "attn_losses": [float(x) for x in attn_losses], "object_tokens": object_tokens,
            "device": str(dev)}


if __name__ == "__main__":
    main()
