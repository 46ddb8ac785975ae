#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (agenda_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- compile agenda_tpu_torch/csrc/*.cu with nvcc for sm_90a, and
                show ptxas's registers and spills of each instantiation of the
                flash forward, the group norm and the f32 kernels (those of
                the bf16 flash backward in phase 10); every phase starts
                with a [host] line: what the process holds after garbage
                collection and the card's cache returned (host_state);
  2. shapes  -- write a full-width SD-1.4-shaped pipeline with seeded random
                weights, load it, record the shape of every kernel call of
                one UNet call (CFG batch) and one VAE decode, and time a cold
                and a warm batch;
  3. parity  -- hold each kernel against its plain PyTorch version on the
                card in bf16 at every recorded shape (plus ragged S and a
                zero-padded head dim);
  4. timing  -- kernel, plain version and a PyTorch yardstick the port never
                calls (SDPA; F.group_norm + F.silu), beside the H100 bound
                (the wide forward, D > 160, at the VAE decode's shape and at
                the VAE pretraining step's (8, 1024, 1, 512) too);
                device times replay a CUDA graph of the calls, eager times
                launch them back to back (the host's cost shows in the
                gap, and the forward's tensor-map encodes are timed on the
                host); the forward's bound counts its exponentials too, and
                each group-norm launch's plan is shown;
  5. e2e     -- the port's CLI (cli/data_generation.main) generates 4 images
                with 3 word heatmaps at 512x512, 20 PLMS steps, batch 2; the
                kernel launch counts must equal the counts from the config;
  6. profile -- torch.profiler breaks one more batch down by kernel group,
                and its trace goes through the port's cli/profile_report
                (utils/xprof.py): its categories sum to its busy ms;
then the training path (SD fine-tune, batch 4 at 512x512, full SD-1.4 width):
  8. train shapes -- one step through the trainer API (fused int8 AdamW +
                EMA) records every flash shape and every quantized leaf, and
                checks both against the counts derived from the config (the
                AdamW: one launch a step updating 293 leaves); then warm
                s/step, images/s, peak memory and a profiled step;
  9. K4 path  -- two steps through the trainer API without EMA on the same
                model: the plain fused AdamW kernel, one launch and 293
                leaves a step;
 10. train parity -- flash backward (dK/dV, dQ) at every training shape (plus
                ragged S) and fused AdamW (with and without EMA) at every
                quantized leaf shape (plus a ragged leaf, and clipping
                active) against their plain versions, one leaf a launch and
                the whole step's leaves (plus the ragged one) in one launch,
                with timing beside the bound, the plain version and a
                PyTorch yardstick (the AdamW: the step's one launch, with its
                TB/s, and the host's time to enqueue it); the flash
                backward's bound counts its exponentials too, its pair is set
                against SDPA's backward per shape and per step, and ptxas's
                registers and spills of each of its instantiations are shown;
 11. train e2e -- cli/finetune_sd.main trains 3 steps on 8 fabricated PNG
                tiles, writes checkpoint-3/ and the final export, which
                loads back; the kernel launch counts must equal the config's;
 12. GN tail  -- the group norm at H*W % 8 != 0 (the UNet's 6x6 and
                10x10 levels at 384 and 640 pixels, with and without SiLU)
                against the plain version; then cli/data_generation at
                --resolution 384 (2 images, 20 PLMS steps, 3 word heatmaps),
                launch counts as the config's;
 13. token API -- one step of train/finetune_sd_token at batch 4, 512x512, full
                width, tokens + UNet + cross-attention regularization, f32
                AdamW: launches as the config's, attn_loss > 0, the embedding
                moved; warm s/step, peak memory, a profiled step; then a
                token-only step, whose flash backward skips the first attn1;
 14. token CLI, stage 1 -- cli/finetune_sd_token.main with the recipe's flags,
                2 steps on the 8 tiles, a checkpoint at 2, one validation
                image at step 2: checkpoint-2/, learned_embeds_steps_2.bin and
                full_model_step_2/ load back;
 15. token CLI, stage 2 -- from full_model_step_2/ with --embedding_path, 2
                updates of the UNet with the reg loss under --use_8bit_adam
                and --gradient_accumulation_steps 2 (4 micro-batches): the
                loaded rows are the exported table's, K4 launches once an
                update;
 16. accumulation -- cli/finetune_sd.main with --use_8bit_adam --use_ema
                --gradient_accumulation_steps 2 over 4 micro-batches: K5 launches,
                the EMA step and the global step are 2;
 17. labels   -- 512 fabricated object / fg / bg heatmap triples (112x112)
                stacked by cli/postprocess_heatmap into two sets of 256: a GT
                set with a COCO file of its fabricated vehicles, and one
                given an images-only COCO by cli/build_empty_annotation; seeded
                YOLOv8n and YOLOv8s checkpoints in the JAX runner's layout;
                a COCO of all 512 stacks with their vehicles;
 18. detector parity -- one batch of 192 stacks through each detector on the
                card and on the CPU (f32, TF32 off), from the same weights:
                the eval resize within one level, the per-level head outputs
                within their limit (and the same heads with TF32 on beyond it:
                the limit's control), the kept detections matched at IoU >= 0.99
                both ways with the share unmatched bounded; then
                DetectorRunner.test (det_test's path: pinned staging, one packed
                copy back a batch) with YOLOv8n over all 512 stacks and their
                boxes, three batches, on the card and on the CPU: equal image
                paths and GT fields, predictions matched record by record;
 19. labelling stages -- as cli/pipeline.py chains them, on the card with
                YOLOv8n: det_test on the GT set, select_threshold --table-out
                --result-out, det_test on the empty set, select_threshold
                --emit-pseudo-coco --thresh-conf <the selected threshold>;
                every output loads back with one record per image;
 20. labelling timing -- warm images/s of the runner's _predict_batches over
                the 512 stacks at batch 192 for YOLOv8n and YOLOv8s (host
                clock, PNG decode included), the device busy share, a
                batch's convolution, NMS (ms and launches) and the rest, and
                on the host the ms to decode a tile and to enqueue a batch;
 21. detector train step -- YOLOv8n at 128 px, batch 192 (the
                synthetic_heatmap preset), one host-augmented batch of the
                stacks, the calibrated weights, on the card and on the CPU
                (f32): each side's TAL assignment (the anchors that differ,
                bounded); with the CPU's assignment on both, the loss and its
                parts, every gradient, the new batch statistics, the SGD
                update and the EMA, each within its limit; the same step
                with TF32 on, the control, beyond every limit; the gradients
                in float64 on both sides;
 22. det_train -- cli/det_train --preset synthetic_heatmap on 384 stacks with
                64 to validate, batch 192, 12 epochs: the recipe switch
                logged at epoch 2, validation after epoch 1 and every epoch
                from 2, finite losses, the checkpoints; det_test reads its
                latest.safetensors; a resume with --max-epochs 13 starts at
                epoch 12, step 24;
 23. detector training timing -- at batch 192 and 1024 (synthetic_target's):
                the step alone (warm, synchronised), host augmentation ms an
                image (mix and stage 2), the host-to-device copy, the step's
                device time by kernel group, the training loop's wall a step
                (counted over the steps it ran, across epochs of the loader)
                and the card's busy share of it, peak memory;
 24. render parity -- detect/device_aug.py's render_batch on the card
                against the same code on the CPU at batch 192, 128 px over
                the stacks: real_source's mix plans with passthrough samples
                forced in, the separable and the gather form, a stage-2
                batch; render_lsj_batch at 112 -> 128 px; the CPU tests'
                limits; the render's ms a batch;
 25. device-aug training -- DetectorRunner.train with device_aug at batch
                192 (the stacks) and 1024 (1024 fabricated tiles in two
                parts, a 50 MB tensor), serial and with 4 plan workers: the
                loop's s/step and images/s, the card's busy share, the
                render's and the step's ms, the host's plan ms an image, the
                plan upload ms, peak memory; aug_path "device", the step
                count, finite losses; the workers' plans of an epoch equal
                to the serial ones;
 26. device-aug CLI -- phase 22 with --device-aug --device-aug-workers 2:
                the switch, validations, resume and det_test as there, and
                both runs on the device path;
 27. refine parity -- ResNet-50 at 224 px from the refine CLI's fresh init:
                one train step at batch 32 (28 real rows padded) on the card
                (f32, TF32 off) and on the CPU: the loss, every gradient,
                the new running statistics and the Adam update, each within
                its limit; the same step with TF32 on, the control, beyond
                each; the gradients in float64 on both sides; eval logits at
                batch 64; a bf16 step (the CLI's default on the card) finite;
 28. refine_label -- cli/refine_label on the card over 400 fabricated
                112x112 tiles with 10 detections each (every bucket), batch
                256 / 512, crop 224, 2 epochs: both checkpoints load back,
                the refined COCO is sorted, re-id'd and holds every label-1
                crop and the kept ones;
 29. refine timing -- warm s/step at batch 256 (bf16 and f32, peak memory),
                predict images/s at batch 512, the CLI's loop a step over an
                epoch and the card's busy share of it; on the host the crop
                and resize ms a crop and the gather + upload ms a batch;
 30. the chain -- the port's cli/pipeline --device cuda through all 21 stages
                (SD-1.4's layout cut to two levels of 128 and 256 channels,
                fabricated real sets): up to label_synthetic_target, a rerun
                that skips every stage, the target predictions doctored to
                fill the refine buckets, then --from-stage refine; every
                stage's marker and manifest line, K1-K6 launched by the stages
                that run them and by no other, one final record per target
                image, each stage's wall time;
 31. family parity -- Faster R-CNN (R50-FPN), YOLOv5m, YOLOv5s and ViTDet
                (ViT-B) at their reference widths, 128 px: one train step at
                batch 8 of the stacks (the real_source recipe and optimizer:
                SGD, the yolo SGD, AdamW with layer decay) from seeded
                weights with measured batch-norm statistics, on the card and
                on the CPU (f32, the CPU's RCNN targets on both sides): the
                loss and its parts, the gradients, the update and the
                statistics' move within the family's FAM_LIMITS, the TF32
                control beyond each; predictions matched box for box;
 32. family CLIs -- cli/det_train --preset real_source --detector <family>
                on 24 of the stacks (24 to validate) at the preset's batch
                with --pretrained from a fabricated
                mmdet/mmyolo checkpoint (80-class COCO heads): the import
                report (every tensor but the heads imported, the heads
                shape-skipped), one epoch, a resume for one more, det_test;
                Faster R-CNN once more with --device-aug;
 33. family timing -- each family's train step at its real_source and
                synthetic_target batches (cold, warm, images/s, peak memory,
                the card's busy share and kernel launches of a profiled step,
                the NMS rank loop's launches), and labelling 192 of the stacks
                at batch 192 (images/s, NMS launches a batch);
 34. the chain with faster-rcnn -- phase 30 with `detector: faster-rcnn`;
 35. TGATE   -- (run after phase 6, on its pipeline) one UNet call that
                collects the cross-attention contributions and one that
                replays them against the exact call; generation with
                tgate_step 10 and the exact sampler through the API in
                turns (s/batch), K1/K6 launches a TGATE batch against the
                config's count, a profiled TGATE batch, and the CLI with
                --tgate-step;
 36. VAE pretraining -- (run after phase 16) SD-1.4's VAE at 256 px, batch 8,
                bf16 autocast: steps of make_vae_pretrain_step (losses finite,
                the reconstruction falling, warm s/step, peak memory, the wide
                K1/K2/K3 and K6 launches a step against the VAE's count),
                then pretrain_vae and its scaling_factor;
 37. wide flash backward -- dK/dV and dQ (both wgmma and TMA) at
                D > 160 against their plain versions at the VAE step's (8, 1024, 1,
                512), at (2, 4096, 1, 512) and a ragged (1, 333, 2, 264),
                timed beside their bound and SDPA's backward;
 41. f32 VAE pretraining -- (run after phase 37) the same VAE in f32, as
                make_vae_pretrain_step computes by default (TF32 off): steps
                (losses, warm s/step, peak, every flash and GroupNorm launch
                an f32 kernel's: wide K1 f32 and its pre-pass, 2 wide K2 f32
                and K3 f32 of csrc/flash_bwd_f32_wide.cu, from one pre-pass a
                backward, each a scores pass and the gradient products, K6 f32 a GroupNorm
                module), pretrain_vae(dtype=f32) and its scaling_factor; the
                f32 step card vs CPU at VAE_F32_PARITY_RES px with a control
                that drops the attention's gradient; the wide f32 dK/dV and
                dQ against float64 at WIDE_FLASH_BWD's shapes, timed beside
                their bound, the plain version and SDPA's f32 backward, and
                split into their three passes, with the scratch and the
                peak memory a call adds;
 38. multi-rank -- (run after phase 20) two ranks spawned on the one card
                over gloo, as torchrun would start them: the generation CLI
                at batch 1 a rank (512x512, 20 PLMS steps, 3 word heatmaps)
                over phase 5's first batch of 2 seeds, against phase 5's
                PNGs one by one; one SD step at batch 2
                a rank (global 4) with --fsdp 2 and the fused int8 AdamW +
                EMA against one process's step over the same global batch
                and draws (each element's update, the loss, the global
                gradient norm, the gathered EMA), each rank's peak memory
                beside the one-process peak at its batch and its K1-K6
                launches against the config's; det_test split over the
                ranks against phase 19's records. Two ranks share one card,
                so no speed of NCCL or of several cards is measured;
 39. host libraries -- (run after phase 20) build both host libraries
                (utils/host_build.py: the matchers, resize, HSV and median
                without dependencies; the PNG/JPEG decode against libpng and
                libjpeg, or the headers it lacks); the committed fixtures
                (tests/data/images) against their expected pixels, or the
                raise naming the missing library; the labelling decode a
                tile, native against utils/png.py, on phase 17's stacks and a
                512-px Pillow-written tile; the procedural domain (48 + 16
                tiles); the bench's stack labeler trained 10 epochs (its
                own 30, cut) on the card (val AP >= 0.9), then from its
                cache (same threshold and
                weights, no training); the box matchers, native against
                numpy;
 40. full precision -- (run after phase 37) --mixed_precision no: one f32 SD
                step at batch 4, 512x512 through the trainer API, every flash and
                group-norm launch an f32 kernel's (launches_f32), the
                counts the config's, warm s/step and peak memory; the f32
                forward (D = 40, 80, 160 and 512; tensor cores on three bf16
                pieces of each operand, which its pre-pass writes, bit for
                bit the plain version's), dK/dV, dQ and GroupNorm at the
                shapes of the f32 SD CLI's run, each against float64 on
                the card (at most F32_LIMIT x the f32 plain version's
                error) and timed beside its bound, the plain version and
                SDPA or F.group_norm + F.silu in f32; the f32 step at 256
                px, batch 1, card vs CPU with a TF32 control; then
                cli/finetune_sd --mixed_precision no for 2 steps with one
                validation (4 PNGs) and cli/finetune_sd_token
                --mixed_precision no for 2 steps of stage 1, their launches
                the config's and all f32;
 41. report  -- a `kernels` JSON line (the six kernels, the flash forward's and
                backward's wide kernels and the six f32 kernels of phase 40
                as entries of their own; none is on the labelling,
                detector, refine or orchestrator path: the render is einsums
                and elementwise PyTorch, as it is jnp in the reference,
                ResNet-50 is cuDNN and ATen as it is flax without Pallas
                there, ViTDet's attention is the reference's plain
                attention_reference and RoIAlign, NMS and the assigners are
                PyTorch as they are jnp there), the card's name and power
                limit, and last the device JSON line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. It imports nothing of JAX or agenda_tpu.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Tuple
from unittest import mock

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (SXM data sheet)
H100_F32_FLOPS = 67e12  # CUDA-core f32 peak
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_EXP_PER_S = 3.9e12  # SFU exponentials (FlashAttention-3, Shah et al. 2024)
# Flash output, elementwise: |out - ref| <= FLASH_ATOL_RMS * rms(ref) + FLASH_RTOL * |ref|.
# Both sides round the output to bf16 (up to one ulp of |ref| apart, covered by
# the relative term); P is rounded to bf16 before P V, as on the TPU, an error of
# order 2^-9 of rms(ref) (the absolute term). rms(ref) falls as 1/sqrt(S) at these
# inputs, so an absolute limit cannot be tight at every S.
FLASH_ATOL_RMS, FLASH_RTOL = 0.05, 1.6e-2
FLASH_TOL_LSE = 1e-3  # f32 logsumexp from bf16 q, k with f32 accumulation
GN_ATOL, GN_RTOL = 2e-2, 1.6e-2  # about two bf16 ulps of the output
# off the main path: ragged S with one warpgroup a block at D = 40 and at D = 80,
# and D zero-filled to the wide kernel's 512; the VAE pretraining step's wide
# shape (2 launches a step, phase 36)
EXTRA_FLASH = ((2, 1000, 8, 40), (2, 300, 4, 80), (1, 333, 2, 264), (8, 1024, 1, 512))

E2E_ARGS = ["--resolution", "512", "--image-size", "112", "--num-inference-steps", "20",
            "--batch-size", "2", "--num-images", "4",
            "--word_token_heatmaps", "cars", "aerial", "utah"]
E2E_BATCH, E2E_IMAGES, E2E_STEPS, E2E_WORDS = 2, 4, 20, ("cars", "aerial", "utah")
PROFILE_PROMPT = "an aerial view image with cars in utah"

TRAIN_BATCH, TRAIN_RES, TRAIN_STEPS, TRAIN_TILES, TILE = 4, 512, 3, 8, 112
TRAIN_ARGS = ["--resolution", str(TRAIN_RES), "--train_batch_size", str(TRAIN_BATCH),
              "--max_train_steps", str(TRAIN_STEPS), "--use_8bit_adam", "--use_ema",
              "--snr_gamma", "5", "--learning_rate", "1e-6", "--checkpointing_steps", "3",
              "--seed", "0", "--device", "cuda", "--report_to", "jsonl"]
# Flash backward, elementwise as the forward: |grad - ref| <= FLASH_ATOL_RMS * rms(ref)
# + FLASH_RTOL * |ref|. The kernels round P and dS to bf16 before their products
# (2^-9 relative per term, errors of order 2^-9 rms(ref) after the f32 sums: the
# absolute term) and store the gradient in bf16 (one ulp of |ref|: the relative term).
EXTRA_FLASH_BWD = ((2, 1000, 8, 40),)  # off the path: a ragged S
ADAMW_TOL_P = 1e-6  # params and EMA shadow, absolute: f32 rounding at |p| ~ 1
ADAMW_TOL_SCALE = 1e-5  # row absmax scales, relative
ADAMW_KW = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2)
RAGGED_LEAF = (1000, 77)  # off the path: 77 000 % 256 != 0

# the group norm where H*W % 8 != 0: the UNet's 6x6 (384 pixels) and 10x10 (640) levels
GN_TAIL_SHAPES = ((2, 1280, 6, 6), (2, 1280, 10, 10), (2, 640, 10, 10))
TAIL_RES_ARGS = ["--resolution", "384", "--image-size", "112", "--num-inference-steps", "20",
                 "--batch-size", "2", "--num-images", "2",
                 "--word_token_heatmaps", "cars", "aerial", "utah", "--device", "cuda"]
# the token fine-tune's recipe (scripts/finetune_sd_token.sh), cut to a few steps
TOKEN_WORDS = ("cars", "Utah", "New Zealand")
TOKEN_PROMPTS = ("An aerial view image with cars in Utah",
                 "An aerial view image with cars in New Zealand")
TOKEN_LR = 5e-7
TOKEN_ARGS = ["--resolution", str(TRAIN_RES), "--train_batch_size", str(TRAIN_BATCH),
              "--learning_rate", str(TOKEN_LR), "--snr_gamma", "5", "--reg_weight", "0.5",
              "--n_object_embedding", "1", "--object_token", "new_token",
              "--initialize_token", *TOKEN_WORDS, "--with_cross_attn_reg", "--train_unet",
              "--seed", "0", "--device", "cuda", "--report_to", "jsonl"]
STAGE1_STEPS, STAGE2_STEPS = 2, 2
ACCUM, ACCUM_UPDATES = 2, 2

# labelling: the synthetic_heatmap yolov8 preset's batch, DetectionConfig's 128 px
LABEL_BATCH, LABEL_IMG, LABEL_TILES = 192, 128, 512
LABEL_DETECTORS = ("yolov8", "yolov8s")  # YOLOv8n (the pipeline's default) and YOLOv8s
LABEL_WORDS = ("cars", "new_token_v0", "new_token_v2")  # object, fg, bg (cli/pipeline.py)
# card vs CPU, both f32 (TF32 off), from weights whose batch-norm statistics
# were measured on data (logits up to about 100): each per-level head output
# within HEAD_TOL_RMS * rms(ref) elementwise (summation order and cuDNN's
# algorithms differ by about 1e-6 relative a layer; over the 60-odd
# convolutions of the deepest path the sound runs reached 3.4e-5 of the rms
# here and 1.9e-4 in the card test's noise images, the limit is 3x the
# larger; an element's error follows its layer's scale, not its own size, as
# for flash); the same forward with TF32 on for cuDNN and cuBLAS (2.0e-2 to
# 2.7e-2) is the control and must fail the limit, as a run that lost full f32
# would;
# a kept detection matches one of the other side's at IoU >= DET_IOU and
# |d score| <= DET_SCORE_TOL (a logit off by 4e-3 moves a score by at most
# 1e-3); near-tied scores may trade places in NMS, so at most
# DET_UNMATCHED_MAX of the kept detections go unmatched, each way (5e-4 of
# them under 1e-4 relative noise on the CPU); the resize within one level
HEAD_TOL_RMS = 6e-4
DET_IOU, DET_SCORE_TOL, DET_UNMATCHED_MAX = 0.99, 1e-3, 0.02
RESIZE_TOL = 1.0

# detector training (phases 21-23): the synthetic_heatmap preset's YOLOv8n at
# 128 px; the CLI on 384 stacks with 64 more for validation, 12 epochs (the
# mosaic-close switch at epoch 12 - 10 = 2); phase 21's update at step 1000
# (the end of the warmup, in an epoch of 1001 steps: the preset's full lr,
# so an update stands well above the rounding of the weights); timing at the
# synthetic_heatmap (192) and synthetic_target (1024) batches
DET_TRAIN_TILES, DET_VAL_TILES, DET_EPOCHS, DET_SWITCH = 384, 64, 12, 2
DET_STEP, DET_AUG_IMAGES, DET_AUG_WARM = 1000, 64, 8
DET_TIMING = (("synthetic_heatmap", 192), ("synthetic_target", 1024))
# card vs CPU, both f32, one train step from the same weights and batch: each
# limit lies between the sound runs' largest reading and the TF32 control's
# (det_readings says what each reads; the readings, sound / TF32 control, are
# the H100's with the CPU's TAL assignment on both sides): the loss and its
# parts 1.4e-7 / 4.5e-5 relative; the gradients 3.5e-3 / 1.2 of their rms (the
# CPU's own f32 error against a float64 run is the larger: 3.5e-3 at sppf.cv1,
# the card's 5.8e-4; the float64 runs agree to 2.8e-10); the batch statistics
# 1.4e-5 / 1.5e-2 of their move; the update 3.5e-3 / 1.2 and the EMA 3.3e-3 /
# 1.2 of theirs; TAL, each side's own, 8 / 28 anchors of 64 512 (8 of the
# CPU's 5 780 fg anchors sit between two GT boxes of near-equal IoU; the
# control with autotuned cuDNN algorithms read from 13 to 22: tf32_on pins them)
DET_LOSS_RTOL = 2.5e-6
DET_GRAD_TOL_RMS = 1e-2  # per tensor, max |d| / rms(CPU)
DET_GRAD64_TOL_RMS = 1e-9  # the same step in float64 on both sides
DET_STATS_TOL_RMS = 1e-4
DET_UPDATE_TOL_RMS = 1e-2
DET_EMA_TOL_RMS = 1e-2
DET_TAL_MAX = 13  # anchors whose fg or assigned GT differ
# device augmentation (phases 24-26): the render card vs CPU at batch 192 with
# the CPU tests' limits (tests/test_torch_device_aug.py), levels: the mean
# |d| and the share of values more than half a level apart (HSV's sector
# can flip at a tie); LSJ within one level on at most LSJ_DIFF_SHARE of the
# values (one of its two roundings can flip at .5); RENDER_FORCED
# passthrough samples forced into the mix batch. Timing at the
# synthetic_heatmap (192, the 512 stacks, 2 epochs of 3 steps) and
# synthetic_target (1024, two parts of 512 fabricated tiles: a 50 MB
# tensor, 2 epochs of 1 step) batches, the loop timed over epoch 1 (cut
# from 4096 tiles and 4 epochs at 192, then from 3 epochs and 2048 tiles,
# to keep the script within its limit); with 4 plan workers at 192 only
# (their pool's start took 12.8 s of the 1024 run's)
RENDER_MEAN_TOL, RENDER_FAR_SHARE, LSJ_DIFF_SHARE = 1e-3, 1e-4, 1e-3
RENDER_SLOTS, RENDER_FORCED = 24, 4
DEVICE_AUG_TILES = 1024
DEVICE_AUG_TIMING = (("synthetic_heatmap", 192, 2), ("synthetic_target", 1024, 2))


# TGATE (phase 35): the main path's generation with --tgate-step 10 of 20 PLMS
# steps (11 UNet calls at 2B, 10 at B). The replay gate: one UNet call at 2B
# in bf16 that collects the cross-attention contributions, the same call
# replaying them, and the exact call, against one another, max |d| over
# rms(exact eps): the collecting call runs the exact call's kernels and the
# replay adds the very tensors the collecting call added, so the readings
# are bitwise 0 unless a kernel's order of summation varies between calls
# (bf16 rounds at 2^-8: the limit is a few of its ulps)
TGATE_STEP = 10
TGATE_REPLAY_TOL_RMS = 1e-2
# VAE pretraining (phase 36): SD-1.4's VAE (128/256/512/512, fabricated) at
# 256 px, batch 8, so the mid-block attention is S = 1024, D = 512 (the
# wide K2/K3), under bf16 autocast (asked for: the default is f32, phase 41);
# VAE_STEPS steps of Adam at VAE_LR, the first two cold; then pretrain_vae end
# to end for 2 steps and its scaling_factor. Phase 41 runs VAE_F32_STEPS of
# them in f32.
VAE_RES, VAE_BATCH, VAE_STEPS, VAE_LR, VAE_IMAGES = 256, 8, 8, 1e-4, 32
VAE_F32_STEPS = 4
# phase 41's f32 step card vs CPU from the fabricated weights at
# VAE_F32_PARITY_RES px, batch 2 (the mid-block attention S = 64, D = 512:
# the wide f32 kernels): the loss within VAE_F32_LOSS_RTOL, each gradient
# (Adam's first moment / 0.1) within VAE_F32_GRAD_TOL relative L2 over the
# tensors whose CPU gradient is above VAE_NULL_GRAD of the largest; the
# same step with the attention's dK, dV and dQ zeroed, the control, beyond
# the gradient limit. Set before the first run, from the f32 SD step's
# card-vs-CPU readings (loss 8.8e-8, gradients 4.9e-6).
VAE_F32_PARITY_RES, VAE_F32_LOSS_RTOL, VAE_F32_GRAD_TOL, VAE_NULL_GRAD = 64, 1e-5, 1e-3, 1e-4
# the wide flash backward (D > 160) against its plain version (phase 37):
# the VAE step's shape, a longer S, and a ragged S at a D the tiles pad
WIDE_FLASH_BWD = {(8, 1024, 1, 512): None, (2, 4096, 1, 512): 0, (1, 333, 2, 264): 0}
PROFILE_SUM_TOL = 0.01  # phase 6's report: its categories' sum over its busy ms, relative

def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def host_state() -> str:
    """What this process holds on the host and the card: live threads (and
    their names), child processes, kernel tasks, torch's intra-op threads,
    resident memory, the gc's tracked objects and the card's reserved
    bytes."""
    import gc
    import multiprocessing
    import threading

    import torch

    names = sorted(t.name for t in threading.enumerate())
    tasks = len(os.listdir("/proc/self/task")) if os.path.isdir("/proc/self/task") else -1
    rss = -1.0
    with contextlib.suppress(OSError):
        for line in open("/proc/self/status"):
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 2**20  # kB -> GiB
    return (f"threads {len(names)} {names}, children {len(multiprocessing.active_children())}, "
            f"tasks {tasks}, torch threads {torch.get_num_threads()}, rss {rss:.2f} GiB, gc "
            f"objects {len(gc.get_objects())}, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")


def settle(phase: str) -> float:
    """The start of a phase: stop what earlier phases left running (a child
    process, an open profiler), collect garbage, return the card's cached
    blocks and the cached pinned host blocks, print one [host] line
    (``host_state``, and the seconds this took) and return the time. It does
    not trim the C heap, a step whose work grows with the heap: with it,
    settling took 0.84-2.33 s a phase at 27-31 GiB resident against
    0.11-0.39 s at 4.5-6.8 GiB, about 30 s a run (PERF.md)."""
    import gc
    import multiprocessing

    import torch

    t0 = time.perf_counter()
    for child in multiprocessing.active_children():
        print(f"[host] {phase}: stopping a child left running: {child.name} ({child.pid})",
              flush=True)
        child.terminate()
        child.join(10)
    if torch.autograd.profiler._is_profiler_enabled:  # a profile left open
        print(f"[host] {phase}: a profiler was left enabled", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):  # cached pinned blocks
        if hasattr(torch._C, name):
            with contextlib.suppress(RuntimeError):
                getattr(torch._C, name)()
            break
    print(f"[host] {phase}: {host_state()}; settled in {time.perf_counter() - t0:.2f} s",
          flush=True)
    return time.perf_counter()


def part(tag: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall printed as a [parts] line."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[parts] {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def time_ms(fn, target_ms: float = 40.0, max_iters: int = 200,
            stream=None) -> Tuple[float, float]:
    """(device ms, eager ms) per call of fn, both from CUDA events.

    Device time replays a CUDA graph of the calls, so the host's Python and
    ctypes overhead is excluded; eager time launches back to back, so for
    small shapes it is the host's enqueue rate rather than the card's.
    ``stream`` is the side stream to warm up and capture on: an autograd
    backward runs each node on its forward's stream, so a backward is timed
    with the stream its forward ran on.
    """
    import torch

    def timed(run, n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def eager(n):
        for _ in range(n):
            fn()

    eager(1)  # warm up (workspace allocation, lazy module loading)
    torch.cuda.synchronize()
    probe = timed(eager, 1)  # a second warm call; one call of a slow function is timed once
    iters = 1 if probe >= target_ms else int(min(max_iters, max(3, target_ms / max(probe, 1e-3))))
    eager_ms = timed(eager, iters) / iters
    graph_iters = min(iters, 20)
    graph = torch.cuda.CUDAGraph()
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager(1)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph, stream=side):
        eager(graph_iters)
    graph.replay()
    reps = max(1, iters // graph_iters)
    device_ms = timed(lambda n: [graph.replay() for _ in range(n)], reps) / (reps * graph_iters)
    del graph
    return device_ms, eager_ms


def expected_launches(unet_cfg, vae_cfg, unet_calls: int) -> dict:
    """Kernel launches of one batch, counted from the model configs."""
    n = unet_cfg.layers_per_block
    transformers = (n * sum(t == "CrossAttnDownBlock2D" for t in unet_cfg.down_block_types) + 1
                    + (n + 1) * sum(t == "CrossAttnUpBlock2D" for t in unet_cfg.up_block_types))
    resnets = n * len(unet_cfg.down_block_types) + 2 + (n + 1) * len(unet_cfg.up_block_types)
    vae_resnets = 2 + (vae_cfg.layers_per_block + 1) * len(vae_cfg.block_out_channels)
    return {
        "flash_attention_fwd": transformers * unet_calls + 1,  # + the VAE mid attention
        "group_norm_act": (2 * resnets + transformers + 1) * unet_calls + 2 * vae_resnets + 2,
    }


def record_calls(modules, run) -> dict:
    """{"flash": [(B, S, H, D), ...], "gn": [(shape, groups, eps, act), ...]}:
    the kernel calls, in order, that ``run()`` makes through the group norms,
    self-attentions and VAE attentions among ``modules``."""
    from agenda_tpu_torch.models.layers import Attention, GroupNormAct, VAEAttention

    calls = {"flash": [], "gn": []}

    def on_gn(m, args):
        calls["gn"].append((tuple(args[0].shape), m.num_groups, m.eps, m.act))

    def on_self_attn(m, args):
        x = args[0]
        if len(args) == 1:  # attn1: no context
            calls["flash"].append((x.shape[0], x.shape[1], m.heads, x.shape[2] // m.heads))

    def on_vae_attn(m, args):
        b, c, h, w = args[0].shape
        calls["flash"].append((b, h * w, 1, c))

    hooks = []
    for mod in modules:
        if isinstance(mod, GroupNormAct):
            hooks.append(mod.register_forward_pre_hook(on_gn))
        elif isinstance(mod, Attention):
            hooks.append(mod.register_forward_pre_hook(on_self_attn))
        elif isinstance(mod, VAEAttention):
            hooks.append(mod.register_forward_pre_hook(on_vae_attn))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def tally(calls: dict, times: int = 1, into: dict = None) -> dict:
    """{kind: {key: count}}: ``record_calls``' lists, each call counted
    ``times`` times, added to ``into``."""
    into = {"flash": {}, "gn": {}} if into is None else into
    for kind, keys in calls.items():
        for key in keys:
            into[kind][key] = into[kind].get(key, 0) + times
    return into


def sampler_shapes(unet, vae, hw: int, batch: int, unet_calls: int, dev) -> dict:
    """Shapes, and calls per batch, of every kernel call of one sampled batch:
    ``unet_calls`` guided UNet calls (at 2 x batch) and one decode."""
    import torch

    with torch.no_grad():
        ctx = torch.randn(2 * batch, 77, unet.config.cross_attention_dim, device=dev)
        lat = torch.randn(2 * batch, hw, hw, 4, device=dev)
        t = torch.full((2 * batch,), 500.0, device=dev)
        in_unet = record_calls(unet.modules(), lambda: unet(lat, t, ctx, collect_attn=True))
        z = torch.randn(batch, hw, hw, 4, device=dev)
        in_decode = record_calls(vae.decoder.modules(), lambda: vae.decode(z))
    return tally(in_decode, 1, tally(in_unet, unet_calls))


def record_shapes(pipe, batch: int):
    """Shapes, and calls per batch, of every kernel call of one UNet call and one decode."""
    unet_calls = len(pipe.timestep_table(E2E_STEPS))
    return (sampler_shapes(pipe.unet, pipe.vae, pipe.latent_hw, batch, unet_calls, pipe.device),
            unet_calls)


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name), first match wins
    ("flash_fwd (ours)", ("flash_fwd",)),
    ("flash_bwd_dkv (ours)", ("flash_bwd_dkv",)),
    ("flash_bwd_dq (ours)", ("flash_bwd_dq",)),
    ("fused_adamw8bit (ours)", ("fused_adamw8bit",)),
    ("groupnorm (ours)", ("groupnorm_kernel",)),
    ("foreach (optimizer, EMA)", ("multi_tensor", "foreach")),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "cublas", "xmma", "nvjet", "sm90_", "sm80_", "ampere")),
    ("softmax", ("softmax",)),
    ("layer_norm", ("layer_norm",)),
    ("copy / cat / elementwise", ("elementwise", "vectorized", "unrolled", "copy", "cat",
                                   "index", "fill", "memcpy", "memset")),
    ("reduce", ("reduce",)),
)


# the detector training's profile: batch norm first, then the shared table
DET_KERNEL_GROUPS = (("batch norm", ("batch_norm", "bn_fw", "bn_bw")),) + KERNEL_GROUPS


def generate_kwargs():
    return dict(num_inference_steps=E2E_STEPS, words=list(E2E_WORDS), out_size=112,
                heatmap_size=112)


def time_batches(pipe, batch: int) -> Tuple[float, float]:
    """Wall seconds of the process's first (cold) batch and of a second (warm) one."""
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        pipe.generate_async(PROFILE_PROMPT, list(range(batch)), **generate_kwargs())()
        walls.append(time.perf_counter() - t0)
    print(f"[shapes] batch {batch} at 512x512, {E2E_STEPS} steps through the pipeline API: "
          f"cold {walls[0]:.3f} s, warm {walls[1]:.3f} s", flush=True)
    return walls[0], walls[1]


def device_times(run, trace_dir: str = None) -> Tuple[dict, float]:
    """torch.profiler over one run(): ({CUDA kernel, memcpy or memset name:
    (us, count)}, the run's wall seconds); with ``trace_dir`` the Chrome
    trace is written there as ``trace.json``, as ``utils/profiling.py::
    maybe_profile`` writes it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    per_name = {}  # CUDA kernel (and memcpy/memset) events only: the ops' rows would double count
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return per_name, wall


def profile_run(run, tag: str, what: str, warm_s: float, kernel_groups=KERNEL_GROUPS,
                trace_dir: str = None) -> None:
    """torch.profiler breakdown of one run() by kernel group (last in its path:
    the profiler's CUPTI hooks can slow later launches)."""
    per_name, wall = device_times(run, trace_dir)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    groups = {}
    for name, (us, n) in per_name.items():
        low = name.lower()
        group = next((g for g, subs in kernel_groups if any(x in low for x in subs)), "other")
        ms, count = groups.get(group, (0.0, 0))
        groups[group] = (ms + us / 1e3, count + n)
    print(f"[{tag}] {what}: device busy {busy_ms / 1e3:.3f} s = "
          f"{100.0 * busy_ms / (1e3 * wall):.1f}% of the profiled run's {wall:.3f} s wall, "
          f"{100.0 * busy_ms / (1e3 * warm_s):.1f}% of the unprofiled warm run's {warm_s:.3f} s",
          flush=True)
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {group:26s} {ms:9.2f} ms  {100.0 * ms / busy_ms:5.1f}% of busy  "
              f"{n} launches", flush=True)
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[{tag}]   top: {us / 1e3:8.2f} ms  x{n:<5d} {name[:110]}", flush=True)
    return busy_ms, groups


def flash_rows(per_batch):
    import ctypes

    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels import _build
    from agenda_tpu_torch.kernels.flash import flash_attention_fwd, flash_attention_reference

    encode_ns = _build.load_library().function(
        "agenda_flash_fwd_encode_ns",
        [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int])
    rows = []
    shapes = dict(per_batch)
    for shape in EXTRA_FLASH:
        shapes.setdefault(shape, 0)
    for shape, count in shapes.items():
        b, s, h, d = shape
        g = torch.Generator(device="cuda").manual_seed(b * 7919 + s + h + d)
        q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v)
        ref_out, ref_lse = flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        ref_f = ref_out.float()
        diff = (out.float() - ref_f).abs()
        rms = ref_f.square().mean().sqrt().item()
        err = diff.max().item()
        of_limit = (diff / (FLASH_ATOL_RMS * rms + FLASH_RTOL * ref_f.abs())).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        require(of_limit <= 1.0 and err_lse <= FLASH_TOL_LSE,
                f"flash {shape}: out err {err}, {of_limit:.4g} of the limit {FLASH_ATOL_RMS} "
                f"rms(ref) + {FLASH_RTOL}|ref| (rms {rms:.4g}); lse err {err_lse} "
                f"(tol {FLASH_TOL_LSE})")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, eager = time_ms(lambda: flash_attention_fwd(q, k, v))
        # every launch encodes three tensor maps
        ns = encode_ns(q.data_ptr(), b, s, h, d, *q.stride()[:3], 1000)
        require(ns >= 0, f"flash {shape}: cuTensorMapEncodeTiled refused a tensor map")
        maps = f", of which tensor maps {ns / 1e6:.3f} us"
        plain, _ = time_ms(lambda: flash_attention_reference(q, k, v), max_iters=20)
        lib, _ = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * b * h * s * s * d
        nbytes = 4.0 * b * s * h * d * 2 + 4.0 * b * h * s
        exps = float(b * h * s * s)
        terms = {"tensor operations": flops / H100_BF16_FLOPS,
                 "exponentials": exps / H100_EXP_PER_S, "bytes": nbytes / H100_BYTES_PER_S}
        term = max(terms, key=terms.get)
        rows.append(dict(shape=shape, per_batch=count, err=max(err, err_lse), ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=1e3 * terms[term],
                         bound_by="bytes" if term == "bytes" else "operations"))
        print(f"flash (B,S,H,D)={shape} x{count}/batch  out err {err:.3g}, {of_limit:.4g} of the "
              f"limit {FLASH_ATOL_RMS} rms(ref) + {FLASH_RTOL}|ref| (rms {rms:.4g})  lse err "
              f"{err_lse:.3g} (tol {FLASH_TOL_LSE})  kernel {ms:.4f} ms "
              f"(eager {eager:.4f}{maps})  plain {plain:.4f} ms  SDPA {lib:.4f} ms  bound "
              f"{1e3 * terms[term]:.4f} ms ({term}: 4*B*H*S^2*D = {flops:.4g} ops over 989e12/s "
              f"= {1e3 * terms['tensor operations']:.4f} ms; B*H*S^2 = {exps:.4g} exp over "
              f"3.9e12/s = {1e3 * terms['exponentials']:.4f} ms; {nbytes:.4g} bytes over "
              f"3.35e12/s = {1e3 * terms['bytes']:.4f} ms)", flush=True)
        del q, k, v, out, lse, ref_out, ref_lse, ref_f, diff
    ours, sdpa, bound = (sum(r[key] * r["per_batch"] for r in rows)
                         for key in ("ms", "library_ms", "bound_ms"))
    print(f"flash forward per generation batch: {ours:.4f} ms against SDPA {sdpa:.4f} ms "
          f"({ours / sdpa:.2f}x) and the bound {bound:.4f} ms", flush=True)
    return rows


def gn_row(shape, groups, eps, act, count, tag="groupnorm"):
    """Parity and timing of the group norm at one shape (``count`` launches
    a batch), with its launch plan."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels import _build
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference

    plan_fn = _build.load_library().function("agenda_groupnorm_plan",
                                             [ctypes.c_int] * 5 + [ctypes.c_void_p])
    c = shape[1]
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + c)
    x = (torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5).to(torch.bfloat16)
    w = torch.randn(c, device="cuda", generator=g)
    bias = torch.randn(c, device="cuda", generator=g)
    before = group_norm_act.launches
    y = group_norm_act(x, w, bias, groups, eps, act)
    ref = group_norm_act_reference(x, w, bias, groups, eps, act)
    torch.cuda.synchronize()
    require(group_norm_act.launches == before + 1, f"group norm {shape} did not launch")
    diff = (y.float() - ref.float()).abs()
    err = diff.max().item()
    require(bool((diff <= GN_ATOL + GN_RTOL * ref.float().abs()).all()),
            f"group norm {shape} eps {eps} act {act}: max err {err} "
            f"(tol {GN_ATOL} + {GN_RTOL}*|ref|)")
    wb, bb = w.to(x.dtype), bias.to(x.dtype)

    def library():
        out = F.group_norm(x, groups, wb, bb, eps)
        return F.silu(out) if act == "silu" else out

    ms, eager = time_ms(lambda: group_norm_act(x, w, bias, groups, eps, act))
    plain, _ = time_ms(lambda: group_norm_act_reference(x, w, bias, groups, eps, act))
    lib, _ = time_ms(library)
    n = x.numel()
    plan = (ctypes.c_longlong * 4)()
    plan_fn(shape[0], c, n // (shape[0] * c), groups, x.element_size(), plan)
    nbytes = 2.0 * n * 2 + 2.0 * c * 4
    flops = n * (8.0 if act == "silu" else 4.0)
    row = dict(shape=(shape, eps, act), per_batch=count, err=err, ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=1e3 * max(nbytes / H100_BYTES_PER_S,
                                                  flops / H100_F32_FLOPS),
               bound_by="bytes" if nbytes / H100_BYTES_PER_S >= flops / H100_F32_FLOPS
               else "operations")
    print(f"{tag} {shape} (H*W = {n // (shape[0] * c)}) eps {eps:g} act {act} x{count}/batch  "
          f"err {err:.3g} (tol {GN_ATOL}+{GN_RTOL}|ref|)  kernel {ms:.4f} ms (eager "
          f"{eager:.4f})  plain {plain:.4f} ms  F.group_norm {lib:.4f} ms  bound "
          f"{row['bound_ms']:.4f} ms  (cluster of {plan[0]}, {plan[1]} threads, "
          f"{plan[2]} chunks a thread in shared memory; "
          + ("x read once)" if plan[3] == 0 else f"{plan[3]} of each block's chunks "
             "read twice)"), flush=True)
    return row


def gn_rows(per_batch):
    rows = [gn_row(shape, groups, eps, act, count)
            for (shape, groups, eps, act), count in per_batch.items()]
    ours, lib, bound = (sum(r[key] * r["per_batch"] for r in rows)
                        for key in ("ms", "library_ms", "bound_ms"))
    print(f"groupnorm per generation batch: {ours:.4f} ms against F.group_norm + F.silu "
          f"{lib:.4f} ms and the bound {bound:.4f} ms", flush=True)
    return rows


# -- the training path --------------------------------------------------------


def n_transformers(unet_cfg) -> int:
    n = unet_cfg.layers_per_block
    return (n * sum(t == "CrossAttnDownBlock2D" for t in unet_cfg.down_block_types) + 1
            + (n + 1) * sum(t == "CrossAttnUpBlock2D" for t in unet_cfg.up_block_types))


def train_expected(unet_cfg, vae_cfg) -> dict:
    """Per-step and per-run counts of the training path, from the configs."""
    import torch

    from agenda_tpu_torch.kernels.fused_adamw import capacity, leaf_plan
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.train.optim import MIN_QUANTIZE_SIZE

    with torch.device("meta"):
        sizes = [p.numel() for p in UNet2DConditionModel(unet_cfg).parameters()]
    quantized = [n for n in sizes if n >= MIN_QUANTIZE_SIZE]
    n = unet_cfg.layers_per_block
    resnets = n * len(unet_cfg.down_block_types) + 2 + (n + 1) * len(unet_cfg.up_block_types)
    enc_resnets = vae_cfg.layers_per_block * len(vae_cfg.block_out_channels) + 2
    tf = n_transformers(unet_cfg)
    return {"tensors": len(sizes), "quantized": len(quantized),
            "quantized_elements": sum(quantized),
            "ragged": sum(k % 256 != 0 for k in quantized),
            "adamw_per_step": len(leaf_plan(quantized, capacity())),  # launches
            "flash_per_step": tf,
            "gn_per_step": 2 * resnets + tf + 1,  # + conv_norm_out
            "gn_per_cache_batch": 2 * enc_resnets + 2}  # + mid attention, conv_norm_out


def build_trainer(model_dir: str, dev, lr: float = 1e-6, mesh=None, dtype=None):
    """The full-width model through the trainer API, as cli/finetune_sd builds
    it (over ``mesh``'s ranks with one) in the compute ``dtype`` (by default
    bf16 on the card; f32 is --mixed_precision no); returns (unet, make,
    vocab size) with make(use_ema) -> (state, step); make.vae and make.text
    are the frozen modules."""
    import torch

    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.generate.pipeline import _build
    from agenda_tpu_torch.io.diffusers_io import load_pipeline
    from agenda_tpu_torch.models.clip_text import CLIPTextModel
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train.finetune_sd import LossConfig, init_train_state, make_train_step
    from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer

    bundle = load_pipeline(model_dir)
    with torch.device("meta"):
        unet = UNet2DConditionModel(bundle.unet_config)
    unet.load_state_dict({k: v.to(dev, torch.float32) for k, v in bundle.unet_state.items()},
                         strict=True, assign=True)
    frozen = dtype or (torch.bfloat16 if dev.type == "cuda" else torch.float32)
    vae = _build(AutoencoderKL, bundle.vae_config, bundle.vae_state, dev, frozen)
    text = _build(CLIPTextModel, bundle.text_config, bundle.text_state, dev, frozen)
    tx = make_optimizer(lr_schedule("constant", lr, 0, 100), use_8bit_adam=True)

    def make(use_ema: bool):
        state = init_train_state(unet.train(), tx, use_ema, mesh)
        return state, make_train_step(unet, vae, text, make_schedule(), tx,
                                      LossConfig(snr_gamma=5.0), use_ema, mesh=mesh,
                                      dtype=frozen)

    make.vae, make.text = vae, text
    return unet, make, bundle.text_config.vocab_size


def synthetic_batch(vae_cfg, vocab: int, dev, seed: int):
    """Cached latent moments (as the CLI's default path gives) and token ids."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    h = TRAIN_RES // 2 ** (len(vae_cfg.block_out_channels) - 1)
    mean = torch.randn(TRAIN_BATCH, h, h, vae_cfg.latent_channels, device=dev, generator=g)
    logvar = torch.full_like(mean, -6.0)
    ids = torch.randint(0, vocab, (TRAIN_BATCH, 77), device=dev, generator=g)
    return {"latent_moments": torch.cat([mean, logvar], dim=-1), "input_ids": ids}


def train_counters():
    from agenda_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from agenda_tpu_torch.kernels.fused_adamw import fused_adamw8bit_leaves
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    return {"flash_attention_fwd": (flash_attention_fwd, "launches"),
            "flash_attention_fwd_wide": (flash_attention_fwd, "launches_wide"),  # D > 160
            "flash_attention_bwd_dkv": (flash_attention_bwd_dkv, "launches"),
            "flash_attention_bwd_dq": (flash_attention_bwd_dq, "launches"),
            "fused_adamw8bit": (fused_adamw8bit_leaves, "launches"),
            "fused_adamw8bit_ema": (fused_adamw8bit_leaves, "launches_ema"),
            "fused_adamw8bit_leaves": (fused_adamw8bit_leaves, "leaves"),
            "fused_adamw8bit_leaves_ema": (fused_adamw8bit_leaves, "leaves_ema"),
            "group_norm_act": (group_norm_act, "launches")}


def reset_counts() -> None:
    for fn, attr in train_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in train_counters().items()}


def record_train_step(unet, state, step, batch, dev):
    """Flash shapes of one training step (forward hooks on attn1) and the
    quantized leaves of the optimizer state."""
    from agenda_tpu_torch.models.layers import Attention
    from agenda_tpu_torch.train.optim import _Quantized

    shapes = {}

    def on_self_attn(m, args):
        x = args[0]
        if len(args) == 1:  # attn1: no context
            key = (x.shape[0], x.shape[1], m.heads, x.shape[2] // m.heads)
            shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(on_self_attn) for m in unet.modules()
             if isinstance(m, Attention)]
    step(state, batch, generator=torch_generator(dev, 0))
    for h in hooks:
        h.remove()
    leaves = {}
    for m in state.opt_state.mu.values():
        if isinstance(m, _Quantized):
            key = tuple(m.q.shape)
            leaves[key] = leaves.get(key, 0) + 1
    return shapes, leaves


def torch_generator(dev, seed: int):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def train_api_phase(model_dir, unet_cfg, vae_cfg, dev):
    """Phases 8 and 9: shapes, warm timing, profile, then the no-EMA (K4) path."""
    import torch

    expected = train_expected(unet_cfg, vae_cfg)
    unet, make, vocab = build_trainer(model_dir, dev)
    state, step = make(True)
    batch = synthetic_batch(vae_cfg, vocab, dev, 0)
    reset_counts()
    flash_shapes, leaves = record_train_step(unet, state, step, batch, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    n_leaves = sum(leaves.values())
    print(f"[train shapes] one step at batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}: flash "
          f"(B,S,H,D) x per-step {flash_shapes}; {n_leaves} quantized leaves of "
          f"{len(state.params)} tensors in {len(leaves)} shapes; launches {counts}", flush=True)
    want = {"flash_attention_fwd": expected["flash_per_step"], "flash_attention_fwd_wide": 0,
            "flash_attention_bwd_dkv": expected["flash_per_step"],
            "flash_attention_bwd_dq": expected["flash_per_step"],
            "fused_adamw8bit": 0, "fused_adamw8bit_ema": expected["adamw_per_step"],
            "fused_adamw8bit_leaves": 0, "fused_adamw8bit_leaves_ema": expected["quantized"],
            "group_norm_act": expected["gn_per_step"]}
    print(f"[train shapes] from the config: {expected}", flush=True)
    require(sum(flash_shapes.values()) == expected["flash_per_step"]
            and n_leaves == expected["quantized"] and len(state.params) == expected["tensors"]
            and expected["ragged"] == sum(n for s, n in leaves.items() if math.prod(s) % 256),
            "recorded training shapes differ from the config's counts")
    require(counts == want, f"training-step launches {counts} differ from the config's {want}")

    # warm timing (host clock around synchronised steps), peak memory, a profiled step
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        _, m = step(state, batch, generator=torch_generator(dev, i + 1))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"non-finite training loss {losses}")
    print(f"[train timing] warm {warm_s:.4f} s/step = {TRAIN_BATCH / warm_s:.3f} images/s "
          f"(batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}, fused int8 AdamW + EMA, 3 steps); "
          f"peak memory {peak / 2**30:.2f} GiB; losses {losses}", flush=True)
    profile_run(lambda: (step(state, batch, generator=torch_generator(dev, 9)),
                         torch.cuda.synchronize()),
                "train profile", f"one step at batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}",
                warm_s)

    # 9. the K4 path: no EMA, a fresh optimizer state, the same model
    del state, step
    state, step = make(False)
    before = {k: p.detach().clone() for k, p in list(state.params.items())[:4]}
    reset_counts()
    for i in range(2):
        step(state, batch, generator=torch_generator(dev, 20 + i))
    torch.cuda.synchronize()
    k4 = read_counts()
    changed = any(not torch.equal(before[k], state.params[k]) for k in before)
    print(f"[K4 path] 2 steps without EMA through the trainer API: launches {k4}; params "
          f"changed {changed}", flush=True)
    require(k4["fused_adamw8bit"] == 2 * expected["adamw_per_step"]
            and k4["fused_adamw8bit_leaves"] == 2 * expected["quantized"]
            and k4["fused_adamw8bit_ema"] == 0 and k4["fused_adamw8bit_leaves_ema"] == 0
            and changed, f"the no-EMA path did not launch the fused AdamW kernel "
            f"{expected['adamw_per_step']}x for {expected['quantized']} leaves a step")
    del unet, make, state, step, batch
    torch.cuda.empty_cache()
    return flash_shapes, leaves, k4, {"warm_s": warm_s, "peak": peak}


def ptxas_report(log: str):
    """'kernel<template args>' -> 'registers, stack, spills' of each instantiation
    of the port's kernels, from the build's ptxas -v output."""
    import re

    names = ("flash_fwd_wgmma|flash_fwd_wide_wgmma|flash_bwd_dkv_wide_wgmma|flash_bwd_dq_wide_wgmma"
             "|flash_bwd_dkv|flash_bwd_dq|flash_fwd_f32|flash_fwd_f32_wide|flash_f32_split"
             "|flash_f32_wide_scores|flash_f32_wide_products"
             "|flash_bwd_dkv_f32_wgmma|flash_bwd_dq_f32_wgmma"
             "|groupnorm|fused_adamw8bit")
    types = {"13__nv_bfloat16": "bf16", "f": "f32"}  # the group norm's element type
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(rf"({names})_kernel(?:I(13__nv_bfloat16|f)?((?:L[ib]\d+E)+)E)?", line)
        if m and ("Compiling entry function" in line or "Function properties" in line):
            args = ([types[m.group(2)]] if m.group(2) else []) + re.findall(
                r"L[ib](\d+)E", m.group(3) or "")
            current = f"{m.group(1)}_kernel" + (f"<{', '.join(args)}>" if args else "")
        elif current and "spill stores" in line:
            found[current] = line.strip()
        elif current and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            found[current] = f"{regs.group(1) if regs else '?'} registers, {found.get(current, '')}"
            current = None
    return found


def serialized_report(log: str):
    """'<note code> <kernel>' for each of the port's kernels whose wgmma products
    ptxas serializes (C7512: not enough registers), from the build's ptxas -v
    output."""
    import re

    return sorted({" ".join(m.groups()) for m in (
        re.search(r"\((C75\d\d)\).*serialized.*\d((?:flash|groupnorm|fused)\w*?_kernel)", line)
        for line in log.splitlines()) if m})


def flash_bwd_rows(per_step, extra=EXTRA_FLASH_BWD, tag: str = "flash bwd"):
    """Parity and timing of the dK/dV and dQ kernels at every training shape
    (and the off-path ``extra`` shapes); ptxas's report of the instantiations
    with the first call."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels import _build
    from agenda_tpu_torch.kernels import flash as fl

    kernels = _build.load_library()
    smem = kernels.function("agenda_flash_bwd_smem_bytes", [ctypes.c_int, ctypes.c_int])
    for name, text in sorted(ptxas_report(kernels.log).items()):
        if name.startswith("flash_bwd_") and "_f32" not in name and tag == "flash bwd":
            nd = int(name[name.index("<") + 1:-1]) if "<" in name else 512  # wide: D <= 512
            print(f"[ptxas] {name}: {text}; {smem('dkv' in name, nd)} bytes of dynamic shared "
                  "memory", flush=True)
    if tag == "flash bwd":
        print(f"[ptxas] wgmma serialized in: {serialized_report(kernels.log) or 'none'}",
              flush=True)
    rows = {"dkv": [], "dq": []}
    pair = []  # (shape, launches a step, dK/dV + dQ ms, SDPA backward ms)
    shapes = dict(per_step)
    for shape in extra:
        shapes.setdefault(shape, 0)
    for shape, count in shapes.items():
        b, s, h, d = shape
        g = torch.Generator(device="cuda").manual_seed(b * 131 + s + h + d)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fl.flash_attention_fwd(q, k, v)
        delta = fl.flash_delta(out, do)
        got = {"dkv": fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
               "dq": (fl.flash_attention_bwd_dq(q, k, v, do, lse, delta),)}
        want = {"dkv": fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta),
                "dq": (fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta),)}
        torch.cuda.synchronize()
        errs = {}
        for kind in ("dkv", "dq"):
            worst, err = 0.0, 0.0
            for x, ref in zip(got[kind], want[kind]):
                ref_f = ref.float()
                diff = (x.float() - ref_f).abs()
                rms = ref_f.square().mean().sqrt().item()
                err = max(err, diff.max().item())
                worst = max(worst, (diff / (FLASH_ATOL_RMS * rms + FLASH_RTOL * ref_f.abs()))
                            .max().item())
            require(worst <= 1.0, f"{tag} {kind} {shape}: max err {err}, {worst:.4g} "
                    f"of the limit {FLASH_ATOL_RMS} rms(ref) + {FLASH_RTOL}|ref|")
            errs[kind] = (err, worst)
        # SDPA's backward (dQ, dK, dV in one call) as the yardstick the port never calls,
        # timed as the kernels are (graph replay); its forward runs on the capture stream
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            o = F.scaled_dot_product_attention(qt, kt, vt)
        torch.cuda.current_stream().wait_stream(side)
        lib, lib_eager = time_ms(
            lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), stream=side)
        flops1 = 2.0 * b * h * s * s * d  # one S x S x D product
        io = 2.0 * b * s * h * d  # one bf16 (B, S, H, D) tensor, bytes
        stats = 8.0 * b * h * s  # lse and delta, f32
        exps = float(b * h * s * s)  # P is recomputed in each kernel
        specs = {  # kind: (call, plain, products, bytes moved: q, k, v, dO, stats in; grads out)
            "dkv": (lambda: fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
                    lambda: fl.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta),
                    4, 4 * io + stats + 2 * io),
            "dq": (lambda: fl.flash_attention_bwd_dq(q, k, v, do, lse, delta),
                   lambda: fl.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta),
                   3, 4 * io + stats + io),
        }
        for kind, (call, plain_fn, products, nbytes) in specs.items():
            ms, eager = time_ms(call)
            plain, _ = time_ms(plain_fn, max_iters=10)
            flops = products * flops1
            terms = {"tensor operations": flops / H100_BF16_FLOPS,
                     "exponentials": exps / H100_EXP_PER_S, "bytes": nbytes / H100_BYTES_PER_S}
            term = max(terms, key=terms.get)
            rows[kind].append(dict(shape=shape, per_batch=count, err=errs[kind][0], ms=ms,
                                   plain_ms=plain, library_ms=lib,
                                   bound_ms=1e3 * terms[term],
                                   bound_by="bytes" if term == "bytes" else "operations"))
            print(f"{tag} {kind} (B,S,H,D)={shape} x{count}/step  err {errs[kind][0]:.3g}, "
                  f"{errs[kind][1]:.4g} of the limit  kernel {ms:.4f} ms (eager {eager:.4f})  "
                  f"plain {plain:.4f} ms  SDPA backward (dQ, dK, dV) {lib:.4f} ms (eager "
                  f"{lib_eager:.4f})  bound {1e3 * terms[term]:.4f} ms ({term}: {products} x "
                  f"2*B*H*S^2*D = {flops:.4g} ops over 989e12/s = "
                  f"{1e3 * terms['tensor operations']:.4f} ms; B*H*S^2 = {exps:.4g} exp over "
                  f"3.9e12/s = {1e3 * terms['exponentials']:.4f} ms; {nbytes:.4g} bytes over "
                  f"3.35e12/s = {1e3 * terms['bytes']:.4f} ms)", flush=True)
        pair.append((shape, count, rows["dkv"][-1]["ms"] + rows["dq"][-1]["ms"], lib))
        print(f"{tag} pair (B,S,H,D)={shape}: dK/dV + dQ {pair[-1][2]:.4f} ms against SDPA's "
              f"backward {lib:.4f} ms ({pair[-1][2] / lib:.2f}x)", flush=True)
        del q, k, v, do, out, lse, delta, got, want, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    ours, sdpa = (sum(n * x[i] for _, n, *x in pair) for i in (0, 1))
    print(f"{tag} pair per training step: dK/dV + dQ {ours:.4f} ms against SDPA's backward "
          f"{sdpa:.4f} ms ({ours / sdpa:.2f}x)", flush=True)
    return rows


def adamw_inputs(shape, seed: int):
    """p, g, qm, sm, qv, sv and an EMA shadow of one leaf, seeded."""
    import torch

    n = math.prod(shape)
    nb = (n + 255) // 256
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=g),
            torch.randn(shape, device="cuda", generator=g) * 1e-3,
            torch.randint(-127, 128, shape, device="cuda", generator=g).to(torch.int8),
            torch.rand(nb, device="cuda", generator=g) * 1e-3,
            torch.randint(0, 128, shape, device="cuda", generator=g).to(torch.int8),
            torch.rand(nb, device="cuda", generator=g) * 1e-6,
            torch.randn(shape, device="cuda", generator=g)]


def adamw_errors(ours, ref, e_ours=None, e_ref=None):
    """(param err, shadow err, codes off by, scale rel err) of one leaf."""
    err_p = (ours[0] - ref[0]).abs().max().item()
    err_e = (e_ours - e_ref).abs().max().item() if e_ours is not None else 0.0
    codes = max((ours[i].int() - ref[i].int()).abs().max().item() for i in (2, 4))
    err_s = max(((ours[i] - ref[i]).abs() / ref[i].abs().clamp(min=1e-30)).max().item()
                for i in (3, 5))
    return err_p, err_e, codes, err_s


def adamw_ok(errs) -> bool:
    err_p, err_e, codes, err_s = errs
    return (err_p <= ADAMW_TOL_P and err_e <= ADAMW_TOL_P and codes <= 1
            and err_s <= ADAMW_TOL_SCALE)


def adamw_bound(n: int, ema: bool) -> Tuple[float, str]:
    """(ms, term): 16 or 24 bytes an element plus the two scales read and
    written, over 3.35e12/s, against 60 f32 operations an element."""
    nb = (n + 255) // 256
    t_ops = 60.0 * n / H100_F32_FLOPS
    t_bytes = (n * (24.0 if ema else 16.0) + 16.0 * nb) / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def adamw_rows(leaves):
    """Parity and timing of the fused AdamW kernel, with and without EMA: one
    leaf a launch at every quantized leaf shape of the UNet, plus a ragged
    leaf; then the whole step's leaves (plus the ragged one, for parity) in
    one launch, as the optimizer launches it. Clipping is active (scale 0.4)
    in every call. Returns the rows of each: the step's first, counted once
    a step; the one-leaf rows are off the main path now."""
    import torch

    from agenda_tpu_torch.kernels.fused_adamw import (
        FusedLeaves,
        fused_adamw8bit_leaf,
        fused_adamw8bit_leaf_reference,
        fused_adamw8bit_leaves,
    )

    scalars = torch.tensor([1e-4, 0.4, 0.271, 0.0029701, 0.97], device="cuda")
    rows = {False: [], True: []}
    plain_step = {False: 0.0, True: 0.0}  # the plain version a leaf, summed over a step
    shapes = dict(leaves)
    shapes.setdefault(RAGGED_LEAF, 0)  # off the path: 77 000 % 256 != 0
    for shape, count in sorted(shapes.items(), key=lambda kv: -math.prod(kv[0])):
        n = math.prod(shape)
        *leaf, e = adamw_inputs(shape, n % 100003)
        for ema in (False, True):
            args = [t.clone() for t in leaf]
            ref = [t.clone() for t in leaf]
            ea, er = (e.clone(), e.clone()) if ema else (None, None)
            fused_adamw8bit_leaf(*args, scalars, ema=ea, **ADAMW_KW)
            fused_adamw8bit_leaf_reference(*ref, scalars, ema=er, **ADAMW_KW)
            torch.cuda.synchronize()
            errs = adamw_errors(args, ref, ea, er)
            require(adamw_ok(errs), f"fused AdamW {shape} ema={ema}: param err {errs[0]}, "
                    f"shadow err {errs[1]}, codes off by {errs[2]}, scale rel err {errs[3]}")
            work = [t.clone() for t in leaf]
            ew = e.clone() if ema else None
            ms, eager = time_ms(lambda: fused_adamw8bit_leaf(*work, scalars, ema=ew, **ADAMW_KW))
            plain, _ = time_ms(lambda: fused_adamw8bit_leaf_reference(
                *work, scalars, ema=ew, **ADAMW_KW), max_iters=10)
            plain_step[ema] += count * plain
            bound, term = adamw_bound(n, ema)
            rows[ema].append(dict(shape=shape, per_batch=0, err=max(errs[0], errs[1]), ms=ms,
                                  plain_ms=plain, library_ms=None, bound_ms=bound,
                                  bound_by=term))
            print(f"fused adamw ema={ema} {shape} x{count}/step, one leaf a launch  param err "
                  f"{errs[0]:.3g} shadow err {errs[1]:.3g} codes off by <= {errs[2]} scale rel "
                  f"err {errs[3]:.3g}  kernel {ms:.4f} ms (eager {eager:.4f})  plain "
                  f"{plain:.4f} ms  bound {bound:.4f} ms ({term})", flush=True)
            del args, ref, work
        del leaf, e
    torch.cuda.empty_cache()

    # the step's leaves in one launch: parity at every leaf (with the ragged
    # one), then the 293 timed as the optimizer launches them
    step_shapes = [s for s, c in sorted(leaves.items()) for _ in range(c)]
    inputs = [adamw_inputs(s, i) for i, s in enumerate(step_shapes + [RAGGED_LEAF])]
    n_step = sum(math.prod(s) for s in step_shapes)
    for ema in (False, True):
        ours = [[t.clone() for t in x[:6]] for x in inputs]
        e_ours = [x[6].clone() for x in inputs] if ema else None
        fused_adamw8bit_leaves(ours, scalars, emas=e_ours, **ADAMW_KW)
        worst, err = (0.0, 0.0, 0, 0.0), 0.0
        for i, x in enumerate(inputs):  # the plain version a leaf, from the same inputs
            ref = [t.clone() for t in x[:6]]
            e_ref = x[6].clone() if ema else None
            fused_adamw8bit_leaf_reference(*ref, scalars, ema=e_ref, **ADAMW_KW)
            errs = adamw_errors(ours[i], ref, e_ours[i] if ema else None, e_ref)
            require(adamw_ok(errs), f"fused AdamW in one launch, leaf {i} "
                    f"{tuple(ours[i][0].shape)} ema={ema}: param err {errs[0]}, shadow err "
                    f"{errs[1]}, codes off by {errs[2]}, scale rel err {errs[3]}")
            worst = tuple(max(a, b) for a, b in zip(worst, errs))
            err = max(err, errs[0], errs[1])
            del ref, e_ref
        del ours, e_ours
        torch.cuda.empty_cache()
        k = len(step_shapes)
        statics = [(x[0], *x[2:6]) for x in inputs[:k]]
        grads = [x[1] for x in inputs[:k]]
        table = FusedLeaves(statics, [x[6] for x in inputs[:k]] if ema else None)
        ms, eager = time_ms(lambda: table(grads, scalars, **ADAMW_KW))
        host = []
        for _ in range(7):  # the host's time to enqueue the step's update, eager
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table(grads, scalars, **ADAMW_KW)
            host.append(time.perf_counter() - t0)
        loop = []
        for _ in range(3):  # the same leaves as 293 one-leaf calls, one launch a leaf
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for st, gr, x in zip(statics, grads, inputs):
                fused_adamw8bit_leaf(st[0], gr, *st[1:], scalars, ema=x[6] if ema else None,
                                     **ADAMW_KW)
            loop.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        bound, term = adamw_bound(n_step, ema)
        nbytes = n_step * (24.0 if ema else 16.0) + 16.0 * ((n_step + 255) // 256)
        rows[ema].insert(0, dict(shape=f"{k} leaves", per_batch=1, err=err, ms=ms,
                                 plain_ms=plain_step[ema], library_ms=None, bound_ms=bound,
                                 bound_by=term))
        print(f"fused adamw ema={ema}, the step's {k} leaves ({n_step} elements) in "
              f"{table.launches} launch(es): kernel {ms:.4f} ms (eager {eager:.4f}) = "
              f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, bound {bound:.4f} ms ({term}: "
              f"{nbytes:.4g} bytes over 3.35e12/s; {bound / ms:.1%} of it), plain version "
              f"{plain_step[ema]:.4f} ms (the one-leaf rows' sum); parity at all {k + 1} leaves "
              f"(the ragged one too): param err {worst[0]:.3g} shadow err {worst[1]:.3g} "
              f"codes off by <= {worst[2]} scale rel err {worst[3]:.3g}", flush=True)
        print(f"fused adamw ema={ema}: host time to enqueue the step's update, eager: one "
              f"FusedLeaves call {1e6 * sorted(host)[3]:.1f} us (median of 7), {k} one-leaf "
              f"calls {1e6 * sorted(loop)[1]:.1f} us (median of 3)", flush=True)
        del table
    del inputs
    torch.cuda.empty_cache()
    return rows[False], rows[True]


def write_tiles(data_dir: str) -> None:
    """TRAIN_TILES fabricated 112x112 RGB PNG tiles and their prompt JSON."""
    import numpy as np

    from agenda_tpu_torch.utils.png import write_png

    os.makedirs(data_dir)
    rng = np.random.RandomState(0)
    ramp = np.add.outer(np.arange(TILE), np.arange(TILE)).astype(np.float32)
    prompts = {}
    for i in range(TRAIN_TILES):
        img = np.stack([ramp * (1 + i % 3), ramp.T * 1.5, ramp * 0 + 40 * i], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        write_png(os.path.join(data_dir, f"tile_{i}.png"), img)
        prompts[f"tile_{i}.png"] = "An aerial view image with cars in Utah"
    with open(os.path.join(data_dir, "train.json"), "w") as f:
        json.dump(prompts, f)


def train_e2e(model_dir: str, tmp: str, unet_cfg, vae_cfg):
    """Phase 11: cli/finetune_sd.main at full width; returns the launch counts."""
    import torch

    from agenda_tpu_torch.cli import finetune_sd
    from agenda_tpu_torch.io.diffusers_io import load_pipeline

    data_dir, out_dir = os.path.join(tmp, "tiles"), os.path.join(tmp, "finetuned")
    write_tiles(data_dir)
    expected = train_expected(unet_cfg, vae_cfg)
    cache_batches = math.ceil(TRAIN_TILES / TRAIN_BATCH)
    want = {"flash_attention_fwd": expected["flash_per_step"] * TRAIN_STEPS + cache_batches,
            "flash_attention_fwd_wide": cache_batches,  # the VAE encoder's mid-block attention
            "flash_attention_bwd_dkv": expected["flash_per_step"] * TRAIN_STEPS,
            "flash_attention_bwd_dq": expected["flash_per_step"] * TRAIN_STEPS,
            "fused_adamw8bit": 0,
            "fused_adamw8bit_ema": expected["adamw_per_step"] * TRAIN_STEPS,
            "fused_adamw8bit_leaves": 0,
            "fused_adamw8bit_leaves_ema": expected["quantized"] * TRAIN_STEPS,
            "group_norm_act": (expected["gn_per_step"] * TRAIN_STEPS
                               + expected["gn_per_cache_batch"] * cache_batches)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = finetune_sd.main(["--pretrained_model_name_or_path", model_dir,
                              "--dataset_folder", data_dir, "--json_file_name", "train.json",
                              "--output_dir", out_dir, *TRAIN_ARGS])
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[train e2e] cli/finetune_sd: {stats['steps']} steps in {stats['seconds']:.3f} s "
          f"({stats['seconds'] / stats['steps']:.4f} s/step with the cold first step, the logging "
          f"syncs of steps 1-3 and the checkpoint snapshot of step 3); peak memory "
          f"{peak / 2**30:.2f} GiB; losses {stats['losses']}; grad norms "
          f"{stats['grad_norms']}", flush=True)
    print(f"[train e2e] launches {launches} (expected {want})", flush=True)
    require(launches == want, "training launch counts differ from the config's count")
    require(len(stats["losses"]) == TRAIN_STEPS
            and all(math.isfinite(x) for x in stats["losses"]), "non-finite training loss")
    ckpt = os.path.join(out_dir, "checkpoint-3")
    for sub in ("unet", "unet_ema", "train_state"):
        require(os.path.isdir(os.path.join(ckpt, sub)), f"checkpoint-3/{sub} was not written")
    fabricated = load_pipeline(model_dir)
    exported = load_pipeline(out_dir)
    changed = sum(not torch.equal(exported.unet_state[k], v)
                  for k, v in fabricated.unet_state.items())
    require(changed > 0, "the exported UNet equals the fabricated one: nothing was trained")
    require(set(exported.vae_state) == set(fabricated.vae_state), "the export lacks the VAE")
    print(f"[train e2e] checkpoint-3/ (unet, unet_ema, train_state) and the export written; "
          f"the export loads back through load_pipeline; {changed} of "
          f"{len(fabricated.unet_state)} UNet tensors changed", flush=True)
    return launches


# -- the group norm's tail, the token fine-tune and accumulation --------------------


def gn_tail_rows():
    """Phase 12: the group norm at H*W % 8 != 0 against its plain version, at the
    UNet's 6x6 and 10x10 levels (off the main path: they count 0 times a
    batch)."""
    return [gn_row(shape, 32, 1e-5, act, 0, tag="[GN tail] groupnorm")
            for shape in GN_TAIL_SHAPES for act in (None, "silu")]


def tail_resolution_e2e(model_dir: str, embeds: str, tmp: str, expected: dict) -> None:
    """Phase 12, second half: generation at 384x384, whose UNet's lowest
    level is 6x6 (H*W = 36), through the CLI."""
    import torch

    from agenda_tpu_torch.cli import data_generation
    from agenda_tpu_torch.kernels.flash import flash_attention_fwd
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    save_dir = os.path.join(tmp, "out_384")
    flash_attention_fwd.launches = 0
    group_norm_act.launches = 0
    stats = data_generation.main(["--pretrained-model-path", model_dir,
                                  "--learnable-tokens-embedding-path", embeds,
                                  "--save-dir", save_dir, *TAIL_RES_ARGS])
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "group_norm_act": group_norm_act.launches}
    want = {k: v * stats["batches"] for k, v in expected.items()}
    print(f"[GN tail] cli/data_generation at 384x384: {stats['images']} images in "
          f"{stats['seconds']:.3f} s; launches {launches} (expected {want})", flush=True)
    require(launches == want, "384x384 launch counts differ from the config's count")
    check_outputs(save_dir, n_images=2)
    print("[GN tail] 2 images 112x112x3 uint8 and 3x2 heatmaps 112x112 uint8 written at 384",
          flush=True)


def build_token_trainer(model_dir: str, dev):
    """The full-width models as cli/finetune_sd_token builds them, with three
    new tokens in the tokenizer and the token table."""
    import dataclasses

    import torch

    from agenda_tpu_torch.cli.finetune_sd_token import TOKEN_TABLE, extend_token_table
    from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
    from agenda_tpu_torch.generate.pipeline import _build
    from agenda_tpu_torch.io.diffusers_io import load_pipeline
    from agenda_tpu_torch.models.clip_text import CLIPTextModel
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.models.vae import AutoencoderKL

    bundle = load_pipeline(model_dir)
    tokenizer = CLIPTokenizer.from_pretrained(bundle.tokenizer_dir)
    new_tokens = [f"new_token_v{i}" for i in range(len(TOKEN_WORDS))]
    tokenizer.add_tokens(new_tokens)
    table = extend_token_table(bundle.text_state[TOKEN_TABLE].numpy(),
                               tokenizer.convert_tokens_to_ids(new_tokens), 0)
    text_cfg = dataclasses.replace(bundle.text_config, vocab_size=table.shape[0])
    with torch.device("meta"):
        unet = UNet2DConditionModel(bundle.unet_config)
    unet.load_state_dict({k: v.to(dev, torch.float32) for k, v in bundle.unet_state.items()},
                         strict=True, assign=True)
    vae = _build(AutoencoderKL, bundle.vae_config, bundle.vae_state, dev, torch.bfloat16)
    text = _build(CLIPTextModel, text_cfg, {**bundle.text_state,
                                            TOKEN_TABLE: torch.from_numpy(table)},
                  dev, torch.bfloat16)
    for m in (vae, text):
        m.requires_grad_(False)
    return unet.train(), vae, text, tokenizer, new_tokens, text_cfg.hidden_size


def token_batch(tokenizer, new_tokens, vae_cfg, dev):
    """The recipe's prompts with the new tokens spliced in (as TokenDataset
    does), and cached latent moments."""
    import numpy as np
    import torch

    from agenda_tpu_torch.data.tokens import insert_new_tokens

    ids, starts = [], []
    for i in range(TRAIN_BATCH):
        prompt, st = insert_new_tokens(tokenizer, TOKEN_PROMPTS[i % 2], TOKEN_WORDS, new_tokens)
        ids.append(tokenizer(prompt))
        starts.append((st + [-1] * len(TOKEN_WORDS))[:len(TOKEN_WORDS)])
    batch = synthetic_batch(vae_cfg, 2, dev, 5)
    batch["input_ids"] = torch.from_numpy(np.stack(ids).astype(np.int64)).to(dev)
    batch["new_tokens_start"] = torch.tensor(starts, dtype=torch.int32, device=dev)
    require(bool((batch["new_tokens_start"][:, 0] > 0).all()),
            f"the tokenizer did not find the object word in every prompt: {starts}")
    return batch


def token_api_phase(model_dir, unet_cfg, vae_cfg, dev):
    """Phase 13: the token step through the trainer API at full width."""
    import torch

    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.train.finetune_sd_token import (
        TokenLossConfig,
        init_token_train_state,
        make_token_train_step,
    )
    from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer

    expected = train_expected(unet_cfg, vae_cfg)
    unet, vae, text, tokenizer, new_tokens, hidden = build_token_trainer(model_dir, dev)
    batch = token_batch(tokenizer, new_tokens, vae_cfg, dev)

    before_update = []  # (allocated, peak) bytes when the step reaches the optimizer

    def make(train_unet: bool):
        tx = make_optimizer(lr_schedule("constant", TOKEN_LR, 0, 100), max_grad_norm=None)

        def apply(*args, **kw):
            before_update.append((torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()))
            return update(*args, **kw)

        update = tx.apply
        tx = tx._replace(apply=apply)
        cfg = TokenLossConfig(snr_gamma=5.0, with_cross_attn_reg=True, reg_weight=0.5,
                              n_object_embedding=1, train_token=True, max_grad_norm=1.0)
        state = init_token_train_state(unet, tx, True, train_unet, False, len(new_tokens),
                                       hidden, generator=torch_generator(dev, 0))
        return state, make_token_train_step(unet, vae, text, make_schedule(), tx, cfg)

    state, step = make(True)
    emb0 = state.embedding.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, m = step(state, batch, generator=torch_generator(dev, 0))
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in counts}
    want.update({"flash_attention_fwd": expected["flash_per_step"],
                 "flash_attention_bwd_dkv": expected["flash_per_step"],
                 "flash_attention_bwd_dq": expected["flash_per_step"],
                 "group_norm_act": expected["gn_per_step"]})
    metrics = {k: float(v) for k, v in m.items()}
    moved = float((state.embedding.detach() - emb0).abs().max())
    print(f"[token API] one step at batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}, tokens + UNet + "
          f"reg, f32 AdamW: metrics {metrics}; embedding moved by up to {moved:.3g}; launches "
          f"{counts} (expected {want})", flush=True)
    require(counts == want, "token-step launches differ from the config's")
    require(math.isfinite(metrics["loss"]) and metrics["attn_loss"] > 0
            and math.isfinite(metrics["attn_loss"]), f"token step metrics {metrics}")
    require(moved > 0, "the learned embedding did not move")
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        _, m = step(state, batch, generator=torch_generator(dev, i + 1))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"non-finite token loss {losses}")
    allocated, peak_grads = before_update[0]  # the first step, before its optimizer ran
    print(f"[token API] warm {warm_s:.4f} s/step = {TRAIN_BATCH / warm_s:.3f} images/s (3 "
          f"synchronised steps); peak memory {peak / 2**30:.2f} GiB over 4 steps, where the "
          f"first step's forward and backward peak at {peak_grads / 2**30:.2f} GiB and "
          f"{allocated / 2**30:.2f} GiB stay allocated when its f32 AdamW starts; losses "
          f"{losses}", flush=True)
    profile_run(lambda: (step(state, batch, generator=torch_generator(dev, 9)),
                         torch.cuda.synchronize()),
                "token profile", f"one token step at batch {TRAIN_BATCH}, "
                f"{TRAIN_RES}x{TRAIN_RES}", warm_s)

    # tokens only: the UNet is frozen, so the first attn1 (before any attn2
    # depends on the tokens) needs no flash backward
    del state, step
    torch.cuda.empty_cache()
    state, step = make(False)
    reset_counts()
    step(state, batch, generator=torch_generator(dev, 20))
    torch.cuda.synchronize()
    only = read_counts()
    print(f"[token API] a token-only step (frozen UNet): launches {only}", flush=True)
    require(only["flash_attention_fwd"] == expected["flash_per_step"]
            and only["flash_attention_bwd_dkv"] == expected["flash_per_step"] - 1
            and only["flash_attention_bwd_dq"] == expected["flash_per_step"] - 1,
            "the token-only step's flash backward launches are not one short of the forward's")
    del unet, vae, text, state, step, batch
    torch.cuda.empty_cache()
    return {"warm_s": warm_s, "peak": peak, "launches": counts, "token_only": only}


def token_cli_phases(model_dir: str, tmp: str, unet_cfg, vae_cfg, unet_calls: int):
    """Phases 14-15: the token CLI's stage 1 and stage 2 at full width."""

    import numpy as np
    import torch

    from agenda_tpu_torch.cli import finetune_sd_token
    from agenda_tpu_torch.cli.finetune_sd_token import TOKEN_TABLE
    from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
    from agenda_tpu_torch.io.diffusers_io import load_pipeline
    from agenda_tpu_torch.io.learned_embeds import load_learned_embeddings

    data_dir = os.path.join(tmp, "tiles")
    if not os.path.isdir(data_dir):
        write_tiles(data_dir)
    expected = train_expected(unet_cfg, vae_cfg)
    cache_batches = math.ceil(TRAIN_TILES / TRAIN_BATCH)
    validation = expected_launches(unet_cfg, vae_cfg, unet_calls)  # one 20-step batch

    def want(steps: int, micro: int, validations: int, int8: bool) -> dict:
        out = {k: 0 for k in train_counters()}
        out.update({
            "flash_attention_fwd": (expected["flash_per_step"] * micro + cache_batches
                                    + validation["flash_attention_fwd"] * validations),
            # the VAE's mid-block attention: its encoder a cache batch, its decoder a validation
            "flash_attention_fwd_wide": cache_batches + validations,
            "flash_attention_bwd_dkv": expected["flash_per_step"] * micro,
            "flash_attention_bwd_dq": expected["flash_per_step"] * micro,
            "group_norm_act": (expected["gn_per_step"] * micro
                               + expected["gn_per_cache_batch"] * cache_batches
                               + validation["group_norm_act"] * validations)})
        if int8:  # K4 once an update, over every quantized UNet leaf
            out["fused_adamw8bit"] = expected["adamw_per_step"] * steps
            out["fused_adamw8bit_leaves"] = expected["quantized"] * steps
        return out

    def run(tag, argv, steps, validations, accum=1, int8=False):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stats = finetune_sd_token.main(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        micro = steps * accum
        expect = want(steps, micro, validations, int8)
        print(f"[{tag}] cli/finetune_sd_token: {stats['steps']} steps ({stats['micro_batches']} "
              f"micro-batches) in {stats['seconds']:.3f} s (cold first step, checkpoints, "
              f"validation included); peak memory {peak / 2**30:.2f} GiB; losses "
              f"{stats['losses']}; attn losses {stats['attn_losses']}; launches {launches} "
              f"(expected {expect})", flush=True)
        require(stats["steps"] == stats["global_step"] == steps
                and stats["micro_batches"] == len(stats["losses"]) == micro
                and all(math.isfinite(x) for x in stats["losses"]),
                f"{tag}: {stats['steps']} steps, {stats['micro_batches']} micro-batches, "
                f"losses {stats['losses']}")
        require(all(a > 0 and math.isfinite(a) for a in stats["attn_losses"]),
                f"{tag}: attn losses {stats['attn_losses']}")
        require(launches == expect, f"{tag}: launch counts differ")
        return stats

    one = os.path.join(tmp, "token_stage1")
    run("token CLI 1", ["--pretrained_model_name_or_path", model_dir, "--dataset_folder",
                        data_dir, "--json_file_name", "train.json", "--output_dir", one,
                        *TOKEN_ARGS, "--train_token", "--max_train_steps", str(STAGE1_STEPS),
                        "--checkpointing_steps", "2",
                        "--validation_prompts", "An aerial view image with {} cars in {} Utah",
                        "--num_validation_images", "1",
                        "--validation_steps", str(STAGE1_STEPS)], STAGE1_STEPS, 1)
    ckpt = os.path.join(one, "checkpoint-2")
    for sub in ("unet", "train_state", "learned_embeds_steps_2.bin"):
        require(os.path.exists(os.path.join(ckpt, sub)), f"checkpoint-2/{sub} was not written")
    bin_path = os.path.join(one, f"learned_embeds_steps_{STAGE1_STEPS}.bin")
    learned = load_learned_embeddings(bin_path)
    export = os.path.join(one, f"full_model_step_{STAGE1_STEPS}")
    exported = load_pipeline(export)
    ids = CLIPTokenizer.from_pretrained(exported.tokenizer_dir).convert_tokens_to_ids(
        list(learned))
    table = exported.text_state[TOKEN_TABLE].numpy()
    require(all(np.array_equal(table[i], learned[t]) for t, i in zip(learned, ids)),
            "the export's token table does not hold the learned rows")
    require(len(os.listdir(os.path.join(one, "logs", "images"))) == 1,
            "the validation image was not logged")
    print(f"[token CLI 1] checkpoint-2/ (unet, train_state, learned_embeds_steps_2.bin), "
          f"{os.path.basename(bin_path)} ({list(learned)}) and {os.path.basename(export)}/ "
          f"written and loaded back; the export's table holds the learned rows at ids {ids}; "
          "one validation image", flush=True)
    for d in os.listdir(one):  # free the disk: stage 2 needs the export and the .bin
        if d.startswith("checkpoint-"):
            shutil.rmtree(os.path.join(one, d))

    two = os.path.join(tmp, "token_stage2")
    stats2 = run("token CLI 2", ["--pretrained_model_name_or_path", export, "--dataset_folder",
                                 data_dir, "--json_file_name", "train.json", "--output_dir",
                                 two, *TOKEN_ARGS, "--embedding_path", bin_path,
                                 "--max_train_steps", str(STAGE2_STEPS),
                                 "--checkpointing_steps", "100", "--use_8bit_adam",
                                 "--gradient_accumulation_steps", str(ACCUM)],
                 STAGE2_STEPS, 0, accum=ACCUM, int8=True)
    table2 = load_pipeline(os.path.join(two, f"full_model_step_{STAGE2_STEPS}")).text_state[
        TOKEN_TABLE].numpy()
    require(stats2["object_tokens"] == list(learned)
            and all(np.array_equal(table2[i], learned[t]) for t, i in zip(learned, ids)),
            "stage 2 did not train with the exported rows")
    print(f"[token CLI 2] the loaded embeddings ({stats2['object_tokens']}) are the rows of "
          "the exported table, and stay so in stage 2's export; under --use_8bit_adam and "
          f"--gradient_accumulation_steps {ACCUM}, K4 launched once an update", flush=True)
    shutil.rmtree(one)
    shutil.rmtree(two)


def accumulation_e2e(model_dir: str, tmp: str, unet_cfg, vae_cfg):
    """Phase 16: the SD CLI with gradient accumulation: K5 launches once an update."""
    import torch

    from agenda_tpu_torch.cli import finetune_sd

    data_dir = os.path.join(tmp, "tiles")
    if not os.path.isdir(data_dir):
        write_tiles(data_dir)
    expected = train_expected(unet_cfg, vae_cfg)
    out_dir = os.path.join(tmp, "accumulated")
    args = [a for a in TRAIN_ARGS]
    args[args.index("--max_train_steps") + 1] = str(ACCUM_UPDATES)
    args[args.index("--checkpointing_steps") + 1] = "100"
    reset_counts()
    stats = finetune_sd.main(["--pretrained_model_name_or_path", model_dir, "--dataset_folder",
                              data_dir, "--json_file_name", "train.json", "--output_dir",
                              out_dir, "--gradient_accumulation_steps", str(ACCUM), *args])
    torch.cuda.synchronize()
    launches = read_counts()
    micro = ACCUM * ACCUM_UPDATES
    print(f"[accumulation] cli/finetune_sd --gradient_accumulation_steps {ACCUM}: "
          f"{stats['micro_batches']} micro-batches, global step {stats['global_step']}, EMA "
          f"step {stats['ema_step']}, {stats['seconds']:.3f} s; losses {stats['losses']}; "
          f"launches {launches}", flush=True)
    require(stats["micro_batches"] == micro and stats["global_step"] == ACCUM_UPDATES
            and stats["ema_step"] == ACCUM_UPDATES,
            "accumulation: micro-batches, global step or EMA step off")
    require(launches["fused_adamw8bit_ema"] == expected["adamw_per_step"] * ACCUM_UPDATES
            and launches["fused_adamw8bit_leaves_ema"] == expected["quantized"] * ACCUM_UPDATES
            and launches["fused_adamw8bit"] == 0
            and launches["flash_attention_bwd_dkv"] == expected["flash_per_step"] * micro,
            f"accumulation: K5 must launch once an update ({ACCUM_UPDATES}), the backward "
            "once a micro-batch")
    require(all(math.isfinite(x) for x in stats["losses"]), "non-finite accumulated loss")
    shutil.rmtree(out_dir)
    return launches


def fabricate_heatmaps(save_dir: str, n: int, seed: int):
    """n object / fg / bg word-heatmap triples, 112x112 uint8 PNGs as
    cli/data_generation writes them, with a blob on each of 1-3 fabricated
    42.36-px vehicles -> the vehicles' xywh boxes per image."""
    import numpy as np

    from agenda_tpu_torch.detect.fabricate import BOX
    from agenda_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:TILE, 0:TILE].astype(np.float32)
    dirs = {w: os.path.join(save_dir, f"daam_{w}_heatmaps") for w in LABEL_WORDS}
    for d in dirs.values():
        os.makedirs(d)
    boxes = []
    for i in range(n):
        xy = rng.uniform(0, TILE - BOX, (int(rng.integers(1, 4)), 2))
        boxes.append([[float(x), float(y), BOX, BOX] for x, y in xy])
        c = xy + BOX / 2
        blob = np.exp(-((xx[..., None] - c[:, 0]) ** 2 + (yy[..., None] - c[:, 1]) ** 2)
                      / (2 * (BOX / 4) ** 2)).max(-1)
        obj = blob + rng.uniform(0, 0.2, blob.shape)
        fg = 0.8 * blob + rng.uniform(0, 0.3, blob.shape)
        bg = 1.0 - blob + rng.uniform(0, 0.2, blob.shape)
        for word, m in zip(LABEL_WORDS, (obj, fg, bg)):
            m = (m - m.min()) / (m.max() - m.min())  # min-max, as the generator's maps
            write_png(os.path.join(dirs[word], f"{i}.png"), (m * 255).round().astype(np.uint8))
    return boxes


def labels_fabricate(root: str) -> dict:
    """Phase 17: heatmap stacks through cli/postprocess_heatmap (a GT set and
    an unlabelled set), the GT set's COCO, the other's through
    cli/build_empty_annotation, and seeded YOLOv8n and YOLOv8s checkpoints in
    the JAX runner's layout."""
    import numpy as np

    from agenda_tpu_torch.cli import build_empty_annotation, postprocess_heatmap
    from agenda_tpu_torch.detect.fabricate import coco_dict, fabricate_detector
    from agenda_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    sets = {}
    for seed, name in enumerate(("gt", "empty")):
        save_dir = os.path.join(root, name)
        boxes = fabricate_heatmaps(save_dir, LABEL_TILES // 2, seed)
        postprocess_heatmap.main([
            "--save-dir", save_dir, "--object-heatmap-path", f"daam_{LABEL_WORDS[0]}_heatmaps",
            "--fg-heatmap-path", f"daam_{LABEL_WORDS[1]}_heatmaps",
            "--bg-heatmap-path", f"daam_{LABEL_WORDS[2]}_heatmaps",
            "--stack-heatmap-save-path", "daam_stack_heatmaps",
            "--inv-heatmap-save-path", f"daam_{LABEL_WORDS[2]}_inv_heatmaps"])
        stacks = sorted(os.listdir(os.path.join(save_dir, "daam_stack_heatmaps")))
        require(len(stacks) == LABEL_TILES // 2, f"{name}: {len(stacks)} heatmap stacks")
        sets[name] = (save_dir, boxes)
    gt_dir, gt_boxes = sets["gt"]
    names = [f"{i}.png" for i in range(LABEL_TILES // 2)]
    with open(os.path.join(gt_dir, "ann.json"), "w") as f:
        json.dump(coco_dict(names, gt_boxes, TILE), f)
    empty_dir = sets["empty"][0]
    build_empty_annotation.main([
        "--image-dir", os.path.join(empty_dir, "daam_stack_heatmaps"),
        "--save-dir", os.path.join(empty_dir, "annotations_coco_Empty.json"),
        "--coco-dir", os.path.join(gt_dir, "ann.json")])
    with open(os.path.join(empty_dir, "annotations_coco_Empty.json")) as f:
        empty = json.load(f)
    require(len(empty["images"]) == LABEL_TILES // 2 and not empty["annotations"],
            "the empty annotation is not 256 images without annotations")
    # a stack is (object, fg, 255 - bg)
    stack = read_png(os.path.join(gt_dir, "daam_stack_heatmaps", "7.png"))
    parts = [read_png(os.path.join(gt_dir, f"daam_{w}_heatmaps", "7.png")) for w in LABEL_WORDS]
    require(stack.shape == (TILE, TILE, 3) and (stack[..., 0] == parts[0]).all()
            and (stack[..., 1] == parts[1]).all() and (stack[..., 2] == 255 - parts[2]).all(),
            "a heatmap stack is not (object, fg, 255 - bg)")
    # every stack with its boxes: phase 18's runner check and phase 20's timing
    all_names = [os.path.join(s, "daam_stack_heatmaps", f"{i}.png") for s in ("gt", "empty")
                 for i in range(LABEL_TILES // 2)]
    with open(os.path.join(root, "all.json"), "w") as f:
        json.dump(coco_dict(all_names, gt_boxes + sets["empty"][1], TILE), f)
    ckpts = {}
    for seed, detector in enumerate(LABEL_DETECTORS):
        ckpts[detector] = fabricate_detector(os.path.join(root, f"work_{detector}"), detector,
                                             seed, LABEL_IMG, LABEL_BATCH)
    n_boxes = sum(len(b) for b in gt_boxes)
    print(f"[labels] {LABEL_TILES} heatmap stacks {TILE}x{TILE} (GT set {LABEL_TILES // 2} tiles, "
          f"{n_boxes} boxes; empty set {LABEL_TILES // 2}), checkpoints {sorted(ckpts)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"gt": gt_dir, "empty": empty_dir, "all": "all.json", "ckpts": ckpts}


def match_detections(boxes, scores, ref_boxes, ref_scores) -> int:
    """How many of the (K, 4), (K,) detections have no partner among the
    reference's at IoU >= DET_IOU and |d score| <= DET_SCORE_TOL (one to one)."""
    from agenda_tpu_torch.detect.ops import box_iou

    ok = (box_iou(boxes, ref_boxes) >= DET_IOU) & (
        (scores[:, None] - ref_scores[None, :]).abs() <= DET_SCORE_TOL)
    free = [True] * len(ref_scores)
    unmatched = 0
    for row in ok.tolist():
        j = next((j for j, hit in enumerate(row) if hit and free[j]), None)
        if j is None:
            unmatched += 1
        else:
            free[j] = False
    return unmatched


def unmatched_both(boxes, scores, ref_boxes, ref_scores) -> Tuple[int, int]:
    """(detections without a partner, the reference's without a partner)."""
    return (match_detections(boxes, scores, ref_boxes, ref_scores),
            match_detections(ref_boxes, ref_scores, boxes, scores))


def head_error(heads, ref_heads) -> float:
    """The largest max |d| / rms(ref) over the per-level (cls, box) outputs."""
    err = 0.0
    for pair, ref_pair in zip(heads, ref_heads):
        for out, ref in zip(pair, ref_pair):
            rms = float(ref.square().mean().sqrt())
            err = max(err, float((out.cpu() - ref).abs().max()) / rms)
    return err


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuDNN's convolutions and cuBLAS's matmuls: the control. Its
    cuDNN algorithms are the deterministic ones, not autotuned: the TF32
    rounding an autotuned algorithm adds differs from run to run, and with it
    a count such as phase 21's TAL anchors that flip, which then ranged from
    the limit to well above it."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=True):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def detector_parity(labels: dict, dev) -> None:
    """Phase 18: one batch of 192 heatmap stacks through each detector on the
    card and on the CPU (f32, TF32 off on the card), from the same weights:
    the eval resize, the per-level head outputs and the kept detections; the
    heads once more with TF32 on, as the control of their limit."""
    import numpy as np
    import torch

    from agenda_tpu_torch.data.device_resize import resize_levels, resize_weights
    from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig
    from agenda_tpu_torch.detect.runner import DetectorRunner, full_f32, load_variables

    for detector, (config, ckpt) in labels["ckpts"].items():
        cfg = DetectionConfig.from_json(config)
        ds = cfg.build_eval_dataset(DatasetSpec(labels["gt"], "ann.json", "daam_stack_heatmaps/"))
        u8 = torch.from_numpy(np.stack([ds.item_u8(j)["image_u8"] for j in range(LABEL_BATCH)]))
        wy = torch.from_numpy(resize_weights(TILE, LABEL_IMG, "bilinear"))
        family = cfg.build_family()
        state = load_variables(ckpt)
        on_card = DetectorRunner(family, cfg.runner, device=dev).variables_on_device(state)
        with full_f32(dev):
            levels = resize_levels(u8.to(dev), wy.to(dev), wy.to(dev)).cpu()
            ref_levels = resize_levels(u8, wy, wy)
            x = ref_levels / 255.0
            heads = family.forward(on_card, x.to(dev))
            boxes, scores, valid = (t.cpu() for t in family.predict_fn(on_card, x.to(dev)))
        with tf32_on():
            control = family.forward(on_card, x.to(dev))
        ref_heads = family.forward(state, x)
        ref_boxes, ref_scores, ref_valid = family.predict_fn(state, x)
        resize_err = float((levels - ref_levels).abs().max())
        head_err, control_err = head_error(heads, ref_heads), head_error(control, ref_heads)
        kept, ref_kept = int(valid.sum()), int(ref_valid.sum())
        unmatched = ref_unmatched = 0
        for i in range(LABEL_BATCH):
            u, ru = unmatched_both(boxes[i][valid[i]], scores[i][valid[i]],
                                   ref_boxes[i][ref_valid[i]], ref_scores[i][ref_valid[i]])
            unmatched, ref_unmatched = unmatched + u, ref_unmatched + ru
        share = max(unmatched / max(kept, 1), ref_unmatched / max(ref_kept, 1))
        print(f"[parity] {detector} batch {LABEL_BATCH} at {LABEL_IMG}px, card vs CPU (f32): "
              f"resize max |d| {resize_err:.0f} levels (limit {RESIZE_TOL}); heads max |d| "
              f"{head_err:.3e} rms(ref) (limit {HEAD_TOL_RMS}; TF32 control {control_err:.3e}); "
              f"kept {kept} on the card, {ref_kept} on the CPU, {unmatched} and {ref_unmatched} "
              f"without a partner at IoU >= {DET_IOU} and |d score| <= {DET_SCORE_TOL} "
              f"({100 * share:.2f}%, limit {100 * DET_UNMATCHED_MAX:.0f}%)", flush=True)
        require(resize_err <= RESIZE_TOL, f"{detector}: the eval resize differs on the card")
        require(head_err <= HEAD_TOL_RMS,
                f"{detector}: head outputs differ on the card beyond the limit")
        require(control_err > HEAD_TOL_RMS,
                f"{detector}: the TF32 control passes the head limit: the limit cannot tell "
                "TF32 from full f32")
        require(kept > LABEL_BATCH and share <= DET_UNMATCHED_MAX,
                f"{detector}: {unmatched} of {kept} kept detections unmatched, "
                f"{ref_unmatched} of the CPU's {ref_kept}")


def runner_parity(labels: dict, root: str, dev) -> None:
    """Phase 18 (cont.): DetectorRunner.test, the path det_test runs, with
    YOLOv8n over all 512 stacks and their boxes at batch 192 (three batches,
    the last padded, so the first pinned staging buffers are reused) on the
    card and on the CPU: equal image paths and GT fields, and the
    predictions matched record by record."""
    import numpy as np
    import torch

    from agenda_tpu_torch.detect.configs import DetectionConfig
    from agenda_tpu_torch.detect.dataset import CocoDetDataset
    from agenda_tpu_torch.detect.runner import DetectorRunner, load_variables

    config, ckpt = labels["ckpts"]["yolov8"]
    cfg = DetectionConfig.from_json(config)
    state = load_variables(ckpt)
    ds = CocoDetDataset(root, labels["all"], "", cfg.img_scale, cfg.max_gt)
    card, ref = (DetectorRunner(cfg.build_family(), cfg.runner, device=d).test(state, ds)
                 for d in (dev, torch.device("cpu")))
    require(len(card) == len(ref) == LABEL_TILES, f"records {len(card)} and {len(ref)}")
    kept = ref_kept = unmatched = ref_unmatched = n_gt = 0
    for a, r in zip(card, ref):
        require(a["img_path"] == r["img_path"], f"{a['img_path']} != {r['img_path']}")
        ga, gr = a["gt_instances"], r["gt_instances"]
        require(np.array_equal(ga["bboxes"], gr["bboxes"])
                and np.array_equal(ga["labels"], gr["labels"]),
                f"{a['img_path']}: the GT fields differ")
        n_gt += len(gr["labels"])
        pa, pr = a["pred_instances"], r["pred_instances"]
        require(len(pa["labels"]) == len(pa["scores"]) == len(pa["bboxes"]),
                f"{a['img_path']}: prediction fields of unequal length")
        u, ru = unmatched_both(*(torch.from_numpy(p[k]) for p in (pa, pr)
                                 for k in ("bboxes", "scores")))
        kept, ref_kept = kept + len(pa["scores"]), ref_kept + len(pr["scores"])
        unmatched, ref_unmatched = unmatched + u, ref_unmatched + ru
    share = max(unmatched / max(kept, 1), ref_unmatched / max(ref_kept, 1))
    n_batches = -(-LABEL_TILES // LABEL_BATCH)
    print(f"[parity] DetectorRunner.test, yolov8, {LABEL_TILES} stacks at batch {LABEL_BATCH} "
          f"({n_batches} batches, the last padded), card vs CPU: image paths and GT fields equal "
          f"({n_gt} boxes); kept {kept} on the card, {ref_kept} on the CPU, {unmatched} and "
          f"{ref_unmatched} without a partner ({100 * share:.2f}%, limit "
          f"{100 * DET_UNMATCHED_MAX:.0f}%)", flush=True)
    require(n_gt > 0 and kept > LABEL_TILES and share <= DET_UNMATCHED_MAX,
            f"DetectorRunner.test: {unmatched} of {kept} detections unmatched, "
            f"{ref_unmatched} of the CPU's {ref_kept}")


def labelling_stages(labels: dict, root: str, dev) -> dict:
    """Phase 19: the labelling stages as cli/pipeline.py chains them, on the
    card with YOLOv8n: det_test on the GT set, select_threshold --table-out
    --result-out, det_test on the empty set, select_threshold
    --emit-pseudo-coco --thresh-conf <the selected threshold>."""
    from agenda_tpu_torch.annotate.records import load_predictions
    from agenda_tpu_torch.cli import det_test, select_threshold

    config, ckpt = labels["ckpts"]["yolov8"]
    pred_real, pred_syn = os.path.join(root, "pred_real.pkl"), os.path.join(root, "pred_syn.pkl")
    table, result = os.path.join(root, "thr_table.json"), os.path.join(root, "thr_result.json")
    common = ["--config", config, "--checkpoint", ckpt, "--test-prefix", "daam_stack_heatmaps/",
              "--device", dev.type]
    walls = {}
    t0 = time.perf_counter()
    det_test.main(common + ["--test-root", labels["gt"], "--test-ann", "ann.json",
                            "--out", pred_real])
    walls["det_test (GT set)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    select_threshold.main(["--prediction_pkl", pred_real, "--table-out", table,
                           "--result-out", result])
    walls["select_threshold"] = time.perf_counter() - t0
    with open(result) as f:
        chosen = json.load(f)
    with open(table) as f:
        tab = json.load(f)
    t0 = time.perf_counter()
    det_test.main(common + ["--test-root", labels["empty"], "--test-ann",
                            "annotations_coco_Empty.json", "--out", pred_syn])
    walls["det_test (empty set)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    select_threshold.main(["--prediction_pkl", pred_syn, "--emit-pseudo-coco",
                           "--out-dir", labels["empty"], "--detector-tag", "yolov8",
                           "--dataset-tag", "SynLINZ-STACKDAAMHeatMaps", "--image-size", str(TILE),
                           "--thresh-conf", str(chosen["threshold"])])
    walls["select_threshold --emit-pseudo-coco"] = time.perf_counter() - t0
    real, syn = load_predictions(pred_real), load_predictions(pred_syn)
    pseudo = [n for n in os.listdir(labels["empty"]) if n.startswith("annotations_coco_FakeBBoxes")]
    require(len(pseudo) == 1, f"pseudo COCO files: {pseudo}")
    with open(os.path.join(labels["empty"], pseudo[0])) as f:
        coco = json.load(f)
    half = LABEL_TILES // 2
    require(len(real) == half and len(syn) == half and len(coco["images"]) == half,
            f"records {len(real)}, {len(syn)}, pseudo COCO images {len(coco['images'])}")
    require(chosen["n_pred"] == len(tab["score"]) and 0.0 < chosen["threshold"] < 1.0,
            f"the threshold result does not fit its table: {chosen}")
    n_gt = sum(len(r["gt_instances"]["bboxes"]) for r in real)
    n_pred = sum(len(r["pred_instances"]["scores"]) for r in syn)
    print(f"[stages] det_test -> {len(real)} records ({n_gt} GT boxes, {chosen['n_pred']} "
          f"predictions); select_threshold: AP {chosen['ap']:.4f}, F1 {chosen['f1_max']:.4f} at "
          f"threshold {chosen['threshold']:.4f}; det_test on the empty set -> {len(syn)} records, "
          f"{n_pred} predictions; pseudo COCO {pseudo[0]}: {len(coco['images'])} images, "
          f"{len(coco['annotations'])} annotations; wall "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()), flush=True)
    return chosen


def labelling_timing(labels: dict, root: str, dev) -> dict:
    """Phase 20: warm images/s of DetectorRunner._predict_batches over all
    512 stacks at batch 192 (host clock, PNG decode included), the device
    busy share, the split into convolution, NMS and the rest, and the
    host's two shares: decoding a tile and enqueueing a batch's predict."""
    import torch

    from agenda_tpu_torch.detect.configs import DatasetSpec, DetectionConfig
    from agenda_tpu_torch.detect.dataset import CocoDetDataset
    from agenda_tpu_torch.detect.ops import nms_images
    from agenda_tpu_torch.detect.runner import DetectorRunner, full_f32, load_variables
    from agenda_tpu_torch.detect.yolov8 import _anchors, _flatten_outputs, decode_boxes

    out = {}
    for detector, (config, ckpt) in labels["ckpts"].items():
        cfg = DetectionConfig.from_json(config)
        ds = CocoDetDataset(root, labels["all"], "", cfg.img_scale, cfg.max_gt)
        runner = DetectorRunner(cfg.build_family(), cfg.runner, device=dev)
        state = load_variables(ckpt)
        walls = []
        for _ in range(3):  # cold (cuDNN autotune, allocation), then warm twice
            t0 = time.perf_counter()
            recs = runner._predict_batches(state, ds)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        require(len(recs) == LABEL_TILES, f"{detector}: {len(recs)} records")
        warm = min(walls[1:])
        n_batches = -(-LABEL_TILES // LABEL_BATCH)
        busy_ms, groups = profile_run(lambda: runner._predict_batches(state, ds), "label-profile",
                                      f"{detector}, {LABEL_TILES} stacks at batch {LABEL_BATCH}",
                                      warm)
        # NMS alone, on one batch of this detector's decoded boxes
        fam = runner.family
        params = runner.variables_on_device(state)
        x = torch.rand(LABEL_BATCH, LABEL_IMG, LABEL_IMG, 3, device=dev,
                       generator=torch_generator(dev, 0))
        with full_f32(dev):
            cls, dist = _flatten_outputs(fam.forward(params, x), fam.config)
            pts, strides = _anchors(fam.config, x.device)
            boxes = decode_boxes(dist, pts, strides, fam.config)
            scores = torch.sigmoid(cls)[..., 0]

            def nms():
                nms_images(boxes, scores, fam.iou_thr, fam.max_dets, fam.score_thr)

            nms()
            torch.cuda.synchronize()
            per_name, _ = device_times(lambda: (nms(), torch.cuda.synchronize()))
            # the host's two shares: enqueueing one batch's predict, decoding the tiles
            enqueue = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fam.predict_fn(params, x)
                enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(len(ds)):
            ds.item_u8(j, expect_size=(TILE, TILE))
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        nms_ms = sum(us for us, _ in per_name.values()) / 1e3
        nms_launches = sum(n for _, n in per_name.values())
        conv_ms = groups.get("convolution", (0.0, 0))[0] / n_batches
        out[detector] = {"images_per_s": LABEL_TILES / warm, "warm_s": warm,
                         "busy": busy_ms / (1e3 * warm), "nms_ms": nms_ms,
                         "nms_launches": nms_launches, "conv_ms": conv_ms,
                         "rest_ms": busy_ms / n_batches - conv_ms - nms_ms,
                         "decode_ms": decode_ms, "enqueue_ms": min(enqueue) * 1e3}
        print(f"[label-timing] {detector}: {LABEL_TILES} stacks at batch {LABEL_BATCH} "
              f"({n_batches} batches, the last padded): cold {walls[0]:.3f} s, warm "
              f"{walls[1]:.3f} / {walls[2]:.3f} s -> {LABEL_TILES / warm:.1f} images/s; device "
              f"busy {100 * busy_ms / (1e3 * warm):.1f}% of the warm run; a batch: convolution "
              f"{conv_ms:.2f} ms, NMS {nms_ms:.2f} ms in {nms_launches} launches (N = "
              f"{boxes.shape[1]} anchors, K = {fam.max_dets}), the rest "
              f"{out[detector]['rest_ms']:.2f} ms; host: decoding a tile {decode_ms:.3f} ms, "
              f"enqueueing a batch's predict {min(enqueue) * 1e3:.2f} ms (of "
              + ", ".join(f"{1e3 * e:.2f}" for e in enqueue) + ")", flush=True)
    return out


def det_split(labels: dict, root: str, n_train: int = DET_TRAIN_TILES,
              n_val: int = DET_VAL_TILES) -> Tuple[str, str]:
    """The 512 stacks' COCO split into n_train to train on and the n_val
    after DET_TRAIN_TILES to validate on -> the two file names under root."""
    with open(os.path.join(root, labels["all"])) as f:
        coco = json.load(f)
    names = []
    for name, images in (("det_train.json", coco["images"][:n_train]),
                         ("det_val.json", coco["images"][DET_TRAIN_TILES:
                                                         DET_TRAIN_TILES + n_val])):
        ids = {im["id"] for im in images}
        with open(os.path.join(root, name), "w") as f:
            json.dump({**coco, "images": images,
                       "annotations": [a for a in coco["annotations"] if a["image_id"] in ids]}, f)
        names.append(name)
    return names[0], names[1]


def det_preset(root: str, ann: str, stage: str = "synthetic_heatmap"):
    """A stage's yolov8 preset over one COCO file of the stacks."""
    from agenda_tpu_torch.detect.configs import DatasetSpec, preset

    return preset(stage, "yolov8", [DatasetSpec(root, ann, "")],
                  output_dir=os.path.join(root, "det_work"))


def det_first_batch(cfg, batch: int) -> dict:
    """The loader's first host-augmented batch (the mix recipe)."""
    from agenda_tpu_torch.data.datasets import DataLoader

    loader = DataLoader(cfg.build_train_dataset(), batch, shuffle=True, seed=cfg.runner.seed,
                        num_workers=0, pad_to_full=True)
    return next(iter(loader))


def det_assignment(fam, st, tb):
    """TAL's (fg, assigned GT, target scores, labels) for the train-mode heads
    of ``st``'s weights on ``tb``, as the step's loss computes it."""
    import torch
    from torch.func import functional_call

    from agenda_tpu_torch.detect.assign import task_aligned_assign
    from agenda_tpu_torch.detect.yolov8 import _anchors, _flatten_outputs, decode_boxes

    with torch.no_grad():
        fam.model.train()
        try:
            stats = {k: v.clone() for k, v in st.stats.items()}
            outs = functional_call(fam.model, {**st.params, **stats, **st.counters},
                                   (tb["image"].permute(0, 3, 1, 2).contiguous(),))
        finally:
            fam.model.eval()
        cls, dist = _flatten_outputs(outs, fam.config)
        pts, strides = _anchors(fam.config, cls.device)
        labels = torch.zeros(tb["gt_valid"].shape, dtype=torch.long, device=cls.device)
        return task_aligned_assign(torch.sigmoid(cls), decode_boxes(dist, pts, strides, fam.config),
                                   pts, tb["gt_boxes"], labels, tb["gt_valid"])


def det_step_on(dev, cfg, state, batch, assign=None, mode: str = "step") -> dict:
    """One train step through DetectorRunner.make_train_step on ``dev`` from
    ``state`` (CPU tensors): update count DET_STEP, the end of the warmup, in
    an epoch of DET_STEP + 1 steps (the preset's full lr), zero moments and
    the EMA at the weights. Returns (on the CPU) its own TAL assignment,
    then, with ``assign`` (the CPU's) in place of its own where given, the
    loss, its parts, every gradient, the new batch statistics, the weights
    before and after the update and the EMA. ``mode`` "tf32" runs all of it
    with TF32 on (the control); "f64" (the weights and batch in float64)
    returns the gradients only."""
    import torch

    from agenda_tpu_torch.detect import yolov8
    from agenda_tpu_torch.detect.optim import DetectorSGD
    from agenda_tpu_torch.detect.runner import DetectorRunner, batch_to_device, full_f32

    f64 = mode == "f64"
    if f64:
        state = {k: v.double() if v.is_floating_point() else v for k, v in state.items()}
        batch = {k: v.astype("float64") if v.dtype.kind == "f" else v for k, v in batch.items()}
    fam = cfg.build_family()
    runner = DetectorRunner(fam, cfg.runner, device=dev)
    opt = DetectorSGD(cfg.runner, steps_per_epoch=DET_STEP + 1, total_bs=cfg.runner.batch_size)
    st = runner.init_train_state(opt, state)
    st.opt.count = DET_STEP
    tb = batch_to_device(batch, dev)
    names = list(st.params)
    arith = tf32_on if mode == "tf32" else lambda: full_f32(dev)
    with arith():
        own = det_assignment(fam, st, tb)
    out = {"assign": tuple(t.cpu() for t in own)}

    def grads_with(assignment, context):
        with mock.patch.object(yolov8, "task_aligned_assign", lambda *a, **k: assignment), context:
            loss, parts, _ = fam.loss_fn({**st.params, **st.stats, **st.counters}, tb)
            grads = torch.autograd.grad(loss, [st.params[k] for k in names])
        return loss, parts, {k: g.cpu().double() for k, g in zip(names, grads)}

    given = own if assign is None else tuple(
        t.to(dev, tb["gt_boxes"].dtype if t.is_floating_point() else t.dtype) for t in assign)
    loss, parts, out["grads"] = grads_with(given, arith())
    if f64:
        return out
    if assign is not None and mode == "step":  # for the record: with this side's own assignment
        out["own_grads"] = grads_with(own, full_f32(dev))[2]
    old_stats = {k: v.cpu() for k, v in st.stats.items()}
    with mock.patch.object(yolov8, "task_aligned_assign", lambda *a, **k: given), arith():
        before = {k: v.detach().clone() for k, v in st.params.items()}
        runner.make_train_step(opt)(st, tb, DET_STEP)
    out.update(loss=loss.item(), parts={k: v.item() for k, v in parts.items()},
               old_stats=old_stats, stats={k: v.cpu() for k, v in st.stats.items()},
               before={k: v.cpu() for k, v in before.items()},
               params={k: st.params[k].detach().cpu() for k in names},
               ema={k: st.ema[k].cpu() for k in names})
    return out


def moved_error(got: dict, want: dict, before: dict, roundings: int = 1) -> Tuple[float, str]:
    """The largest difference of two updated tensors beyond ``roundings``
    f32 roundings of the result (an update of a few ulps of the weight
    rounds either way), over the rms of the move (want - before), and its
    name."""
    import torch

    worst = (0.0, "")
    for k, w in want.items():
        ulp = torch.nextafter(w, torch.full_like(w, math.inf)) - w
        rms = float((w - before[k]).double().square().mean().sqrt())
        beyond = float(((got[k] - w).abs() - roundings * ulp).clamp(min=0).max())
        worst = max(worst, (beyond / max(rms, 1e-30), k))
    return worst


def rms_error(got: dict, want: dict) -> Tuple[float, str]:
    """The largest max |d| / rms(want) over the tensors, and its name."""
    worst = (0.0, "")
    for k, w in want.items():
        rms = float(w.double().square().mean().sqrt())
        worst = max(worst, (float((got[k] - w).abs().max()) / max(rms, 1e-30), k))
    return worst


def det_readings(side: dict, ref: dict) -> dict:
    """One side's train step against the CPU's (``ref``): the loss and its
    parts (relative), the gradients (max |d| / rms, per tensor), the batch
    statistics, the update and the EMA (each beyond its own roundings, over
    the rms of its move: the statistics move by 0.03 of a batch's, the EMA
    by 1 - d of the update; the EMA's two products and its sum round atop
    the update's one rounding, hence three), and the TAL assignment (the
    anchors whose fg differs, and the CPU's fg anchors whose GT differs)."""
    (fg, agt), (ref_fg, ref_agt) = side["assign"][:2], ref["assign"][:2]
    return {  # each (reading, the tensor it was read at)
        "loss": (abs(side["loss"] - ref["loss"]) / abs(ref["loss"]), ""),
        "parts": max((abs(side["parts"][k] - ref["parts"][k]) / abs(ref["parts"][k]), k)
                     for k in ref["parts"]),
        "grads": rms_error(side["grads"], ref["grads"]),
        "stats": moved_error(side["stats"], ref["stats"], ref["old_stats"]),
        "update": moved_error(side["params"], ref["params"], ref["before"]),
        "ema": moved_error(side["ema"], ref["ema"], ref["before"], roundings=3),
        "tal": (int((fg != ref_fg).sum()) + int(((agt != ref_agt) & ref_fg).sum()), ""),
    }


def det_train_parity(labels: dict, root: str, dev) -> dict:
    """Phase 21: one train step of YOLOv8n at 128 px, batch 192 (the
    synthetic_heatmap preset), from the calibrated weights and one
    host-augmented batch of the stacks, on the card and on the CPU (both
    f32): the TAL assignment each side makes, then, with the CPU's
    assignment on both sides (an anchor claimed by two GT boxes of near-equal
    IoU goes to either under 1e-5 of noise: 8 such anchors of 5780 moved
    down4's gradient by a third of its rms), the loss and its parts, every
    gradient, the new batch statistics, the SGD update and the EMA; all of
    it once more with TF32 on, the control that each limit must fail; the
    gradients in float64 on both sides, to tell the port's arithmetic from
    f32 noise."""
    import torch

    from agenda_tpu_torch.detect.runner import ema_decay_at, load_variables

    t0 = time.perf_counter()
    cfg = det_preset(root, labels["all"])
    require(cfg.runner.batch_size == LABEL_BATCH, "the synthetic_heatmap preset's batch")
    batch = det_first_batch(cfg, LABEL_BATCH)
    state = load_variables(labels["ckpts"]["yolov8"][1])
    cpu = torch.device("cpu")
    ref = det_step_on(cpu, cfg, state, batch)
    card = det_step_on(dev, cfg, state, batch, assign=ref["assign"])
    control = det_step_on(dev, cfg, state, batch, assign=ref["assign"], mode="tf32")
    card64 = det_step_on(dev, cfg, state, batch, assign=ref["assign"], mode="f64")
    ref64 = det_step_on(cpu, cfg, state, batch, assign=ref["assign"], mode="f64")
    sound, tf32 = det_readings(card, ref), det_readings(control, ref)
    own_err, own_at = rms_error(card["own_grads"], ref["grads"])
    f64_err, f64_at = rms_error(card64["grads"], ref64["grads"])
    card_f32, card_f32_at = rms_error(card["grads"], card64["grads"])
    cpu_f32, cpu_f32_at = rms_error(ref["grads"], ref64["grads"])
    worst = sorted(((rms_error({k: card["grads"][k]}, {k: v})[0], k)
                    for k, v in ref["grads"].items()), reverse=True)[:4]
    n_anchors, n_fg = ref["assign"][0].numel(), int(ref["assign"][0].sum())
    limits = {"loss": DET_LOSS_RTOL, "parts": DET_LOSS_RTOL, "grads": DET_GRAD_TOL_RMS,
              "stats": DET_STATS_TOL_RMS, "update": DET_UPDATE_TOL_RMS,
              "ema": DET_EMA_TOL_RMS, "tal": DET_TAL_MAX}

    def show(r: dict) -> str:
        return ", ".join((f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}")
                         + (f" (at {at})" if at else "")
                         for k, (v, at) in r.items())

    d = ema_decay_at(cfg.runner.ema_decay, DET_STEP)
    print(f"[det-parity] YOLOv8n train step at batch {LABEL_BATCH}, {LABEL_IMG} px, update "
          f"{DET_STEP}, EMA d = {d:.6f}, all with the CPU's TAL assignment (tal: each side's "
          f"own, of {n_anchors} anchors, {n_fg} fg on the CPU); loss {card['loss']:.6f} vs "
          f"{ref['loss']:.6f}; limits {limits}; card (f32) against the CPU: {show(sound)}; "
          f"TF32 control against the CPU: {show(tf32)}; the worst gradients "
          f"{[(k, f'{e:.2e}') for e, k in worst]}; with the card's own assignment "
          f"{own_err:.3e} at {own_at}; float64 on both sides {f64_err:.3e} (at {f64_at}; "
          f"limit {DET_GRAD64_TOL_RMS}); f32 against f64: the card {card_f32:.3e} (at "
          f"{card_f32_at}), the CPU {cpu_f32:.3e} (at {cpu_f32_at}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    require(n_fg > LABEL_BATCH, f"only {n_fg} foreground anchors in a batch of {LABEL_BATCH}")
    for k, limit in limits.items():
        require(sound[k][0] <= limit, f"the train step's {k} differs on the card: "
                f"{sound[k][0]:.3e} > {limit}")
        require(tf32[k][0] > limit, f"the TF32 control passes the {k} limit ({limit}): "
                f"the limit cannot tell TF32 from f32")
    require(f64_err <= DET_GRAD64_TOL_RMS, "the float64 gradients differ on the card")
    return {"sound": sound, "tf32": tf32, "f64_err": f64_err}


class LogRecorder:
    """The messages of the port's detector logger, in order."""

    def __init__(self):
        import logging

        self.messages = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.messages.append(record.getMessage())
        self.logger = logging.getLogger("agenda_tpu_torch.detect")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        self.logger.setLevel(20)  # INFO
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def det_cli_phase(labels: dict, root: str, dev, extra=(), tag: str = "det-cli") -> dict:
    """Phase 22 (and 26 with ``extra`` = the device-aug flags): cli/det_train
    --preset synthetic_heatmap --detector yolov8 on the card: 384 stacks, 64
    to validate, batch 192, 12 epochs (mix recipe in epochs 0-1, stage 2 from
    epoch 2, validation after epoch 1 and every epoch from 2); det_test reads
    its latest.safetensors; a resume from it with --max-epochs 13 starts at
    epoch 12, step 24. With the device-aug flags both runs must log the
    device path."""
    import math as _math

    import torch

    from agenda_tpu_torch.cli import det_test, det_train
    from agenda_tpu_torch.io.safetensors_io import load_file

    train_ann, val_ann = det_split(labels, root)
    work = os.path.join(root, tag)
    args = ["--preset", "synthetic_heatmap", "--detector", "yolov8", "--train-root", root,
            "--train-ann", train_ann, "--train-prefix", "", "--val-root", root, "--val-ann",
            val_ann, "--val-prefix", "", "--work-dir", work, "--device", dev.type, *extra]
    steps_per_epoch = -(-DET_TRAIN_TILES // LABEL_BATCH)
    with LogRecorder() as log:
        t0 = time.perf_counter()
        det_train.main(args + ["--max-epochs", str(DET_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first = list(log.messages)
        t0 = time.perf_counter()
        det_train.main(args + ["--max-epochs", str(DET_EPOCHS + 1), "--resume",
                               os.path.join(work, "latest.safetensors")])
        resume_wall = time.perf_counter() - t0
        second = log.messages[len(first):]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "loss" in r]
    vals = [r["epoch"] for r in rows if "bbox_mAP" in r]
    first_vals = [m for m in first if m.startswith("epoch ") and " val:" in m]
    switch_at = [i for i, m in enumerate(first) if m.startswith("mosaic-close")]
    # the switch comes after the validation of epoch 1 and before that of epoch 2
    after = [m for m in first[:switch_at[0]] if " val:" in m] if switch_at else []
    n_steps = DET_EPOCHS * steps_per_epoch
    for name in ("config.json", "latest.safetensors", "train_state_torch.safetensors",
                 "best_bbox_mAP.safetensors", "best_bbox_mAP_50.safetensors"):
        require(os.path.exists(os.path.join(work, name)), f"det_train wrote no {name}")
    pred = os.path.join(root, f"{tag}_pred.pkl")
    records = det_test.main(["--config", os.path.join(work, "config.json"), "--checkpoint",
                             os.path.join(work, "latest.safetensors"), "--test-root", root,
                             "--test-ann", val_ann, "--test-prefix", "", "--out", pred,
                             "--device", dev.type])
    side = load_file(os.path.join(work, "train_state_torch.safetensors"))
    resumed = [m for m in second if m.startswith("resumed optimizer/epoch state")]
    paths = [sum(m.startswith("device aug on") for m in run) for run in (first, second)]
    print(f"[{tag}] cli/det_train {' '.join(extra)} {DET_EPOCHS} epochs of {steps_per_epoch} "
          f"steps at batch {LABEL_BATCH} ({DET_TRAIN_TILES} stacks, {DET_VAL_TILES} to validate; "
          f"device-aug path logged by {paths} of the two runs): "
          f"{wall:.1f} s ({wall / n_steps:.3f} s a step with validation and checkpoints); "
          f"logged steps {[r['step'] for r in steps]}, losses "
          f"{[round(r['loss'], 3) for r in steps]}; validations after epochs {vals}; recipe "
          f"switch logged after {len(after)} validation(s) ({after[-1:] or 'none'}); det_test "
          f"read latest: {len(records)} records; resume: {resumed}, {resume_wall:.1f} s, sidecar "
          f"epoch {int(side['epoch'])} step {int(side['gstep'])}", flush=True)
    require(len(switch_at) == 1 and len(after) == 1 and after[0].startswith("epoch 1 val")
            and len(first_vals) == DET_EPOCHS - DET_SWITCH + 1,
            "the mosaic-close switch is not logged once, between the validations of epochs 1 "
            "and 2")
    require([r["step"] for r in steps][:3] == [1, 2, 20]
            and all(_math.isfinite(r[k]) for r in steps for k in ("loss", "cls", "iou", "dfl")),
            "metrics.jsonl: the logged steps are not 1, 2, 20 with finite losses")
    require(vals[:DET_EPOCHS - DET_SWITCH + 1] == list(range(1, DET_EPOCHS))
            and vals[-1] == DET_EPOCHS, f"validation epochs {vals}")
    require(len(records) == DET_VAL_TILES, f"det_test wrote {len(records)} records")
    require(paths == ([1, 1] if extra else [0, 0])
            and not any("unsupported" in m for m in first + second),
            f"the augmentation path: device aug logged by {paths} of the runs")
    require(resumed == [f"resumed optimizer/epoch state: epoch {DET_EPOCHS}, step {n_steps}"]
            and int(side["epoch"]) == DET_EPOCHS
            and int(side["gstep"]) == n_steps + steps_per_epoch,
            "the resume did not continue at the next epoch and step")
    shutil.rmtree(work)
    return {"wall": wall, "steps": n_steps}


def host_aug_ms(ds) -> dict:
    """Host augmentation ms an image of a detector train set: the mix and
    stage-2 recipes over DET_AUG_IMAGES images after DET_AUG_WARM untimed
    ones, the tile cache warm (as after a first epoch)."""
    from agenda_tpu_torch.detect.augment import stage2_aug

    for j in range(len(ds)):
        ds._load_scaled(j)
    out = {}
    for recipe in ("mix", "stage2"):
        if recipe == "stage2":
            ds.aug = stage2_aug(ds.aug)
        for j in range(DET_AUG_WARM):  # first calls: imports, the native library's load
            ds[j]
        t0 = time.perf_counter()
        for j in range(DET_AUG_IMAGES):
            ds[j]
        out[recipe] = (time.perf_counter() - t0) * 1e3 / DET_AUG_IMAGES
    return out


def det_timing(labels: dict, root: str, dev) -> dict:
    """Phase 23: YOLOv8n training at batch 192 (synthetic_heatmap) and 1024
    (synthetic_target): warm s/step over 3 synchronised steps through
    DetectorRunner.make_train_step on one batch on the card; host
    augmentation ms an image (mix and stage-2 recipes, the tile cache
    warm); the batch's host-to-device copy; the step's device time by kernel
    group; the training loop's wall a step (the loader's producer thread
    augmenting while the card steps, from a fresh epoch) and the card's busy
    share of it; peak memory."""
    import torch

    from agenda_tpu_torch.data.datasets import DataLoader
    from agenda_tpu_torch.detect.optim import DetectorSGD
    from agenda_tpu_torch.detect.runner import (DetectorRunner, batch_to_device, full_f32,
                                                load_variables)

    state = load_variables(labels["ckpts"]["yolov8"][1])
    out = {}
    for stage, bs in DET_TIMING:
        cfg = det_preset(root, labels["all"], stage)
        require(cfg.runner.batch_size == bs, f"the {stage} preset's batch")
        ds = cfg.build_train_dataset()
        aug_ms = host_aug_ms(ds)
        batch = det_first_batch(cfg, bs)
        fam = cfg.build_family()
        runner = DetectorRunner(fam, cfg.runner, device=dev)
        opt = DetectorSGD(cfg.runner, steps_per_epoch=-(-len(ds) // bs), total_bs=bs)
        st = runner.init_train_state(opt, state)
        step = runner.make_train_step(opt)
        with full_f32(dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb = batch_to_device(batch, dev)
            torch.cuda.synchronize()
            h2d_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(st, tb, 0)  # cold: cuDNN's autotune, allocation
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            walls = []
            for g in range(1, 4):
                t0 = time.perf_counter()
                step(st, tb, g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            warm = sum(walls) / len(walls)
            # the loop as DetectorRunner.train runs it, from a fresh epoch of the loader
            ds = cfg.build_train_dataset()
            for j in range(len(ds)):
                ds._load_scaled(j)
            loader = DataLoader(ds, bs, shuffle=True, seed=0, num_workers=1, pad_to_full=True)
            n_loop = 1 if bs > LABEL_BATCH else 2
            # as many epochs of the loader as n_loop steps take (one batch an
            # epoch at 1024: each epoch's producer starts with its first batch)
            epochs = itertools.chain.from_iterable(itertools.repeat(loader))
            n = 0
            t0 = time.perf_counter()
            for b in itertools.islice(epochs, n_loop):
                step(st, batch_to_device(b, dev), 4 + n)
                n += 1
            torch.cuda.synchronize()
            loop = (time.perf_counter() - t0) / n
            require(n == n_loop, f"the loop ran {n} steps, not {n_loop}")
            busy_ms, groups = profile_run(lambda: (step(st, tb, 9), torch.cuda.synchronize()),
                                          "det-profile", f"YOLOv8n train step at batch {bs}",
                                          warm, DET_KERNEL_GROUPS)
        out[bs] = {"warm_s": warm, "images_per_s": bs / warm, "cold_s": cold, "h2d_ms": h2d_ms,
                   "aug_ms": aug_ms, "busy_ms": busy_ms, "loop_s": loop,
                   "loop_images_per_s": bs / loop, "busy": busy_ms / (1e3 * loop), "peak": peak}
        print(f"[det-timing] {stage}, batch {bs}: step cold {cold:.3f} s, warm "
              + ", ".join(f"{w:.4f}" for w in walls) + f" s -> {warm:.4f} s/step, "
              f"{bs / warm:.1f} images/s (the step alone, its batch on the card); host "
              f"augmentation {aug_ms['mix']:.2f} ms an image (mix), {aug_ms['stage2']:.2f} "
              f"(stage 2); host-to-device copy {h2d_ms:.2f} ms a batch; device busy "
              f"{busy_ms:.2f} ms a step; the loop {loop:.3f} s a step over {n} steps in "
              f"{loader.epoch} epoch(s) of the loader "
              f"({bs / loop:.1f} images/s), card busy {100 * busy_ms / (1e3 * loop):.1f}% of "
              f"it; peak memory {peak / 2**30:.2f} GiB", flush=True)
        del st, tb, batch
        torch.cuda.empty_cache()
    return out


def plans_on(packed: dict, dev) -> dict:
    """Packed plans as the runner hands them to the render: on ``dev``, the
    tail selectors on the host."""
    import torch

    from agenda_tpu_torch.detect.device_aug import SELECTORS

    return {k: torch.from_numpy(v) if k in SELECTORS else torch.from_numpy(v).to(dev)
            for k, v in packed.items()}


def events_ms(fn, n: int = 3) -> float:
    """Mean ms of n warm calls of fn between two CUDA events (eager)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def render_parity(labels: dict, root: str, dev) -> dict:
    """Phase 24: device_aug.render_batch on the card against the same code
    on the CPU, at batch 192 and 128 px over the 512 stacks: real_source's mix
    plans with passthrough samples forced in, separable and gather forms;
    a stage-2 batch; then render_lsj_batch over the stacks at 112 -> 128 px.
    The CPU tests' limits; the render's ms a batch (CUDA events)."""
    import numpy as np
    import torch

    from agenda_tpu_torch.detect.augment import lsj_aug, stage2_aug
    from agenda_tpu_torch.detect.dataset import CocoDetDataset
    from agenda_tpu_torch.detect.device_aug import (AugPlanner, LSJPlanner, render_batch,
                                                    render_lsj_batch)

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    ds = det_preset(root, labels["all"], "real_source").build_train_dataset()
    planner = AugPlanner(ds)
    tiles = planner.dataset_tensor()
    data = {d: torch.from_numpy(tiles).to(d) for d in (cpu, dev)}
    rng = np.random.default_rng(24)
    idx = rng.integers(0, len(ds), LABEL_BATCH)
    out = {}
    for recipe in ("mix", "stage2"):
        if recipe == "stage2":
            ds.aug = stage2_aug(ds.aug)
        packed, scratch, plans = planner.plan_batch(idx, rng, ds.max_gt, RENDER_SLOTS)
        if recipe == "mix":  # passthrough samples forced in, past the drawn ones
            forced = [i for i in range(RENDER_FORCED) if packed["pass_slot"][i] < 0]
            used = int((packed["pass_slot"] >= 0).sum())
            packed["pass_slot"][forced] = used + np.arange(len(forced))
            scratch[used:used + len(forced)] = [planner.render_host(plans[i]) for i in forced]
        slab = {d: torch.from_numpy(scratch).to(d) for d in (cpu, dev)}
        for separable in (True, False):
            def run(d, separable=separable):
                return render_batch(data[d], slab[d], plans_on(packed, d), (LABEL_IMG, LABEL_IMG),
                                    separable=separable)
            got, want = run(dev).cpu() * 255.0, run(cpu) * 255.0
            diff = (got - want).abs()
            ms = events_ms(lambda: run(dev))
            name = f"{recipe} {'separable' if separable else 'gather'}"
            out[name] = {"mean": float(diff.mean()), "far": float((diff > 0.5).float().mean()),
                         "max": float(diff.max()), "ms": ms}
            require(bool(torch.isfinite(got).all()) and out[name]["mean"] <= RENDER_MEAN_TOL
                    and out[name]["far"] <= RENDER_FAR_SHARE,
                    f"render_batch ({name}) differs on the card: {out[name]}")
        if recipe == "mix":
            n_mix, n_pass = int((packed["mix"] > 0).sum()), int((packed["pass_slot"] >= 0).sum())
    lds = CocoDetDataset(root, labels["all"], "", img_scale=(LABEL_IMG, LABEL_IMG), train=True,
                         aug=lsj_aug())
    lsj = LSJPlanner(lds)
    raw = lsj.dataset_tensor()
    packed, _, _ = lsj.plan_batch(idx, rng, lds.max_gt, 1)

    def run_lsj(d):
        return render_lsj_batch(torch.from_numpy(raw).to(d), plans_on(packed, d),
                                (LABEL_IMG, LABEL_IMG), (lsj.sh, lsj.sw))

    def levels(x):  # LSJ's output is whole levels / 255 (the card divides by a reciprocal)
        return torch.round(x.cpu() * 255.0)
    diff = (levels(run_lsj(dev)) - levels(run_lsj(cpu))).abs()
    out["lsj"] = {"max": float(diff.max()), "share": float((diff > 0).float().mean()),
                  "ms": events_ms(lambda: run_lsj(dev))}
    print(f"[render-parity] batch {LABEL_BATCH} at {LABEL_IMG} px, card against the CPU, levels "
          f"({n_mix} mixed and {n_pass} passthrough samples in the mix batch; limits: mean "
          f"{RENDER_MEAN_TOL}, share > 0.5 {RENDER_FAR_SHARE}; LSJ max 1, share "
          f"{LSJ_DIFF_SHARE}): " + "; ".join(
              f"{k}: " + ", ".join(f"{m} {v:.3g}" for m, v in r.items()) for k, r in out.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    require(n_mix > 0 and n_pass >= RENDER_FORCED, "the mix batch lacks mixed or passthrough samples")
    require(out["lsj"]["max"] <= 1.0 and out["lsj"]["share"] <= LSJ_DIFF_SHARE,
            f"render_lsj_batch differs on the card: {out['lsj']}")
    return out


def device_aug_timing(labels: dict, root: str, dev) -> dict:
    """Phase 25: YOLOv8n training through DetectorRunner.train with
    device_aug at batch 192 (synthetic_heatmap, the 512 stacks) and 1024
    (synthetic_target, two fabricated parts of 1024 tiles), each serial, and
    with 4 plan workers at 192: the loop's s/step from the first step of epoch 1 to
    the run's end (host clock; the last checkpoint's write included), the
    card's busy share of it (one profiled render + step), the render's and
    the step's ms (CUDA events), the host's plan ms an image, the plan upload
    ms (warm: the copy into a pinned slot and up), peak memory, the dataset
    tensor's MB; the workers' plans of one epoch (at 192) equal to the
    serial ones."""
    import numpy as np
    import torch

    from agenda_tpu_torch.detect.configs import DatasetSpec, preset
    from agenda_tpu_torch.detect.device_aug import PlanPrefetcher, epoch_plans
    from agenda_tpu_torch.detect.fabricate import write_square_set
    from agenda_tpu_torch.detect.optim import DetectorSGD
    from agenda_tpu_torch.detect.runner import (DetectorRunner, DeviceAugFeed, full_f32,
                                                load_variables)

    state = load_variables(labels["ckpts"]["yolov8"][1])
    parts = []
    for k in range(2):
        part = os.path.join(root, f"square_{k}")
        write_square_set(part, DEVICE_AUG_TILES // 2, seed=40 + k)
        parts.append(DatasetSpec(part, "ann.json"))
    out = {}
    for stage, bs, epochs in DEVICE_AUG_TIMING:
        specs = parts if stage == "synthetic_target" else [DatasetSpec(root, labels["all"], "")]
        cfg = preset(stage, "yolov8", specs, output_dir=os.path.join(root, f"devaug_{bs}"))
        require(cfg.runner.batch_size == bs, f"the {stage} preset's batch")
        cfg.runner.max_epochs, cfg.runner.close_mosaic_epochs = epochs, 0
        cfg.runner.log_interval, cfg.runner.device_aug = 10 ** 6, True
        ds = cfg.build_train_dataset()
        planner, why = DetectorRunner._make_planner(ds)
        require(planner is not None, f"no planner for {stage}: {why}")
        t0 = time.perf_counter()
        feed = DeviceAugFeed(planner, len(ds), bs, cfg.runner.seed, ds.max_gt, 0, None, dev)
        fill_s = time.perf_counter() - t0
        steps_per_epoch = len(feed.loader)
        batches = feed.loader.batches_for_epoch(0)
        t0 = time.perf_counter()
        packed, scratch, _ = planner.plan_batch(batches[0], np.random.default_rng(0), ds.max_gt,
                                                feed.slots)
        plan_ms = (time.perf_counter() - t0) * 1e3 / bs
        for _ in range(2):  # each staging slot allocates its pinned buffers once
            feed.upload(packed, scratch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans, slab = feed.upload(packed, scratch)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        fam = cfg.build_family()
        runner = DetectorRunner(fam, cfg.runner, device=dev)
        opt = DetectorSGD(cfg.runner, steps_per_epoch=steps_per_epoch, total_bs=bs)
        st = runner.init_train_state(opt, state)
        step = runner.make_train_step(opt)
        with full_f32(dev):
            image = feed.render(plans, slab)
            batch = {"image": image, "gt_boxes": plans["gt_boxes"], "gt_valid": plans["gt_valid"]}
            render_ms = events_ms(lambda: feed.render(plans, slab))
            step_ms = events_ms(lambda: step(st, batch, 1))
            busy_ms, _ = profile_run(lambda: (step(st, {**batch, "image": feed.render(plans, slab)},
                                                   1), torch.cuda.synchronize()),
                                     "devaug-profile", f"render + YOLOv8n train step at batch {bs}",
                                     (render_ms + step_ms) / 1e3, DET_KERNEL_GROUPS)
        mb = feed.data.nbytes / 1e6
        index_loader, seed_base, slots = feed.loader, feed.seed_base, feed.slots
        feed.close()
        del st, batch, image, plans, slab, feed
        torch.cuda.empty_cache()
        if bs == DEVICE_AUG_TIMING[0][1]:  # the workers' plans of epoch 0 against the serial
            t0 = time.perf_counter()
            pre = PlanPrefetcher(planner, index_loader.batches_for_epoch, seed_base, ds.max_gt,
                                 slots, 4, planner.dataset_tensor(), stop_epoch=1)
            try:
                prefetched = pre.epoch_batches(0)
            finally:
                pre.close()
            pool_s = time.perf_counter() - t0
            serial = list(epoch_plans(planner, batches, np.random.default_rng(seed_base),
                                      ds.max_gt, slots))
            same = len(prefetched) == len(serial) == steps_per_epoch and all(
                all(np.array_equal(a[k], b[k]) for k in a) and (s is None) == (t is None)
                and (s is None or np.array_equal(s, t))
                for (a, s), (b, t) in zip(serial, prefetched))
            print(f"[devaug] batch {bs}: 4 workers planned epoch 0 ({len(prefetched)} batches) in "
                  f"{pool_s:.1f} s with the pool's start; equal to the serial plans: {same}",
                  flush=True)
            require(same, "the workers' plans differ from the serial ones")
        for workers in ((0, 4) if bs == DEVICE_AUG_TIMING[0][1] else (0,)):
            cfg.runner.device_aug_workers = workers
            runner = DetectorRunner(cfg.build_family(), cfg.runner, device=dev)
            times = []
            make = DetectorRunner.make_train_step

            def timed_make(self, opt, make=make, times=times):
                inner = make(self, opt)

                def timed(*a):
                    times.append(time.perf_counter())
                    return inner(*a)
                return timed
            torch.cuda.reset_peak_memory_stats()
            os.makedirs(cfg.runner.output_dir, exist_ok=True)
            t0 = time.perf_counter()
            with mock.patch.object(DetectorRunner, "make_train_step", timed_make):
                runner.train(ds)
            torch.cuda.synchronize()
            end = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            with open(os.path.join(cfg.runner.output_dir, "metrics.jsonl")) as f:
                losses = [json.loads(line)["loss"] for line in f]
            shutil.rmtree(cfg.runner.output_dir)
            n = len(times)
            loop = (end - times[steps_per_epoch]) / (n - steps_per_epoch)
            r = {"loop_s": loop, "images_per_s": bs / loop, "busy": busy_ms / (1e3 * loop),
                 "render_ms": render_ms, "step_ms": step_ms, "busy_ms": busy_ms,
                 "plan_ms": plan_ms, "upload_ms": upload_ms, "peak": peak, "mb": mb,
                 "start_s": times[0] - t0, "fill_s": fill_s}
            out[(bs, workers)] = r
            print(f"[devaug] {stage}, batch {bs}, {workers} plan workers: {n} steps in {epochs} "
                  f"epochs of {steps_per_epoch}; the loop {loop:.4f} s a step from epoch 1 "
                  f"({bs / loop:.1f} images/s), card busy {100 * r['busy']:.1f}% of it "
                  f"({busy_ms:.2f} ms a render + step profiled); render {render_ms:.2f} ms, "
                  f"step {step_ms:.2f} ms (events); host plans {plan_ms:.3f} ms an image; plan "
                  f"upload {upload_ms:.2f} ms a batch; dataset tensor {mb:.0f} MB (host fill and "
                  f"upload {fill_s:.1f} s), first step {r['start_s']:.1f} s after train() began; "
                  f"peak {peak / 2**30:.2f} GiB; aug_path {runner.aug_path}; losses "
                  f"{[round(v, 3) for v in losses]}", flush=True)
            require(runner.aug_path == "device", f"the run took the {runner.aug_path} path")
            require(n == epochs * steps_per_epoch, f"{n} steps, not {epochs * steps_per_epoch}")
            require(all(math.isfinite(v) for v in losses), "a loss is not finite")
    return out


# ---------------------------------------------------------------------------
# the refine classifier and the chain (phases 27-30)
# ---------------------------------------------------------------------------

# ResNet-50 at the recipe's 224 px and batches (train 256, test 512); crops
# from fabricated 112x112 target tiles, REFINE_DETS detections a tile with
# scores spread over every bucket
REFINE_CROP, REFINE_TRAIN_BATCH, REFINE_TEST_BATCH, REFINE_LR = 224, 256, 512, 4e-4
REFINE_TILES, REFINE_DETS, REFINE_EPOCHS = 400, 10, 2
REFINE_PARITY_BATCH, REFINE_PARITY_REAL, REFINE_PREDICT_BATCH = 32, 28, 64
REFINE_TIMING_ROWS = 4 * REFINE_TRAIN_BATCH
# One train step card vs CPU, both f32 (TF32 off), from the CLI's fresh init
# with REFINE_PARITY_REAL real rows padded to 32. A fresh ResNet-50 in train
# mode is chaotic: its f32 gradients on the CPU lie up to 2.8e-2 (relative
# L2, per tensor) from its own float64 ones at 224 px (batch 8), its new
# running statistics 4.6e-4 of their move, and 0.55% of the Adam update's
# elements more than 0.01 lr apart (ReLU and max-pool gates near 0 flip). The
# limits sit a few times above that; TF32 (2^-11 per product, four orders
# above f32) is the control and must fail each. In float64 on both sides
# the gradients agree to REFINE_GRAD64_TOL. Eval logits (batch 64, no train
# mode) within REFINE_LOGIT_TOL_RMS of their rms.
REFINE_LOSS_RTOL = 1e-5
REFINE_GRAD_TOL_L2 = 0.1  # per tensor, ||d|| / ||CPU||
REFINE_GRAD64_TOL = 1e-6  # the same, float64 on both sides
REFINE_STATS_TOL = 5e-3  # running statistics, max |d| / rms(their move)
REFINE_UPDATE_SHARE = 0.03  # Adam update elements more than 0.01 lr apart
REFINE_LOGIT_TOL_RMS = 1e-3
# the chain (phase 30): SD-1.4's layout cut to two UNet and VAE levels of
# 128 and 256 channels (the VAE's own group sizes 4 and 8, flash head dims 64
# and 128), CLIP at width 64; the CPU test's extra_args, plus the int8 AdamW
# in finetune_sd (with EMA: K5) and token_stage2 (K4)
CHAIN_ARGS = {
    "finetune_sd": ["--train_batch_size", "1", "--checkpointing_steps", "100",
                    "--report_to", "jsonl", "--use_8bit_adam", "--use_ema"],
    "token_stage1": ["--train_batch_size", "1", "--checkpointing_steps", "100",
                     "--report_to", "jsonl"],
    "token_stage2": ["--train_batch_size", "1", "--checkpointing_steps", "100",
                     "--report_to", "jsonl", "--use_8bit_adam"],
    "generate_source": ["--batch-size", "4", "--num-inference-steps", "2"],
    "generate_target": ["--batch-size", "4", "--num-inference-steps", "2"],
    "generate_target_nocars": ["--batch-size", "4", "--num-inference-steps", "2"],
    "det_real_source": ["--max-epochs", "1", "--batch-size", "4"],
    "det_synthetic_heatmap": ["--max-epochs", "1", "--batch-size", "4"],
    "det_synthetic_target": ["--max-epochs", "1", "--batch-size", "4"],
    "refine": ["--num_epochs", "1", "--train_batch_size", "8", "--test_batch_size", "8"],
}
CHAIN_REAL_TILES = 8
# the kernels each stage must launch (every other stage launches none)
_CHAIN_FLASH = ("flash_attention_fwd", "flash_attention_fwd_wide")  # the VAE's too (D = 256)
_CHAIN_FLASH_BWD = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
CHAIN_KERNELS = {
    "finetune_sd": (*_CHAIN_FLASH, *_CHAIN_FLASH_BWD, "fused_adamw8bit_ema", "group_norm_act"),
    "token_stage1": (*_CHAIN_FLASH, *_CHAIN_FLASH_BWD, "group_norm_act"),
    "token_stage2": (*_CHAIN_FLASH, *_CHAIN_FLASH_BWD, "fused_adamw8bit", "group_norm_act"),
    "generate_source": (*_CHAIN_FLASH, "group_norm_act"),
    "generate_target": (*_CHAIN_FLASH, "group_norm_act"),
    "generate_target_nocars": (*_CHAIN_FLASH, "group_norm_act"),
}


def refine_step_on(dev, state_dict, images, labels, mask, mode: str = "f32") -> dict:
    """One classifier train step (annotate/classifier.py, Adam at the
    recipe's lr) from ``state_dict`` on ``dev``: mode f32 (TF32 off), tf32
    (the control), f64 or bf16 (autocast, the card's default). -> the loss,
    the gradients (Adam's first moment / 0.1), the new running statistics,
    the parameters after the update and before it."""
    import torch

    from agenda_tpu_torch.annotate.classifier import make_adam, make_classifier_train_step
    from agenda_tpu_torch.models.resnet import ResNet50

    dtype = {"f32": torch.float32, "tf32": torch.float32, "f64": torch.float64,
             "bf16": torch.bfloat16}[mode]
    model = ResNet50(num_classes=1)
    model.load_state_dict(state_dict)
    model = model.to(dev, torch.float64 if mode == "f64" else torch.float32)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    tx = make_adam(REFINE_LR)
    opt_state = tx.init(dict(model.named_parameters()))
    step = make_classifier_train_step(model, tx, dtype)
    x_dtype = torch.float64 if mode == "f64" else torch.float32
    args = (images.to(dev, x_dtype), labels.to(dev, x_dtype), mask.to(dev, x_dtype))
    with tf32_on() if mode == "tf32" else contextlib.nullcontext():
        loss = step(opt_state, *args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cpu = torch.device("cpu")
    sd = model.state_dict()
    return {"loss": float(loss),
            "grads": {k: (v / 0.1).to(cpu, torch.float64) for k, v in opt_state.mu.items()},
            "stats": {k: v.to(cpu, torch.float64) for k, v in sd.items() if "running" in k},
            "params": {k: v.detach().to(cpu, torch.float64) for k, v in model.named_parameters()},
            "before": {k: v.to(cpu, torch.float64) for k, v in before.items()}}


def refine_readings(side: dict, ref: dict, old_stats: dict) -> dict:
    """One side's classifier step against the CPU's: the loss (relative),
    the gradients (the largest relative L2 over the tensors), the running
    statistics (max |d| over the rms of the CPU's move), the update (the
    share of elements more than 0.01 lr apart)."""
    grads = max((float((side["grads"][k] - g).norm() / g.norm().clamp(min=1e-30)), k)
                for k, g in ref["grads"].items())
    stats = max((float((side["stats"][k] - s).abs().max()
                       / (s - old_stats[k]).square().mean().sqrt().clamp(min=1e-30)), k)
                for k, s in ref["stats"].items())
    apart = sum(int((side["params"][k] - p).abs().gt(0.01 * REFINE_LR).sum())
                for k, p in ref["params"].items())
    n = sum(p.numel() for p in ref["params"].values())
    return {"loss": (abs(side["loss"] - ref["loss"]) / abs(ref["loss"]), ""),
            "grads": grads, "stats": stats, "update": (apart / n, "")}


def refine_parity(dev) -> dict:
    """Phase 27: ResNet-50 at 224 px from the CLI's fresh init (seed 0), one
    train step at batch 32 (28 real rows padded with copies of row 0, as
    batches_padded pads) on the card (f32, TF32 off) and on the CPU: the
    loss, every gradient, the new running statistics and the Adam update,
    each within its limit; the same step with TF32 on, the control, beyond
    each; the gradients in float64 on both sides; eval logits at batch 64
    from the CPU's stepped weights; a bf16 step (the card's default) finite."""
    import numpy as np
    import torch

    from agenda_tpu_torch.annotate.classifier import classifier_logits, padded_index_batches
    from agenda_tpu_torch.models.resnet import ResNet50, init_resnet_

    t0 = time.perf_counter()
    model = ResNet50(num_classes=1)
    init_resnet_(model, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (REFINE_PARITY_REAL, REFINE_CROP, REFINE_CROP, 3)).astype(np.float32)
    bb, real = next(padded_index_batches(REFINE_PARITY_REAL, REFINE_PARITY_BATCH, False, rng))
    images = torch.from_numpy(x[bb])
    labels = torch.from_numpy((np.arange(REFINE_PARITY_REAL) % 2)[bb].astype(np.float32))
    mask = (torch.arange(REFINE_PARITY_BATCH) < real).float()
    old_stats = {k: v.double() for k, v in sd.items() if "running" in k}
    cpu = torch.device("cpu")
    ref = refine_step_on(cpu, sd, images, labels, mask)
    card = refine_step_on(dev, sd, images, labels, mask)
    control = refine_step_on(dev, sd, images, labels, mask, "tf32")
    ref64 = refine_step_on(cpu, sd, images, labels, mask, "f64")
    card64 = refine_step_on(dev, sd, images, labels, mask, "f64")
    bf16 = refine_step_on(dev, sd, images, labels, mask, "bf16")
    sound, tf32 = refine_readings(card, ref, old_stats), refine_readings(control, ref, old_stats)
    f64 = max(float((card64["grads"][k] - g).norm() / g.norm().clamp(min=1e-30))
              for k, g in ref64["grads"].items())
    cpu_f32 = max(float((ref["grads"][k] - g).norm() / g.norm().clamp(min=1e-30))
                  for k, g in ref64["grads"].items())
    # eval logits at batch 64 from the CPU's stepped weights (its statistics moved once)
    stepped = {k: v.clone() for k, v in sd.items()}
    stepped.update({k: v.float() for k, v in ref["params"].items()})
    stepped.update({k: v.float() for k, v in ref["stats"].items()})
    xp = torch.from_numpy(rng.uniform(0, 1, (REFINE_PREDICT_BATCH, REFINE_CROP, REFINE_CROP, 3))
                          .astype(np.float32))
    logits = []
    for d in (cpu, dev):
        m = ResNet50(num_classes=1)
        m.load_state_dict(stepped)
        logits.append(classifier_logits(m.to(d), xp.to(d), torch.float32).cpu().double())
    lref, lcard = logits
    logit_err = float((lcard - lref).abs().max() / lref.square().mean().sqrt())
    bf16_ok = math.isfinite(bf16["loss"]) and all(bool(torch.isfinite(g).all())
                                                   for g in bf16["grads"].values())
    limits = {"loss": REFINE_LOSS_RTOL, "grads": REFINE_GRAD_TOL_L2, "stats": REFINE_STATS_TOL,
              "update": REFINE_UPDATE_SHARE}

    def show(r: dict) -> str:
        return ", ".join(f"{k} {v:.3e}" + (f" (at {at})" if at else "") for k, (v, at) in r.items())

    print(f"[refine-parity] ResNet-50 train step at batch {REFINE_PARITY_BATCH} ({real} real "
          f"rows), {REFINE_CROP} px, Adam lr {REFINE_LR}: loss {card['loss']:.7f} vs "
          f"{ref['loss']:.7f}; limits {limits}; card (f32) against the CPU: {show(sound)}; TF32 "
          f"control against the CPU: {show(tf32)}; float64 on both sides {f64:.3e} (limit "
          f"{REFINE_GRAD64_TOL}); the CPU's f32 against its float64 {cpu_f32:.3e}; eval logits "
          f"at batch {REFINE_PREDICT_BATCH} {logit_err:.3e} of their rms (limit "
          f"{REFINE_LOGIT_TOL_RMS}); bf16 step loss {bf16['loss']:.5f}, finite {bf16_ok}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k, limit in limits.items():
        require(sound[k][0] <= limit, f"the classifier step's {k} differs on the card: "
                f"{sound[k][0]:.3e} > {limit}")
        require(tf32[k][0] > limit, f"the TF32 control passes the {k} limit ({limit}): "
                f"the limit cannot tell TF32 from f32")
    require(f64 <= REFINE_GRAD64_TOL, f"the float64 gradients differ on the card: {f64:.3e}")
    require(logit_err <= REFINE_LOGIT_TOL_RMS, f"eval logits differ on the card: {logit_err:.3e}")
    require(bf16_ok, "the bf16 classifier step is not finite")
    return {"sound": sound, "tf32": tf32, "f64": f64, "logits": logit_err}


def refine_fabricate(root: str, n_tiles: int, n_dets: int, seed: int = 0) -> Tuple[str, str]:
    """``n_tiles`` 112x112 PNG tiles of dark noise and a prediction pkl of
    ``n_dets`` detections a tile: scores uniform on [0, 1] (every bucket,
    hard negatives too), box centres uniform over the tile and 5 px past its
    edges; a detection scoring 0.5 or more has a bright 21-px square at its
    centre, something for the classifier to learn. -> (image dir, pkl)."""
    import pickle

    import numpy as np

    from agenda_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    records = []
    for i in range(n_tiles):
        tile = rng.integers(0, 60, (TILE, TILE, 3), dtype=np.uint8)
        c = rng.uniform(-5, TILE + 5, (n_dets, 2))
        boxes = np.clip(np.concatenate([c - 21.18, c + 21.18], 1), 0, TILE)
        scores = np.sort(rng.uniform(0, 1, n_dets))[::-1]
        for (x, y), s in zip(c.astype(int), scores):
            if s >= 0.5:
                tile[max(y - 10, 0):max(y + 11, 0), max(x - 10, 0):max(x + 11, 0)] = 220
        write_png(os.path.join(img_dir, f"{i}.png"), tile)
        records.append({"img_path": f"stacks/{i}.png", "pred_instances": {
            "bboxes": boxes.astype(np.float32), "scores": scores.astype(np.float32),
            "labels": np.zeros(n_dets, np.int64)}})
    pkl = os.path.join(root, "pred.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(records, f)
    return img_dir, pkl


def refine_cli_phase(root: str, dev) -> dict:
    """Phase 28: cli/refine_label on the card over REFINE_TILES fabricated
    tiles (REFINE_DETS detections each, every bucket filled), the recipe's
    batches 256 / 512, crop 224, 2 epochs: both checkpoints load back into
    the port's ResNet-50; the refined COCO is sorted by image_id, re-id'd,
    and holds every label-1 crop and the kept ones."""
    import numpy as np
    import torch

    from agenda_tpu_torch.annotate.records import load_predictions
    from agenda_tpu_torch.cli import refine_label
    from agenda_tpu_torch.io.safetensors_io import load_file
    from agenda_tpu_torch.models.resnet import ResNet50, resnet_from_flax

    img_dir, pkl = refine_fabricate(root, REFINE_TILES, REFINE_DETS)
    n_pos = 0
    for r in load_predictions(pkl):
        s = r["pred_instances"]["scores"]
        s = s[s >= 0.05]
        n_pos += int(len(s) > 0) + int((s[1:] >= 0.75).sum())
    out_json = os.path.join(root, "refined.json")
    t0 = time.perf_counter()
    stats = refine_label.main([
        "--prediction_pkl", pkl, "--synthetic_image_base_path", img_dir,
        "--json_save_path", out_json, "--checkpoint_save_path", os.path.join(root, "clf"),
        "--num_epochs", str(REFINE_EPOCHS), "--device", dev.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loaded = []
    for name in ("resnet_best_accuracy.safetensors", "resnet_best_f1.safetensors"):
        path = os.path.join(root, "clf", name)
        require(os.path.exists(path), f"refine_label wrote no {name}")
        m = ResNet50(num_classes=1)
        missing, unexpected = m.load_state_dict(
            resnet_from_flax({k: v.numpy() for k, v in load_file(path).items()}), strict=False)
        loaded.append(not unexpected and all(k.endswith("num_batches_tracked") for k in missing))
    with open(out_json) as f:
        coco = json.load(f)
    anns = coco["annotations"]
    ids = [a["image_id"] for a in anns]
    labels = [a["label"] for a in anns]
    hist = [(h["accuracy"], h["f1"]) for h in stats["history"]]
    print(f"[refine-cli] cli/refine_label on {REFINE_TILES} tiles x {REFINE_DETS} detections: "
          f"{stats['n_train']} train crops, {stats['n_test']} unlabeled, {stats['steps']} steps "
          f"at batch {REFINE_TRAIN_BATCH} ({stats['dtype']}), {REFINE_EPOCHS} epochs "
          f"(accuracy, F1 {[(round(a, 4), round(b, 4)) for a, b in hist]}), kept "
          f"{stats['kept']}; {wall:.1f} s (crops {stats['crop_seconds']:.2f} s, resize "
          f"{stats['resize_seconds']:.2f} s, epochs {[round(s, 2) for s in stats['epoch_seconds']]}"
          f" s); checkpoints load back {loaded}; COCO {len(coco['images'])} images, "
          f"{labels.count(1)} label-1 + {labels.count(-1)} kept annotations", flush=True)
    require(all(loaded), "a refine checkpoint does not load back")
    require(stats["dtype"] == "torch.bfloat16", f"the card's compute dtype {stats['dtype']}")
    require(stats["n_train"] + stats["n_test"] > 2000 and stats["n_test"] > 0
            and 0 < n_pos < stats["n_train"],
            "the fabricated predictions do not fill every bucket")
    require(len(coco["images"]) == REFINE_TILES and ids == sorted(ids)
            and [a["id"] for a in anns] == list(range(len(anns))),
            "the refined COCO is not sorted by image_id and re-id'd")
    require(labels.count(1) == n_pos and labels.count(-1) == stats["kept"]
            and len(anns) == n_pos + stats["kept"],
            f"the refined COCO holds {labels.count(1)} label-1 crops (of {n_pos}) and "
            f"{labels.count(-1)} kept (of {stats['kept']})")
    require(all(np.isfinite(a) and np.isfinite(b) for a, b in hist), "accuracy or F1 not finite")
    shutil.rmtree(os.path.join(root, "clf"))
    return {**stats, "wall": wall}


def refine_timing(cli: dict, dev) -> dict:
    """Phase 29: the classifier on the card at the recipe's batches: warm
    s/step at batch 256 in bf16 (the CLI's) and f32, synchronised, with peak
    memory; predict images/s at batch 512 (bf16); one epoch of
    REFINE_TIMING_ROWS crops through the CLI's loop (CropFeed + step), its
    wall a step and the card's busy share (torch.profiler); on the host the
    gather + upload ms a batch (CropFeed.batch, synchronised), and phase
    28's crop and resize ms a crop."""
    import numpy as np
    import torch

    from agenda_tpu_torch.annotate.classifier import (CropFeed, init_classifier, make_adam,
                                                      make_classifier_train_step,
                                                      padded_index_batches, predict)

    rng = np.random.default_rng(1)
    crops = rng.integers(0, 256, (REFINE_TIMING_ROWS, REFINE_CROP, REFINE_CROP, 3), np.uint8)
    feed = CropFeed(crops, dev)
    labels = feed.upload((np.arange(REFINE_TIMING_ROWS) % 2).astype(np.float32))
    mask = torch.ones(REFINE_TRAIN_BATCH, device=dev)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        tx = make_adam(REFINE_LR)
        model, opt_state = init_classifier(torch.Generator().manual_seed(0), tx, dev)
        step = make_classifier_train_step(model, tx, dtype)
        images, rows = feed.batch(np.arange(REFINE_TRAIN_BATCH))
        for _ in range(2):
            step(opt_state, images, labels[rows], mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            step(opt_state, images, labels[rows], mask)
        torch.cuda.synchronize()
        out[name] = {"step_s": (time.perf_counter() - t0) / 3,
                     "peak": torch.cuda.max_memory_allocated()}
        if name == "bf16":
            test_images, _ = feed.batch(np.arange(REFINE_TEST_BATCH))
            predict(model, test_images, dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                predict(model, test_images, dtype).cpu()
            out["predict_images_per_s"] = 3 * REFINE_TEST_BATCH / (time.perf_counter() - t0)

            def epoch():
                feed.set_flips(rng.random(REFINE_TIMING_ROWS) < 0.5)
                for bb, real in padded_index_batches(REFINE_TIMING_ROWS, REFINE_TRAIN_BATCH,
                                                     True, rng):
                    x, r = feed.batch(bb)
                    step(opt_state, x, labels[r], mask)
                feed.set_flips(None)
                torch.cuda.synchronize()

            epoch()
            t0 = time.perf_counter()
            epoch()
            out["epoch_step_s"] = (time.perf_counter() - t0) / (REFINE_TIMING_ROWS
                                                               // REFINE_TRAIN_BATCH)
            per_name, wall = device_times(epoch)
            out["busy"] = sum(us for us, _ in per_name.values()) / 1e6 / wall
        del model, opt_state, step
        torch.cuda.empty_cache()
    idx = np.arange(REFINE_TRAIN_BATCH)
    feed.batch(idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        feed.batch(idx)
        torch.cuda.synchronize()
    out["gather_upload_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out["crop_ms"] = 1e3 * cli["crop_seconds"] / cli["n_crops"]
    out["resize_ms"] = 1e3 * cli["resize_seconds"] / cli["n_crops"]
    print(f"[refine-timing] ResNet-50 at {REFINE_CROP} px: warm step at batch "
          f"{REFINE_TRAIN_BATCH} bf16 {out['bf16']['step_s']:.4f} s "
          f"({REFINE_TRAIN_BATCH / out['bf16']['step_s']:.1f} images/s, peak "
          f"{out['bf16']['peak'] / 2**30:.2f} GiB), f32 {out['f32']['step_s']:.4f} s "
          f"({REFINE_TRAIN_BATCH / out['f32']['step_s']:.1f} images/s, peak "
          f"{out['f32']['peak'] / 2**30:.2f} GiB); predict {out['predict_images_per_s']:.1f} "
          f"images/s at batch {REFINE_TEST_BATCH} (bf16); the CLI's loop "
          f"{out['epoch_step_s']:.4f} s a step over an epoch of {REFINE_TIMING_ROWS} crops, card "
          f"busy {100 * out['busy']:.1f}%; host: crop {out['crop_ms']:.3f} ms and resize "
          f"{out['resize_ms']:.3f} ms a crop (phase 28's {cli['n_crops']}), gather + upload "
          f"{out['gather_upload_ms']:.2f} ms a batch of {REFINE_TRAIN_BATCH} "
          f"({REFINE_TRAIN_BATCH * REFINE_CROP * REFINE_CROP * 3 / 2**20:.0f} MiB)", flush=True)
    return out


def fabricate_chain_pipeline(out_dir: str) -> None:
    """SD-1.4's layout at two UNet and VAE levels of 128 and 256 channels,
    CLIP at width 64, the tiny tokenizer, seeded weights."""
    from agenda_tpu_torch.io.configs import CLIPTextConfig, UNetConfig, VAEConfig
    from agenda_tpu_torch.io.diffusers_io import save_pipeline
    from agenda_tpu_torch.io.fabricate import random_state, write_tiny_tokenizer
    from agenda_tpu_torch.models.clip_text import CLIPTextModel
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.models.vae import AutoencoderKL

    tok_dir = os.path.join(out_dir, "tokenizer")
    vocab = write_tiny_tokenizer(tok_dir)
    unet = UNetConfig(sample_size=16, block_out_channels=(128, 256), layers_per_block=1,
                      down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                      up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                      attention_head_dim=2, cross_attention_dim=64)
    vae = VAEConfig(block_out_channels=(128, 256), layers_per_block=1)
    text = CLIPTextConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=2, num_attention_heads=2)
    save_pipeline(out_dir, unet, random_state(UNet2DConditionModel, unet, 0),
                  vae, random_state(AutoencoderKL, vae, 1),
                  text, random_state(CLIPTextModel, text, 2), tokenizer_dir=tok_dir)


def chain_phase(root: str, dev, detector: str = "yolov8") -> dict:
    """Phase 30 (and 34 with ``detector`` faster-rcnn): the port's
    cli/pipeline --device cuda through all 21 stages on fabricated sets:
    --until-stage label_synthetic_target; a rerun that skips every stage;
    the target predictions doctored to fill the refine buckets; --from-stage
    refine. Each stage leaves its marker and manifest line, launches the
    kernels CHAIN_KERNELS names for it (and no other), and the final
    prediction_real_target.pkl holds one record per target image."""
    import pickle

    import numpy as np
    import torch

    from agenda_tpu_torch.cli import pipeline as pl
    from agenda_tpu_torch.detect.fabricate import write_square_set
    from agenda_tpu_torch.utils.png import write_png

    t0 = time.perf_counter()
    fabricate_chain_pipeline(os.path.join(root, "pipe"))
    rng = np.random.default_rng(0)
    ds = os.path.join(root, "ds")
    os.makedirs(ds)
    prompts = {}
    for i in range(2):
        write_png(os.path.join(ds, f"img{i}.png"), rng.integers(0, 256, (64, 64, 3), np.uint8))
        prompts[f"img{i}.png"] = "An aerial view image with cars in Utah"
    with open(os.path.join(ds, "data.json"), "w") as f:
        json.dump(prompts, f)
    write_square_set(os.path.join(root, "real"), CHAIN_REAL_TILES, seed=1)
    cfg = pl.PipelineConfig(
        work_dir=os.path.join(root, "run"), base_model=os.path.join(root, "pipe"),
        dataset_folder=ds, train_json="data.json", num_images=4, sd_steps=1,
        token_steps_stage1=1, token_steps_stage2=1, resolution=32, image_size=112,
        real_train_root=os.path.join(root, "real"), real_train_ann="ann.json",
        real_target_test_root=os.path.join(root, "real"), real_target_test_ann="ann.json",
        thresh_conf=0.0, extra_args=CHAIN_ARGS, detector=detector)
    path = os.path.join(root, "chain.json")
    cfg.to_json(path)
    run = ["--config", path, "--device", dev.type]
    per_stage = {}
    run_stage = pl.run_stage

    def counted(stage, c):
        reset_counts()
        t = time.perf_counter()
        run_stage(stage, c)
        torch.cuda.synchronize()
        per_stage[stage.name] = (time.perf_counter() - t, read_counts())

    with mock.patch.object(pl, "run_stage", counted):
        pl.main(run + ["--until-stage", "label_synthetic_target"])
        first = dict(per_stage)
        pl.main(run + ["--until-stage", "label_synthetic_target"])
        rerun = len(per_stage) - len(first)
        pred_tgt = os.path.join(cfg.work_dir, "work_dirs", f"{detector}_synthetic_heatmap",
                                "prediction_syn_target.pkl")
        with open(pred_tgt, "rb") as f:
            records = pickle.load(f)
        for r in records:
            r["pred_instances"] = {
                "scores": np.array([0.9, 0.5, 0.2, 0.6, 0.01]), "labels": np.zeros(5, np.int64),
                "bboxes": np.array([[30, 30, 72, 72], [0, 0, 42, 42], [60, 60, 100, 100],
                                    [80, 5, 112, 47], [10, 70, 52, 112]], np.float32)}
        with open(pred_tgt, "wb") as f:
            pickle.dump(records, f)
        pl.main(run + ["--from-stage", "refine"])
    names = [s.name for s in pl.build_stages(cfg)]
    with open(os.path.join(cfg.work_dir, "pipeline_manifest.jsonl")) as f:
        manifest = [json.loads(line) for line in f]
    markers = sorted(os.listdir(os.path.join(cfg.work_dir, ".stage_done")))
    with open(os.path.join(cfg.work_dir, "work_dirs", f"{detector}_synthetic_target",
                           "prediction_real_target.pkl"), "rb") as f:
        final = pickle.load(f)
    wrong = {n: {k: v for k, v in counts.items() if not k.startswith("fused_adamw8bit_leaves")
                 and (v > 0) != (k in CHAIN_KERNELS.get(n, ()))}
             for n, (_, counts) in per_stage.items()}
    wrong = {n: w for n, w in wrong.items() if w}
    wall = time.perf_counter() - t0
    print(f"[chain] detector {detector}: cli/pipeline --device {dev.type}, {len(names)} "
          f"stages: "
          + ", ".join(f"{n} {s:.1f} s" for n, (s, _) in per_stage.items())
          + f"; kernel launches by stage "
          + "; ".join(f"{n} {({k: v for k, v in c.items() if v})}" for n, (_, c)
                      in per_stage.items() if any(c.values()))
          + f"; rerun ran {rerun} stages; manifest {len(manifest)} lines, markers {len(markers)};"
          f" final records {len(final)}; {wall:.1f} s", flush=True)
    require(list(per_stage) == names, f"the stages ran {list(per_stage)}")
    require(rerun == 0, f"the rerun ran {rerun} stages")
    require([e["stage"] for e in manifest] == names and markers == sorted(names),
            "a stage left no marker or manifest line")
    modules = {s.name: s.module for s in pl.build_stages(cfg)}
    require(all((e["argv"][-2:] == ["--device", dev.type])
                == (modules[e["stage"]] in pl.DEVICE_MODULES) for e in manifest),
            "--device is not on exactly the stages whose CLIs take it")
    require(not wrong, f"kernel launches differ from CHAIN_KERNELS: {wrong}")
    require(len(final) == CHAIN_REAL_TILES, f"{len(final)} final records")
    return {"stages": {n: s for n, (s, _) in per_stage.items()}, "wall": wall}


# the other detector families (phases 31-34): Faster R-CNN R50-FPN, YOLOv5m and
# YOLOv5s, ViTDet ViT-B, each at its reference config's widths at 128 px
FAMILIES = ("faster-rcnn", "yolov5", "yolov5s", "vitdet")
# phase 31: one train step at FAM_BATCH of the stacks (the real_source preset's
# recipe and optimizer, update FAM_STEP: past the warmup of the plain SGD and
# AdamW, 1/3 into the yolo one's), card vs CPU, both f32 with TF32 off and the
# CPU's RCNN targets on both sides (a proposal whose IoU sits at a sampling
# threshold goes either way under 1e-6 of noise); each reading (relative:
# the loss, its largest part, the gradients, the update and the statistics'
# move, as L2 norms of the difference over the CPU's) within its family's
# limit, and the TF32 control beyond every limit. The limits sit between the
# sound runs' readings and the TF32 controls' (read on an H100 80GB HBM3 at
# 700 W; sound / TF32): Faster R-CNN's fresh ResNet-50 in train mode is
# chaotic, as the refine step's (gradients 1.7e-2 / 0.48, update 1.7e-2 /
# 0.46, parts 8.7e-6 / 4.5e-3, statistics 3.3e-5 / 1.8e-2); YOLOv5m (loss
# 5.8e-7 / 2.8e-4, gradients 4.1e-4 / 0.22, statistics 1.1e-5 / 6.1e-3);
# YOLOv5s, whose TF32 control moves the loss least and by a varying amount
# over three calls (loss 2.3e-7 / 3.4e-6 to 7.7e-5, parts 2.4e-7 / 1.1e-5 to
# 9.1e-5, gradients 6.8e-5 / 4.0e-2, statistics 7.1e-6 / 3.3e-3); ViTDet's
# layer norms keep it tame (gradients 7.8e-5 / 2.1e-3) and its first AdamW
# update moves every weight by about lr, so a gradient's 1e-4 noise flips
# an element's sign (update 3.6e-3 / 4.7e-2). Each limit sits near the
# geometric mean of its two readings.
# Predictions on the calibrated weights: each kept box matched one to one
# (corners within FAM_BOX_TOL px, the score within DET_SCORE_TOL); at most
# FAM_UNMATCHED_MAX of an image's go unmatched (the two-stage families' NMS
# over near-tied proposals: 4 of Faster R-CNN's 800, 2 in the worst image)
FAM_BATCH, FAM_STEP, FAM_SEED = 8, 1000, 5
FAM_BOX_TOL, FAM_UNMATCHED_MAX = 0.05, 0.05
FAM_LIMITS = {
    "faster-rcnn": {"loss": 1e-5, "parts": 1e-4, "grads": 0.1, "update": 0.1, "stats": 1e-3},
    "yolov5": {"loss": 1e-5, "parts": 1e-5, "grads": 5e-3, "update": 5e-3, "stats": 1e-4},
    "yolov5s": {"loss": 1e-6, "parts": 2e-6, "grads": 2e-3, "update": 2e-3, "stats": 1.5e-4},
    "vitdet": {"loss": 1e-5, "parts": 1e-5, "grads": 4e-4, "update": 1.5e-2},
}
# phase 32: cli/det_train --preset real_source (each family's batch) with
# --pretrained on a fabricated mm checkpoint, FAM_EPOCHS epochs on the first
# FAM_CLI_TILES stacks of phase 22's split (cut from its 384, then from 128,
# then from 48 to pay for phase 40, to keep the script within its time limit:
# every family's batch now takes them in one step an epoch), for FAM_RESUME's
# families a resume for one more (cut from every family's to keep the script
# within its time limit: the resume is the runner's, whatever the family, and
# phase 22 resumes YOLOv8), det_test on the first FAM_CLI_TILES of phase 22's
# validation stacks (cut from its 64, also to pay for phase 40: one predict
# batch at every family's batch); Faster R-CNN once more with --device-aug;
# phase 33: timing at the real_source batch (FAM_WARM synchronised steps
# after a cold one, the batch on the card) and labelling FAM_LABEL_TILES of
# the stacks in one batch (cut from all 512, then from 256 to one batch of
# 192 to pay for phase 40, to keep the script within its time limit). Each
# new batch shape costs a cold pass of cuDNN's autotuning in f32 (the
# runner's full_f32): 10.3, 8.5 and 4.6 s for the synthetic_target batches
# (256, 512, 512), which phase 33 no longer times, 29 s for ViTDet's first
# step at its 24 and 37 s for its labelling batch of 192 (192 000 RoIs
# through its four head convolutions: scripts/sample_phases.py, PERF.md). So
# ViTDet trains and labels at FAM_BATCH in phases 32 and 33 (the batch phase
# 31 tunes, FAM_SMALL_BATCH), and each family labels 48 stacks.
FAM_EPOCHS, FAM_WARM, FAM_CLI_TILES, FAM_LABEL_TILES = 1, 1, 24, 48
FAM_RESUME = ("faster-rcnn",)
FAM_SMALL_BATCH = ("vitdet",)


def family_preset(root: str, ann: str, detector: str, stage: str = "real_source"):
    from agenda_tpu_torch.detect.configs import DatasetSpec, preset

    return preset(stage, detector, [DatasetSpec(root, ann, "")],
                  output_dir=os.path.join(root, f"fam_{detector}"))


_FAMILY_WEIGHTS = {}  # a family's model and seed -> its weights: phase 31's, reused by 33


def family_weights(cfg, seed: int = 0) -> dict:
    """A family's seeded init, batch-norm statistics measured on noise (a copy
    of the one made for the same detector and seed)."""
    import copy

    import torch

    from agenda_tpu_torch.detect.fabricate import calibrate_batch_norm

    key = (cfg.detector, repr(sorted(cfg.model.items())), cfg.img_scale, cfg.max_gt, seed)
    if key not in _FAMILY_WEIGHTS:
        fam = cfg.build_family()
        gen = torch.Generator().manual_seed(seed)
        state = fam.init_variables(gen)
        _FAMILY_WEIGHTS[key] = calibrate_batch_norm(
            fam, state, torch.rand(16, LABEL_IMG, LABEL_IMG, 3, generator=gen))
    return copy.deepcopy(_FAMILY_WEIGHTS[key])


def rel_l2(got: dict, want: dict, base: dict = None) -> float:
    """||got - want|| / ||want - base|| over all tensors (base 0: ||want||)."""
    num = den = 0.0
    for k, w in want.items():
        w = w.double()
        b = base[k].double() if base is not None else 0.0
        num += float((got[k].double() - w).square().sum())
        den += float((w - b).square().sum())
    return math.sqrt(num / max(den, 1e-300))


def family_step_on(dev, cfg, state: dict, batch: dict, targets=None, mode: str = "f32",
                   benchmark: bool = False) -> dict:
    """One train step of ``cfg``'s family through the runner's optimizer on
    ``dev`` from ``state`` (CPU tensors), update FAM_STEP, the samplers' and
    drop path's uniforms from a CPU generator on both sides; the two-stage
    families take ``targets`` (the CPU's RCNN targets) where given. Also
    predicts on ``state``. ``mode`` "tf32" is the control. In f32 cuDNN
    autotunes the batch's convolutions with ``benchmark``, else takes its
    heuristics. All on the CPU."""
    import torch

    from agenda_tpu_torch.detect import faster_rcnn
    from agenda_tpu_torch.detect.optim import make_optimizer
    from agenda_tpu_torch.detect.runner import DetectorRunner, batch_to_device, full_f32

    fam = cfg.build_family()
    runner = DetectorRunner(fam, cfg.runner, device=dev)
    opt = make_optimizer(cfg.runner, steps_per_epoch=FAM_STEP + 1, total_bs=FAM_BATCH)
    st = runner.init_train_state(opt, state)
    st.opt.count = FAM_STEP
    tb = batch_to_device(batch, dev)
    names = list(st.params)
    seen = {}
    real = faster_rcnn.rcnn_targets

    def rcnn_targets(*args, **kw):
        out = real(*args, **kw) if targets is None else tuple(t.to(dev) for t in targets)
        seen["targets"] = tuple(t.cpu() for t in out)
        return out

    arith = tf32_on() if mode == "tf32" else full_f32(dev, benchmark=benchmark)
    with arith, mock.patch.object(faster_rcnn, "rcnn_targets", rcnn_targets):
        boxes, scores, valid = fam.predict_fn(runner.variables_on_device(state), tb["image"])
        loss, parts, stats = fam.loss_fn({**st.params, **st.stats, **st.counters}, tb,
                                         torch.Generator().manual_seed(FAM_SEED))
        grads = torch.autograd.grad(loss, [st.params[k] for k in names])
        before = {k: v.detach().to("cpu", copy=True) for k, v in st.params.items()}
        opt.update(dict(zip(names, grads)), st.opt, st.params)
    return {"loss": loss.item(), "parts": {k: v.item() for k, v in parts.items()},
            "grads": {k: g.cpu() for k, g in zip(names, grads)},
            "old_stats": {k: v.to("cpu", copy=True) for k, v in st.stats.items()},
            "stats": {k: v.cpu() for k, v in stats.items()}, "before": before,
            "params": {k: v.detach().cpu() for k, v in st.params.items()},
            "targets": seen.get("targets"),
            "pred": [(boxes[i][valid[i]].cpu(), scores[i][valid[i]].cpu())
                     for i in range(valid.shape[0])]}


def match_boxes(boxes, scores, ref_boxes, ref_scores) -> int:
    """How many detections have no partner among the reference's with every
    corner within FAM_BOX_TOL px and |d score| <= DET_SCORE_TOL (one to one;
    by corners, not IoU: the two-stage families keep zero-area boxes at the
    image's edge, whose IoU with themselves is 0)."""
    ok = (((boxes[:, None, :] - ref_boxes[None, :, :]).abs().amax(-1) <= FAM_BOX_TOL)
          & ((scores[:, None] - ref_scores[None, :]).abs() <= DET_SCORE_TOL))
    free = [True] * len(ref_scores)
    unmatched = 0
    for row in ok.tolist():
        j = next((j for j, hit in enumerate(row) if hit and free[j]), None)
        if j is None:
            unmatched += 1
        else:
            free[j] = False
    return unmatched


def family_readings(side: dict, ref: dict) -> dict:
    return {"loss": abs(side["loss"] - ref["loss"]) / abs(ref["loss"]),
            "parts": max(abs(side["parts"][k] - ref["parts"][k]) / max(abs(ref["parts"][k]), 1e-6)
                         for k in ref["parts"]),
            "grads": rel_l2(side["grads"], ref["grads"]),
            "update": rel_l2(side["params"], ref["params"], ref["before"]),
            "stats": rel_l2(side["stats"], ref["stats"], ref["old_stats"]) if ref["stats"] else 0.0}


def family_parity(labels: dict, root: str, dev) -> dict:
    """Phase 31: for each family, one train step on FAM_BATCH host-augmented
    stacks (the real_source recipe) from seeded weights with measured
    batch-norm statistics, on the card and on the CPU (both f32): the loss
    and its parts, the gradients, the update and the batch statistics' move
    within FAM_LIMITS; the same with TF32 on beyond every limit; the
    predictions on those weights matched as phase 18's."""
    import torch

    cpu = torch.device("cpu")
    out = {}
    for det in FAMILIES:
        t0 = time.perf_counter()
        cfg = family_preset(root, labels["all"], det)
        limits = FAM_LIMITS[det]
        batch = det_first_batch(cfg, FAM_BATCH)
        state = family_weights(cfg)
        ref = family_step_on(cpu, cfg, state, batch)
        # cuDNN's plans for the batch are autotuned only where phases 32-33
        # train and label at it (FAM_SMALL_BATCH), which reuse them
        card = family_step_on(dev, cfg, state, batch, ref["targets"],
                              benchmark=det in FAM_SMALL_BATCH)
        control = family_step_on(dev, cfg, state, batch, ref["targets"], mode="tf32")
        sound, tf32 = family_readings(card, ref), family_readings(control, ref)
        kept = sum(len(s) for _, s in ref["pred"])
        unmatched = [(match_boxes(b, s, rb, rs), match_boxes(rb, rs, b, s))
                     for (b, s), (rb, rs) in zip(card["pred"], ref["pred"])]
        worst = max(max(u) / max(1, len(rs)) for u, (_, rs) in zip(unmatched, ref["pred"]))
        print(f"[fam-parity] {det}: train step at batch {FAM_BATCH}, {LABEL_IMG} px, update "
              f"{FAM_STEP} ({cfg.runner.optimizer}, lr {cfg.runner.lr}), loss {card['loss']:.6f} "
              f"vs {ref['loss']:.6f} (parts {ref['parts']}); limits {limits}; card (f32) "
              f"against the CPU: " + ", ".join(f"{k} {v:.3e}" for k, v in sound.items())
              + "; TF32 control: " + ", ".join(f"{k} {v:.3e}" for k, v in tf32.items())
              + f"; predictions: {kept} kept on the CPU, unmatched (card, CPU) {unmatched}, "
              f"worst share {worst:.4f} (limit {FAM_UNMATCHED_MAX}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        require(bool(ref["stats"]) == ("stats" in limits), f"{det}: batch-norm statistics")
        for k, limit in limits.items():
            require(sound[k] <= limit, f"{det}: the train step's {k} differs on the card: "
                    f"{sound[k]:.3e} > {limit}")
            require(tf32[k] > limit, f"{det}: the TF32 control passes the {k} limit ({limit})")
        require(kept > 0 and worst <= FAM_UNMATCHED_MAX, f"{det}: predictions differ")
        out[det] = {"sound": sound, "tf32": tf32, "limits": limits}
        torch.cuda.empty_cache()
    return out


def family_cli_phase(labels: dict, root: str, dev) -> dict:
    """Phase 32: cli/det_train --preset real_source --detector <family> on the
    card over the first FAM_CLI_TILES stacks of phase 22's split (as many
    to validate), at the preset's batch (padded past the stacks: YOLOv5's
    200; FAM_BATCH for FAM_SMALL_BATCH),
    --pretrained from a fabricated mmdet/mmyolo checkpoint with
    80-class COCO heads: the import report (every tensor but the heads
    imported, the heads shape-skipped, nothing unmatched), FAM_EPOCHS epochs
    with validation each, for FAM_RESUME's families a resume from
    latest.safetensors for one more, det_test on the validation set; Faster
    R-CNN once more with --device-aug for one epoch."""
    import pickle

    from agenda_tpu_torch.cli import det_test, det_train
    from agenda_tpu_torch.detect.fabricate import write_mm_checkpoint
    from agenda_tpu_torch.detect.runner import SIDECAR, DetectorRunner
    from agenda_tpu_torch.io.safetensors_io import load_file

    train_ann, val_ann = det_split(labels, root, FAM_CLI_TILES, FAM_CLI_TILES)
    checkpoints, out = {}, {}
    runs = [(det, ()) for det in FAMILIES] + [("faster-rcnn", ("--device-aug",))]
    for det, extra in runs:
        t0 = time.perf_counter()
        tag = det + ("-devaug" if extra else "")
        work = os.path.join(root, f"fam_cli_{tag}")
        pth = os.path.join(root, f"coco_{det}.pth")
        if det not in checkpoints:
            checkpoints[det] = write_mm_checkpoint(pth, det, seed=1)
        sd = checkpoints[det]
        heads = {k for k in sd if re.search(r"fc_cls|fc_reg|convs_pred", k)}
        expect = {k for k in sd if not k.endswith("num_batches_tracked")} - heads
        reports, runners = [], []
        train = DetectorRunner.train

        def spy(self, *args, **kw):
            runners.append(self)
            result = train(self, *args, **kw)
            reports.append(self.import_report)
            return result

        args = ["--preset", "real_source", "--detector", det, "--train-root", root,
                "--train-ann", train_ann, "--train-prefix", "", "--val-root", root,
                "--val-ann", val_ann, "--val-prefix", "", "--work-dir", work, "--pretrained", pth,
                "--device", dev.type, *extra]
        if det in FAM_SMALL_BATCH:
            args += ["--batch-size", str(FAM_BATCH)]
        epochs = 1 if extra else FAM_EPOCHS
        resume = not extra and det in FAM_RESUME
        with mock.patch.object(DetectorRunner, "train", spy):
            det_train.main(args + ["--max-epochs", str(epochs)])
            t_train = time.perf_counter() - t0
            if resume:
                det_train.main(args + ["--max-epochs", str(epochs + 1), "--resume",
                                       os.path.join(work, "latest.safetensors")])
        with open(os.path.join(work, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r for r in rows if "loss" in r]  # logged at steps 1, 2, 20, 40, ...
        vals = [r for r in rows if "bbox_mAP" in r]
        side = load_file(os.path.join(work, SIDECAR))
        bs = runners[0].cfg.batch_size
        n_steps = -(-FAM_CLI_TILES // bs) * (epochs + resume)
        recs = det_test.main(["--config", os.path.join(work, "config.json"), "--checkpoint",
                              os.path.join(work, "latest.safetensors"), "--test-root", root,
                              "--test-ann", val_ann, "--test-prefix", "", "--out",
                              os.path.join(work, "pred.pkl"), "--device", dev.type])
        with open(os.path.join(work, "pred.pkl"), "rb") as f:
            n_pkl = len(pickle.load(f))
        rep = reports[0]
        wall = time.perf_counter() - t0
        print(f"[fam-cli] {tag}: det_train real_source, batch {bs}, "
              f"--pretrained ({len(rep.imported)} tensors imported of {len(expect)} expected, "
              f"{len(rep.skipped_shape)} shape-skipped: {sorted(k for k, _, _ in rep.skipped_shape)}"
              f", {len(rep.unmatched)} unmatched, {len(rep.missing_target)} missing); "
              f"{int(side['gstep'])} steps to epoch {int(side['epoch'])} (sidecar), validations "
              f"after epochs {[r['epoch'] for r in vals]}, logged losses "
              f"{[round(r['loss'], 4) for r in steps]}; aug path {runners[0].aug_path}; "
              f"det_test {len(recs)} "
              f"records ({n_pkl} in the pkl); train {t_train:.1f} s, all {wall:.1f} s", flush=True)
        require(all(set(r.imported) == expect and {k for k, _, _ in r.skipped_shape} == heads
                    and not r.unmatched and not r.missing_target for r in reports),
                f"{tag}: the import report differs from the checkpoint's schema")
        require(all(math.isfinite(r["loss"]) for r in steps), f"{tag}: a loss is not finite")
        want_epochs = list(range(epochs + resume))
        require(int(side["gstep"]) == n_steps and int(side["epoch"]) == want_epochs[-1]
                and [r["epoch"] for r in vals] == want_epochs, f"{tag}: steps or validations")
        require(runners[0].aug_path == ("device" if extra else "host"), f"{tag}: aug path")
        require(len(recs) == n_pkl == FAM_CLI_TILES, f"{tag}: det_test records")
        out[tag] = {"steps": n_steps, "wall": wall, "train_s": t_train}
        shutil.rmtree(work)
    return out


def nms_counter():
    """Patches for the families' nms_images that count calls and ranks (two
    launches a rank in the rank loop)."""
    from agenda_tpu_torch.detect import faster_rcnn, ops, yolov5

    counts = {"calls": 0, "ranks": 0}
    real = ops.nms_images

    def counted(boxes, scores, *args, **kw):
        counts["calls"] += 1
        counts["ranks"] += scores.shape[1]
        return real(boxes, scores, *args, **kw)

    stack = contextlib.ExitStack()
    for mod in (faster_rcnn, yolov5):
        stack.enter_context(mock.patch.object(mod, "nms_images", counted))
    return stack, counts


def family_timing(labels: dict, root: str, dev) -> dict:
    """Phase 33: for each family at its real_source batch (FAM_BATCH for
    FAM_SMALL_BATCH): the train step (make_train_step, the batch on the
    card) cold and warm, images/s, peak memory, the card's busy share of a
    profiled step and its kernel launches, the NMS ranks and launches a
    step; then labelling FAM_LABEL_TILES stacks in one batch (batches of
    FAM_BATCH for FAM_SMALL_BATCH; DetectorRunner.test, PNG decode included,
    the second pass timed), its images/s and NMS launches a batch."""
    import numpy as np
    import torch

    from agenda_tpu_torch.detect.configs import DatasetSpec
    from agenda_tpu_torch.detect.optim import make_optimizer
    from agenda_tpu_torch.detect.runner import DetectorRunner, batch_to_device, full_f32

    out = {}
    for det in FAMILIES:
        t_fam = time.perf_counter()
        cfg = family_preset(root, labels["all"], det)
        state = family_weights(cfg)
        bs = FAM_BATCH if det in FAM_SMALL_BATCH else cfg.runner.batch_size
        base = det_first_batch(cfg, 64)
        batch = {k: np.concatenate([v] * -(-bs // 64))[:bs] for k, v in base.items()}
        runner = DetectorRunner(cfg.build_family(), cfg.runner, device=dev)
        opt = make_optimizer(cfg.runner, steps_per_epoch=1000, total_bs=bs)
        st = runner.init_train_state(opt, state)
        step = runner.make_train_step(opt)
        tb = batch_to_device(batch, dev)
        patches, nms = nms_counter()
        with full_f32(dev), patches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(st, tb, 0)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            walls = []
            for g in range(1, FAM_WARM + 1):
                nms.update(calls=0, ranks=0)
                t0 = time.perf_counter()
                step(st, tb, g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            warm = sum(walls) / len(walls)
            nms_step = dict(nms)  # the last warm step's
            per_name, wall = device_times(lambda: (step(st, tb, 9), torch.cuda.synchronize()))
        busy_ms = sum(us for us, _ in per_name.values()) / 1e3
        launches = sum(n for _, n in per_name.values())
        row = {"warm_s": warm, "images_per_s": bs / warm, "cold_s": cold, "peak": peak,
               "busy": busy_ms / (1e3 * wall), "busy_ms": busy_ms, "launches": launches,
               "nms_calls": nms_step["calls"], "nms_launches": 2 * nms_step["ranks"]}
        out[(det, bs)] = row
        print(f"[fam-timing] {det} real_source batch {bs}: step cold {cold:.3f} s, warm "
              + ", ".join(f"{w:.4f}" for w in walls) + f" -> {warm:.4f} s/step, "
              f"{bs / warm:.1f} images/s; peak {peak / 2**30:.2f} GiB; a profiled step: "
              f"device busy {busy_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
              f"({100 * row['busy']:.1f}%), {launches} kernel launches; NMS "
              f"{nms_step['calls']} calls, {nms_step['ranks']} ranks = "
              f"{2 * nms_step['ranks']} loop launches a step", flush=True)
        require(all(math.isfinite(w) for w in walls), f"{det}: step time")
        del st, tb, step, opt, runner
        torch.cuda.empty_cache()
        # labelling FAM_LABEL_TILES of the stacks in one batch (at FAM_BATCH for
        # FAM_SMALL_BATCH, the batch phase 32's det_test tunes)
        label_bs = FAM_BATCH if det in FAM_SMALL_BATCH else FAM_LABEL_TILES
        ds = cfg.build_eval_dataset(DatasetSpec(root, det_split(labels, root,
                                                                FAM_LABEL_TILES)[0], ""))
        runner = DetectorRunner(cfg.build_family(), cfg.runner, device=dev)
        patches, nms = nms_counter()
        with patches:
            runner.test(state, ds, batch_size=label_bs)  # cold
            nms.update(calls=0, ranks=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = runner.test(state, ds, batch_size=label_bs)
            wall = time.perf_counter() - t0
        n_batches = -(-len(ds) // label_bs)
        out[(det, "label")] = {"images_per_s": len(ds) / wall, "batch": label_bs,
                               "nms_launches": 2 * nms["ranks"] // n_batches}
        print(f"[fam-timing] {det} labelling {len(ds)} stacks at batch {label_bs}: "
              f"{len(ds) / wall:.1f} images/s warm (host clock, PNG decode included), NMS "
              f"{nms['calls'] // n_batches} calls and {2 * nms['ranks'] // n_batches} loop "
              f"launches a batch; {sum(len(r['pred_instances']['scores']) for r in recs)} "
              f"detections", flush=True)
        require(len(recs) == len(ds), f"{det}: labelling records")
        del runner
        torch.cuda.empty_cache()
        print(f"[parts] family timing {det}: {time.perf_counter() - t_fam:.1f} s", flush=True)
    return out


def family_phases(tmp: str, dev, phase_s: dict) -> dict:
    """Phases 31-34 over fresh heatmap stacks (phase 17's fabricator): the
    step card vs CPU, det_train/det_test with --pretrained, timing, and the
    chain with detector faster-rcnn."""
    import torch

    label_root = os.path.join(tmp, "fam_labels")
    labels = labels_fabricate(label_root)
    t_phase = settle("family parity (31)")
    parity = family_parity(labels, label_root, dev)
    phase_s["family parity (31)"] = time.perf_counter() - t_phase
    t_phase = settle("family det_train/det_test (32)")
    cli = family_cli_phase(labels, label_root, dev)
    phase_s["family det_train/det_test (32)"] = time.perf_counter() - t_phase
    t_phase = settle("family timing (33)")
    timing = family_timing(labels, label_root, dev)
    phase_s["family timing (33)"] = time.perf_counter() - t_phase
    shutil.rmtree(label_root)
    torch.cuda.empty_cache()
    t_phase = settle("chain with faster-rcnn (34)")
    chain = chain_phase(os.path.join(tmp, "chain_frcnn"), dev, "faster-rcnn")
    phase_s["chain with faster-rcnn (34)"] = time.perf_counter() - t_phase
    return {"parity": parity, "cli": cli, "timing": timing, "chain": chain}


def family_reports(fam: dict, card: str) -> None:
    for det, r in fam["parity"].items():
        print(f"[report] {det} train step card vs CPU at batch {FAM_BATCH} ({card}): "
              + ", ".join(f"{k} {r['sound'][k]:.3e} (TF32 control {r['tf32'][k]:.3e}, limit "
                          f"{limit})" for k, limit in r["limits"].items()), flush=True)
    for key, r in fam["timing"].items():
        det, what = key
        if what == "label":
            print(f"[report] {det} labelling at batch {r['batch']}, {LABEL_IMG} px ({card}): "
                  f"{r['images_per_s']:.1f} images/s, NMS {r['nms_launches']} loop launches a "
                  f"batch", flush=True)
        else:
            print(f"[report] {det} training at batch {what}, {LABEL_IMG} px ({card}): "
                  f"{r['warm_s']:.4f} s a step ({r['images_per_s']:.1f} images/s), card busy "
                  f"{100 * r['busy']:.1f}% of a profiled step, {r['launches']} kernel launches "
                  f"of which {r['nms_launches']} in the NMS rank loop, peak "
                  f"{r['peak'] / 2**30:.2f} GiB", flush=True)
    print(f"[report] det_train real_source with --pretrained ({card}): "
          + "; ".join(f"{tag} {r['steps']} steps, {r['train_s']:.1f} s" for tag, r
                      in fam["cli"].items())
          + f"; the chain with faster-rcnn in {fam['chain']['wall']:.1f} s. No TPU kernel lies "
          "on these families' path (the reference's ViTDet attention is attention_reference, "
          "agenda_tpu/detect/vitdet.py:40; its RoIAlign, NMS, assigners and losses are jnp, "
          "agenda_tpu/detect/ops.py:207)", flush=True)


def profile_report_phase(trace_dir: str, busy_ms: float) -> dict:
    """Phase 6's trace through cli/profile_report (utils/xprof.py): it exits
    0 and its categories sum to its busy ms within PROFILE_SUM_TOL (one
    stream: nothing overlaps); the profiler's own kernel sum is printed
    beside it."""
    import contextlib
    import io

    from agenda_tpu_torch.cli import profile_report
    from agenda_tpu_torch.utils import xprof

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_report.main([trace_dir, "--iters", "1", "--top", "8"])
    require(rc == 0, f"profile_report exited {rc}:\n{out.getvalue()}")
    rep = xprof.device_op_report(trace_dir, iters=1)
    total = sum(ms for _, ms in rep.by_category)
    print(f"[profile-report] plane {rep.plane}: busy {rep.total_ms:.2f} ms "
          f"({100 * rep.busy_share:.1f}% of the traced {rep.window_ms:.1f} ms), categories sum "
          f"to {total:.2f} ms ({100 * (total / rep.total_ms - 1):+.3f}%, limit "
          f"{100 * PROFILE_SUM_TOL:.0f}%); the profiler's own kernel sum {busy_ms:.2f} ms",
          flush=True)
    for line in out.getvalue().splitlines()[:14]:
        print(f"[profile-report] {line}", flush=True)
    require(abs(total - rep.total_ms) <= PROFILE_SUM_TOL * rep.total_ms,
            "the report's categories do not sum to its busy time")
    return {"busy_ms": rep.total_ms, "share": rep.busy_share,
            "top": rep.by_category[:5]}


def tgate_phase(pipe, model_dir: str, embeds: str, tmp: str, expected: dict,
                exact_warm_s: float) -> dict:
    """Phase 35: TGATE at the main path's size. The replay gate (one UNet
    call at 2B collecting the contributions, replayed, against the exact
    call); s/batch of the TGATE and the exact sampler through the API in
    turns; K1 and K6 launches a TGATE batch against the config's count (the
    exact path's: attn1 and every GroupNorm run on every call); the busy
    share of a profiled TGATE batch; the CLI with --tgate-step."""
    import torch

    from agenda_tpu_torch.cli import data_generation
    from agenda_tpu_torch.kernels.flash import flash_attention_fwd
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    dev, hw, b = pipe.device, pipe.latent_hw, E2E_BATCH
    g = torch.Generator(device=dev).manual_seed(35)
    x = torch.randn(2 * b, hw, hw, 4, device=dev, generator=g)
    t = torch.full((2 * b,), 500.0, device=dev)
    ctx = torch.randn(2 * b, 77, pipe.unet.config.cross_attention_dim, device=dev, generator=g)
    with torch.no_grad():
        exact, _ = pipe.unet(x, t, ctx)
        collected, _, cross = pipe.unet(x, t, ctx, collect_cross=True)
        replayed, _ = pipe.unet(x, t, ctx, cached_cross=cross)
    rms = exact.float().square().mean().sqrt().item()
    readings = {k: (v.float() - exact.float()).abs().max().item() / rms
                for k, v in (("collect", collected), ("replay", replayed))}
    print(f"[tgate] replay gate, one UNet call at batch {2 * b}: {len(cross)} cross-attention "
          f"contributions; max |d| / rms(exact eps) collecting {readings['collect']:.3g}, "
          f"replaying {readings['replay']:.3g} (limit {TGATE_REPLAY_TOL_RMS})", flush=True)
    require(len(cross) == 16, f"{len(cross)} cross-attention layers, SD-1.x has 16")
    require(all(r <= TGATE_REPLAY_TOL_RMS for r in readings.values()),
            "a replayed UNet call differs from the exact call")
    del exact, collected, replayed, cross

    seeds = list(range(b))
    kw = generate_kwargs()
    pipe.generate_async(PROFILE_PROMPT, seeds, tgate_step=TGATE_STEP, **kw)()  # cold
    walls = {"exact": [], "tgate": []}
    for kind in ("exact", "tgate", "tgate", "exact"):
        extra = {"tgate_step": TGATE_STEP} if kind == "tgate" else {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate_async(PROFILE_PROMPT, seeds, **kw, **extra)()
        walls[kind].append(time.perf_counter() - t0)
    warm = {k: sum(v) / len(v) for k, v in walls.items()}
    flash_attention_fwd.launches = group_norm_act.launches = 0
    images, maps = pipe.generate_async(PROFILE_PROMPT, seeds, tgate_step=TGATE_STEP, **kw)()
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "group_norm_act": group_norm_act.launches}
    print(f"[tgate] batch {b} at 512x512, {E2E_STEPS} PLMS steps, gate at step {TGATE_STEP} "
          f"({TGATE_STEP + 1} UNet calls at {2 * b}, {len(pipe.timestep_table(E2E_STEPS)) - TGATE_STEP - 1}"
          f" at {b}): TGATE {warm['tgate']:.4f} s/batch against the exact sampler's "
          f"{warm['exact']:.4f} s in turns ({100 * (1 - warm['tgate'] / warm['exact']):.1f}% "
          f"less; phase 2's exact warm batch {exact_warm_s:.4f} s); launches a batch "
          f"{launches} (the config's {expected})", flush=True)
    require(launches == expected, "TGATE's K1/K6 launches differ from the config's count")
    require(images.shape == (b, 112, 112, 3) and all(m.shape == (b, 112, 112)
                                                     for m in maps.values()),
            "TGATE outputs have the wrong shapes")
    busy_ms, _ = profile_run(
        lambda: pipe.generate_async(PROFILE_PROMPT, seeds, tgate_step=TGATE_STEP, **kw)(),
        "tgate-profile", f"TGATE batch {b}, gate at {TGATE_STEP}", warm["tgate"])

    save_dir = os.path.join(tmp, "tgate_out")
    flash_attention_fwd.launches = group_norm_act.launches = 0
    stats = data_generation.main([
        "--pretrained-model-path", model_dir, "--learnable-tokens-embedding-path", embeds,
        "--save-dir", save_dir, "--device", "cuda", *E2E_ARGS, "--tgate-step", str(TGATE_STEP)])
    torch.cuda.synchronize()
    cli = {"flash_attention_fwd": flash_attention_fwd.launches,
           "group_norm_act": group_norm_act.launches}
    want = {k: v * stats["batches"] for k, v in expected.items()}
    print(f"[tgate] CLI --tgate-step {TGATE_STEP}: {stats['batches']} batches, "
          f"{stats['seconds'] / stats['batches']:.3f} s/batch; launches {cli} (expected {want})",
          flush=True)
    require(cli == want, "the TGATE CLI's launch counts differ from the config's count")
    check_outputs(save_dir)
    shutil.rmtree(save_dir)
    return {"warm": warm, "busy_ms": busy_ms, "replay": readings, "launches": launches}


def vae_images(n: int, res: int, seed: int):
    """n smooth uint8 images (res x res): blocks of 8x8 noise upsampled."""
    import numpy as np

    low = np.random.default_rng(seed).uniform(0, 255, (n, 8, 8, 3))
    return np.kron(low, np.ones((1, res // 8, res // 8, 1))).astype(np.uint8)


def vae_state(model_dir: str):
    """(config, state dict on the host) of the pipeline's VAE."""
    from agenda_tpu_torch.io import diffusers_io as io
    from agenda_tpu_torch.io.configs import vae_config_from_json

    d = os.path.join(model_dir, "vae")
    state = io._read_tensor_file(os.path.join(d, "diffusion_pytorch_model"))
    return (vae_config_from_json(io._load_json(os.path.join(d, "config.json"))),
            io.rename_legacy_vae_keys(state))


def vae_pretrain_phase(cfg, state: dict, dev, dtype, steps: int, tag: str) -> dict:
    """Phases 36 (bf16) and 41 (f32): SD-1.4's VAE from ``state`` at VAE_RES px
    and VAE_BATCH, computing in ``dtype``: ``steps`` steps of
    make_vae_pretrain_step (each synchronised; the first two cold), the
    losses (finite, the reconstruction falling), the warm s/step, peak memory
    and the launches of the wide K1, K2, K3 and of K6 a step against the VAE's
    count (two mid-block attentions, one per GroupNorm module; the GroupNorm
    backward is the plain recompute), in f32 each an f32 kernel's (the
    pre-pass once a forward and once a backward); then pretrain_vae end to end and its
    scaling_factor. The peak is the phase's own: above what was held before."""
    import numpy as np
    import torch

    from agenda_tpu_torch.kernels import flash as fl
    from agenda_tpu_torch.models.layers import GroupNormAct, VAEAttention
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train import vae_pretrain as vp
    from agenda_tpu_torch.train.optim import make_adam

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what earlier phases left
    vae = AutoencoderKL(cfg)
    vae.load_state_dict(state, strict=True)
    vae.to(dev)
    images = vae_images(VAE_IMAGES, VAE_RES, 36)
    pixels = images.astype(np.float32) / 127.5 - 1.0
    tx = make_adam(VAE_LR)
    opt_state = tx.init(dict(vae.named_parameters()))
    step = vp.make_vae_pretrain_step(vae, tx, kl_weight=1e-4, dtype=dtype)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = vp.latent_shape(vae, VAE_BATCH, VAE_RES, VAE_RES)
    want = {"flash_attention_fwd": 2, "flash_attention_fwd_wide": 2,
            "flash_attention_bwd_dkv": 2, "flash_attention_bwd_dq": 2,
            "group_norm_act": sum(isinstance(m, GroupNormAct) for m in vae.modules())}
    wrappers = {"flash_attention_fwd": fl.flash_attention_fwd,
                "flash_attention_bwd_dkv": fl.flash_attention_bwd_dkv,
                "flash_attention_bwd_dq": fl.flash_attention_bwd_dq}
    f32 = dtype == torch.float32
    if f32:  # every launch an f32 kernel's, the backward's wide ones too
        want.update({f"{k} f32": want[k] for k in (*wrappers, "group_norm_act")})
        want.update({"flash_attention_bwd_dkv_wide": 2, "flash_attention_bwd_dq_wide": 2,
                     # the pre-pass: one launch a forward and one a backward (its dK/dV
                     # and dQ share the pieces)
                     "flash_f32_split": 2 + 2, **{k: 4 for k in WIDE_F32_PASSES}})
    require(sum(isinstance(m, VAEAttention) for m in vae.modules()) == 2,
            "the VAE should have two mid-block attentions")

    def counts() -> dict:
        c = {k: v for k, v in read_counts().items() if k in want}
        if f32:
            c.update({f"{k} f32": v for k, (_, v) in all_f32(read_counts()).items()})
            c.update({f"{k}_wide": wrappers[k].launches_wide
                      for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")})
            c["flash_f32_split"] = fl.flash_f32_split.launches
            c.update({k: getattr(fl, k).launches for k in WIDE_F32_PASSES})
        return c

    losses, walls, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = torch.from_numpy(pixels[rng.randint(0, len(pixels), VAE_BATCH)]).to(dev)
        eps = torch.randn(shape, generator=gen, device=dev)
        reset_all_counts()
        t0 = time.perf_counter()
        m = step(opt_state, batch, eps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(counts())
        losses.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() - held
    warm = sum(walls[2:]) / len(walls[2:])
    print(f"[{tag}] SD-1.4 VAE {tuple(cfg.block_out_channels)} at {VAE_RES} px, batch "
          f"{VAE_BATCH}, {dtype}, Adam lr {VAE_LR}: steps " + ", ".join(
              f"{w:.4f}" for w in walls) + f" s -> warm {warm:.4f} s/step "
          f"({VAE_BATCH / warm:.1f} images/s); peak {peak / 2**30:.2f} GiB (its own)", flush=True)
    print(f"[{tag}] recon " + ", ".join(f"{x['recon']:.5f}" for x in losses) + "; kl " + ", ".join(
        f"{x['kl']:.3f}" for x in losses), flush=True)
    print(f"[{tag}] launches a step {launches[-1]} (expected {want})", flush=True)
    require(all(math.isfinite(v) for x in losses for v in x.values()), "VAE losses not finite")
    require(losses[-1]["recon"] < losses[0]["recon"], "the VAE's reconstruction did not fall")
    require(all(c == want for c in launches), f"VAE step launches {launches} differ from {want}")

    t0 = time.perf_counter()
    _, scale, recon = vp.pretrain_vae(vae, images, steps=2, batch_size=VAE_BATCH, lr=VAE_LR,
                                      seed=1, dtype=dtype)
    torch.cuda.synchronize()
    print(f"[{tag}] pretrain_vae(dtype={dtype}), 2 steps over {VAE_IMAGES} images: "
          f"scaling_factor {scale:.5f}, recon {recon:.5f} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    require(math.isfinite(scale) and scale > 0 and math.isfinite(recon),
            "pretrain_vae's scaling_factor or recon is not finite")
    del vae, opt_state, step
    torch.cuda.empty_cache()
    return {"warm_s": warm, "peak": peak, "losses": losses, "scale": scale,
            "launches": launches[-1]}


def vae_f32_step(dev, cfg, state: dict, pixels, eps) -> Tuple[float, dict]:
    """One f32 make_vae_pretrain_step on ``dev`` from ``state`` -> (loss, the
    gradients by name on the host, read from Adam's first moment)."""
    import torch

    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train.optim import make_adam
    from agenda_tpu_torch.train.vae_pretrain import make_vae_pretrain_step

    vae = AutoencoderKL(cfg)
    vae.load_state_dict(state, strict=True)
    vae.to(dev)
    tx = make_adam(VAE_LR)
    opt_state = tx.init(dict(vae.named_parameters()))
    m = make_vae_pretrain_step(vae, tx, 1e-2, torch.float32)(opt_state, pixels.to(dev),
                                                              eps.to(dev))
    return float(m["loss"]), {k: (v / 0.1).cpu() for k, v in opt_state.mu.items()}


def vae_f32_parity(cfg, state: dict, dev) -> dict:
    """Phase 41's f32 step, card against CPU, and its control (the wide f32
    dK/dV and dQ zeroed): (loss, gradients) relative readings."""
    import torch

    from agenda_tpu_torch.kernels import flash as fl

    g = torch.Generator().manual_seed(41)
    res = VAE_F32_PARITY_RES
    pixels = torch.rand(2, res, res, 3, generator=g) * 2 - 1
    f = 2 ** (len(cfg.block_out_channels) - 1)
    eps = torch.randn(2, res // f, res // f, cfg.latent_channels, generator=g)
    ref = vae_f32_step(torch.device("cpu"), cfg, state, pixels, eps)
    top = max(float(v.norm()) for v in ref[1].values())

    def readings(side):
        grads = max(float((side[1][k] - v).norm() / v.norm()) for k, v in ref[1].items()
                    if float(v.norm()) > VAE_NULL_GRAD * top)
        return abs(side[0] - ref[0]) / abs(ref[0]), grads

    before = (fl.flash_attention_bwd_dkv.launches_wide, fl.flash_attention_bwd_dq.launches_wide)
    sound = readings(vae_f32_step(dev, cfg, state, pixels, eps))
    wide = (fl.flash_attention_bwd_dkv.launches_wide - before[0],
            fl.flash_attention_bwd_dq.launches_wide - before[1])
    with mock.patch.object(fl, "flash_attention_bwd_dkv",
                           lambda q, *a: (torch.zeros_like(q), torch.zeros_like(q))), \
            mock.patch.object(fl, "flash_attention_bwd_dq", lambda q, *a: torch.zeros_like(q)):
        control = readings(vae_f32_step(dev, cfg, state, pixels, eps))
    print(f"[vae f32] step card vs CPU at {res} px, batch 2 (mid-block attention S = "
          f"{(res // f) ** 2}, D = {cfg.block_out_channels[-1]}; wide f32 launches {wide}): loss "
          f"{sound[0]:.3g} (limit {VAE_F32_LOSS_RTOL}), gradients {sound[1]:.3g} relative L2 "
          f"(limit {VAE_F32_GRAD_TOL}); control without the attention's gradient: loss "
          f"{control[0]:.3g}, gradients {control[1]:.3g}", flush=True)
    require(wide == (2, 2), f"the f32 VAE step's wide backward launches {wide}, not (2, 2)")
    require(sound[0] <= VAE_F32_LOSS_RTOL and sound[1] <= VAE_F32_GRAD_TOL,
            f"the f32 VAE step on the card differs from the CPU's: {sound}")
    require(control[1] > VAE_F32_GRAD_TOL, f"the control passes the gradient limit: {control}")
    return {"sound": sound, "control": control}


# phase 38: two ranks on the one card, over gloo (NCCL refuses two ranks on one
# device), so no speed of NCCL or of several cards is measured here. Generation
# at batch 1 a rank against phase 5's batch 2: a bf16 convolution takes another
# algorithm at another batch, and 20 steps carry that rounding into the images
# and maps, so each PNG's mean |d| stays within MR_PNG_MEAN_TOL levels. The SD
# step at batch 2 a rank (global 4, --fsdp 2, fused int8 AdamW + EMA) against one
# process over the same global batch and draws: step 1 moves an element by about
# lr sign(g), and where a gradient within bf16 noise of 0 takes the other sign
# the two updates differ by up to 2 lr; compared in units of lr / MR_UPDATE_UNIT
# (int8 codes), at most MR_FLIP_SHARE of the elements differ by more than lr / 4
# and none by more than 2 lr; the loss and the global gradient norm within
# MR_LOSS_RTOL; the gathered EMA equal to its blend of the old and new weights
# within MR_EMA_TOL; each rank's peak memory below the one-process peak at the
# same batch by at least MR_SAVED_SHARE of the optimizer state and EMA it does
# not hold. det_test split over the ranks against phase 19's records as phase 18
# holds the card against the CPU.
MR_WORLD, MR_LR, MR_UPDATE_UNIT, MR_SEED, MR_DEADLINE_S = 2, 1e-4, 32, 38, 420
MR_PNG_MEAN_TOL, MR_FLIP_SHARE, MR_LOSS_RTOL, MR_EMA_TOL, MR_SAVED_SHARE = 3.0, 0.02, 2e-2, 1e-6, 0.6

# phase 39: the host libraries (utils/host_build.py) and the bench's stack
# labeler. The committed fixtures (tests/data/images, written by
# scripts/make_image_fixtures.py) hold the decode to the JAX package's
# libpng/libjpeg decode of them: bit for bit where the decode builds
# (HOST_DECODE_TOL levels). Without the libpng/libjpeg headers the decode
# does not build; a JPEG, or a PNG form utils/png.py refuses, must then raise
# naming the missing library. The labelling decode is timed over
# HOST_DECODE_TILES of phase 17's stacks and HOST_DECODE_REPS reads of the
# 512-px Pillow-written fixture; the matchers over HOST_MATCH_IMAGES seeded
# images (HOST_MATCH_DETS detections, HOST_MATCH_GTS ground truths each).
HOST_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             "images")
HOST_DECODE_TOL, HOST_DECODE_TILES, HOST_DECODE_REPS = 0, 64, 3
HOST_MATCH_IMAGES, HOST_MATCH_DETS, HOST_MATCH_GTS = 400, 30, 5
# the labeler's own 30 epochs cut to 10 to pay for phase 40: JAX on a CPU reached
# AP 1.000 at 30 epochs, the port on a CPU at 10 and at 15
LABELER_EPOCHS, LABELER_AP_MIN = 10, 0.9


def update_codes(params: dict, before: dict, dev):
    """Every parameter's move from ``before`` in units of MR_LR / MR_UPDATE_UNIT
    (clamped to +-3.9 lr), int8, flat, on the host, in ``params``' order."""
    import torch

    out = []
    for k, p in params.items():
        d = p.detach().float() - before[k].to(dev, torch.float32)
        q = torch.round(torch.clamp(d / MR_LR, -3.9, 3.9) * MR_UPDATE_UNIT)
        out.append(q.to(torch.int8).reshape(-1).cpu())
    return torch.cat(out)


def held_bytes(state) -> int:
    """The optimizer state's and the EMA's bytes on this process."""
    from agenda_tpu_torch.train.optim import _Quantized

    n = 0
    for part in (state.opt_state.mu, state.opt_state.nu):
        for m in part.values():
            ts = (m.q, m.scale) if isinstance(m, _Quantized) else (m,)
            n += sum(t.numel() * t.element_size() for t in ts)
    return n + sum(e.numel() * e.element_size() for e in state.ema.params.values())


def multirank_reference(model_dir: str, vae_cfg, dev, tmp: str) -> dict:
    """Phase 38's one-process side: the SD step over the global batch of
    TRAIN_BATCH (its batch and draws saved for the ranks), the update codes,
    the peak memory, then a step at a rank's batch for its peak (both above
    what the process held before, as a rank's are)."""
    import numpy as np
    import torch

    from agenda_tpu_torch.io.diffusers_io import load_unet
    from agenda_tpu_torch.train.finetune_sd import LossConfig, StepDraws, make_draws

    base = torch.cuda.memory_allocated()  # what earlier phases left allocated
    unet, make, vocab = build_trainer(model_dir, dev, lr=MR_LR)
    state, step = make(True)
    batch = synthetic_batch(vae_cfg, vocab, dev, MR_SEED)
    shape = tuple(batch["latent_moments"].shape[:-1]) + (vae_cfg.latent_channels,)
    draws = make_draws(torch_generator(dev, MR_SEED), shape, 1000, LossConfig(snr_gamma=5.0),
                       dev)
    fields = {"latent_eps": draws.latent_eps, "noise": draws.noise,
              "timesteps": draws.timesteps}
    paths = {"batch": os.path.join(tmp, "mr_batch.pt"), "codes": os.path.join(tmp, "mr_codes.npy")}
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                "draws": {k: v.cpu() for k, v in fields.items()}}, paths["batch"] + ".part")
    os.replace(paths["batch"] + ".part", paths["batch"])  # the ranks wait for it
    before = load_unet(model_dir)[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, m = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    out = {"peak_global": torch.cuda.max_memory_allocated() - base, "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]), "held": held_bytes(state), "paths": paths}
    np.save(paths["codes"] + ".part.npy", update_codes(state.params, before, dev).numpy())
    os.replace(paths["codes"] + ".part.npy", paths["codes"])
    half = TRAIN_BATCH // MR_WORLD
    torch.cuda.reset_peak_memory_stats()
    step(state, {k: v[:half] for k, v in batch.items()},
         draws=StepDraws(**{k: v[:half] for k, v in fields.items()}))
    torch.cuda.synchronize()
    out["peak_rank_batch"] = torch.cuda.max_memory_allocated() - base
    del unet, make, state, step, batch, draws, before
    torch.cuda.empty_cache()
    return out


def mr_rank_work(job: dict) -> dict:
    """One rank of phase 38: the generation CLI split over the ranks, the SD
    step at --fsdp 2 on this rank's rows, det_test split over the ranks."""
    import gc

    import numpy as np
    import torch

    from agenda_tpu_torch.cli import data_generation, det_test
    from agenda_tpu_torch.io.diffusers_io import load_unet
    from agenda_tpu_torch.parallel.mesh import make_mesh
    from agenda_tpu_torch.train.checkpoint import full_ema
    from agenda_tpu_torch.train.finetune_sd import StepDraws

    parts = {"start": time.time() - job["spawned"]}  # the spawn and the imports
    mesh = make_mesh(fsdp=MR_WORLD, device="cuda", backend="gloo", timeout_s=MR_DEADLINE_S)
    dev = mesh.device
    out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend, "device": str(dev),
           "mesh": mesh.shape, "parts": parts}
    # (a) generation, batch 1 a rank
    reset_counts()
    t0 = time.perf_counter()
    stats = data_generation.main(job["gen_argv"])
    torch.cuda.synchronize()
    c = read_counts()
    out["gen"] = {"batches": stats["batches"], "seconds": time.perf_counter() - t0,
                  "launches": {k: c[k] for k in ("flash_attention_fwd", "flash_attention_fwd_wide",
                                                 "group_norm_act")}}
    parts["gen"] = out["gen"]["seconds"]
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the SD step at --fsdp 2: this rank's rows of the global batch and draws,
    # which the parent's one-process step (run meanwhile) saves
    t0 = time.perf_counter()
    while not (os.path.exists(job["batch"]) and os.path.exists(job["codes"])):
        require(time.perf_counter() - t0 < MR_DEADLINE_S, "phase 38: no reference step")
        time.sleep(0.2)
    parts["wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    saved = torch.load(job["batch"])
    rows = mesh.rows(TRAIN_BATCH)
    base = torch.cuda.memory_allocated()
    unet, make, _ = build_trainer(job["model_dir"], dev, lr=MR_LR, mesh=mesh)
    state, step = make(True)
    batch = {k: v[rows].to(dev) for k, v in saved["batch"].items()}
    draws = StepDraws(**{k: v[rows].to(dev) for k, v in saved["draws"].items()})
    before = load_unet(job["model_dir"])[1] if mesh.is_main else None
    parts["trainer"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    _, m = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    out.update(step_s=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated() - base,
               launches=read_counts(), loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               held=held_bytes(state), sharded=len(state.shard.sharded))
    ema = full_ema(state)  # every rank takes part in the gather
    if mesh.is_main:
        codes = update_codes(state.params, before, dev).numpy().astype(np.int16)
        diff = np.abs(codes - np.load(job["codes"]).astype(np.int16))
        out["flip_share"] = float((diff > MR_UPDATE_UNIT // 4).mean())
        out["worst"] = int(diff.max())
        decay = 2.0 / 11.0  # ema_decay_at at the first update
        out["ema_err"] = max(float((ema[k] - (decay * before[k].to(dev, torch.float32)
                                              + (1 - decay) * p.detach())).abs().max())
                             for k, p in state.params.items())
    del unet, make, state, step, ema, before
    gc.collect()
    torch.cuda.empty_cache()
    parts["step"] = time.perf_counter() - t0 - parts["trainer"]
    # (c) det_test, each batch split over the ranks
    t0 = time.perf_counter()
    out["det_records"] = len(det_test.main(job["det_argv"]))
    parts["det_test"] = time.perf_counter() - t0
    return out


def mr_rank(rank: int, port: int, job: dict, path: str) -> None:
    """Phase 38's spawned rank: torchrun's environment (both ranks on card 0),
    its work, its result or its error written to ``path``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(MR_WORLD), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        res = {"ok": mr_rank_work(job)}
    except BaseException:
        import traceback

        res = {"error": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(res, f)
    if "error" in res:
        sys.exit(1)


def png_mean_diffs(got_dir: str, want_dir: str) -> dict:
    """mean |d| of each PNG of ``got_dir``'s tree against ``want_dir``'s."""
    import numpy as np

    from agenda_tpu_torch.utils.png import read_png

    out = {}
    for sub in sorted(os.listdir(got_dir)):
        for name in sorted(os.listdir(os.path.join(got_dir, sub))):
            a = read_png(os.path.join(got_dir, sub, name)).astype(np.float64)
            b = read_png(os.path.join(want_dir, sub, name)).astype(np.float64)
            out[f"{sub}/{name}"] = float(np.abs(a - b).mean())
    return out


def multirank_phase(model_dir: str, embeds: str, gen_dir: str, labels: dict, label_root: str,
                    expected: dict, unet_cfg, vae_cfg, dev, tmp: str) -> dict:
    """Phase 38: two ranks spawned on the card with explicit gloo: the
    generation CLI at batch 1 a rank against phase 5's output, the SD step at
    --fsdp 2 against one process's (peak memory, launches, update codes), and
    det_test split over the ranks against phase 19's records."""
    import socket

    import torch

    from agenda_tpu_torch.annotate.records import load_predictions

    texp = train_expected(unet_cfg, vae_cfg)
    gen_w2 = os.path.join(tmp, "out_w2")
    gen_args = list(E2E_ARGS)  # phase 5's first batch: its 2 seeds, 1 a rank
    gen_args[gen_args.index("--batch-size") + 1] = str(E2E_BATCH // MR_WORLD)
    gen_args[gen_args.index("--num-images") + 1] = str(E2E_BATCH)
    config, ckpt = labels["ckpts"]["yolov8"]
    pred_w2 = os.path.join(label_root, "pred_real_w2.pkl")
    job = {"model_dir": model_dir, "batch": os.path.join(tmp, "mr_batch.pt"),
           "codes": os.path.join(tmp, "mr_codes.npy"), "spawned": time.time(),
           "gen_argv": ["--pretrained-model-path", model_dir, "--learnable-tokens-embedding-path",
                        embeds, "--save-dir", gen_w2, "--device", "cuda", "--dist-backend", "gloo",
                        *gen_args],
           "det_argv": ["--config", config, "--checkpoint", ckpt, "--test-prefix",
                        "daam_stack_heatmaps/", "--test-root", labels["gt"], "--test-ann",
                        "ann.json", "--out", pred_w2, "--device", "cuda", "--dist-backend",
                        "gloo"]}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    paths = [os.path.join(tmp, f"mr_rank{r}.json") for r in range(MR_WORLD)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mr_rank, args=(r, port, job, paths[r])) for r in range(MR_WORLD)]
    for p in procs:
        p.start()
    try:  # the one-process step while the ranks import and generate
        t_ref = time.perf_counter()
        ref = multirank_reference(model_dir, vae_cfg, dev, tmp)
        t_ref = time.perf_counter() - t_ref
        require(ref["paths"] == {"batch": job["batch"], "codes": job["codes"]},
                "phase 38: the reference's files")
        for p in procs:
            p.join(max(1.0, MR_DEADLINE_S - (time.perf_counter() - t0)))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    ranks = []
    for r, path in enumerate(paths):
        res = json.load(open(path)) if os.path.exists(path) else {"error": "no result written"}
        if "error" in res:
            print(f"[multi-rank] rank {r} failed:\n{res['error']}", flush=True)
        ranks.append(res.get("ok"))
    require(not hung and all(p.exitcode == 0 for p in procs) and all(ranks),
            f"phase 38: ranks hung {len(hung)}, exit codes {[p.exitcode for p in procs]}")
    r0 = ranks[0]
    print(f"[parts] multi-rank: one-process reference {t_ref:.1f} s beside the ranks; a rank's "
          "parts " + "; ".join(", ".join(f"{k} {v:.1f}" for k, v in r["parts"].items())
                               for r in ranks) + " s", flush=True)
    # (a) generation
    n_batches = ranks[0]["gen"]["batches"]
    want_gen = {"flash_attention_fwd": expected["flash_attention_fwd"] * n_batches,
                "flash_attention_fwd_wide": n_batches,
                "group_norm_act": expected["group_norm_act"] * n_batches}
    diffs = png_mean_diffs(gen_w2, gen_dir)
    worst_png = max(diffs.items(), key=lambda kv: kv[1])
    print(f"[multi-rank] {MR_WORLD} ranks on {r0['device']} over {r0['backend']} (world "
          f"{r0['world']}, mesh {r0['mesh']}), {wall:.1f} s with the spawn: generation CLI at "
          f"batch {E2E_BATCH // MR_WORLD} a rank, {n_batches} global batches of {E2E_BATCH}: "
          f"{[round(r['gen']['seconds'], 2) for r in ranks]} s; launches a rank "
          f"{[r['gen']['launches'] for r in ranks]} (expected {want_gen}); {len(diffs)} PNGs "
          f"against phase 5's batch {E2E_BATCH}: mean |d| {sum(diffs.values()) / len(diffs):.3f} "
          f"levels, the worst {worst_png[0]} {worst_png[1]:.3f} (limit {MR_PNG_MEAN_TOL})",
          flush=True)
    require(all(r["gen"]["launches"] == want_gen for r in ranks),
            "phase 38: a rank's generation launches differ from the config's")
    require(len(diffs) == E2E_BATCH * (1 + len(E2E_WORDS)) and n_batches == 1
            and worst_png[1] <= MR_PNG_MEAN_TOL, "phase 38: the split generation's files")
    # (b) the SD step at --fsdp 2
    step_want = {k: 0 for k in train_counters()}
    step_want.update({"flash_attention_fwd": texp["flash_per_step"],
                      "flash_attention_bwd_dkv": texp["flash_per_step"],
                      "flash_attention_bwd_dq": texp["flash_per_step"],
                      "fused_adamw8bit_ema": texp["adamw_per_step"],
                      "fused_adamw8bit_leaves_ema": texp["quantized"],
                      "group_norm_act": texp["gn_per_step"]})
    saved = [ref["held"] - r["held"] for r in ranks]
    print(f"[multi-rank] SD step at batch {TRAIN_BATCH // MR_WORLD} a rank (global {TRAIN_BATCH}, "
          f"{TRAIN_RES}x{TRAIN_RES}, --fsdp {MR_WORLD}: {r0['sharded']} leaves in block runs), "
          f"fused int8 AdamW + EMA at lr {MR_LR}: loss {[r['loss'] for r in ranks]} against one "
          f"process's {ref['loss']}, grad norm {[r['grad_norm'] for r in ranks]} against "
          f"{ref['grad_norm']}; updates differing by more than lr/4: "
          f"{100 * r0['flip_share']:.4f}% (limit {100 * MR_FLIP_SHARE}%), the worst by "
          f"{r0['worst'] / MR_UPDATE_UNIT:.3f} lr (limit 2); gathered EMA against its blend "
          f"{r0['ema_err']:.2e} (limit {MR_EMA_TOL}); peak memory a rank "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB against one process's "
          f"{ref['peak_rank_batch'] / 2**30:.2f} GiB at batch {TRAIN_BATCH // MR_WORLD} "
          f"({ref['peak_global'] / 2**30:.2f} at {TRAIN_BATCH}); optimizer state + EMA held "
          f"{[round(r['held'] / 2**30, 3) for r in ranks]} GiB against {ref['held'] / 2**30:.3f}; "
          f"a rank's step {[round(r['step_s'], 2) for r in ranks]} s (two ranks share the card "
          f"over gloo: context, not a multi-card speed); launches a rank "
          f"{[r['launches'] for r in ranks]} (expected {step_want})", flush=True)
    require(all(r["launches"] == step_want for r in ranks),
            "phase 38: a rank's training-step launches differ from the config's")
    require(all(abs(r["loss"] - ref["loss"]) <= MR_LOSS_RTOL * abs(ref["loss"])
                and abs(r["grad_norm"] - ref["grad_norm"]) <= MR_LOSS_RTOL * ref["grad_norm"]
                for r in ranks), "phase 38: the loss or the gradient norm")
    require(r0["flip_share"] <= MR_FLIP_SHARE and r0["worst"] <= 2 * MR_UPDATE_UNIT + 1
            and r0["ema_err"] <= MR_EMA_TOL, "phase 38: the update or the EMA")
    require(all(ref["peak_rank_batch"] - r["peak"] >= MR_SAVED_SHARE * s
                for r, s in zip(ranks, saved)) and min(saved) > 0.4 * ref["held"],
            "phase 38: a rank's peak memory is not below one process's by the state it "
            "does not hold")
    # (c) det_test split over the ranks
    import torch as _torch

    got, want = load_predictions(pred_w2), load_predictions(
        os.path.join(label_root, "pred_real.pkl"))
    kept = ref_kept = unmatched = ref_unmatched = 0
    same = len(got) == len(want) and all(a["img_path"] == b["img_path"]
                                         for a, b in zip(got, want))
    for a, b in zip(got, want):
        pa, pb = a["pred_instances"], b["pred_instances"]
        u, ru = unmatched_both(*(_torch.from_numpy(p[k]) for p in (pa, pb)
                                 for k in ("bboxes", "scores")))
        kept, ref_kept = kept + len(pa["scores"]), ref_kept + len(pb["scores"])
        unmatched, ref_unmatched = unmatched + u, ref_unmatched + ru
    share = max(unmatched / max(kept, 1), ref_unmatched / max(ref_kept, 1))
    print(f"[multi-rank] det_test over {len(got)} stacks at batch {LABEL_BATCH} split over the "
          f"ranks: records in phase 19's order {same}; kept {kept} against {ref_kept}, "
          f"{unmatched} and {ref_unmatched} without a partner ({100 * share:.2f}%, limit "
          f"{100 * DET_UNMATCHED_MAX:.0f}%)", flush=True)
    require(same and [r["det_records"] for r in ranks] == [len(want)] * MR_WORLD
            and kept > 0 and share <= DET_UNMATCHED_MAX, "phase 38: det_test's records")
    shutil.rmtree(gen_w2)
    for path in list(ref["paths"].values()) + paths:
        os.remove(path)
    return {"ranks": ranks, "ref": ref, "png_worst": worst_png[1], "wall": wall}



def host_fixture_pairs():
    """(file, expected pixels .npy) of every committed decode fixture."""
    out = []
    for npy in sorted(f for f in os.listdir(HOST_FIXTURES) if f.endswith(".npy")):
        stem = npy[:-4]
        ext = ".jpg" if stem.startswith("jpeg") else ".png"
        out.append((os.path.join(HOST_FIXTURES, stem + ext), os.path.join(HOST_FIXTURES, npy)))
    return out


def host_phase(labels: dict, tmp: str) -> dict:
    """Phase 39: build both host libraries; the committed fixtures through the
    decode (or, without its headers, the raise that names the missing
    library); the labelling decode a tile, native against utils/png.py; the
    procedural domain; the stack labeler at LABELER_EPOCHS on the card, then from
    its cache; the box matchers, native against numpy."""
    import numpy as np
    import torch

    from agenda_tpu_torch.annotate.threshold import match_per_gt_reference
    from agenda_tpu_torch.data import native_image
    from agenda_tpu_torch.detect import bench_labeler, native
    from agenda_tpu_torch.detect.coco_eval import _match_image
    from agenda_tpu_torch.io.procedural import make_heatmap_domain
    from agenda_tpu_torch.utils import host_build
    from agenda_tpu_torch.utils.png import read_png, read_rgb

    out = {}
    host = host_build.load("host")
    out["host_build_s"] = host.build_seconds
    try:
        codecs = host_build.load("codecs")
        out["codecs"] = f"built in {codecs.build_seconds:.2f} s"
    except host_build.MissingHeaders as e:
        codecs = None
        out["codecs"] = f"not built: {e}"
    print(f"[host] host library {os.path.basename(host.path)} built in "
          f"{host.build_seconds:.2f} s; decode library {out['codecs']}", flush=True)

    worst, raised = 0, []
    pairs = host_fixture_pairs()
    for path, npy in pairs:
        want = np.load(npy)
        name = os.path.basename(path)
        try:
            got = native_image.load_rgb(path)
        except ValueError as e:
            need = "libjpeg" if name.startswith("jpeg") else "libpng"
            require(codecs is None and need in str(e),
                    f"phase 39: {name} raised without naming {need}: {e}")
            raised.append(name)
            continue
        require(got.shape == want.shape, f"phase 39: {name} decodes to {got.shape}")
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
    require(worst <= HOST_DECODE_TOL, f"phase 39: a fixture decodes {worst} levels off")
    out["fixtures"] = {"max_abs": worst, "raised": raised,
                       "decoded": len(pairs) - len(raised)}
    print(f"[host] fixtures: {out['fixtures']['decoded']} decoded, max |d| {worst} levels "
          f"(tolerance {HOST_DECODE_TOL}); raised naming the missing library: "
          f"{raised or 'none'}", flush=True)

    def per_read_ms(fn, paths):
        t0 = time.perf_counter()
        for p in paths:
            fn(p)
        return (time.perf_counter() - t0) * 1e3 / len(paths)

    stack_dir = os.path.join(labels["gt"], "daam_stack_heatmaps")
    stacks = [os.path.join(stack_dir, f) for f in sorted(os.listdir(stack_dir))][
        :HOST_DECODE_TILES]
    tile = os.path.join(HOST_FIXTURES, "png_tile_512.png")
    for p in (stacks[0], tile):
        require(np.array_equal(native_image.load_rgb(p), read_rgb(p)),
                f"phase 39: {os.path.basename(p)}: load_rgb differs from utils/png.py")
    decode = {"stack_python_ms": per_read_ms(read_rgb, stacks),
              "tile_python_ms": per_read_ms(read_rgb, [tile] * HOST_DECODE_REPS)}
    if codecs is not None:
        decode["stack_native_ms"] = per_read_ms(native_image.load_rgb, stacks)
        decode["tile_native_ms"] = per_read_ms(native_image.load_rgb, [tile] * HOST_DECODE_REPS)
    out["decode"] = decode
    print(f"[host] labelling decode a tile: {len(stacks)} of phase 17's {TILE}-px stacks "
          f"(filter 0) utils/png.py {decode['stack_python_ms']:.3f} ms, native "
          + (f"{decode['stack_native_ms']:.3f} ms" if codecs else "not built")
          + f"; the 512-px Pillow-written tile utils/png.py {decode['tile_python_ms']:.1f} ms, "
          + (f"native {decode['tile_native_ms']:.2f} ms" if codecs else "native not built"),
          flush=True)

    t0 = time.perf_counter()
    dom = os.path.join(tmp, "procedural")
    make_heatmap_domain(os.path.join(dom, "train"), bench_labeler.TRAIN_TILES,
                        seed=bench_labeler.TRAIN_SEED, **bench_labeler.DOMAIN_KW)
    make_heatmap_domain(os.path.join(dom, "val"), bench_labeler.VAL_TILES,
                        seed=bench_labeler.VAL_SEED, **bench_labeler.DOMAIN_KW)
    out["domain_s"] = time.perf_counter() - t0
    stack = read_png(os.path.join(dom, "train", "daam_stack_heatmaps", "0.png"))
    require(stack.shape == (112, 112, 3), f"phase 39: a procedural stack is {stack.shape}")
    shutil.rmtree(dom)

    cache = os.path.join(tmp, "stack_labeler")
    t0 = time.perf_counter()
    _, variables, thr = bench_labeler.prepare_stack_labeler(cache, epochs=LABELER_EPOCHS,
                                                            log=lambda m: print(m, flush=True))
    out["train_wall"] = time.perf_counter() - t0
    with open(os.path.join(cache, bench_labeler.META)) as f:
        meta = json.load(f)
    require(meta["ap"] >= LABELER_AP_MIN, f"phase 39: the stack labeler's val AP {meta['ap']:.3f}"
            f" < {LABELER_AP_MIN}")
    t0 = time.perf_counter()
    with mock.patch("agenda_tpu_torch.detect.runner.DetectorRunner.train",
                    side_effect=AssertionError("the cached call trained")):
        _, cached, cthr = bench_labeler.prepare_stack_labeler(
            cache, epochs=LABELER_EPOCHS, log=lambda m: print(m, flush=True))
    out["cached_wall"] = time.perf_counter() - t0
    require(cthr == thr and set(cached) == set(variables)
            and all(torch.equal(cached[k], variables[k]) for k in variables),
            "phase 39: the cached labeler's threshold or weights differ")
    out["labeler"] = {"ap": meta["ap"], "f1_max": meta["f1_max"], "threshold": thr}
    print(f"[host] stack labeler ({LABELER_EPOCHS} epochs on the card): "
          f"{out['train_wall']:.1f} s, val AP {meta['ap']:.4f}, F1-max {meta['f1_max']:.4f}, "
          f"threshold {thr:.4f}; cached call {out['cached_wall']:.3f} s, same threshold and "
          f"weights", flush=True)

    rng = np.random.default_rng(39)

    def boxes(n):
        xy = rng.integers(0, 100, (n, 2))
        return np.concatenate([xy, xy + rng.integers(4, 40, (n, 2))], 1).astype(np.float64)

    sets = [(boxes(HOST_MATCH_DETS), boxes(HOST_MATCH_GTS)) for _ in range(HOST_MATCH_IMAGES)]
    thrs = np.round(np.arange(0.5, 1.0, 0.05), 2)
    t0 = time.perf_counter()
    nat = [(native.match_image_greedy(d, g, thrs), native.match_per_gt_greedy(d, g, 0.5))
           for d, g in sets]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(sets)
    t0 = time.perf_counter()
    ref = [(_match_image(d, -np.arange(len(d), dtype=np.float64), g, thrs, len(d)),
            match_per_gt_reference(d, g, 0.5)) for d, g in sets]
    numpy_ms = (time.perf_counter() - t0) * 1e3 / len(sets)
    require(all(np.array_equal(a, c) and np.array_equal(b, e) for (a, b), (c, e) in zip(nat, ref)),
            "phase 39: the native matchers differ from the numpy ones")
    out["match"] = {"native_ms": native_ms, "numpy_ms": numpy_ms}
    print(f"[host] matchers (COCO greedy at 10 IoU thresholds + per-GT at 0.5, "
          f"{HOST_MATCH_DETS} x {HOST_MATCH_GTS} boxes an image): native {native_ms:.4f} ms, "
          f"numpy {numpy_ms:.3f} ms an image, equal on {len(sets)} images", flush=True)
    shutil.rmtree(cache)
    return out


# -- full precision: --mixed_precision no (phase 40) --------------------------------

# The f32 kernels (csrc/flash_fwd_f32.cu, csrc/flash_bwd_f32.cu,
# csrc/flash_bwd_f32_wide.cu; groupnorm.cu's f32 instantiation) are held to
# their plain versions computed in float64 on the
# card: a kernel's max |error| may be at most F32_LIMIT times that of the f32
# plain version (TF32 off) on the same inputs. Their bound counts the products
# as three TF32 tensor-core passes (hi*hi + hi*lo + lo*hi) at 495e12/s, the
# cheapest f32-accurate product the card has (six bf16 passes over three bf16
# pieces, as the forward runs them, cost the same at 989e12/s), beside the
# exponentials and the bytes.
F32_LIMIT = 4.0
H100_TF32_FLOPS = 495e12
# The SD step in f32 at F32_PARITY_RES px, batch F32_PARITY_BATCH, on the card and
# on the CPU from the same weights, batch and draws: the loss within
# F32_LOSS_RTOL and the gradients (relative L2 distance over all of them) within
# F32_GRAD_TOL; the same step with TF32 on, the control, beyond both.
F32_PARITY_RES, F32_PARITY_BATCH, F32_SEED = 256, 1, 40
# Read on an H100 80GB HBM3 at 700 W (sound / TF32) from the fabricated weights,
# the same in five runs: loss 8.8e-8 / 9.1e-5, gradients 4.9e-6 / 1.5e-3, each
# limit near the geometric mean of its two. The weights after phase 40's steps
# differ from run to run (the step's autotuned cuDNN algorithms), and the TF32
# loss read 1.7e-6 to 1.8e-5 from them, so the step loads the fabricated ones.
F32_LOSS_RTOL, F32_GRAD_TOL = 3e-6, 1e-4
F32_STEPS, F32_PROMPT = 2, "An aerial view image with cars in Utah"
F32_SD_ARGS = ["--resolution", str(TRAIN_RES), "--train_batch_size", str(TRAIN_BATCH),
               "--use_8bit_adam", "--use_ema", "--snr_gamma", "5", "--learning_rate", "1e-6",
               "--seed", "0", "--device", "cuda", "--report_to", "jsonl",
               "--validation_prompts", F32_PROMPT, "--validation_steps", str(F32_STEPS)]


def f32_errors(got, plain, ref) -> Tuple[float, float]:
    """(the kernel's, the f32 plain version's) largest max |error| against the
    float64 reference over the outputs."""
    e_k = max((x.double() - r.double()).abs().max().item() for x, r in zip(got, ref))
    e_p = max((x.double() - r.double()).abs().max().item() for x, r in zip(plain, ref))
    return e_k, e_p


def f32_bound(flops: float, exps: float, nbytes: float):
    """(bound ms, what binds, the three terms in ms): the products as three TF32
    passes, the exponentials, the bytes."""
    terms = {"products": 3 * flops / H100_TF32_FLOPS, "exponentials": exps / H100_EXP_PER_S,
             "bytes": nbytes / H100_BYTES_PER_S}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], term, {k: 1e3 * v for k, v in terms.items()}


F32_VAL_IMAGES = 4  # the CLIs' validation: 4 seeds a prompt, 20 PNDM steps


def by_key(per_context: dict) -> dict:
    """{key: {context: calls}} from {context: {key: calls}}, keys in first-seen order."""
    out = {}
    for ctx, keys in per_context.items():
        for key, n in keys.items():
            out.setdefault(key, {})[ctx] = n
    return out


def f32_row(tag, shape, per, runs, got, plain, ref, call, plain_call, library, flops, exps,
            nbytes, rows, stream=None):
    """Hold one f32 kernel call to float64, time it, and append its row: ``per``
    {context: calls in one step, cache batch or validation batch}, ``runs``
    {context: times the f32 SD CLI's run has it}; the row's per_batch is the
    calls of that run."""
    e_k, e_p = f32_errors(got, plain, ref)
    require(e_k <= F32_LIMIT * e_p, f"{tag} {shape}: max err {e_k:.4g} against float64, over "
            f"{F32_LIMIT} x the f32 plain version's {e_p:.4g}")
    ms, eager = time_ms(call)
    plain_ms, _ = time_ms(plain_call, max_iters=10)
    lib, _ = time_ms(library, stream=stream)
    bound, term, terms = f32_bound(flops, exps, nbytes)
    rows.append(dict(shape=shape, per=per, per_batch=sum(n * runs[c] for c, n in per.items()),
                     err=e_k, ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                     bound_by="bytes" if term == "bytes" else "operations"))
    print(f"[f32] {tag} {shape} x{per}  err {e_k:.3g} against float64 ({e_k / e_p:.3g} x the "
          f"f32 plain version's {e_p:.3g}, limit {F32_LIMIT})  kernel {ms:.4f} ms (eager "
          f"{eager:.4f})  plain {plain_ms:.4f} ms  library {lib:.4f} ms  bound {bound:.4f} ms "
          f"({term}; products 3 x {flops:.4g} over 495e12/s = {terms['products']:.4f} ms, "
          f"{exps:.4g} exp = {terms['exponentials']:.4f} ms, {nbytes:.4g} bytes = "
          f"{terms['bytes']:.4f} ms)", flush=True)


def in_chunks(fn, *ins, chunk: int = 2):
    """fn over slices of ``chunk`` rows of the inputs' first dim, outputs
    joined: a float64 reference of a large batch within memory (the plain
    versions keep the batch as the outer dim of every output)."""
    import torch

    parts = [fn(*(t[i:i + chunk] for t in ins)) for i in range(0, ins[0].shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def f32_split_row(shape, per, runs, rows, *ops):
    """The f32 pre-pass at one shape over ``ops`` (q, k, v for a forward; q,
    k, v, dO for a backward): its bf16 pieces bit for bit those of the plain
    version, timed beside its bytes bound (the f32 operands read once, three
    bf16 planes an operand written) and the plain version; no PyTorch call
    computes it (library_ms null). Returns the pieces."""
    from agenda_tpu_torch.kernels import flash as fl

    tag = "flash f32 split" + ("" if len(ops) == 3 else " of q, k, v, dO")
    got, want = fl.flash_f32_split(*ops), fl.flash_f32_split_reference(*ops)
    err = (got.float() - want.float()).abs().max().item()
    require(err == 0, f"{tag} {shape}: pieces differ from the plain version's by {err}")
    del want
    ms, eager = time_ms(lambda: fl.flash_f32_split(*ops))
    plain_ms, _ = time_ms(lambda: fl.flash_f32_split_reference(*ops), max_iters=10)
    nbytes = len(ops) * ops[0].numel() * (4.0 + 3 * 2.0)
    bound = 1e3 * nbytes / H100_BYTES_PER_S
    rows.append(dict(shape=shape, per=per, per_batch=sum(n * runs[c] for c, n in per.items()),
                     err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                     bound_by="bytes", operands=len(ops)))
    print(f"[f32] {tag} {shape} x{per}  pieces equal to the plain version's  kernel "
          f"{ms:.4f} ms (eager {eager:.4f})  plain {plain_ms:.4f} ms  bound {bound:.4f} ms "
          f"(bytes: {nbytes:.4g})", flush=True)
    return got


def f32_flash_rows(per_context: dict, runs: dict) -> dict:
    """The f32 forward at every self-attention shape of the f32 SD CLI's run
    (``per_context``: {"step", "cache", "validation": {(B, S, H, D): calls}}),
    the f32 dK/dV and dQ at the step's; each against float64 and timed beside
    its bound, the plain version and SDPA on the same f32 tensors (forward;
    its whole backward for the two gradient kernels); the forward's rows
    time the whole call, its pre-pass included, which has rows of its own
    (``f32_split_row``)."""
    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels import flash as fl
    from agenda_tpu_torch.kernels.flash import WIDE_ABOVE

    rows = {"fwd": [], "fwd_wide": [], "split": [], "dkv": [], "dq": []}
    for shape, per in by_key(per_context).items():
        b, s, h, d = shape
        g = torch.Generator(device="cuda").manual_seed(b * 7919 + s + h + d)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        f32_split_row(shape, per, runs, rows["split"], q, k, v)
        out, lse = fl.flash_attention_fwd(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        io, stats, prod = 4.0 * b * s * h * d, 4.0 * b * h * s, 2.0 * b * h * s * s * d
        f32_row("flash fwd", shape, per, runs, (out, lse),
                fl.flash_attention_reference(q, k, v),
                in_chunks(fl.flash_attention_reference, q.double(), k.double(), v.double()),
                lambda: fl.flash_attention_fwd(q, k, v),
                lambda: fl.flash_attention_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(qt, kt, vt),
                2 * prod, float(b * h * s * s), 4 * io + stats,
                rows["fwd_wide" if d > WIDE_ABOVE else "fwd"])
        if "step" in per:
            require(d <= WIDE_ABOVE, f"a training step's attention at D = {d}")
            f32_bwd_pair(shape, {"step": per["step"]}, runs, q, k, v, do, out, lse, rows)
        del q, k, v, do, out, lse, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def f32_bwd_pair(shape, per, runs, q, k, v, do, out, lse, rows, tag: str = "flash"):
    """The f32 dK/dV and dQ on (q, k, v, do) against float64, each timed given
    the pieces of one pre-pass (as ``flash_attention``'s backward runs them)
    beside its bound, the plain version and SDPA's f32 backward (dQ, dK, dV
    in one call) on the same tensors; a row each into rows["dkv"] and
    rows["dq"], and the pre-pass's into rows["split"] (one a backward).
    Returns (the pieces, delta)."""
    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels import flash as fl

    b, s, h, d = shape
    io, stats, prod = 4.0 * b * s * h * d, 4.0 * b * h * s, 2.0 * b * h * s * s * d
    delta = fl.flash_delta(out, do)
    ins = (q, k, v, do, lse, delta)
    pieces = f32_split_row(shape, per, runs, rows["split"], q, k, v, do)
    wide_ins = tuple(t.double() for t in ins)
    qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o = F.scaled_dot_product_attention(qg, kg, vg)
    torch.cuda.current_stream().wait_stream(side)
    dot = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(o, (qg, kg, vg), dot, retain_graph=True)

    f32_row(f"{tag} dkv", shape, per, runs, fl.flash_attention_bwd_dkv(*ins, pieces),
            fl.flash_attention_bwd_dkv_reference(*ins),
            fl.flash_attention_bwd_dkv_reference(*wide_ins),
            lambda: fl.flash_attention_bwd_dkv(*ins, pieces),
            lambda: fl.flash_attention_bwd_dkv_reference(*ins), sdpa_bwd,
            4 * prod, float(b * h * s * s), 6 * io + 2 * stats, rows["dkv"], side)
    f32_row(f"{tag} dq", shape, per, runs, (fl.flash_attention_bwd_dq(*ins, pieces),),
            (fl.flash_attention_bwd_dq_reference(*ins),),
            (fl.flash_attention_bwd_dq_reference(*wide_ins),),
            lambda: fl.flash_attention_bwd_dq(*ins, pieces),
            lambda: fl.flash_attention_bwd_dq_reference(*ins), sdpa_bwd,
            3 * prod, float(b * h * s * s), 5 * io + 2 * stats, rows["dq"], side)
    pair = rows["dkv"][-1]["ms"] + rows["dq"][-1]["ms"] + rows["split"][-1]["ms"]
    lib = rows["dq"][-1]["library_ms"]
    print(f"[f32] {tag} pair {shape}: dK/dV + dQ + their pre-pass {pair:.4f} ms against SDPA's "
          f"f32 backward {lib:.4f} ms ({pair / lib:.3f}x)", flush=True)
    return pieces, delta


def f32_wide_bwd_rows(per_step: dict) -> dict:
    """The wide f32 dK/dV and dQ (``csrc/flash_bwd_f32_wide.cu``, D > 160) at
    each (B, S, H, D) of ``per_step`` ({shape: launches a VAE step}; 0 off
    the path), against float64 and timed as ``f32_bwd_pair`` does, then
    split into their passes (``f32_wide_bwd_parts``; their ptxas lines are
    phase 1's)."""
    import torch

    from agenda_tpu_torch.kernels import flash as fl

    rows = {"dkv": [], "dq": [], "split": []}
    for shape, count in per_step.items():
        b, s, h, d = shape
        require(d > fl.WIDE_ABOVE, f"{shape} is not a wide shape")
        g = torch.Generator(device="cuda").manual_seed(b * 7919 + s + h + d)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
        out, lse = fl.flash_attention_fwd(q, k, v)
        pieces, delta = f32_bwd_pair(shape, {"step": count}, {"step": 1}, q, k, v, do, out, lse,
                                     rows, "flash wide")
        f32_wide_bwd_parts(shape, q, k, v, do, delta, lse, pieces)
        del q, k, v, do, out, lse, pieces, delta
        torch.cuda.empty_cache()
    return rows


def f32_wide_bwd_parts(shape, q, k, v, do, delta, lse, pieces) -> None:
    """The wide f32 backward's passes alone at one shape, from ``pieces``
    (its pre-pass's, which ``f32_bwd_pair`` times): each entry's scores pass
    and gradient products over the call's chunks, and the scratch and peak
    memory a call adds to what it is given."""
    import torch

    from agenda_tpu_torch.kernels import flash as fl

    for dkv, entry in ((True, "dkv"), (False, "dq")):
        plan, scratch = fl.f32_wide_bwd_scratch(shape, dkv, "cuda")
        scratch_bytes = 2 * scratch.numel()
        outs = [torch.empty(shape, device="cuda") for _ in range(2 if dkv else 1)]
        scores_ms = time_ms(lambda: [fl.f32_wide_bwd_scores(pieces, lse, delta, scratch, shape,
                                                            c, dkv) for c in plan])[0]
        products_ms = time_ms(lambda: [fl.f32_wide_bwd_products(pieces, scratch, outs, shape,
                                                                c, dkv) for c in plan])[0]
        del scratch, outs
        call = fl.flash_attention_bwd_dkv if dkv else fl.flash_attention_bwd_dq
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = call(q, k, v, do, lse, delta, pieces)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        del result
        print(f"[f32] flash wide {entry} passes {shape}: scores pass "
              f"{scores_ms:.4f} ms, gradient products {products_ms:.4f} ms over {len(plan)} "
              f"chunk(s); scratch {scratch_bytes / 2**20:.1f} MiB (cap "
              f"{fl.F32_WIDE_BWD_SCRATCH / 2**20:.0f} MiB), the call's peak above its inputs "
              f"{peak / 2**20:.1f} MiB", flush=True)


def f32_gn_rows(per_context: dict, runs: dict) -> list:
    """The f32 group norm at every shape of the f32 SD CLI's run (``per_context``:
    {"step", "cache", "validation": {(shape, groups, eps, act): calls}}), with a
    per-channel offset, against float64, timed beside its bound, the plain
    version and F.group_norm + F.silu on the same f32 tensors."""
    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference

    rows = []
    for (shape, groups, eps, act), per in by_key(per_context).items():
        c = shape[1]
        g = torch.Generator(device="cuda").manual_seed(sum(shape) + c)
        off = 4.0 * (torch.arange(c, device="cuda") % (c // groups)) / (c // groups)
        x = torch.randn(shape, device="cuda", generator=g) * 2 + off[:, None, None]
        w = torch.randn(c, device="cuda", generator=g)
        bias = torch.randn(c, device="cuda", generator=g)
        args = (groups, eps, act)

        def library():
            out = F.group_norm(x, groups, w, bias, eps)
            return F.silu(out) if act == "silu" else out

        n = x.numel()
        f32_row("groupnorm", (shape, eps, act), per, runs, (group_norm_act(x, w, bias, *args),),
                (group_norm_act_reference(x, w, bias, *args),),
                (group_norm_act_reference(x.double(), w.double(), bias.double(), *args),),
                lambda: group_norm_act(x, w, bias, *args),
                lambda: group_norm_act_reference(x, w, bias, *args), library,
                0.0, float(n if act == "silu" else 0), 8.0 * n + 8.0 * c, rows)
        del x, w, bias
        torch.cuda.empty_cache()
    return rows


def f32_context_ms(rows: list, ctx: str, key: str = "ms"):
    """``key`` summed over the calls of one step, cache batch or validation
    batch; None where a row has none (no library call)."""
    if any(r[key] is None for r in rows):
        return None
    return sum(r[key] * r["per"].get(ctx, 0) for r in rows)


def f32_counters():
    from agenda_tpu_torch.kernels.flash import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq, "group_norm_act": group_norm_act}


# the wide f32 backward's passes (csrc/flash_bwd_f32_wide.cu): from the
# pieces of one pre-pass a backward (flash_f32_split, counted with the
# forward's), each dK/dV or dQ call runs, chunk by chunk (one chunk at the
# VAE's shapes), these
WIDE_F32_PASSES = ("f32_wide_bwd_scores", "f32_wide_bwd_products")


def reset_all_counts() -> None:
    from agenda_tpu_torch.kernels import flash as fl

    reset_counts()
    for fn in f32_counters().values():
        fn.launches_f32 = 0
    for name in ("flash_f32_split", *WIDE_F32_PASSES):
        getattr(fl, name).launches = 0
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        f32_counters()[name].launches_wide = 0


def all_f32(counts: dict) -> dict:
    """{kernel: (launches, f32 launches)}; every launch an f32 kernel's when equal."""
    return {k: (counts[k], fn.launches_f32) for k, fn in f32_counters().items()}


def f32_step_phase(model_dir, unet_cfg, vae_cfg, unet_calls, dev) -> dict:
    """Phase 40's step: the full-width SD step in f32 (fused int8 AdamW + EMA,
    batch 4 at 512x512) through the trainer API: every flash and group-norm
    launch an f32 kernel's, the counts the config's; warm s/step and the peak
    memory over what was held before; then the shapes the kernels get, and
    how often, in a step, in a batch of the latent cache's encode and in a
    validation batch (the UNet at 2 x F32_VAL_IMAGES, ``unet_calls`` times,
    and the decode)."""
    import torch

    expected = train_expected(unet_cfg, vae_cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what earlier phases left
    unet, make, vocab = build_trainer(model_dir, dev, dtype=torch.float32)
    state, step = make(True)
    batch = synthetic_batch(vae_cfg, vocab, dev, 0)
    reset_all_counts()
    calls = {}

    def first_step():
        calls["flash"], _ = record_train_step(unet, state, step, batch, dev)

    calls["gn"] = record_calls(unet.modules(), first_step)["gn"]
    torch.cuda.synchronize()
    counts = read_counts()
    f32 = all_f32(counts)
    in_step = {"flash": calls["flash"], "gn": tally({"gn": calls["gn"]})["gn"]}
    want = {"flash_attention_fwd": expected["flash_per_step"], "flash_attention_fwd_wide": 0,
            "flash_attention_bwd_dkv": expected["flash_per_step"],
            "flash_attention_bwd_dq": expected["flash_per_step"],
            "fused_adamw8bit": 0, "fused_adamw8bit_ema": expected["adamw_per_step"],
            "fused_adamw8bit_leaves": 0, "fused_adamw8bit_leaves_ema": expected["quantized"],
            "group_norm_act": expected["gn_per_step"]}
    print(f"[f32 step] one f32 step at batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}: flash "
          f"(B,S,H,D) x per-step {in_step['flash']}; group norms {len(calls['gn'])} in "
          f"{len(in_step['gn'])} shapes; launches {counts}; (launches, f32 launches) {f32}",
          flush=True)
    require(counts == want, f"f32 training-step launches {counts} differ from the config's {want}")
    require(all(n == m for n, m in f32.values()), f"a launch of the f32 step was not an f32 "
            f"kernel's: {f32}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(state, batch, generator=torch_generator(dev, i + 1))[1]["loss"]
              for i in range(F32_STEPS)]
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / F32_STEPS
    peak = torch.cuda.max_memory_allocated() - held
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses), f"non-finite f32 training loss {losses}")
    print(f"[f32 step] warm {warm_s:.4f} s/step = {TRAIN_BATCH / warm_s:.3f} images/s (f32, "
          f"TF32 off, fused int8 AdamW + EMA, {F32_STEPS} steps); peak memory {peak / 2**30:.2f} "
          f"GiB for the step's models, optimizer state and activations (the "
          f"{held / 2**30:.2f} GiB that earlier phases held left out); losses {losses}",
          flush=True)
    vae = make.vae
    with torch.no_grad():
        pixels = torch.rand(TRAIN_BATCH, TRAIN_RES, TRAIN_RES, 3, device=dev) * 2 - 1
        in_cache = tally(record_calls(vae.encoder.modules(), lambda: vae.encode(pixels)))
    del pixels
    hw = TRAIN_RES // 2 ** (len(vae_cfg.block_out_channels) - 1)
    in_validation = sampler_shapes(unet.eval(), vae, hw, F32_VAL_IMAGES, unet_calls, dev)
    shapes = {kind: {"step": in_step[kind], "cache": in_cache[kind],
                     "validation": in_validation[kind]} for kind in ("flash", "gn")}
    print(f"[f32 step] kernel calls by shape in a latent-cache batch (encode at batch "
          f"{TRAIN_BATCH}): flash {in_cache['flash']}, group norms "
          f"{sum(in_cache['gn'].values())} in {len(in_cache['gn'])} shapes; in a validation "
          f"batch ({F32_VAL_IMAGES} images, {unet_calls} UNet calls at batch "
          f"{2 * F32_VAL_IMAGES}, the decode): flash {in_validation['flash']}, group norms "
          f"{sum(in_validation['gn'].values())} in {len(in_validation['gn'])} shapes", flush=True)
    models = (unet, make.vae, make.text, vocab)  # for the card-vs-CPU step
    del make, state, step, batch, vae
    torch.cuda.empty_cache()
    return {"shapes": shapes, "warm_s": warm_s, "peak": peak, "held": held, "models": models}


def f32_step_parity(models, model_dir: str, dev) -> dict:
    """The f32 SD step at F32_PARITY_RES px, batch F32_PARITY_BATCH, on the CPU,
    then on the card from the same weights, batch and draws (``models``: the
    f32 step's UNet, VAE and text encoder and the vocabulary's size, moved to
    the CPU and back, the UNet given ``model_dir``'s fabricated weights again),
    f32 and then with TF32 on (the control): the loss and the gradients the
    optimizer receives, card against CPU."""
    import torch

    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.io.diffusers_io import load_pipeline
    from agenda_tpu_torch.train import finetune_sd as ttrain
    from agenda_tpu_torch.train.optim import Optimizer, global_norm

    cpu = torch.device("cpu")
    unet, vae, text, vocab = models
    unet.load_state_dict(load_pipeline(model_dir).unet_state, strict=True)
    g = torch.Generator().manual_seed(F32_SEED)
    h = F32_PARITY_RES // 2 ** (len(vae.config.block_out_channels) - 1)
    shape = (F32_PARITY_BATCH, h, h, vae.config.latent_channels)
    mean = torch.randn(shape, generator=g)
    batch = {"latent_moments": torch.cat([mean, torch.full_like(mean, -6.0)], dim=-1),
             "input_ids": torch.randint(0, vocab, (F32_PARITY_BATCH, 77), generator=g)}
    draws = ttrain.StepDraws(latent_eps=torch.randn(shape, generator=g),
                             noise=torch.randn(shape, generator=g),
                             timesteps=torch.randint(0, 1000, (F32_PARITY_BATCH,), generator=g))
    for m in (unet, vae, text):
        m.to(cpu)
    grads = {}

    def record(gr, opt_state, params, norm=global_norm):
        grads.clear()
        grads.update({k: x.detach().clone() for k, x in gr.items()})
        return params, opt_state, norm(gr)

    tx = Optimizer(init=lambda params: None, apply=record)  # the gradients, no update

    def run(device, tf32: bool):
        state = ttrain.init_train_state(unet.train(), tx, False)
        step = ttrain.make_train_step(unet, vae, text, make_schedule(), tx,
                                      ttrain.LossConfig(snr_gamma=5.0), False,
                                      dtype=torch.float32)
        on = {k: x.to(device) for k, x in batch.items()}
        d = ttrain.StepDraws(latent_eps=draws.latent_eps.to(device),
                             noise=draws.noise.to(device), timesteps=draws.timesteps.to(device))
        patch = (mock.patch.object(ttrain, "full_f32_if", lambda *_: tf32_on()) if tf32
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with patch:
            _, metrics = step(state, on, draws=d)
        return float(metrics["loss"]), dict(grads), time.perf_counter() - t0

    loss_cpu, ref, cpu_s = run(cpu, False)
    for m in (unet, vae, text):
        m.to(dev)
    ref = {k: x.to(dev, torch.float64) for k, x in ref.items()}
    ref_norm = math.sqrt(sum(float(x.square().sum()) for x in ref.values()))
    n_tensors, out = len(ref), {}
    for side, tf32 in (("card", False), ("tf32", True)):
        loss, got, secs = run(dev, tf32)
        diffs = {k: (got[k].double() - x).norm() / x.norm().clamp_min(1e-30)
                 for k, x in ref.items()}
        dist = math.sqrt(sum(float((got[k].double() - x).square().sum())
                             for k, x in ref.items()))
        worst = max(diffs, key=lambda k: float(diffs[k]))
        out[side] = {"loss": abs(loss - loss_cpu) / abs(loss_cpu), "grads": dist / ref_norm,
                     "worst": (float(diffs[worst]), worst), "s": secs, "value": loss}
    del unet, vae, text, ref, grads
    torch.cuda.empty_cache()
    print(f"[f32 parity] the f32 SD step at {F32_PARITY_RES} px, batch {F32_PARITY_BATCH}, card "
          f"vs CPU ({n_tensors} gradient tensors, the CPU's step {cpu_s:.1f} s, the card's "
          f"{out['card']['s']:.2f} s cold): loss {out['card']['value']:.7f} vs {loss_cpu:.7f} "
          f"({out['card']['loss']:.3g}, limit {F32_LOSS_RTOL}), gradients "
          f"{out['card']['grads']:.3g} of their L2 norm (limit {F32_GRAD_TOL}; worst tensor "
          f"{out['card']['worst'][0]:.3g}, {out['card']['worst'][1]}); TF32 control: loss "
          f"{out['tf32']['loss']:.3g}, gradients {out['tf32']['grads']:.3g} (worst tensor "
          f"{out['tf32']['worst'][0]:.3g})", flush=True)
    require(out["card"]["loss"] <= F32_LOSS_RTOL and out["card"]["grads"] <= F32_GRAD_TOL,
            "the card's f32 step left the CPU's")
    require(out["tf32"]["loss"] > F32_LOSS_RTOL and out["tf32"]["grads"] > F32_GRAD_TOL,
            "the TF32 control stayed within the f32 limits: they cannot tell TF32 from f32")
    return out


def f32_cli_phase(model_dir: str, tmp: str, unet_cfg, vae_cfg, unet_calls: int) -> dict:
    """Phase 40's CLIs: cli/finetune_sd --mixed_precision no at full width
    (batch 4, 512x512, fused int8 AdamW + EMA) for F32_STEPS steps and one
    validation (4 images, 20 PNDM steps, f32), then cli/finetune_sd_token
    --mixed_precision no, F32_STEPS steps of stage 1; each run's launches the
    config's, every flash and group-norm launch an f32 kernel's."""
    import torch

    from agenda_tpu_torch.cli import finetune_sd, finetune_sd_token
    from agenda_tpu_torch.kernels.flash import flash_f32_split
    from agenda_tpu_torch.utils.png import read_png

    data_dir = os.path.join(tmp, "tiles")
    if not os.path.isdir(data_dir):
        write_tiles(data_dir)
    expected = train_expected(unet_cfg, vae_cfg)
    cache_batches = math.ceil(TRAIN_TILES / TRAIN_BATCH)
    validation = expected_launches(unet_cfg, vae_cfg, unet_calls)  # one 20-step batch

    def want(validations: int, int8: bool) -> dict:
        out = {k: 0 for k in train_counters()}
        out.update({
            "flash_attention_fwd": (expected["flash_per_step"] * F32_STEPS + cache_batches
                                    + validation["flash_attention_fwd"] * validations),
            "flash_attention_fwd_wide": cache_batches + validations,
            "flash_attention_bwd_dkv": expected["flash_per_step"] * F32_STEPS,
            "flash_attention_bwd_dq": expected["flash_per_step"] * F32_STEPS,
            "group_norm_act": (expected["gn_per_step"] * F32_STEPS
                               + expected["gn_per_cache_batch"] * cache_batches
                               + validation["group_norm_act"] * validations)})
        if int8:
            out["fused_adamw8bit_ema"] = expected["adamw_per_step"] * F32_STEPS
            out["fused_adamw8bit_leaves_ema"] = expected["quantized"] * F32_STEPS
        return out

    common = ["--pretrained_model_name_or_path", model_dir, "--dataset_folder", data_dir,
              "--json_file_name", "train.json", "--max_train_steps", str(F32_STEPS),
              "--checkpointing_steps", "100", "--mixed_precision", "no"]
    runs = (("f32 sd-cli", finetune_sd, ["--output_dir", os.path.join(tmp, "f32_sd"),
                                         *F32_SD_ARGS], 1, True),
            ("f32 token-cli", finetune_sd_token, ["--output_dir", os.path.join(tmp, "f32_tok"),
                                                  *TOKEN_ARGS, "--train_token"], 0, False))
    out = {}
    for tag, cli, argv, validations, int8 in runs:
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        t0 = time.perf_counter()
        stats = cli.main(common + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        f32 = all_f32(launches)
        splits = flash_f32_split.launches
        # D > 160: the wide passes (csrc/flash_bwd_f32_wide.cu); the SD UNet's
        # D <= 160 runs csrc/flash_bwd_f32.cu alone
        wide_bwd = [f32_counters()[name].launches_wide
                    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")]
        expect = want(validations, int8)
        peak = torch.cuda.max_memory_allocated()
        print(f"[{tag}] --mixed_precision no: {stats['steps']} steps in {stats['seconds']:.3f} s "
              f"(cold first step{', validation' if validations else ''} included), {wall:.1f} s "
              f"with loading and the latent cache; peak memory {peak / 2**30:.2f} GiB; losses "
              f"{stats['losses']}; launches {launches} (expected {expect}); (launches, f32 "
              f"launches) {f32}", flush=True)
        require(stats["steps"] == F32_STEPS and all(math.isfinite(x) for x in stats["losses"]),
                f"{tag}: {stats['steps']} steps, losses {stats['losses']}")
        require(launches == expect, f"{tag}: launches differ from the config's count")
        require(all(n == m for n, m in f32.values()), f"{tag}: a launch was not an f32 "
                f"kernel's: {f32}")
        require(wide_bwd == [0, 0], f"{tag}: {wide_bwd} f32 dK/dV and dQ launches of the wide "
                "passes (D > 160)")
        require(splits == launches["flash_attention_fwd"] + launches["flash_attention_bwd_dkv"],
                f"{tag}: {splits} launches of the f32 pre-pass, not one a forward and one a "
                "backward")
        if validations:
            images = os.path.join(tmp, "f32_sd", "logs", "images")
            names = sorted(os.listdir(images))
            require(len(names) == F32_VAL_IMAGES, f"{tag}: validation wrote {names}, not "
                    f"{F32_VAL_IMAGES} PNGs")
            for name in names:
                img = read_png(os.path.join(images, name))
                require(img.shape == (TRAIN_RES, TRAIN_RES, 3) and str(img.dtype) == "uint8",
                        f"{tag}: {name} is {img.shape} {img.dtype}")
            print(f"[{tag}] validation wrote {len(names)} PNGs of {TRAIN_RES}x{TRAIN_RES}x3 "
                  f"uint8: {names}", flush=True)
        out[tag] = {"launches": launches, "splits": splits, "wall": wall, "peak": peak}
    for sub in ("f32_sd", "f32_tok"):
        shutil.rmtree(os.path.join(tmp, sub))
    return out


def f32_phase(model_dir, tmp, unet_cfg, vae_cfg, unet_calls, dev) -> dict:
    """Phase 40: full precision on the card, --mixed_precision no."""
    import torch

    t = [time.perf_counter()]
    step = f32_step_phase(model_dir, unet_cfg, vae_cfg, unet_calls, dev)
    models = step.pop("models")
    # the f32 SD CLI's run: F32_STEPS steps, its latent cache, one validation batch
    runs = {"step": F32_STEPS, "cache": math.ceil(TRAIN_TILES / TRAIN_BATCH), "validation": 1}
    t.append(time.perf_counter())
    flash = f32_flash_rows(step["shapes"]["flash"], runs)
    gn = f32_gn_rows(step["shapes"]["gn"], runs)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    parity = f32_step_parity(models, model_dir, dev)
    del models
    t.append(time.perf_counter())
    cli = f32_cli_phase(model_dir, tmp, unet_cfg, vae_cfg, unet_calls)
    t.append(time.perf_counter())
    sd = cli["f32 sd-cli"]["launches"]
    covered = {"flash_attention_fwd": sum(r["per_batch"] for r in flash["fwd"] + flash["fwd_wide"]),
               "flash_attention_fwd_wide": sum(r["per_batch"] for r in flash["fwd_wide"]),
               "flash_attention_bwd_dkv": sum(r["per_batch"] for r in flash["dkv"]),
               "flash_attention_bwd_dq": sum(r["per_batch"] for r in flash["dq"]),
               "group_norm_act": sum(r["per_batch"] for r in gn),
               "flash_f32_split": sum(r["per_batch"] for r in flash["split"])}
    sd = {**sd, "flash_f32_split": cli["f32 sd-cli"]["splits"]}
    print(f"[f32] the rows' calls over the SD CLI's run {covered}; its launches "
          f"{ {k: sd[k] for k in covered} }", flush=True)
    require(all(covered[k] == sd[k] for k in covered), "the f32 rows' shapes do not cover every "
            "launch of the f32 SD CLI's run")
    for name, rows in (("flash fwd", flash["fwd"]), ("flash fwd wide", flash["fwd_wide"]),
                       ("flash f32 split", flash["split"]),
                       ("flash dkv", flash["dkv"]), ("flash dq", flash["dq"]),
                       ("groupnorm", gn)):
        print(f"[f32] {name} (kernel / bound / plain / library ms): " + "; ".join(
            f"{label} " + " / ".join(
                "none" if ms is None else f"{ms:.4f}" for ms in (
                    f32_context_ms(rows, ctx, key)
                    for key in ("ms", "bound_ms", "plain_ms", "library_ms")))
            for ctx, label in (("step", "a step"), ("cache", "a cache batch"),
                               ("validation", "a validation batch"))
            if any(ctx in r["per"] for r in rows)), flush=True)
    pair = {key: sum(r[key] * r["per_batch"] for r in flash["dkv"] + flash["dq"])
            for key in ("ms", "bound_ms")}
    bwd_split = sum(r["ms"] * r["per_batch"] for r in flash["split"] if r["operands"] == 4)
    sdpa = sum(r["library_ms"] * r["per_batch"] for r in flash["dq"])
    print(f"[f32] the f32 dK/dV + dQ over the SD CLI's run: {pair['ms']:.4f} ms (bound "
          f"{pair['bound_ms']:.4f}), with their pre-pass {pair['ms'] + bwd_split:.4f} ms, against "
          f"SDPA's f32 backward {sdpa:.4f} ms ({(pair['ms'] + bwd_split) / sdpa:.3f}x)",
          flush=True)
    print("[f32] phase 40's parts: " + ", ".join(
        f"{name} {b - a:.1f} s" for name, a, b in zip(("step", "kernel rows", "card vs CPU",
                                                       "CLIs"), t, t[1:])), flush=True)
    return {"step": step, "flash": flash, "gn": gn, "parity": parity, "cli": cli}


def summarize(name, route, source, replaces, rows, launches):
    """One `kernels` entry: times summed over one batch's (or training step's)
    main-path launches (off-path rows count 0 times); the error is the
    largest of all rows."""
    def per_batch(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r["per_batch"] for r in rows)

    by_ops = sum(r["bound_ms"] * r["per_batch"] for r in rows if r["bound_by"] == "operations")
    bound_by = "operations" if by_ops >= per_batch("bound_ms") - by_ops else "bytes"
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["err"] for r in rows),
            "ms": per_batch("ms"), "plain_ms": per_batch("plain_ms"),
            "bound_ms": per_batch("bound_ms"), "bound_by": bound_by,
            "library_ms": per_batch("library_ms")}


def check_outputs(save_dir: str, n_images: int = E2E_IMAGES) -> None:
    from agenda_tpu_torch.utils.png import read_png

    images = sorted(os.listdir(os.path.join(save_dir, "images")))
    require(len(images) == n_images, f"expected {n_images} image PNGs, found {images}")
    for name in images:
        img = read_png(os.path.join(save_dir, "images", name))
        require(img.shape == (112, 112, 3) and str(img.dtype) == "uint8",
                f"image {name}: {img.shape} {img.dtype}")
    for word in E2E_WORDS:
        d = os.path.join(save_dir, f"daam_{word}_heatmaps")
        maps = sorted(os.listdir(d))
        require(maps == images, f"heatmaps for {word}: {maps}")
        for name in maps:
            m = read_png(os.path.join(d, name))
            require(m.shape == (112, 112) and str(m.dtype) == "uint8",
                    f"heatmap {word}/{name}: {m.shape} {m.dtype}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs the card",
              file=sys.stderr)
        return 2
    try:
        import agenda_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    from agenda_tpu_torch.cli import data_generation
    from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline
    from agenda_tpu_torch.io.fabricate import fabricate_pipeline, write_learned_embeds
    from agenda_tpu_torch.kernels import _build
    from agenda_tpu_torch.kernels.flash import WIDE_ABOVE, flash_attention_fwd
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_name_power()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)

    # 1. build
    t_start = time.perf_counter()
    phase_s = {}
    t0 = settle("build (1)")
    lib = _build.load_library()
    print(f"[build] {lib.path.name}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s)", flush=True)
    for name, text in sorted(ptxas_report(lib.log).items()):
        if not name.startswith("flash_bwd_") or "_f32" in name:  # the bf16 backward: phase 10
            print(f"[ptxas] {name}: {text}", flush=True)

    phase_s["build (1)"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="agenda_chip_smoke_") as tmp:
        # 2. shapes of the main path
        t_phase = settle("generation (phases 2-6)")
        model_dir = os.path.join(tmp, "sd14_fabricated")
        t0 = time.perf_counter()
        unet_cfg, vae_cfg, text_cfg = fabricate_pipeline(model_dir, seed=0)
        embeds = os.path.join(tmp, "learned_embeds.bin")
        write_learned_embeds(embeds, text_cfg.hidden_size, seed=0)
        print(f"[shapes] fabricated SD-1.4-shaped pipeline in {time.perf_counter() - t0:.1f} s",
              flush=True)
        pipe = StableDiffusionPipeline.from_pretrained(model_dir, device="cuda")
        per_batch, unet_calls = record_shapes(pipe, E2E_BATCH)
        _, warm_s = time_batches(pipe, E2E_BATCH)
        expected = expected_launches(unet_cfg, vae_cfg, unet_calls)
        recorded = {"flash_attention_fwd": sum(per_batch["flash"].values()),
                    "group_norm_act": sum(per_batch["gn"].values())}
        print(f"[shapes] {unet_calls} UNet calls per batch; launches per batch from the "
              f"config {expected}, from the recorded calls {recorded}", flush=True)
        require(recorded == expected, "recorded kernel calls differ from the config's count")

        # 3 + 4. parity and timing at every main-path shape
        flash = flash_rows(per_batch["flash"])
        gn = gn_rows(per_batch["gn"])
        torch.cuda.empty_cache()

        # 5. end to end through the CLI
        save_dir = os.path.join(tmp, "out")
        latents = []
        load = StableDiffusionPipeline.from_pretrained

        def load_capturing_latents(*args, **kwargs):
            # the decoder's post_quant_conv receives latents / scaling_factor
            loaded = load(*args, **kwargs)
            loaded.vae.post_quant_conv.register_forward_pre_hook(
                lambda module, inputs: latents.append(inputs[0]))
            return loaded

        with mock.patch.object(StableDiffusionPipeline, "from_pretrained",
                               load_capturing_latents):
            flash_attention_fwd.launches = flash_attention_fwd.launches_wide = 0
            group_norm_act.launches = 0
            stats = data_generation.main([
                "--pretrained-model-path", model_dir, "--learnable-tokens-embedding-path",
                embeds, "--save-dir", save_dir, "--device", "cuda", *E2E_ARGS])
            torch.cuda.synchronize()
            launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                        "group_norm_act": group_norm_act.launches}
            wide_launches = flash_attention_fwd.launches_wide  # D > 160: the VAE decode's
        n_batches = stats["batches"]
        want = {k: v * n_batches for k, v in expected.items()}
        print(f"[e2e] {n_batches} batches of {E2E_BATCH}: {stats['seconds'] / n_batches:.3f} "
              f"s/batch, {stats['images'] / stats['seconds']:.3f} images/s; launches {launches} "
              f"(expected {want})", flush=True)
        require(launches == want, "kernel launch counts differ from the config's count")
        require(wide_launches == n_batches, f"{wide_launches} wide flash forward launches in "
                f"{n_batches} batches: one a batch expected (the VAE's mid-block attention)")
        require(len(latents) == n_batches and all(bool(torch.isfinite(z).all()) for z in latents),
                "final latents are not finite")
        check_outputs(save_dir)
        print(f"[e2e] {E2E_IMAGES} images 112x112x3 uint8 and {len(E2E_WORDS)}x{E2E_IMAGES} "
              f"heatmaps 112x112 uint8 written; final latents finite", flush=True)

        # 6. where the time goes, and the port's profile report on its trace
        trace_dir = os.path.join(tmp, "profile_trace")
        busy_ms, _ = profile_run(
            lambda: pipe.generate_async(PROFILE_PROMPT, list(range(E2E_BATCH)),
                                        **generate_kwargs())(),
            "profile", f"batch {E2E_BATCH} at 512x512, {E2E_STEPS} steps", warm_s,
            trace_dir=trace_dir)
        report = profile_report_phase(trace_dir, busy_ms)
        phase_s["generation (phases 2-6)"] = time.perf_counter() - t_phase

        # 35. TGATE: the replay gate, the API against the exact sampler, the CLI
        t_phase = settle("TGATE (35)")
        tgate = tgate_phase(pipe, model_dir, embeds, tmp, expected, warm_s)
        del pipe, latents
        torch.cuda.empty_cache()
        phase_s["TGATE (35)"] = time.perf_counter() - t_phase

        # 8 + 9. the training path through the trainer API, then the no-EMA (K4) path
        t_phase = settle("train shapes, timing, K4 path (8-9)")
        dev = torch.device("cuda")
        train_shapes, leaves, k4_launches, _ = train_api_phase(model_dir, unet_cfg, vae_cfg, dev)
        phase_s["train shapes, timing, K4 path (8-9)"] = time.perf_counter() - t_phase

        # 10. parity and timing of the training kernels
        t_phase = settle("train parity and timing (10)")
        bwd = flash_bwd_rows(train_shapes)
        adamw, adamw_ema = adamw_rows(leaves)
        phase_s["train parity and timing (10)"] = time.perf_counter() - t_phase

        # 11. the trainer's CLI end to end
        t_phase = settle("train e2e (11)")
        train_launches = train_e2e(model_dir, tmp, unet_cfg, vae_cfg)
        shutil.rmtree(os.path.join(tmp, "finetuned"))  # the disk for the later phases
        phase_s["train e2e (11)"] = time.perf_counter() - t_phase

        # 12. the group norm's tail path, then generation at 384x384
        t_phase = settle("GN tail (12)")
        gn += gn_tail_rows()
        tail_resolution_e2e(model_dir, embeds, tmp, expected)
        phase_s["GN tail (12)"] = time.perf_counter() - t_phase

        # 13. the token step through the trainer API
        t_phase = settle("token API (13)")
        token = token_api_phase(model_dir, unet_cfg, vae_cfg, dev)
        phase_s["token API (13)"] = time.perf_counter() - t_phase

        # 14-15. the token CLI, stage 1 then stage 2
        t_phase = settle("token CLI (14-15)")
        token_cli_phases(model_dir, tmp, unet_cfg, vae_cfg, unet_calls)
        phase_s["token CLI (14-15)"] = time.perf_counter() - t_phase

        # 16. gradient accumulation through the SD CLI
        t_phase = settle("accumulation (16)")
        accum_launches = accumulation_e2e(model_dir, tmp, unet_cfg, vae_cfg)
        phase_s["accumulation (16)"] = time.perf_counter() - t_phase

        # 36-37. VAE pretraining at SD-1.4's widths; the wide flash backward's rows
        t_phase = settle("VAE pretraining (36)")
        vae_cfg_state = vae_state(model_dir)
        vae = vae_pretrain_phase(*vae_cfg_state, dev, torch.bfloat16, VAE_STEPS, "vae")
        phase_s["VAE pretraining (36)"] = time.perf_counter() - t_phase
        t_phase = settle("wide flash backward (37)")
        wide_shapes = {shape: vae["launches"]["flash_attention_bwd_dkv"] if n is None else n
                       for shape, n in WIDE_FLASH_BWD.items()}
        wide = flash_bwd_rows(wide_shapes, extra=(), tag="wide flash bwd")
        phase_s["wide flash backward (37)"] = time.perf_counter() - t_phase

        # 41. f32 VAE pretraining: the steps, card vs CPU, the wide f32 backward's rows
        t_phase = settle("f32 VAE pretraining (41)")
        vae32 = vae_pretrain_phase(*vae_cfg_state, dev, torch.float32, VAE_F32_STEPS, "vae f32")
        vae32["parity"] = vae_f32_parity(*vae_cfg_state, dev)
        wide32 = f32_wide_bwd_rows({
            shape: vae32["launches"]["flash_attention_bwd_dkv_wide"] if n is None else n
            for shape, n in WIDE_FLASH_BWD.items()})
        del vae_cfg_state
        phase_s["f32 VAE pretraining (41)"] = time.perf_counter() - t_phase

        # 17-20. the labelling stages: heatmap stacks, YOLOv8n/s on the card
        t_phase = settle("labelling (17-20)")
        label_root = os.path.join(tmp, "labels")
        labels = part("labels_fabricate", labels_fabricate, label_root)
        part("detector_parity", detector_parity, labels, dev)
        part("runner_parity", runner_parity, labels, label_root, dev)
        chosen = part("labelling_stages", labelling_stages, labels, label_root, dev)
        label_timing = part("labelling_timing", labelling_timing, labels, label_root, dev)
        phase_s["labelling (17-20)"] = time.perf_counter() - t_phase

        # 39. the host libraries and the bench's stack labeler
        t_phase = settle("host libraries and stack labeler (39)")
        hostlib = host_phase(labels, tmp)
        phase_s["host libraries and stack labeler (39)"] = time.perf_counter() - t_phase

        # 38. two ranks on the card: split generation, the SD step at --fsdp 2, det_test
        t_phase = settle("multi-rank (38)")
        multi = multirank_phase(model_dir, embeds, save_dir, labels, label_root, expected,
                                unet_cfg, vae_cfg, dev, tmp)
        phase_s["multi-rank (38)"] = time.perf_counter() - t_phase

        # 21-23. detector training: a train step card vs CPU, the CLI, timing
        t_phase = settle("detector training (21-23)")
        det_parity = part("det_train_parity", det_train_parity, labels, label_root, dev)
        det_cli = part("det_cli_phase", det_cli_phase, labels, label_root, dev)
        det_time = part("det_timing", det_timing, labels, label_root, dev)
        phase_s["detector training (21-23)"] = time.perf_counter() - t_phase

        # 24-26. device augmentation: the render card vs CPU, the loop, the CLI
        t_phase = settle("device augmentation (24-26)")
        render = part("render_parity", render_parity, labels, label_root, dev)
        devaug = part("device_aug_timing", device_aug_timing, labels, label_root, dev)
        part("det_cli_phase devaug", det_cli_phase, labels, label_root, dev,
             ("--device-aug", "--device-aug-workers", "2"), "devaug-cli")
        phase_s["device augmentation (24-26)"] = time.perf_counter() - t_phase
        shutil.rmtree(label_root)

        # 27-29. the refine classifier: a step card vs CPU, the CLI, timing
        t_phase = settle("refine parity (27)")
        refine = refine_parity(dev)
        phase_s["refine parity (27)"] = time.perf_counter() - t_phase
        t_phase = settle("refine CLI and timing (28-29)")
        refine_root = os.path.join(tmp, "refine")
        refine_cli = refine_cli_phase(refine_root, dev)
        refine_time = refine_timing(refine_cli, dev)
        shutil.rmtree(refine_root)
        torch.cuda.empty_cache()
        phase_s["refine CLI and timing (28-29)"] = time.perf_counter() - t_phase

        # 30. the whole chain through the port's orchestrator
        t_phase = settle("chain (30)")
        chain = chain_phase(os.path.join(tmp, "chain"), dev)
        phase_s["chain (30)"] = time.perf_counter() - t_phase

        # 31-34. the other detector families: Faster R-CNN, YOLOv5m/s, ViTDet
        fam = family_phases(tmp, dev, phase_s)

        # 40. full precision: --mixed_precision no through the f32 kernels
        t_phase = settle("full precision (40)")
        f32 = f32_phase(model_dir, tmp, unet_cfg, vae_cfg, unet_calls, dev)
        phase_s["full precision (40)"] = time.perf_counter() - t_phase

    settle("report (41)")
    wide_d = [r["shape"][3] > WIDE_ABOVE for r in flash]
    f32_sd = f32["cli"]["f32 sd-cli"]["launches"]  # phase 40's main path: the SD CLI's run
    kernels = [
        summarize("flash_attention_fwd", "cuda", "agenda_tpu_torch/csrc/flash_fwd.cu",
                  "agenda_tpu/kernels/flash.py:55",
                  [r for r, w in zip(flash, wide_d) if not w],
                  launches["flash_attention_fwd"] - wide_launches),
        summarize("flash_attention_fwd_wide", "cuda", "agenda_tpu_torch/csrc/flash_fwd.cu",
                  "agenda_tpu/kernels/flash.py:55", [r for r, w in zip(flash, wide_d) if w],
                  wide_launches),
        summarize("group_norm_act", "cuda", "agenda_tpu_torch/csrc/groupnorm.cu",
                  "agenda_tpu/kernels/groupnorm.py:94", gn, launches["group_norm_act"]),
        summarize("flash_attention_bwd_dkv", "cuda", "agenda_tpu_torch/csrc/flash_bwd.cu",
                  "agenda_tpu/kernels/flash.py:153", bwd["dkv"],
                  train_launches["flash_attention_bwd_dkv"]),
        summarize("flash_attention_bwd_dq", "cuda", "agenda_tpu_torch/csrc/flash_bwd.cu",
                  "agenda_tpu/kernels/flash.py:192", bwd["dq"],
                  train_launches["flash_attention_bwd_dq"]),
        summarize("flash_attention_bwd_dkv_wide", "cuda", "agenda_tpu_torch/csrc/flash_bwd.cu",
                  "agenda_tpu/kernels/flash.py:153", wide["dkv"],
                  vae["launches"]["flash_attention_bwd_dkv"]),
        summarize("flash_attention_bwd_dq_wide", "cuda", "agenda_tpu_torch/csrc/flash_bwd.cu",
                  "agenda_tpu/kernels/flash.py:192", wide["dq"],
                  vae["launches"]["flash_attention_bwd_dq"]),
        summarize("flash_attention_fwd_f32", "cuda", "agenda_tpu_torch/csrc/flash_fwd_f32.cu",
                  "agenda_tpu/kernels/flash.py:55", f32["flash"]["fwd"],
                  f32_sd["flash_attention_fwd"] - f32_sd["flash_attention_fwd_wide"]),
        summarize("flash_attention_fwd_f32_wide", "cuda",
                  "agenda_tpu_torch/csrc/flash_fwd_f32.cu",
                  "agenda_tpu/kernels/flash.py:55", f32["flash"]["fwd_wide"],
                  f32_sd["flash_attention_fwd_wide"]),
        summarize("flash_f32_split", "cuda", "agenda_tpu_torch/csrc/flash_fwd_f32.cu",
                  "agenda_tpu/kernels/flash.py:55", f32["flash"]["split"],
                  f32["cli"]["f32 sd-cli"]["splits"]),
        summarize("flash_attention_bwd_dkv_f32", "cuda", "agenda_tpu_torch/csrc/flash_bwd_f32.cu",
                  "agenda_tpu/kernels/flash.py:153", f32["flash"]["dkv"],
                  f32_sd["flash_attention_bwd_dkv"]),
        summarize("flash_attention_bwd_dq_f32", "cuda", "agenda_tpu_torch/csrc/flash_bwd_f32.cu",
                  "agenda_tpu/kernels/flash.py:192", f32["flash"]["dq"],
                  f32_sd["flash_attention_bwd_dq"]),
        summarize("flash_attention_bwd_dkv_f32_wide", "cuda",
                  "agenda_tpu_torch/csrc/flash_bwd_f32_wide.cu",
                  "agenda_tpu/kernels/flash.py:153", wide32["dkv"],
                  vae32["launches"]["flash_attention_bwd_dkv_wide"]),
        summarize("flash_attention_bwd_dq_f32_wide", "cuda",
                  "agenda_tpu_torch/csrc/flash_bwd_f32_wide.cu",
                  "agenda_tpu/kernels/flash.py:192", wide32["dq"],
                  vae32["launches"]["flash_attention_bwd_dq_wide"]),
        summarize("flash_f32_split_wide_bwd", "cuda", "agenda_tpu_torch/csrc/flash_fwd_f32.cu",
                  "agenda_tpu/kernels/flash.py:153", wide32["split"],
                  vae32["launches"]["flash_f32_split"]
                  - vae32["launches"]["flash_attention_fwd f32"]),
        summarize("group_norm_act_f32", "cuda", "agenda_tpu_torch/csrc/groupnorm.cu",
                  "agenda_tpu/kernels/groupnorm.py:94", f32["gn"], f32_sd["group_norm_act"]),
        summarize("fused_adamw8bit", "cuda", "agenda_tpu_torch/csrc/fused_adamw.cu",
                  "agenda_tpu/kernels/fused_adamw.py:111", adamw,
                  k4_launches["fused_adamw8bit"]),
        summarize("fused_adamw8bit_ema", "cuda", "agenda_tpu_torch/csrc/fused_adamw.cu",
                  "agenda_tpu/kernels/fused_adamw.py:118", adamw_ema,
                  train_launches["fused_adamw8bit_ema"]),
    ]
    for name, sec in phase_s.items():
        print(f"[phases] {name}: {sec:.1f} s", flush=True)
    print(f"[phases] all: {time.perf_counter() - t_start:.1f} s since the build began, "
          f"{sum(phase_s.values()):.1f} s in the phases above", flush=True)
    print(f"[report] fused AdamW launches and leaf updates: K4 path {k4_launches['fused_adamw8bit']} "
          f"launches, {k4_launches['fused_adamw8bit_leaves']} leaves in 2 steps; trainer CLI "
          f"{train_launches['fused_adamw8bit_ema']} launches, "
          f"{train_launches['fused_adamw8bit_leaves_ema']} leaves in {TRAIN_STEPS} steps "
          f"({train_launches['fused_adamw8bit_ema'] // TRAIN_STEPS} launch(es) and "
          f"{train_launches['fused_adamw8bit_leaves_ema'] // TRAIN_STEPS} leaves a step)",
          flush=True)
    print(f"[report] token step at batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES} (tokens + UNet + "
          f"reg, f32 AdamW): warm {token['warm_s']:.4f} s/step, peak memory "
          f"{token['peak'] / 2**30:.2f} GiB, launches a step {token['launches']}; token-only "
          f"step {token['token_only']}; accumulation ({ACCUM} micro-batches an update): K5 "
          f"{accum_launches['fused_adamw8bit_ema']} launches in {ACCUM_UPDATES} updates",
          flush=True)
    for detector, t in label_timing.items():
        print(f"[report] labelling with {detector} at batch {LABEL_BATCH}, {LABEL_IMG}px, "
              f"{LABEL_TILES} heatmap stacks: {t['images_per_s']:.1f} images/s warm (host clock, "
              f"PNG decode included), device busy {100 * t['busy']:.1f}%, NMS {t['nms_ms']:.2f} ms "
              f"and {t['nms_launches']} launches a batch, convolution {t['conv_ms']:.2f} ms a "
              f"batch; host decode {t['decode_ms']:.3f} ms a tile, enqueue "
              f"{t['enqueue_ms']:.2f} ms a batch; selected threshold {chosen['threshold']:.4f} "
              f"(YOLOv8n)", flush=True)
    for bs, t in det_time.items():
        print(f"[report] YOLOv8n training at batch {bs}, {LABEL_IMG}px: {t['warm_s']:.4f} s a "
              f"step on the card ({t['images_per_s']:.1f} images/s), the loop {t['loop_s']:.3f} "
              f"s a step ({t['loop_images_per_s']:.1f} images/s, card busy "
              f"{100 * t['busy']:.1f}%); host augmentation {t['aug_ms']['mix']:.2f} / "
              f"{t['aug_ms']['stage2']:.2f} ms an image (mix / stage 2); host-to-device "
              f"{t['h2d_ms']:.2f} ms a batch; peak {t['peak'] / 2**30:.2f} GiB", flush=True)
    for (bs, workers), t in devaug.items():
        host = det_time[bs]
        print(f"[report] YOLOv8n training at batch {bs} with device augmentation, {workers} plan "
              f"workers: the loop {t['loop_s']:.4f} s a step ({t['images_per_s']:.1f} images/s, "
              f"card busy {100 * t['busy']:.1f}%) against the host augmentation's "
              f"{host['loop_s']:.3f} s ({host['loop_images_per_s']:.1f} images/s, busy "
              f"{100 * host['busy']:.1f}%); render {t['render_ms']:.2f} ms, step "
              f"{t['step_ms']:.2f} ms; plans {t['plan_ms']:.3f} ms an image, upload "
              f"{t['upload_ms']:.2f} ms a batch; tensor {t['mb']:.0f} MB; peak "
              f"{t['peak'] / 2**30:.2f} GiB", flush=True)
    print(f"[report] render card vs CPU at batch {LABEL_BATCH}: " + "; ".join(
        f"{k} mean {r['mean']:.2e} ({r['ms']:.2f} ms)" for k, r in render.items() if k != "lsj")
        + f"; LSJ max {render['lsj']['max']:.0f}, share {render['lsj']['share']:.1e} "
        f"({render['lsj']['ms']:.2f} ms)", flush=True)
    print(f"[report] detector train step card vs CPU: gradients "
          f"{det_parity['sound']['grads'][0]:.3e} of their rms (TF32 control "
          f"{det_parity['tf32']['grads'][0]:.3e}); det_train CLI "
          f"{det_cli['steps']} steps in {det_cli['wall']:.1f} s", flush=True)
    print(f"[report] refine classifier (ResNet-50, {REFINE_CROP} px): step card vs CPU "
          f"gradients {refine['sound']['grads'][0]:.3e} relative L2 (TF32 control "
          f"{refine['tf32']['grads'][0]:.3e}, float64 {refine['f64']:.3e}); warm step at batch "
          f"{REFINE_TRAIN_BATCH} bf16 {refine_time['bf16']['step_s']:.4f} s / f32 "
          f"{refine_time['f32']['step_s']:.4f} s, predict {refine_time['predict_images_per_s']:.1f}"
          f" images/s at {REFINE_TEST_BATCH}, the CLI's loop {refine_time['epoch_step_s']:.4f} s a "
          f"step (busy {100 * refine_time['busy']:.1f}%); refine_label {refine_cli['n_train']} + "
          f"{refine_cli['n_test']} crops, {REFINE_EPOCHS} epochs in {refine_cli['wall']:.1f} s; "
          f"the chain's 21 stages in {chain['wall']:.1f} s. No TPU kernel lies on the refine "
          "path (convolutions, batch norm, ReLU, max-pool: cuDNN and ATen, as the reference's "
          "is flax without Pallas) nor on the orchestrator's own; the chain's generation and "
          "fine-tune stages launch K1-K6", flush=True)
    print("[report] units: flash_attention_fwd and group_norm_act sum ms over one generation "
          f"batch (batch {E2E_BATCH}, {E2E_STEPS} PLMS steps; launches from the generation "
          "CLI run); flash_attention_bwd_dkv, flash_attention_bwd_dq and fused_adamw8bit_ema "
          f"sum over one training step (batch {TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}; launches "
          f"from the trainer CLI's {TRAIN_STEPS} steps); fused_adamw8bit is one training step "
          "without EMA (launches from the 2-step no-EMA path); both AdamW entries time the "
          "step's one launch over all quantized leaves, and their plain_ms sums the plain "
          "version a leaf. library_ms of both flash backward entries is SDPA's whole backward "
          "(dQ, dK, dV in one call); the fused AdamW has no single-call PyTorch equivalent "
          "(library_ms null)", flush=True)
    family_reports(fam, card)
    print(f"[report] TGATE (gate at step {TGATE_STEP} of {E2E_STEPS}, batch {E2E_BATCH}, "
          f"512x512): {tgate['warm']['tgate']:.4f} s/batch against the exact sampler's "
          f"{tgate['warm']['exact']:.4f} s in the same turns, a profiled TGATE batch busy "
          f"{tgate['busy_ms'] / 1e3:.3f} s; replay gate {tgate['replay']['replay']:.3g} of rms "
          f"(limit {TGATE_REPLAY_TOL_RMS}); launches a batch {tgate['launches']}", flush=True)
    for name, run in (("bf16 autocast", vae), ("f32, TF32 off", vae32)):
        print(f"[report] VAE pretraining (SD-1.4 VAE, {VAE_RES} px, batch {VAE_BATCH}, {name}): "
              f"warm {run['warm_s']:.4f} s/step, peak {run['peak'] / 2**30:.2f} GiB (its "
              f"own), recon {run['losses'][0]['recon']:.5f} -> {run['losses'][-1]['recon']:.5f}, "
              f"scaling_factor {run['scale']:.5f}; launches a step {run['launches']}", flush=True)
    par = vae32["parity"]
    print(f"[report] f32 VAE step card vs CPU ({VAE_F32_PARITY_RES} px): loss "
          f"{par['sound'][0]:.3g}, gradients {par['sound'][1]:.3g} (limit {VAE_F32_GRAD_TOL}; "
          f"control {par['control'][1]:.3g}). Units: flash_attention_bwd_dkv_f32_wide and "
          "flash_attention_bwd_dq_f32_wide (csrc/flash_bwd_f32_wide.cu, tensor cores: each "
          "call its scores pass and products, given the pieces) sum ms over one "
          f"f32 VAE pretraining step (batch {VAE_BATCH}, {VAE_RES} px: (8, 1024, 1, 512) twice), "
          "launches from phase 41's last step; their bound counts the products as three TF32 "
          "passes (as the other f32 rows); library_ms is SDPA's whole f32 backward at the "
          "same shape; flash_f32_split_wide_bwd is their pre-pass (flash_f32_split on q, "
          "k, v and dO: one launch a backward, shared by its two calls, two a step), bound by "
          "its bytes", flush=True)
    print(f"[report] profile report of phase 6's trace: busy {report['busy_ms']:.2f} ms, "
          f"{100 * report['share']:.1f}% of the traced window; top categories " + ", ".join(
              f"{k} {ms:.2f} ms" for k, ms in report["top"]), flush=True)
    print("[report] units: flash_attention_fwd_wide (D > 160) sums over one generation batch "
          "(the VAE decode's (2, 4096, 1, 512), once; its (8, 1024, 1, 512) row, 2 launches a "
          "VAE pretraining step, is printed in phase 4), launches from the generation CLI run, "
          "and flash_attention_fwd's launches there exclude it; the wide flash backward "
          "entries (flash_attention_bwd_dkv_wide, flash_attention_bwd_dq_wide, both wgmma and TMA) "
          "sum over one VAE "
          f"pretraining step (batch {VAE_BATCH}, {VAE_RES} px: (8, 1024, 1, 512) twice); "
          "launches from phase 36's last step; library_ms is SDPA's whole backward at the "
          "same shape", flush=True)
    par = f32["parity"]
    print(f"[report] full precision (phase 40, --mixed_precision no): the f32 SD step at batch "
          f"{TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES} warm {f32['step']['warm_s']:.4f} s/step, peak "
          f"{f32['step']['peak'] / 2**30:.2f} GiB (its own); at {F32_PARITY_RES} px card vs CPU "
          f"loss "
          f"{par['card']['loss']:.3g}, gradients {par['card']['grads']:.3g} of their norm (TF32 "
          f"control {par['tf32']['loss']:.3g}, {par['tf32']['grads']:.3g}); the SD CLI's "
          f"{F32_STEPS} steps and validation {f32['cli']['f32 sd-cli']['wall']:.1f} s, the token "
          f"CLI's {f32['cli']['f32 token-cli']['wall']:.1f} s. Units: the six f32 entries "
          f"(flash_attention_fwd_f32, flash_attention_fwd_f32_wide, flash_f32_split, "
          f"flash_attention_bwd_dkv_f32, flash_attention_bwd_dq_f32 (csrc/flash_bwd_f32.cu, "
          f"one pass at D <= 160), group_norm_act_f32) sum ms over every launch of the f32 "
          f"SD CLI's run, the launches they sit beside: {F32_STEPS} training steps (batch "
          f"{TRAIN_BATCH}, {TRAIN_RES}x{TRAIN_RES}), {math.ceil(TRAIN_TILES / TRAIN_BATCH)} "
          f"batches of the latent cache's encode and one validation batch ({F32_VAL_IMAGES} "
          f"images: {unet_calls} UNet calls at batch {2 * F32_VAL_IMAGES} and the decode); "
          "phase 40's '[f32] ... a step; a cache batch; a validation batch' lines split them; "
          "library_ms is SDPA on the f32 tensors (its whole backward for dK/dV and dQ) and "
          "F.group_norm + F.silu in f32; the two forward entries time the whole f32 forward "
          "call, its pre-pass (flash_f32_split of q, k, v, one launch a forward, no PyTorch "
          "equivalent: library_ms null) included; the backward entries time a kernel given "
          "the pieces of the backward's one pre-pass (flash_f32_split of q, k, v, dO, its rows "
          "in flash_f32_split's)", flush=True)
    mr0 = multi["ranks"][0]
    print(f"[report] multi-rank (phase 38, {MR_WORLD} ranks sharing the card over gloo): peak "
          f"memory a rank at --fsdp {MR_WORLD} "
          f"{', '.join(f'{r['peak'] / 2**30:.2f}' for r in multi['ranks'])} GiB against one "
          f"process's {multi['ref']['peak_rank_batch'] / 2**30:.2f} GiB at batch "
          f"{TRAIN_BATCH // MR_WORLD}; the update against one process's over the global batch: "
          f"{100 * mr0['flip_share']:.4f}% of the elements past lr/4; generation's worst PNG "
          f"mean |d| {multi['png_worst']:.3f} levels; no NCCL or multi-card speed measured",
          flush=True)
    print(f"[report] host libraries (phase 39): host library built in "
          f"{hostlib['host_build_s']:.2f} s, decode library {hostlib['codecs']}; fixtures max "
          f"|d| {hostlib['fixtures']['max_abs']} over {hostlib['fixtures']['decoded']} decoded, "
          f"{len(hostlib['fixtures']['raised'])} raised naming the missing library; labelling "
          f"decode {hostlib['decode']['stack_python_ms']:.3f} ms a stack with utils/png.py"
          + (f", {hostlib['decode']['stack_native_ms']:.3f} native" if "stack_native_ms"
             in hostlib["decode"] else ", native not built")
          + f"; 512-px tile {hostlib['decode']['tile_python_ms']:.1f} ms"
          + (f", {hostlib['decode']['tile_native_ms']:.2f} native" if "tile_native_ms"
             in hostlib["decode"] else "")
          + f"; procedural domain 48 + 16 in {hostlib['domain_s']:.2f} s; stack labeler "
          f"{LABELER_EPOCHS} epochs {hostlib['train_wall']:.1f} s, val AP "
          f"{hostlib['labeler']['ap']:.4f}, threshold {hostlib['labeler']['threshold']:.4f}, "
          f"cached {hostlib['cached_wall']:.3f} s; matchers native "
          f"{hostlib['match']['native_ms']:.4f} ms against numpy "
          f"{hostlib['match']['numpy_ms']:.3f} ms an image. No TPU kernel lies on this path: "
          "the procedural data, YOLOv8 training and prediction, and host decode and matching "
          "call no Pallas in the reference", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
