#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (agenda_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- compile agenda_tpu_torch/csrc/*.cu with nvcc for sm_90a, and
                show ptxas's registers and spills of each instantiation of the
                flash forward and the group norm;
  2. shapes  -- write a full-width SD-1.4-shaped pipeline with seeded random
                weights, load it, record the shape of every kernel call of
                one UNet call (CFG batch) and one VAE decode, and time a cold
                and a warm batch;
  3. parity  -- hold each kernel against its plain PyTorch version on the
                card in bf16 at every recorded shape (plus ragged S and a
                zero-padded head dim);
  4. timing  -- kernel, plain version and a PyTorch yardstick the port never
                calls (SDPA; F.group_norm + F.silu), beside the H100 bound;
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
 11. train e2e -- cli/finetune_sd.main trains 6 steps on 8 fabricated PNG
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
                4 steps on the 8 tiles, checkpoints at 2 and 4, one validation
                image at step 4: checkpoint-2/, learned_embeds_steps_4.bin and
                full_model_step_4/ load back;
 15. token CLI, stage 2 -- from full_model_step_4/ with --embedding_path, 2
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
                192 (the stacks) and 1024 (2048 fabricated tiles in two
                parts, a 100 MB tensor), serial and with 4 plan workers: the
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
                on 128 of the stacks (64 to validate) at the preset's batch
                with --pretrained from a fabricated
                mmdet/mmyolo checkpoint (80-class COCO heads): the import
                report (every tensor but the heads imported, the heads
                shape-skipped), one epoch, a resume for one more, det_test;
                Faster R-CNN once more with --device-aug;
 33. family timing -- each family's train step at its real_source and
                synthetic_target batches (cold, warm, images/s, peak memory,
                the card's busy share and kernel launches of a profiled step,
                the NMS rank loop's launches), and labelling the 512 stacks
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
                the reconstruction falling, warm s/step, peak memory, K1, the
                wide K2/K3 and K6 launches a step against the VAE's count),
                then pretrain_vae and its scaling_factor;
 37. wide flash backward -- dK/dV and dQ at D > 160 (the mma.sync kernels)
                against their plain versions at the VAE step's (8, 1024, 1,
                512), at (2, 4096, 1, 512) and a ragged (1, 333, 2, 264),
                timed beside their bound and SDPA's backward;
 38. report  -- a `kernels` JSON line (the six kernels, the flash backward's
                wide kernels as entries of their own; none is on the labelling,
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
# off the main path, ragged S: one warpgroup a block at D = 40 and at D = 80, and D
# zero-padded to the wide tiles' 512
EXTRA_FLASH = ((2, 1000, 8, 40), (2, 300, 4, 80), (1, 333, 2, 264))

E2E_ARGS = ["--resolution", "512", "--image-size", "112", "--num-inference-steps", "20",
            "--batch-size", "2", "--num-images", "4",
            "--word_token_heatmaps", "cars", "aerial", "utah"]
E2E_BATCH, E2E_IMAGES, E2E_STEPS, E2E_WORDS = 2, 4, 20, ("cars", "aerial", "utah")
PROFILE_PROMPT = "an aerial view image with cars in utah"

TRAIN_BATCH, TRAIN_RES, TRAIN_STEPS, TRAIN_TILES, TILE = 4, 512, 6, 8, 112
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
STAGE1_STEPS, STAGE2_STEPS = 4, 2
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
DET_STEP, DET_AUG_IMAGES = 1000, 64
DET_TIMING = (("synthetic_heatmap", 192), ("synthetic_target", 1024))
# card vs CPU, both f32, one train step from the same weights and batch: each
# limit lies between the sound runs' largest reading and the TF32 control's
# (det_readings says what each reads; the readings, sound / TF32 control, are
# the H100's with the CPU's TAL assignment on both sides): the loss and its
# parts 1.4e-7 / 4.5e-5 relative; the gradients 3.5e-3 / 1.2 of their rms (the
# CPU's own f32 error against a float64 run is the larger: 3.5e-3 at sppf.cv1,
# the card's 5.8e-4; the float64 runs agree to 2.8e-10); the batch statistics
# 1.4e-5 / 1.5e-2 of their move; the update 3.5e-3 / 1.2 and the EMA 3.3e-3 /
# 1.2 of theirs; TAL, each side's own, 8 / 22 anchors of 64 512 (8 of the
# CPU's 5 780 fg anchors sit between two GT boxes of near-equal IoU)
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
# synthetic_heatmap (192, the 512 stacks, 3 epochs of 3 steps) and
# synthetic_target (1024, two parts of 1024 fabricated tiles: a 100 MB
# tensor, 3 epochs of 2 steps) batches, the loop timed from epoch 1 (cut
# from 4096 tiles and 4 epochs at 192 to keep the script within its limit)
RENDER_MEAN_TOL, RENDER_FAR_SHARE, LSJ_DIFF_SHARE = 1e-3, 1e-4, 1e-3
RENDER_SLOTS, RENDER_FORCED = 24, 4
DEVICE_AUG_TILES = 2048
DEVICE_AUG_TIMING = (("synthetic_heatmap", 192, 3), ("synthetic_target", 1024, 3))


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
# wide K2/K3), under bf16 autocast; VAE_STEPS steps of Adam at VAE_LR, the
# first two cold; then pretrain_vae end to end for 2 steps and its
# scaling_factor
VAE_RES, VAE_BATCH, VAE_STEPS, VAE_LR, VAE_IMAGES = 256, 8, 8, 1e-4, 32
# the wide flash backward (D > 160) against its plain version (phase 37):
# the VAE step's shape, a longer S, and a ragged S at a D the tiles pad
WIDE_FLASH_BWD = {(8, 1024, 1, 512): None, (2, 4096, 1, 512): 0, (1, 333, 2, 264): 0}
PROFILE_SUM_TOL = 0.01  # phase 6's report: its categories' sum over its busy ms, relative

def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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

    eager(2)  # warm up (workspace allocation, lazy module loading)
    torch.cuda.synchronize()
    iters = int(min(max_iters, max(3, target_ms / max(timed(eager, 1), 1e-3))))
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


def record_shapes(pipe, batch: int):
    """Shapes, and calls per batch, of every kernel call of one UNet call and one decode."""
    import torch

    from agenda_tpu_torch.models.layers import Attention, GroupNormAct, VAEAttention

    calls = {"flash": [], "gn": []}
    hooks = []

    def on_gn(m, args):
        calls["gn"].append((tuple(args[0].shape), m.num_groups, m.eps, m.act))

    def on_self_attn(m, args):
        x = args[0]
        if len(args) == 1:  # attn1: no context
            calls["flash"].append((x.shape[0], x.shape[1], m.heads, x.shape[2] // m.heads))

    def on_vae_attn(m, args):
        b, c, h, w = args[0].shape
        calls["flash"].append((b, h * w, 1, c))

    for mod in list(pipe.unet.modules()) + list(pipe.vae.decoder.modules()):
        if isinstance(mod, GroupNormAct):
            hooks.append(mod.register_forward_pre_hook(on_gn))
        elif isinstance(mod, Attention):
            hooks.append(mod.register_forward_pre_hook(on_self_attn))
        elif isinstance(mod, VAEAttention):
            hooks.append(mod.register_forward_pre_hook(on_vae_attn))
    unet_calls = len(pipe.timestep_table(E2E_STEPS))
    hw, dev = pipe.latent_hw, pipe.device
    with torch.no_grad():
        ctx = torch.randn(2 * batch, 77, pipe.unet.config.cross_attention_dim, device=dev)
        pipe.unet(torch.randn(2 * batch, hw, hw, 4, device=dev),
                  torch.full((2 * batch,), 500.0, device=dev), ctx, collect_attn=True)
        n_unet = {k: len(v) for k, v in calls.items()}
        pipe.vae.decode(torch.randn(batch, hw, hw, 4, device=dev))
    for h in hooks:
        h.remove()
    per_batch = {"flash": {}, "gn": {}}
    for kind, lst in calls.items():
        for i, key in enumerate(lst):
            per_batch[kind][key] = per_batch[kind].get(key, 0) + (unet_calls if i < n_unet[kind]
                                                                  else 1)
    return per_batch, unet_calls


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
        maps = ""
        if d <= 160:  # the wgmma kernel encodes three tensor maps a launch
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
                                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    plan_fn(shape[0], c, n // (shape[0] * c), groups, plan)
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


def build_trainer(model_dir: str, dev):
    """The full-width model through the trainer API, as cli/finetune_sd builds
    it; returns (unet, make, vocab size) with make(use_ema) -> (state, step)."""
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
    frozen = torch.bfloat16 if dev.type == "cuda" else torch.float32
    vae = _build(AutoencoderKL, bundle.vae_config, bundle.vae_state, dev, frozen)
    text = _build(CLIPTextModel, bundle.text_config, bundle.text_state, dev, frozen)
    tx = make_optimizer(lr_schedule("constant", 1e-6, 0, 100), use_8bit_adam=True)

    def make(use_ema: bool):
        state = init_train_state(unet.train(), tx, use_ema)
        return state, make_train_step(unet, vae, text, make_schedule(), tx,
                                      LossConfig(snr_gamma=5.0), use_ema)

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
    want = {"flash_attention_fwd": expected["flash_per_step"],
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

    names = ("flash_fwd_wgmma|flash_fwd_wide|flash_bwd_dkv_wide|flash_bwd_dq_wide|flash_bwd_dkv"
             "|flash_bwd_dq|groupnorm|fused_adamw8bit")
    found, current = {}, None
    for line in log.splitlines():
        m = re.search(rf"({names})_kernel(?:I((?:L[ib]\d+E)+)E)?", line)
        if m and ("Compiling entry function" in line or "Function properties" in line):
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            current = f"{m.group(1)}_kernel" + (f"<{', '.join(args)}>" if args else "")
        elif current and "spill stores" in line:
            found[current] = line.strip()
        elif current and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            found[current] = f"{regs.group(1) if regs else '?'} registers, {found.get(current, '')}"
            current = None
    return found


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
        if name.startswith("flash_bwd_") and tag == "flash bwd":
            nd = int(name[name.index("<") + 1:-1]) if "<" in name else 512  # wide: D <= 512
            print(f"[ptxas] {name}: {text}; {smem('dkv' in name, nd)} bytes of dynamic shared "
                  "memory", flush=True)
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
          f"syncs of steps 1-3 and the checkpoint snapshots of steps 3 and 6); peak memory "
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
    """TF32 for cuDNN's convolutions and cuBLAS's matmuls: the control."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
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


def det_split(labels: dict, root: str, n_train: int = DET_TRAIN_TILES) -> Tuple[str, str]:
    """The 512 stacks' COCO split into n_train to train on and the
    DET_VAL_TILES after DET_TRAIN_TILES to validate on -> the two file names
    under root."""
    with open(os.path.join(root, labels["all"])) as f:
        coco = json.load(f)
    names = []
    for name, images in (("det_train.json", coco["images"][:n_train]),
                         ("det_val.json", coco["images"][DET_TRAIN_TILES:
                                                         DET_TRAIN_TILES + DET_VAL_TILES])):
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
    from agenda_tpu_torch.detect.augment import stage2_aug
    from agenda_tpu_torch.detect.optim import DetectorSGD
    from agenda_tpu_torch.detect.runner import (DetectorRunner, batch_to_device, full_f32,
                                                load_variables)

    state = load_variables(labels["ckpts"]["yolov8"][1])
    out = {}
    for stage, bs in DET_TIMING:
        cfg = det_preset(root, labels["all"], stage)
        require(cfg.runner.batch_size == bs, f"the {stage} preset's batch")
        ds = cfg.build_train_dataset()
        for j in range(len(ds)):
            ds._load_scaled(j)  # the tile cache, as after a first epoch
        aug_ms = {}
        for recipe in ("mix", "stage2"):
            if recipe == "stage2":
                ds.aug = stage2_aug(ds.aug)
            t0 = time.perf_counter()
            for j in range(DET_AUG_IMAGES):
                ds[j]
            aug_ms[recipe] = (time.perf_counter() - t0) * 1e3 / DET_AUG_IMAGES
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
            n_loop = 2 if bs > LABEL_BATCH else 3
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
    (synthetic_target, two fabricated parts of 1024 tiles), each serial and
    with 4 plan workers: the loop's s/step from the first step of epoch 1 to
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
        for workers in (0, 4):
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
CHAIN_KERNELS = {
    "finetune_sd": ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                    "fused_adamw8bit_ema", "group_norm_act"),
    "token_stage1": ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                     "group_norm_act"),
    "token_stage2": ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                     "fused_adamw8bit", "group_norm_act"),
    "generate_source": ("flash_attention_fwd", "group_norm_act"),
    "generate_target": ("flash_attention_fwd", "group_norm_act"),
    "generate_target_nocars": ("flash_attention_fwd", "group_norm_act"),
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
# FAM_CLI_TILES stacks of phase 22's split (cut from its 384 to keep the
# script within its time limit), a resume for one more, det_test on phase
# 22's validation stacks; Faster R-CNN once more with
# --device-aug; phase 33: timing at the real_source and synthetic_target
# batches (FAM_WARM synchronised steps after a cold one, the batch on the
# card) and labelling at LABEL_BATCH over the 512 stacks
FAM_EPOCHS, FAM_WARM, FAM_CLI_TILES = 1, 2, 128


def family_preset(root: str, ann: str, detector: str, stage: str = "real_source"):
    from agenda_tpu_torch.detect.configs import DatasetSpec, preset

    return preset(stage, detector, [DatasetSpec(root, ann, "")],
                  output_dir=os.path.join(root, f"fam_{detector}"))


def family_weights(cfg, seed: int = 0) -> dict:
    """A family's seeded init, batch-norm statistics measured on noise."""
    import torch

    from agenda_tpu_torch.detect.fabricate import calibrate_batch_norm

    fam = cfg.build_family()
    gen = torch.Generator().manual_seed(seed)
    state = fam.init_variables(gen)
    return calibrate_batch_norm(fam, state, torch.rand(16, LABEL_IMG, LABEL_IMG, 3,
                                                       generator=gen))


def rel_l2(got: dict, want: dict, base: dict = None) -> float:
    """||got - want|| / ||want - base|| over all tensors (base 0: ||want||)."""
    num = den = 0.0
    for k, w in want.items():
        w = w.double()
        b = base[k].double() if base is not None else 0.0
        num += float((got[k].double() - w).square().sum())
        den += float((w - b).square().sum())
    return math.sqrt(num / max(den, 1e-300))


def family_step_on(dev, cfg, state: dict, batch: dict, targets=None, mode: str = "f32") -> dict:
    """One train step of ``cfg``'s family through the runner's optimizer on
    ``dev`` from ``state`` (CPU tensors), update FAM_STEP, the samplers' and
    drop path's uniforms from a CPU generator on both sides; the two-stage
    families take ``targets`` (the CPU's RCNN targets) where given. Also
    predicts on ``state``. ``mode`` "tf32" is the control. All on the CPU."""
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

    arith = tf32_on() if mode == "tf32" else full_f32(dev)
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
        card = family_step_on(dev, cfg, state, batch, ref["targets"])
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
    card over the first FAM_CLI_TILES stacks of phase 22's split (64 to
    validate), at the preset's batch (padded past the stacks: YOLOv5's 200),
    --pretrained from a fabricated mmdet/mmyolo checkpoint with
    80-class COCO heads: the import report (every tensor but the heads
    imported, the heads shape-skipped, nothing unmatched), FAM_EPOCHS epochs
    with validation each, a resume from latest.safetensors for one more,
    det_test on the validation set; Faster R-CNN once more with
    --device-aug for one epoch."""
    import pickle

    from agenda_tpu_torch.cli import det_test, det_train
    from agenda_tpu_torch.detect.fabricate import write_mm_checkpoint
    from agenda_tpu_torch.detect.runner import SIDECAR, DetectorRunner
    from agenda_tpu_torch.io.safetensors_io import load_file

    train_ann, val_ann = det_split(labels, root, FAM_CLI_TILES)
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
        epochs = 1 if extra else FAM_EPOCHS
        with mock.patch.object(DetectorRunner, "train", spy):
            det_train.main(args + ["--max-epochs", str(epochs)])
            t_train = time.perf_counter() - t0
            if not extra:
                det_train.main(args + ["--max-epochs", str(epochs + 1), "--resume",
                                       os.path.join(work, "latest.safetensors")])
        with open(os.path.join(work, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r for r in rows if "loss" in r]  # logged at steps 1, 2, 20, 40, ...
        vals = [r for r in rows if "bbox_mAP" in r]
        side = load_file(os.path.join(work, SIDECAR))
        bs = runners[0].cfg.batch_size
        n_steps = -(-FAM_CLI_TILES // bs) * (epochs + (0 if extra else 1))
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
        want_epochs = list(range(epochs + (0 if extra else 1)))
        require(int(side["gstep"]) == n_steps and int(side["epoch"]) == want_epochs[-1]
                and [r["epoch"] for r in vals] == want_epochs, f"{tag}: steps or validations")
        require(runners[0].aug_path == ("device" if extra else "host"), f"{tag}: aug path")
        require(len(recs) == n_pkl == DET_VAL_TILES, f"{tag}: det_test records")
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
    """Phase 33: for each family at its real_source and synthetic_target
    batches: the train step (make_train_step, the batch on the card) cold
    and warm, images/s, peak memory, the card's busy share of a profiled
    step and its kernel launches, the NMS ranks and launches a step; then
    labelling the 512 stacks at LABEL_BATCH (DetectorRunner.test, PNG
    decode included, the second pass timed), its images/s and NMS launches
    a batch."""
    import numpy as np
    import torch

    from agenda_tpu_torch.detect.configs import DatasetSpec
    from agenda_tpu_torch.detect.optim import make_optimizer
    from agenda_tpu_torch.detect.runner import DetectorRunner, batch_to_device, full_f32

    out = {}
    for det in FAMILIES:
        state = family_weights(family_preset(root, labels["all"], det))
        base = det_first_batch(family_preset(root, labels["all"], det), 64)
        for stage in ("real_source", "synthetic_target"):
            cfg = family_preset(root, labels["all"], det, stage)
            bs = cfg.runner.batch_size
            if (det, bs) in out:
                continue  # ViTDet's stages share a batch
            reps = -(-bs // 64)
            batch = {k: np.concatenate([v] * reps)[:bs] for k, v in base.items()}
            fam = cfg.build_family()
            runner = DetectorRunner(fam, cfg.runner, device=dev)
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
            print(f"[fam-timing] {det} {stage} batch {bs}: step cold {cold:.3f} s, warm "
                  + ", ".join(f"{w:.4f}" for w in walls) + f" -> {warm:.4f} s/step, "
                  f"{bs / warm:.1f} images/s; peak {peak / 2**30:.2f} GiB; a profiled step: "
                  f"device busy {busy_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
                  f"({100 * row['busy']:.1f}%), {launches} kernel launches; NMS "
                  f"{nms_step['calls']} calls, {nms_step['ranks']} ranks = "
                  f"{2 * nms_step['ranks']} loop launches a step", flush=True)
            require(all(math.isfinite(w) for w in walls), f"{det}: step time")
            del st, tb, step, opt
            torch.cuda.empty_cache()
        # labelling the 512 stacks at LABEL_BATCH
        cfg = family_preset(root, labels["all"], det)
        ds = cfg.build_eval_dataset(DatasetSpec(root, labels["all"], ""))
        runner = DetectorRunner(cfg.build_family(), cfg.runner, device=dev)
        patches, nms = nms_counter()
        with patches:
            runner.test(state, ds, batch_size=LABEL_BATCH)  # cold
            nms.update(calls=0, ranks=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = runner.test(state, ds, batch_size=LABEL_BATCH)
            wall = time.perf_counter() - t0
        n_batches = -(-len(ds) // LABEL_BATCH)
        out[(det, "label")] = {"images_per_s": len(ds) / wall,
                               "nms_launches": 2 * nms["ranks"] // n_batches}
        print(f"[fam-timing] {det} labelling {len(ds)} stacks at batch {LABEL_BATCH}: "
              f"{len(ds) / wall:.1f} images/s warm (host clock, PNG decode included), NMS "
              f"{nms['calls'] // n_batches} calls and {2 * nms['ranks'] // n_batches} loop "
              f"launches a batch; {sum(len(r['pred_instances']['scores']) for r in recs)} "
              f"detections", flush=True)
        require(len(recs) == len(ds), f"{det}: labelling records")
        del runner
        torch.cuda.empty_cache()
    return out


def family_phases(tmp: str, dev, phase_s: dict) -> dict:
    """Phases 31-34 over fresh heatmap stacks (phase 17's fabricator): the
    step card vs CPU, det_train/det_test with --pretrained, timing, and the
    chain with detector faster-rcnn."""
    import torch

    label_root = os.path.join(tmp, "fam_labels")
    labels = labels_fabricate(label_root)
    t_phase = time.perf_counter()
    parity = family_parity(labels, label_root, dev)
    phase_s["family parity (31)"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    cli = family_cli_phase(labels, label_root, dev)
    phase_s["family det_train/det_test (32)"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    timing = family_timing(labels, label_root, dev)
    phase_s["family timing (33)"] = time.perf_counter() - t_phase
    shutil.rmtree(label_root)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
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
            print(f"[report] {det} labelling at batch {LABEL_BATCH}, {LABEL_IMG} px ({card}): "
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


def vae_pretrain_phase(model_dir: str, dev) -> dict:
    """Phase 36: SD-1.4's VAE from the fabricated pipeline at VAE_RES px and
    VAE_BATCH, under bf16 autocast: VAE_STEPS steps of make_vae_pretrain_step
    (each synchronised; the first two cold), the losses (finite, the
    reconstruction falling), the warm s/step, peak memory and the launches
    of K1, K2, K3 and K6 a step against the VAE's count (two mid-block
    attentions, one per GroupNorm module; the GroupNorm backward is the
    plain recompute); then pretrain_vae end to end and its scaling_factor."""
    import numpy as np
    import torch

    from agenda_tpu_torch.io.diffusers_io import load_pipeline
    from agenda_tpu_torch.models.layers import GroupNormAct, VAEAttention
    from agenda_tpu_torch.models.vae import AutoencoderKL
    from agenda_tpu_torch.train import vae_pretrain as vp
    from agenda_tpu_torch.train.optim import make_adam

    bundle = load_pipeline(model_dir)
    vae = AutoencoderKL(bundle.vae_config)
    vae.load_state_dict(bundle.vae_state, strict=True)
    vae.to(dev)
    images = vae_images(VAE_IMAGES, VAE_RES, 36)
    pixels = images.astype(np.float32) / 127.5 - 1.0
    tx = make_adam(VAE_LR)
    opt_state = tx.init(dict(vae.named_parameters()))
    step = vp.make_vae_pretrain_step(vae, tx, kl_weight=1e-4)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = vp.latent_shape(vae, VAE_BATCH, VAE_RES, VAE_RES)
    want = {"flash_attention_fwd": 2, "flash_attention_bwd_dkv": 2,
            "flash_attention_bwd_dq": 2,
            "group_norm_act": sum(isinstance(m, GroupNormAct) for m in vae.modules())}
    require(sum(isinstance(m, VAEAttention) for m in vae.modules()) == 2,
            "the VAE should have two mid-block attentions")
    losses, walls, counts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(VAE_STEPS):
        batch = torch.from_numpy(pixels[rng.randint(0, len(pixels), VAE_BATCH)]).to(dev)
        eps = torch.randn(shape, generator=gen, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        m = step(opt_state, batch, eps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append({k: v for k, v in read_counts().items() if k in want})
        losses.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    warm = sum(walls[2:]) / len(walls[2:])
    print(f"[vae] SD-1.4 VAE {tuple(bundle.vae_config.block_out_channels)} at {VAE_RES} px, batch "
          f"{VAE_BATCH}, bf16 autocast, Adam lr {VAE_LR}: steps " + ", ".join(
              f"{w:.4f}" for w in walls) + f" s -> warm {warm:.4f} s/step "
          f"({VAE_BATCH / warm:.1f} images/s); peak {peak / 2**30:.2f} GiB", flush=True)
    print("[vae] recon " + ", ".join(f"{x['recon']:.5f}" for x in losses) + "; kl " + ", ".join(
        f"{x['kl']:.3f}" for x in losses), flush=True)
    print(f"[vae] launches a step {counts[-1]} (expected {want})", flush=True)
    require(all(math.isfinite(v) for x in losses for v in x.values()), "VAE losses not finite")
    require(losses[-1]["recon"] < losses[0]["recon"], "the VAE's reconstruction did not fall")
    require(all(c == want for c in counts), f"VAE step launches {counts} differ from {want}")

    t0 = time.perf_counter()
    _, scale, recon = vp.pretrain_vae(vae, images, steps=2, batch_size=VAE_BATCH, lr=VAE_LR,
                                      seed=1)
    torch.cuda.synchronize()
    print(f"[vae] pretrain_vae, 2 steps over {VAE_IMAGES} images: scaling_factor {scale:.5f}, "
          f"recon {recon:.5f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    require(math.isfinite(scale) and scale > 0 and math.isfinite(recon),
            "pretrain_vae's scaling_factor or recon is not finite")
    del vae, opt_state, step
    torch.cuda.empty_cache()
    return {"warm_s": warm, "peak": peak, "losses": losses, "scale": scale,
            "launches": counts[-1]}


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
    from agenda_tpu_torch.kernels.flash import flash_attention_fwd
    from agenda_tpu_torch.kernels.groupnorm import group_norm_act

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_name_power()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} ({card})", flush=True)

    # 1. build
    phase_s = {}
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"[build] {lib.path.name}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s)", flush=True)
    for name, text in sorted(ptxas_report(lib.log).items()):
        if not name.startswith("flash_bwd_"):  # the backward's: phase 10
            print(f"[ptxas] {name}: {text}", flush=True)

    phase_s["build (1)"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="agenda_chip_smoke_") as tmp:
        # 2. shapes of the main path
        t_phase = time.perf_counter()
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
            flash_attention_fwd.launches = 0
            group_norm_act.launches = 0
            stats = data_generation.main([
                "--pretrained-model-path", model_dir, "--learnable-tokens-embedding-path",
                embeds, "--save-dir", save_dir, "--device", "cuda", *E2E_ARGS])
            torch.cuda.synchronize()
            launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                        "group_norm_act": group_norm_act.launches}
        n_batches = stats["batches"]
        want = {k: v * n_batches for k, v in expected.items()}
        print(f"[e2e] {n_batches} batches of {E2E_BATCH}: {stats['seconds'] / n_batches:.3f} "
              f"s/batch, {stats['images'] / stats['seconds']:.3f} images/s; launches {launches} "
              f"(expected {want})", flush=True)
        require(launches == want, "kernel launch counts differ from the config's count")
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
        t_phase = time.perf_counter()
        tgate = tgate_phase(pipe, model_dir, embeds, tmp, expected, warm_s)
        del pipe, latents
        torch.cuda.empty_cache()
        phase_s["TGATE (35)"] = time.perf_counter() - t_phase

        # 8 + 9. the training path through the trainer API, then the no-EMA (K4) path
        t_phase = time.perf_counter()
        dev = torch.device("cuda")
        train_shapes, leaves, k4_launches, _ = train_api_phase(model_dir, unet_cfg, vae_cfg, dev)
        phase_s["train shapes, timing, K4 path (8-9)"] = time.perf_counter() - t_phase

        # 10. parity and timing of the training kernels
        t_phase = time.perf_counter()
        bwd = flash_bwd_rows(train_shapes)
        adamw, adamw_ema = adamw_rows(leaves)
        phase_s["train parity and timing (10)"] = time.perf_counter() - t_phase

        # 11. the trainer's CLI end to end
        t_phase = time.perf_counter()
        train_launches = train_e2e(model_dir, tmp, unet_cfg, vae_cfg)
        shutil.rmtree(os.path.join(tmp, "finetuned"))  # the disk for the later phases
        phase_s["train e2e (11)"] = time.perf_counter() - t_phase

        # 12. the group norm's tail path, then generation at 384x384
        t_phase = time.perf_counter()
        gn += gn_tail_rows()
        tail_resolution_e2e(model_dir, embeds, tmp, expected)
        phase_s["GN tail (12)"] = time.perf_counter() - t_phase

        # 13. the token step through the trainer API
        t_phase = time.perf_counter()
        token = token_api_phase(model_dir, unet_cfg, vae_cfg, dev)
        phase_s["token API (13)"] = time.perf_counter() - t_phase

        # 14-15. the token CLI, stage 1 then stage 2
        t_phase = time.perf_counter()
        token_cli_phases(model_dir, tmp, unet_cfg, vae_cfg, unet_calls)
        phase_s["token CLI (14-15)"] = time.perf_counter() - t_phase

        # 16. gradient accumulation through the SD CLI
        t_phase = time.perf_counter()
        accum_launches = accumulation_e2e(model_dir, tmp, unet_cfg, vae_cfg)
        phase_s["accumulation (16)"] = time.perf_counter() - t_phase

        # 36-37. VAE pretraining at SD-1.4's widths; the wide flash backward's rows
        t_phase = time.perf_counter()
        vae = vae_pretrain_phase(model_dir, dev)
        phase_s["VAE pretraining (36)"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        wide_shapes = {shape: vae["launches"]["flash_attention_bwd_dkv"] if n is None else n
                       for shape, n in WIDE_FLASH_BWD.items()}
        wide = flash_bwd_rows(wide_shapes, extra=(), tag="wide flash bwd")
        phase_s["wide flash backward (37)"] = time.perf_counter() - t_phase

        # 17-20. the labelling stages: heatmap stacks, YOLOv8n/s on the card
        t_phase = time.perf_counter()
        label_root = os.path.join(tmp, "labels")
        labels = labels_fabricate(label_root)
        detector_parity(labels, dev)
        runner_parity(labels, label_root, dev)
        chosen = labelling_stages(labels, label_root, dev)
        label_timing = labelling_timing(labels, label_root, dev)
        phase_s["labelling (17-20)"] = time.perf_counter() - t_phase

        # 21-23. detector training: a train step card vs CPU, the CLI, timing
        t_phase = time.perf_counter()
        det_parity = det_train_parity(labels, label_root, dev)
        det_cli = det_cli_phase(labels, label_root, dev)
        det_time = det_timing(labels, label_root, dev)
        phase_s["detector training (21-23)"] = time.perf_counter() - t_phase

        # 24-26. device augmentation: the render card vs CPU, the loop, the CLI
        t_phase = time.perf_counter()
        render = render_parity(labels, label_root, dev)
        devaug = device_aug_timing(labels, label_root, dev)
        det_cli_phase(labels, label_root, dev, ("--device-aug", "--device-aug-workers", "2"),
                      "devaug-cli")
        phase_s["device augmentation (24-26)"] = time.perf_counter() - t_phase
        shutil.rmtree(label_root)

        # 27-29. the refine classifier: a step card vs CPU, the CLI, timing
        t_phase = time.perf_counter()
        refine = refine_parity(dev)
        phase_s["refine parity (27)"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        refine_root = os.path.join(tmp, "refine")
        refine_cli = refine_cli_phase(refine_root, dev)
        refine_time = refine_timing(refine_cli, dev)
        shutil.rmtree(refine_root)
        torch.cuda.empty_cache()
        phase_s["refine CLI and timing (28-29)"] = time.perf_counter() - t_phase

        # 30. the whole chain through the port's orchestrator
        t_phase = time.perf_counter()
        chain = chain_phase(os.path.join(tmp, "chain"), dev)
        phase_s["chain (30)"] = time.perf_counter() - t_phase

        # 31-34. the other detector families: Faster R-CNN, YOLOv5m/s, ViTDet
        fam = family_phases(tmp, dev, phase_s)

    kernels = [
        summarize("flash_attention_fwd", "cuda", "agenda_tpu_torch/csrc/flash_fwd.cu",
                  "agenda_tpu/kernels/flash.py:55", flash, launches["flash_attention_fwd"]),
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
        summarize("fused_adamw8bit", "cuda", "agenda_tpu_torch/csrc/fused_adamw.cu",
                  "agenda_tpu/kernels/fused_adamw.py:111", adamw,
                  k4_launches["fused_adamw8bit"]),
        summarize("fused_adamw8bit_ema", "cuda", "agenda_tpu_torch/csrc/fused_adamw.cu",
                  "agenda_tpu/kernels/fused_adamw.py:118", adamw_ema,
                  train_launches["fused_adamw8bit_ema"]),
    ]
    for name, sec in phase_s.items():
        print(f"[phases] {name}: {sec:.1f} s", flush=True)
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
    print(f"[report] VAE pretraining (SD-1.4 VAE, {VAE_RES} px, batch {VAE_BATCH}, bf16 "
          f"autocast): warm {vae['warm_s']:.4f} s/step, peak {vae['peak'] / 2**30:.2f} GiB, "
          f"recon {vae['losses'][0]['recon']:.5f} -> {vae['losses'][-1]['recon']:.5f}, "
          f"scaling_factor {vae['scale']:.5f}; launches a step {vae['launches']}", flush=True)
    print(f"[report] profile report of phase 6's trace: busy {report['busy_ms']:.2f} ms, "
          f"{100 * report['share']:.1f}% of the traced window; top categories " + ", ".join(
              f"{k} {ms:.2f} ms" for k, ms in report["top"]), flush=True)
    print("[report] units: the wide flash backward entries (flash_attention_bwd_dkv_wide, "
          "flash_attention_bwd_dq_wide; D > 160) sum over one VAE pretraining step (batch "
          f"{VAE_BATCH}, {VAE_RES} px: (8, 1024, 1, 512) twice); launches from phase 36's last "
          "step; library_ms is SDPA's whole backward at the same shape", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
