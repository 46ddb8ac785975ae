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
  6. profile -- torch.profiler breaks one more batch down by kernel group;
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
 21. report  -- a `kernels` JSON line (six kernels; none is on the labelling
                path), the card's name and power limit, and last the device
                JSON line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. It imports nothing of JAX or agenda_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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


def device_times(run) -> Tuple[dict, float]:
    """torch.profiler over one run(): ({CUDA kernel, memcpy or memset name:
    (us, count)}, the run's wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    per_name = {}  # CUDA kernel (and memcpy/memset) events only: the ops' rows would double count
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return per_name, wall


def profile_run(run, tag: str, what: str, warm_s: float) -> None:
    """torch.profiler breakdown of one run() by kernel group (last in its path:
    the profiler's CUPTI hooks can slow later launches)."""
    per_name, wall = device_times(run)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    groups = {}
    for name, (us, n) in per_name.items():
        low = name.lower()
        group = next((g for g, subs in KERNEL_GROUPS if any(x in low for x in subs)), "other")
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

    names = "flash_fwd_wgmma|flash_fwd_wide|flash_bwd_dkv|flash_bwd_dq|groupnorm|fused_adamw8bit"
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


def flash_bwd_rows(per_step):
    """Parity and timing of the dK/dV and dQ kernels at every training shape."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels import _build
    from agenda_tpu_torch.kernels import flash as fl

    kernels = _build.load_library()
    smem = kernels.function("agenda_flash_bwd_smem_bytes", [ctypes.c_int, ctypes.c_int])
    for name, text in sorted(ptxas_report(kernels.log).items()):
        if name.startswith("flash_bwd_"):
            nd = int(name[name.index("<") + 1:-1])
            print(f"[ptxas] {name}: {text}; {smem('dkv' in name, nd)} bytes of dynamic shared "
                  "memory", flush=True)
    rows = {"dkv": [], "dq": []}
    pair = []  # (shape, launches a step, dK/dV + dQ ms, SDPA backward ms)
    shapes = dict(per_step)
    for shape in EXTRA_FLASH_BWD:
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
            require(worst <= 1.0, f"flash backward {kind} {shape}: max err {err}, {worst:.4g} "
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
            print(f"flash bwd {kind} (B,S,H,D)={shape} x{count}/step  err {errs[kind][0]:.3g}, "
                  f"{errs[kind][1]:.4g} of the limit  kernel {ms:.4f} ms (eager {eager:.4f})  "
                  f"plain {plain:.4f} ms  SDPA backward (dQ, dK, dV) {lib:.4f} ms (eager "
                  f"{lib_eager:.4f})  bound {1e3 * terms[term]:.4f} ms ({term}: {products} x "
                  f"2*B*H*S^2*D = {flops:.4g} ops over 989e12/s = "
                  f"{1e3 * terms['tensor operations']:.4f} ms; B*H*S^2 = {exps:.4g} exp over "
                  f"3.9e12/s = {1e3 * terms['exponentials']:.4f} ms; {nbytes:.4g} bytes over "
                  f"3.35e12/s = {1e3 * terms['bytes']:.4f} ms)", flush=True)
        pair.append((shape, count, rows["dkv"][-1]["ms"] + rows["dq"][-1]["ms"], lib))
        print(f"flash bwd pair (B,S,H,D)={shape}: dK/dV + dQ {pair[-1][2]:.4f} ms against SDPA's "
              f"backward {lib:.4f} ms ({pair[-1][2] / lib:.2f}x)", flush=True)
        del q, k, v, do, out, lse, delta, got, want, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    ours, sdpa = (sum(n * x[i] for _, n, *x in pair) for i in (0, 1))
    print(f"flash bwd pair per training step: dK/dV + dQ {ours:.4f} ms against SDPA's backward "
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

        # 6. where the time goes
        profile_run(lambda: pipe.generate_async(PROFILE_PROMPT, list(range(E2E_BATCH)),
                                                **generate_kwargs())(),
                    "profile", f"batch {E2E_BATCH} at 512x512, {E2E_STEPS} steps", warm_s)
        del pipe, latents
        torch.cuda.empty_cache()
        phase_s["generation (phases 2-6)"] = time.perf_counter() - t_phase

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

        # 17-20. the labelling stages: heatmap stacks, YOLOv8n/s on the card
        t_phase = time.perf_counter()
        label_root = os.path.join(tmp, "labels")
        labels = labels_fabricate(label_root)
        detector_parity(labels, dev)
        runner_parity(labels, label_root, dev)
        chosen = labelling_stages(labels, label_root, dev)
        label_timing = labelling_timing(labels, label_root, dev)
        phase_s["labelling (17-20)"] = time.perf_counter() - t_phase

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
