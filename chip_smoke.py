#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (agenda_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- compile agenda_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  2. shapes  -- write a full-width SD-1.4-shaped pipeline with seeded random
                weights, load it, record the shape of every kernel call of
                one UNet call (CFG batch) and one VAE decode, and time a cold
                and a warm batch;
  3. parity  -- hold each kernel against its plain PyTorch version on the
                card in bf16 at every recorded shape (plus ragged S and a
                zero-padded head dim);
  4. timing  -- kernel, plain version and a PyTorch yardstick the port never
                calls (SDPA; F.group_norm + F.silu), beside the H100 bound;
                device times replay a CUDA graph of the calls;
  5. e2e     -- the port's CLI (cli/data_generation.main) generates 4 images
                with 3 word heatmaps at 512x512, 20 PLMS steps, batch 2; the
                kernel launch counts must equal the counts from the config;
  6. profile -- torch.profiler breaks one more batch down by kernel group;
  7. report  -- a `kernels` JSON line, the card's name and power limit, and
                last the device JSON line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. It imports nothing of JAX or agenda_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Tuple
from unittest import mock

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (SXM data sheet)
H100_F32_FLOPS = 67e12  # CUDA-core f32 peak
H100_BYTES_PER_S = 3.35e12  # HBM3
# Flash output, elementwise: |out - ref| <= FLASH_ATOL_RMS * rms(ref) + FLASH_RTOL * |ref|.
# Both sides round the output to bf16 (up to one ulp of |ref| apart, covered by
# the relative term); P is rounded to bf16 before P V, as on the TPU, an error of
# order 2^-9 of rms(ref) (the absolute term). rms(ref) falls as 1/sqrt(S) at these
# inputs, so an absolute limit cannot be tight at every S.
FLASH_ATOL_RMS, FLASH_RTOL = 0.05, 1.6e-2
FLASH_TOL_LSE = 1e-3  # f32 logsumexp from bf16 q, k with f32 accumulation
GN_ATOL, GN_RTOL = 2e-2, 1.6e-2  # about two bf16 ulps of the output
# off the main path: a ragged S, and a ragged S with D zero-padded to the wide tiles' 512
EXTRA_FLASH = ((2, 1000, 8, 40), (1, 333, 2, 264))

E2E_ARGS = ["--resolution", "512", "--image-size", "112", "--num-inference-steps", "20",
            "--batch-size", "2", "--num-images", "4",
            "--word_token_heatmaps", "cars", "aerial", "utah"]
E2E_BATCH, E2E_IMAGES, E2E_STEPS, E2E_WORDS = 2, 4, 20, ("cars", "aerial", "utah")
PROFILE_PROMPT = "an aerial view image with cars in utah"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def time_ms(fn, target_ms: float = 40.0, max_iters: int = 200) -> Tuple[float, float]:
    """(device ms, eager ms) per call of fn, both from CUDA events.

    Device time replays a CUDA graph of the calls, so the host's Python and
    ctypes overhead is excluded; eager time launches back to back, so for
    small shapes it is the host's enqueue rate rather than the card's.
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
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager(1)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
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
    ("groupnorm (ours)", ("groupnorm_kernel",)),
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


def profile_batch(pipe, batch: int, warm_s: float) -> None:
    """torch.profiler breakdown of one batch by kernel group (last: the profiler's
    CUPTI hooks can slow later launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate_async(PROFILE_PROMPT, list(range(batch)), **generate_kwargs())()
        wall = time.perf_counter() - t0
    per_name = {}  # CUDA kernel (and memcpy/memset) events only: the ops' rows would double count
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3
    groups = {}
    for name, (us, n) in per_name.items():
        low = name.lower()
        group = next((g for g, subs in KERNEL_GROUPS if any(x in low for x in subs)), "other")
        ms, count = groups.get(group, (0.0, 0))
        groups[group] = (ms + us / 1e3, count + n)
    print(f"[profile] batch {batch} at 512x512, {E2E_STEPS} steps: device busy "
          f"{busy_ms / 1e3:.3f} s = {100.0 * busy_ms / (1e3 * wall):.1f}% of the profiled "
          f"batch's {wall:.3f} s wall, {100.0 * busy_ms / (1e3 * warm_s):.1f}% of the "
          f"unprofiled warm batch's {warm_s:.3f} s", flush=True)
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {group:26s} {ms:9.2f} ms  {100.0 * ms / busy_ms:5.1f}% of busy  "
              f"{n} launches", flush=True)
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   top: {us / 1e3:8.2f} ms  x{n:<5d} {name[:110]}", flush=True)


def flash_rows(per_batch):
    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels.flash import flash_attention_fwd, flash_attention_reference

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
        plain, _ = time_ms(lambda: flash_attention_reference(q, k, v), max_iters=20)
        lib, _ = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * b * h * s * s * d
        nbytes = 4.0 * b * s * h * d * 2 + 4.0 * b * h * s
        rows.append(dict(shape=shape, per_batch=count, err=max(err, err_lse), ms=ms,
                         plain_ms=plain, library_ms=lib,
                         bound_ms=1e3 * max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S),
                         bound_by="operations" if flops / H100_BF16_FLOPS
                         >= nbytes / H100_BYTES_PER_S else "bytes"))
        print(f"flash (B,S,H,D)={shape} x{count}/batch  out err {err:.3g}, {of_limit:.4g} of the "
              f"limit {FLASH_ATOL_RMS} rms(ref) + {FLASH_RTOL}|ref| (rms {rms:.4g})  lse err "
              f"{err_lse:.3g} (tol {FLASH_TOL_LSE})  kernel {ms:.4f} ms "
              f"(eager {eager:.4f})  plain {plain:.4f} ms  SDPA {lib:.4f} ms  bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})", flush=True)
        del q, k, v, out, lse, ref_out, ref_lse, ref_f, diff
    return rows


def gn_rows(per_batch):
    import torch
    import torch.nn.functional as F

    from agenda_tpu_torch.kernels.groupnorm import group_norm_act, group_norm_act_reference

    rows = []
    for (shape, groups, eps, act), count in per_batch.items():
        c = shape[1]
        g = torch.Generator(device="cuda").manual_seed(sum(shape) + c)
        x = (torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5).to(torch.bfloat16)
        w = torch.randn(c, device="cuda", generator=g)
        bias = torch.randn(c, device="cuda", generator=g)
        y = group_norm_act(x, w, bias, groups, eps, act)
        ref = group_norm_act_reference(x, w, bias, groups, eps, act)
        torch.cuda.synchronize()
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
        nbytes = 2.0 * n * 2 + 2.0 * c * 4
        flops = n * (8.0 if act == "silu" else 4.0)
        rows.append(dict(shape=(shape, eps, act), per_batch=count, err=err, ms=ms,
                         plain_ms=plain, library_ms=lib,
                         bound_ms=1e3 * max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS),
                         bound_by="bytes" if nbytes / H100_BYTES_PER_S
                         >= flops / H100_F32_FLOPS else "operations"))
        print(f"groupnorm {shape} eps {eps:g} act {act} x{count}/batch  err {err:.3g} "
              f"(tol {GN_ATOL}+{GN_RTOL}|ref|)  kernel {ms:.4f} ms (eager {eager:.4f})  "
              f"plain {plain:.4f} ms  F.group_norm {lib:.4f} ms  bound "
              f"{rows[-1]['bound_ms']:.4f} ms", flush=True)
        del x, y, ref, diff
    return rows


def summarize(name, route, source, replaces, rows, launches):
    """One `kernels` entry: times summed over one batch's main-path launches
    (off-path rows count 0 times); the error is the largest of all rows."""
    def per_batch(key):
        return sum(r[key] * r["per_batch"] for r in rows)

    by_ops = sum(r["bound_ms"] * r["per_batch"] for r in rows if r["bound_by"] == "operations")
    bound_by = "operations" if by_ops >= per_batch("bound_ms") - by_ops else "bytes"
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["err"] for r in rows),
            "ms": per_batch("ms"), "plain_ms": per_batch("plain_ms"),
            "bound_ms": per_batch("bound_ms"), "bound_by": bound_by,
            "library_ms": per_batch("library_ms")}


def check_outputs(save_dir: str) -> None:
    from agenda_tpu_torch.utils.png import read_png

    images = sorted(os.listdir(os.path.join(save_dir, "images")))
    require(len(images) == E2E_IMAGES, f"expected {E2E_IMAGES} image PNGs, found {images}")
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
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"[build] {lib.path.name}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s)", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    with tempfile.TemporaryDirectory(prefix="agenda_chip_smoke_") as tmp:
        # 2. shapes of the main path
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
        profile_batch(pipe, E2E_BATCH, warm_s)
        del pipe

    kernels = [
        summarize("flash_attention_fwd", "cuda", "agenda_tpu_torch/csrc/flash_fwd.cu",
                  "agenda_tpu/kernels/flash.py:55", flash, launches["flash_attention_fwd"]),
        summarize("group_norm_act", "cuda", "agenda_tpu_torch/csrc/groupnorm.cu",
                  "agenda_tpu/kernels/groupnorm.py:94", gn, launches["group_norm_act"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
