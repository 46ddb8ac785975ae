"""Batched text-to-image sampling with DAAM heatmaps, in PyTorch.

Counterpart of ``agenda_tpu/generate/pipeline.py``: CLIP text encoding, PLMS
(or DDIM) sampling with classifier-free guidance over an [uncond; cond]
batch, DAAM aggregation from every cross-attention layer (uncond half
dropped, each map resized bicubic to ``latent_hw`` and clamped at 0, running
sum and count over layers and steps), VAE decode, the resize to
``out_size``, uint8 images by rounding and per-word min-max maps truncated
to uint8.

The JAX version compiles the whole loop into one ``lax.scan``; here the loop
is Python and the kernels are queued on the current CUDA stream without a
host synchronisation, so ``generate_async`` returns while the card is still
sampling.

TGATE (arXiv:2404.02747; opt-in, off by default): with ``tgate_step=m``,
0 < m < ``num_inference_steps``, the steps before m run exactly; the gate
step m runs at 2B, applies CFG and caches the mean of the two halves'
cross-attention output contributions; every later step runs at batch B on
the conditional context with those contributions replayed and no CFG (the
halves differ only through cross-attention). The gate's heatmap counts
once for itself and each replayed step: ``len(timesteps) - m`` times, from
the timestep table (PLMS's has T + 1 entries), as
``agenda_tpu/generate/pipeline.py:217-337`` does. It approximates the exact
sampler.

Initial noise: without ``latents``, each seed draws its (h, w, 4) latents
from its own CPU ``torch.Generator(seed)``. This stream is the port's own:
the JAX package draws from jax threefry, which torch cannot reproduce, so
the two packages give different images for the same seed. The parity tests
feed the port the JAX latents.

Over several ranks (``mesh``, ``parallel/mesh.py``; ``agenda_tpu/generate/
pipeline.py:490-498``) a call's seeds are the global batch and each rank
samples its rows of it: a seed's latents depend on the seed alone, so every
image and heatmap is the one a single process makes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agenda_tpu_torch._device import compute_dtype, full_f32_if, resolve_device
from agenda_tpu_torch.core.schedules import (
    DiffusionSchedule,
    ddim_step,
    ddim_timesteps,
    make_schedule,
    plms_init_state,
    plms_step,
    plms_timesteps,
)
from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
from agenda_tpu_torch.data.tokens import compute_token_merge_indices
from agenda_tpu_torch.generate.resize import resize_bicubic, resize_uint8_pil
from agenda_tpu_torch.io.diffusers_io import load_pipeline
from agenda_tpu_torch.models.clip_text import CLIPTextModel
from agenda_tpu_torch.models.layers import cast_for_compute
from agenda_tpu_torch.models.unet import UNet2DConditionModel
from agenda_tpu_torch.models.vae import AutoencoderKL
from agenda_tpu_torch.parallel.mesh import Mesh

log = logging.getLogger(__name__)


def _build(cls, config, state: Dict[str, torch.Tensor], device, dtype):
    with torch.device("meta"):
        module = cls(config)
    module.load_state_dict(state, strict=True, assign=True)
    return cast_for_compute(module.to(device), dtype).eval()


@dataclasses.dataclass
class StableDiffusionPipeline:
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: CLIPTokenizer
    schedule: DiffusionSchedule
    device: torch.device
    scheduler_type: str = "pndm"  # SD-1.x pipeline default
    latent_hw: int = 64  # heatmap aggregation resolution
    mesh: Optional[Mesh] = None  # split each call's seeds over its ranks

    @classmethod
    def from_pretrained(cls, model_dir: str, device: str = "cuda") -> "StableDiffusionPipeline":
        dev = resolve_device(device)
        dtype = compute_dtype(dev)
        bundle = load_pipeline(model_dir)
        sc = bundle.scheduler_config or {}
        schedule = make_schedule(
            num_train_timesteps=sc.get("num_train_timesteps", 1000),
            beta_start=sc.get("beta_start", 0.00085),
            beta_end=sc.get("beta_end", 0.012),
            beta_schedule=sc.get("beta_schedule", "scaled_linear"),
            prediction_type=sc.get("prediction_type", "epsilon"),
            steps_offset=sc.get("steps_offset", 1),
        )
        name = sc.get("_class_name", "PNDMScheduler").lower()
        pipe = cls(
            unet=_build(UNet2DConditionModel, bundle.unet_config, bundle.unet_state, dev, dtype),
            vae=_build(AutoencoderKL, bundle.vae_config, bundle.vae_state, dev, dtype),
            text_encoder=_build(CLIPTextModel, bundle.text_config, bundle.text_state, dev, dtype),
            tokenizer=CLIPTokenizer.from_pretrained(bundle.tokenizer_dir),
            schedule=schedule,
            device=dev,
            scheduler_type="ddim" if "ddim" in name else "pndm",
            latent_hw=bundle.unet_config.sample_size,
        )
        log.info("StableDiffusionPipeline on %s, compute dtype %s", dev, dtype)
        return pipe

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae.config.block_out_channels) - 1)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a host synchronisation."""
        t = torch.from_numpy(np.array(array))  # an owned, writable copy
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- learnable tokens ---------------------------------------------------

    def add_learned_tokens(self, embeds: Dict[str, np.ndarray]) -> List[int]:
        """Add tokens and write their embeddings into the text encoder's table."""
        tokens = list(embeds.keys())
        self.tokenizer.add_tokens(tokens)
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        emb = self.text_encoder.text_model.embeddings.token_embedding
        table = emb.weight.detach()
        need = max(ids) + 1 if ids else 0
        if need > table.shape[0]:
            pad = torch.zeros((need - table.shape[0], table.shape[1]), dtype=table.dtype,
                              device=table.device)
            table = torch.cat([table, pad], dim=0)
        else:
            table = table.clone()
        for tok, i in zip(tokens, ids):
            table[i] = torch.as_tensor(np.asarray(embeds[tok]), dtype=table.dtype)
        self.text_encoder.text_model.embeddings.token_embedding = torch.nn.Embedding.from_pretrained(
            table, freeze=True)
        self.text_encoder.config = dataclasses.replace(self.text_encoder.config,
                                                       vocab_size=table.shape[0])
        return list(ids)

    # -- text ---------------------------------------------------------------

    @torch.no_grad()
    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self._to_device(self.tokenizer(list(prompts)).astype(np.int64))
        return self.text_encoder(ids)[0]

    def initial_latents(self, seeds: Sequence[int], h: int, w: int) -> torch.Tensor:
        """(B, h, w, 4) f32: one CPU torch.Generator per seed (the port's own stream)."""
        draws = [torch.randn((h, w, 4), generator=torch.Generator().manual_seed(int(s) % 2**64))
                 for s in seeds]
        return self._to_device(torch.stack(draws).numpy())

    def timestep_table(self, num_inference_steps: int) -> np.ndarray:
        if self.scheduler_type == "pndm":
            return plms_timesteps(self.schedule, num_inference_steps)
        return ddim_timesteps(self.schedule, num_inference_steps)

    # -- sampler ------------------------------------------------------------

    @torch.no_grad()
    def _sample(
        self,
        context: torch.Tensor,  # (2B, 77, C) [uncond; cond]
        latents: torch.Tensor,  # (B, h, w, 4) f32
        guidance_scale: float,
        collect_heatmaps: bool,
        num_inference_steps: int,
        out_size: int,
        tgate_step: int = 0,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b = latents.shape[0]
        hw = self.latent_hw
        hsum = torch.zeros((b, context.shape[1], hw, hw), dtype=torch.float32,
                           device=self.device) if collect_heatmaps else None
        hcnt = 0
        state = plms_init_state()
        step_ratio = self.schedule.num_train_timesteps // num_inference_steps
        timesteps = self.timestep_table(num_inference_steps).tolist()
        gate = tgate_step if 0 < tgate_step < num_inference_steps else len(timesteps)
        cross_avg = None
        for i, t in enumerate(timesteps):
            if i <= gate:  # exact, or the gate: 2B with CFG
                eps, maps, *cross = self.unet(
                    torch.cat([latents, latents], dim=0),
                    torch.full((2 * b,), float(t), device=self.device), context,
                    collect_attn=collect_heatmaps, collect_cross=i == gate)
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
                if collect_heatmaps:
                    # the gate's maps stand for it and every replayed step
                    weight = len(timesteps) - gate if i == gate else 1
                    heat = sum(torch.clamp(resize_bicubic(m[b:], hw, hw), min=0.0)
                               for m in maps)  # the unconditional half dropped
                    hsum += heat * weight
                    hcnt += len(maps) * weight
                if cross:  # the gate: the mean of the two halves' contributions
                    cross_avg = [0.5 * (c[:b] + c[b:]) for c in cross[0]]
            else:  # gated: batch B, conditional context, contributions replayed
                eps, _ = self.unet(latents, torch.full((b,), float(t), device=self.device),
                                   context[b:], cached_cross=cross_avg)
            if self.scheduler_type == "pndm":
                state, latents = plms_step(self.schedule, state, eps, latents, t,
                                           num_inference_steps)
            elif self.scheduler_type == "ddim":
                latents = ddim_step(self.schedule, eps, t, t - step_ratio, latents)
            else:
                raise ValueError(f"Unknown scheduler {self.scheduler_type}")

        images = self.vae.decode(latents / self.vae.config.scaling_factor)
        images = torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)
        if out_size:
            images = torch.clamp(resize_bicubic(images.permute(0, 3, 1, 2), out_size, out_size),
                                 0.0, 1.0).permute(0, 2, 3, 1)
        images_u8 = torch.round(images * 255.0).to(torch.uint8)
        heatmaps = hsum / max(hcnt, 1) if collect_heatmaps else None
        return images_u8, heatmaps

    def _word_maps(self, heatmaps: torch.Tensor, prompt: str, words: Sequence[str],
                   heatmap_size: int) -> torch.Tensor:
        """(B, 77, hw, hw) f32 -> (B, W, s, s) uint8 per-word min-max maps."""
        idx_lists = [compute_token_merge_indices(self.tokenizer, prompt, w)[0] for w in words]
        k = max(len(x) for x in idx_lists)
        ids = np.zeros((len(words), k), np.int64)
        mask = np.zeros((len(words), k), np.float32)
        for i, xs in enumerate(idx_lists):
            ids[i, : len(xs)] = xs
            mask[i, : len(xs)] = 1.0
        ids_t, mask_t = self._to_device(ids), self._to_device(mask)
        b, _, h, w = heatmaps.shape
        sel = heatmaps.index_select(1, ids_t.reshape(-1)).reshape(b, len(words), k, h, w)
        msum = torch.clamp(mask_t.sum(dim=-1), min=1.0)
        wmaps = (sel * mask_t[None, :, :, None, None]).sum(dim=2) / msum[None, :, None, None]
        mn = wmaps.amin(dim=(2, 3), keepdim=True)
        mx = wmaps.amax(dim=(2, 3), keepdim=True)
        u8 = ((wmaps - mn) / (mx - mn + 1e-8) * 255.0).to(torch.uint8)  # truncates
        if heatmap_size and heatmap_size != h:
            u8 = resize_uint8_pil(u8, heatmap_size, heatmap_size)
        return u8

    # -- public API ---------------------------------------------------------

    def __call__(self, prompt: str, seeds: Sequence[int], **kwargs):
        """Generate len(seeds) images for one prompt; see ``generate_async``."""
        return self.generate_async(prompt, seeds, **kwargs)()

    @torch.no_grad()
    def generate_async(
        self,
        prompt: str,
        seeds: Sequence[int],
        num_inference_steps: int = 20,
        guidance_scale: float = 7.5,
        collect_heatmaps: bool = False,
        negative_prompt: str = "",
        height: int = 512,
        width: int = 512,
        words: Optional[Sequence[str]] = None,
        out_size: int = 0,
        latents: Optional[np.ndarray | torch.Tensor] = None,
        heatmap_size: int = 0,
        tgate_step: int = 0,
    ) -> Callable[[], Tuple[np.ndarray, object]]:
        """Queue one batch on the device and return a thunk for its result.

        The thunk returns (images uint8 (B, H, W, 3), second) where second is
        None, the f32 heatmaps (B, 77, latent_hw, latent_hw) when
        ``collect_heatmaps``, or with ``words`` a dict {word: uint8 (B, s, s)}
        of min-max per-word maps, s = ``heatmap_size`` (Pillow bicubic on
        the device) or ``latent_hw`` when it is 0. ``latents`` (B, h, w, 4)
        replaces the per-seed noise. ``tgate_step=m`` (0 < m <
        ``num_inference_steps``) turns TGATE on (the module's docstring); 0,
        the default, samples exactly. On CUDA the results come back through a
        non-blocking copy and an event, so the caller can write batch i while
        the card samples batch i+1. With ``mesh`` over several ranks, ``seeds``
        (and ``latents``) are the global batch, which divides by the world,
        and the result holds this rank's rows (``mesh.rows``). An f32
        pipeline (``--mixed_precision no``) queues the batch on the card
        with TF32 off in its convolutions and matmuls (``full_f32``).
        """
        if self.mesh is not None and self.mesh.world > 1:
            rows = self.mesh.rows(len(seeds))
            seeds = list(seeds)[rows]
            latents = None if latents is None else latents[rows]
        b = len(seeds)
        if words:
            collect_heatmaps = True
        # cuDNN's heuristics, as the bf16 path has them: a validation batch is one-off
        with full_f32_if(self.unet.dtype, self.device, benchmark=False):
            context = self.encode_prompts([negative_prompt] * b + [prompt] * b)
            f = self.vae_scale_factor
            if latents is None:
                lat = self.initial_latents(seeds, height // f, width // f)
            elif isinstance(latents, torch.Tensor):
                lat = latents.to(self.device, torch.float32)
            else:
                lat = self._to_device(np.asarray(latents, np.float32))
            if lat.shape != (b, height // f, width // f, 4):
                raise ValueError(f"latents must be {(b, height // f, width // f, 4)}, "
                                 f"got {tuple(lat.shape)}")
            images, heatmaps = self._sample(context, lat, float(guidance_scale),
                                            collect_heatmaps, num_inference_steps, out_size,
                                            tgate_step)
            second = heatmaps
            if words:
                second = self._word_maps(heatmaps, prompt, words, heatmap_size)
        outs = [images] + ([second] if second is not None else [])
        if self.device.type == "cuda":
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = outs, None

        def materialize():
            if done is not None:
                done.synchronize()
            arrays = [h.numpy() for h in host]
            if words:
                return arrays[0], {w: arrays[1][:, i] for i, w in enumerate(words)}
            return arrays[0], (arrays[1] if collect_heatmaps else None)

        return materialize
