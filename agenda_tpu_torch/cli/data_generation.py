"""CLI: batched image + DAAM-heatmap generation on the card.

Counterpart of ``agenda_tpu/cli/data_generation.py``: the same flags plus
``--device {cuda,cpu}`` (default cuda; with cuda and no GPU it raises), and
the same output tree, ``images/<seed>.png`` and
``daam_<word>_heatmaps/<seed>.png``. It keeps the all-black skip, the tail
padding to a fixed batch and one batch in flight (the card samples batch
i+1 while the host writes batch i's PNGs). The word maps are upscaled to
``--image-size`` on the card with Pillow's bicubic kernel; PNGs are written
with the port's stdlib writer. Any ``--resolution`` the UNet takes (a
multiple of 64) runs on the card, 384 and 640 included: the GroupNorm
kernel takes their 6x6 and 10x10 levels (H*W % 8 != 0) as any other.
``--tgate-step m`` turns on TGATE sampling from step m (off by default;
``generate/pipeline.py``).

Under ``torchrun --nproc_per_node N`` the N ranks split the seeds, as the
JAX CLI shards them over its chips (``agenda_tpu/cli/data_generation.py:
70-78``): ``--batch-size`` is a rank's, a global batch is N times it (the
tail padded as one process pads it), and each rank writes the files of its
seeds, the same file set one process writes. ``--dist-backend`` names the
process group's backend (nccl on the cards by default).

    python -m agenda_tpu_torch.cli.data_generation --pretrained-model-path <dir> \\
        --learnable-tokens-embedding-path <embeds.bin> --save-dir out \\
        --word_token_heatmaps cars --num-images 8 --batch-size 4
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Image and attention map generation.")
    p.add_argument("--save-dir", type=str, default="Data/Synthetic",
                   help="Directory to save images (and heatmaps if enabled).")
    p.add_argument("--pretrained-model-path", type=str,
                   default="output/LINZ-Utah/sd1.4-token-finetune-stage-two/full_model_step_4500",
                   help="Path of the pretrained pipeline to load (diffusers layout).")
    p.add_argument("--learnable-tokens-embedding-path", type=str,
                   default="output/LINZ-Utah/sd1.4-token-finetune-stage-one/learned_embeds_steps_9000.bin",
                   help="Path to the learned token embeddings (.bin).")
    p.add_argument("--prompt", type=str,
                   default="An aerial view image with {} cars in {} Utah",
                   help="Prompt template for image generation.")
    p.add_argument("--initialize_token", type=str, nargs="+",
                   default=["cars", "Utah", "New Zealand"],
                   help="The initialization words for learnable tokens (stage one order).")
    p.add_argument("--word_token_heatmaps", type=str, default=None, nargs="+",
                   help="word tokens to compute DAAM heatmaps.")
    p.add_argument("--store_learnable_token_heatmaps", action="store_true",
                   help="Whether to store DAAM heatmaps for learnable tokens.")
    p.add_argument("--num-images", type=int, default=10000, help="Number of images to generate.")
    p.add_argument("--image-size", type=int, default=112, help="Size of the generated images.")
    p.add_argument("--start-seed", type=int, default=0, help="First seed (resume support).")
    p.add_argument("--batch-size", type=int, default=8, help="Seeds per batch.")
    p.add_argument("--num-inference-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=512, help="Sampling resolution before resize.")
    p.add_argument("--tgate-step", type=int, default=0,
                   help="TGATE fast sampling (arXiv:2404.02747): freeze cross-"
                        "attention at this step and run the rest CFG-collapsed "
                        "at half batch. APPROXIMATE (changes images and DAAM "
                        "heatmaps) — off (0) by default; 0 keeps the exact "
                        "reference-parity sampler.")
    p.add_argument("--device", type=str, choices=("cuda", "cpu"), default="cuda",
                   help="Run on the card (default) or on the CPU.")
    p.add_argument("--dist-backend", type=str, choices=("nccl", "gloo"), default=None,
                   help="The process group's backend under torchrun (default: nccl on the "
                        "card, gloo on the CPU; gloo puts several ranks on one card).")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline
    from agenda_tpu_torch.io.learned_embeds import load_learned_embeddings
    from agenda_tpu_torch.parallel.mesh import make_mesh
    from agenda_tpu_torch.utils.png import write_png

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    log = logging.getLogger("agenda_tpu_torch.cli.data_generation")
    os.makedirs(args.save_dir, exist_ok=True)
    mesh = make_mesh(device=args.device, backend=args.dist_backend)
    pipeline = StableDiffusionPipeline.from_pretrained(args.pretrained_model_path,
                                                       device=mesh.device)
    pipeline.mesh = mesh
    batch_size = args.batch_size * mesh.dp  # the global batch
    rows = mesh.rows(batch_size)

    embeds_dict = load_learned_embeddings(args.learnable_tokens_embedding_path)
    all_new_tokens = list(embeds_dict.keys())
    all_word_token_heatmaps = list(args.word_token_heatmaps or [])
    new_tokens = []
    for t, n in zip(args.initialize_token, all_new_tokens):
        if t in args.prompt:
            if args.store_learnable_token_heatmaps:
                all_word_token_heatmaps.append(n)
            new_tokens.append(n)
    pipeline.add_learned_tokens({t: embeds_dict[t] for t in new_tokens})
    prompt = args.prompt.format(*new_tokens)

    img_dir = os.path.join(args.save_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    for word in all_word_token_heatmaps:
        os.makedirs(os.path.join(args.save_dir, f"daam_{word}_heatmaps"), exist_ok=True)

    words = all_word_token_heatmaps or None
    seeds = list(range(args.start_seed, args.start_seed + args.num_images))

    def dispatch(batch_seeds):
        # A fixed batch shape: pad the tail with the last seed.
        padded = batch_seeds + [batch_seeds[-1]] * (batch_size - len(batch_seeds))
        return pipeline.generate_async(
            prompt,
            padded,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale,
            height=args.resolution,
            width=args.resolution,
            words=words,
            out_size=args.image_size,
            heatmap_size=args.image_size,
            tgate_step=args.tgate_step,
        )

    def write(batch_seeds, result):
        images, word_maps = result()  # this rank's rows of the padded batch
        for j, pos in enumerate(range(rows.start, rows.stop)):
            if pos >= len(batch_seeds):
                break  # the tail's padding
            seed = batch_seeds[pos]
            if images[j].max() < 1:
                continue  # all-black output (the reference's NSFW-filter skip)
            write_png(os.path.join(img_dir, f"{seed}.png"), images[j])
            for word in all_word_token_heatmaps:
                write_png(os.path.join(args.save_dir, f"daam_{word}_heatmaps", f"{seed}.png"),
                          word_maps[word][j])

    t0 = time.perf_counter()
    pending = None
    n_batches = 0
    for i in range(0, len(seeds), batch_size):
        batch_seeds = seeds[i : i + batch_size]
        result = dispatch(batch_seeds)
        if pending is not None:
            write(*pending)
        pending = (batch_seeds, result)
        n_batches += 1
    if pending is not None:
        write(*pending)
    seconds = time.perf_counter() - t0
    log.info("generated %d images in %d batches: %.3f s/batch, %.3f images/s on %s",
             len(seeds), n_batches, seconds / max(n_batches, 1),
             len(seeds) / seconds if seconds else 0.0, pipeline.device)
    return {"batches": n_batches, "seconds": seconds, "images": len(seeds)}


if __name__ == "__main__":
    main()
