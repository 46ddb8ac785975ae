#!/usr/bin/env python3
"""Whether cuDNN's autotuning pays for the f32 VAE pretraining step, on the card.

    python3 scripts/vae_autotune.py [--order FTTF] [--steps 8]

SD-1.4's VAE (128/256/512/512, seeded init) at 256 px, batch 8, one
``make_vae_pretrain_step`` in f32 a step. Each letter of ``--order`` runs
in a fresh process (cuDNN keeps the plans it chose for a shape, by
heuristics or by autotuning, for the life of a process): F with cuDNN's
heuristics (what ``train/vae_pretrain.py`` takes), T autotuned (its
``full_f32_if`` replaced by one with ``benchmark=True``). Each process
first takes one bf16 step, as chip_smoke.py's phase 36 runs before phase
41, then ``--steps`` synchronised f32 steps. Prints the card's name and
power limit, then a line a process: the steps' seconds, the warm mean over
all but the first two, and the peak memory above what was held before.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import sys, time
import numpy as np
import torch
import chip_smoke as cs
from agenda_tpu_torch.io.configs import VAEConfig
from agenda_tpu_torch.models.vae import AutoencoderKL
from agenda_tpu_torch.train import vae_pretrain as vp
from agenda_tpu_torch.train.optim import make_adam

bench, steps = sys.argv[1] == "T", int(sys.argv[2])
dev = torch.device("cuda")
torch.manual_seed(0)
vae = AutoencoderKL(VAEConfig(block_out_channels=(128, 256, 512, 512), layers_per_block=2))
vae.to(dev)
tx = make_adam(1e-4)
opt = tx.init(dict(vae.named_parameters()))
images = cs.vae_images(8, 256, 36).astype(np.float32) / 127.5 - 1.0
pixels = torch.from_numpy(images).to(dev)
eps = torch.randn(vp.latent_shape(vae, 8, 256, 256), device=dev)
vp.make_vae_pretrain_step(vae, tx, 1e-4, torch.bfloat16)(opt, pixels, eps)
heuristic = vp.full_f32_if
vp.full_f32_if = lambda dtype, dev, benchmark=False: heuristic(dtype, dev, bench)
step = vp.make_vae_pretrain_step(vae, tx, 1e-4, torch.float32)
torch.cuda.synchronize()
held = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
walls = []
for _ in range(steps):
    t0 = time.perf_counter()
    step(opt, pixels, eps)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
peak = torch.cuda.max_memory_allocated() - held
print(f"benchmark={bench}: steps {[round(w, 4) for w in walls]} s, warm "
      f"{sum(walls[2:]) / len(walls[2:]):.4f} s/step, peak over held {peak / 2**30:.2f} GiB")
'''


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="FTTF")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if set(args.order) - set("FT") or args.steps < 3:
        ap.error("--order takes F and T; --steps at least 3")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: no card", flush=True)
    env = {**os.environ, "PYTHONPATH": ROOT}
    for mode in args.order:
        run = subprocess.run([sys.executable, "-c", CHILD, mode, str(args.steps)], cwd=ROOT,
                             env=env, capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
