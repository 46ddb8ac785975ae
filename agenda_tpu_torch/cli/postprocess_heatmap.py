"""CLI: stack (object, fg, inverted-bg) heatmaps into RGB "heatmap images".

Counterpart of ``agenda_tpu/cli/postprocess_heatmap.py`` (flag-compatible
with ``data_generation/postprocess_heatmap.py:8-17``): the same output tree,
``daam_stack_heatmaps/`` keyed by the object-heatmap filenames plus the
inverted background maps, with R = object, G = fg, B = 255 - bg. PNGs are
read and written with the port's stdlib codec (``utils/png.py``); the
pixels equal the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from agenda_tpu_torch.utils.png import read_png, write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stack attention map.")
    p.add_argument("--save-dir", type=str, default="Data/Synthetic",
                   help="Directory to save images (and heatmaps if enabled).")
    p.add_argument("--object-heatmap-path", type=str, default=None,
                   help="Path to the object token heatmaps.")
    p.add_argument("--fg-heatmap-path", type=str, default=None,
                   help="Path to the foreground learnable token heatmaps.")
    p.add_argument("--bg-heatmap-path", type=str, default=None,
                   help="Path to the background learnable token heatmaps.")
    p.add_argument("--stack-heatmap-save-path", type=str, default="daam_stack_heatmaps",
                   help="Path to save the stacked heatmaps.")
    p.add_argument("--inv-heatmap-save-path", type=str, default="daam_inv_heatmaps",
                   help="Path to save the inverted heatmaps of the learnable background token.")
    return p.parse_args(argv)


def stack_heatmaps(obj: np.ndarray, fg: np.ndarray, bg: np.ndarray):
    """(H,W) uint8 x3 -> (stacked (H,W,3), inv_bg (H,W))."""
    inv_bg = (255 - bg.astype(np.int32)).astype(np.uint8)
    return np.stack([obj, fg, inv_bg], axis=-1), inv_bg


def main(argv=None):
    args = parse_args(argv)
    obj_dir = os.path.join(args.save_dir, args.object_heatmap_path)
    fg_dir = os.path.join(args.save_dir, args.fg_heatmap_path)
    bg_dir = os.path.join(args.save_dir, args.bg_heatmap_path)
    stack_dir = os.path.join(args.save_dir, args.stack_heatmap_save_path)
    inv_dir = os.path.join(args.save_dir, args.inv_heatmap_save_path)
    os.makedirs(stack_dir, exist_ok=True)
    os.makedirs(inv_dir, exist_ok=True)

    obj_files = sorted(os.listdir(obj_dir), key=_numkey)
    fg_files = sorted(os.listdir(fg_dir), key=_numkey)
    bg_files = sorted(os.listdir(bg_dir), key=_numkey)
    for of, ff, bf in zip(obj_files, fg_files, bg_files):
        obj = read_png(os.path.join(obj_dir, of))
        fg = read_png(os.path.join(fg_dir, ff))
        bg = read_png(os.path.join(bg_dir, bf))
        stacked, inv_bg = stack_heatmaps(obj, fg, bg)
        write_png(os.path.join(stack_dir, of), stacked)
        write_png(os.path.join(inv_dir, bf), inv_bg)


def _numkey(name: str):
    stem = name.split(".")[0]
    return (0, int(stem)) if stem.isdigit() else (1, stem)


if __name__ == "__main__":
    main()
