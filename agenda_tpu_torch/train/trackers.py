"""Experiment tracking: scalars to ``metrics.jsonl``, images to PNGs.

Counterpart of ``agenda_tpu/train/trackers.py:31-83``. Scalars always
append to ``<logging_dir>/metrics.jsonl``; ``--report_to tensorboard`` also
writes event files when ``torch.utils.tensorboard`` can be imported.
Validation images go to ``<logging_dir>/images/`` through the port's PNG
writer (the card's machine is not known to have Pillow).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from agenda_tpu_torch.utils.png import write_png


class Tracker:
    def __init__(self, logging_dir: str, report_to: str = "tensorboard",
                 config: Optional[dict] = None):
        self.logging_dir = logging_dir
        os.makedirs(logging_dir, exist_ok=True)
        self.jsonl = open(os.path.join(logging_dir, "metrics.jsonl"), "a")
        self.tb = None
        if report_to in ("tensorboard", "all"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(logging_dir)
            except Exception:  # tensorboard is optional: metrics.jsonl is always written
                self.tb = None
        if config is not None:
            with open(os.path.join(logging_dir, "config.json"), "w") as f:
                json.dump({k: _jsonable(v) for k, v in config.items()}, f, indent=2)

    def log(self, scalars: Dict[str, float], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), int(step))

    def log_images(self, tag: str, images: np.ndarray, step: int) -> None:
        """images: (N, H, W, 3) uint8."""
        img_dir = os.path.join(self.logging_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in tag)[:80]
        for i, im in enumerate(images):
            write_png(os.path.join(img_dir, f"{safe}_step{step}_{i}.png"), np.asarray(im))
        if self.tb is not None:
            self.tb.add_images(tag, images, step, dataformats="NHWC")

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class NullTracker:
    """The tracker of a rank that does not log (every rank but 0 of a
    multi-card run)."""

    def log(self, scalars: Dict[str, float], step: int) -> None:
        pass

    def log_images(self, tag: str, images: np.ndarray, step: int) -> None:
        pass

    def close(self) -> None:
        pass
