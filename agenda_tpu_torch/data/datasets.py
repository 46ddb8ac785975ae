"""The SD fine-tune's dataset and batch loader, as numpy batches.

Counterpart of ``agenda_tpu/data/datasets.py:30-241``:

- ``BaseDataset``: a {image_path: prompt} JSON -> token ids and the image.
- ``TokenDataset``: the same with the learnable tokens spliced into each
  prompt and their start positions, for the token fine-tune.
  When every tile has one size (probed from the PNG headers), the tile
  travels as uint8 (``pixel_u8``) and is resized on the device in the step
  (``data/device_resize.py``), as the JAX package's uniform-tile path does;
  otherwise each image is resized on the host with the same Lanczos filter
  (``pixel_values`` in [-1, 1]).
- ``DataLoader``: the same epoch shuffle, ``default_rng(seed + epoch)``,
  ``pad_to_full`` and the thread-pool prefetch.

Images are read with the port's stdlib PNG reader (``utils/png.py``): the
machine that runs the port is not known to have Pillow. Other formats raise.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agenda_tpu_torch.data.device_resize import apply_resize, resize_weights
from agenda_tpu_torch.data.tokens import insert_new_tokens
from agenda_tpu_torch.utils.png import png_size, read_rgb


def load_prompt_json(dataset_folder: str, json_file_name: str) -> List[Tuple[str, str]]:
    with open(os.path.join(dataset_folder, json_file_name)) as f:
        return list(json.load(f).items())


def _png_path(path: str) -> str:
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port reads PNG training images only")
    return path


def load_image_u8(path: str) -> np.ndarray:
    """uint8 (H, W, 3) at the tile's own size."""
    return read_rgb(_png_path(path))


def load_image(path: str, resolution: int, filt: str = "lanczos") -> np.ndarray:
    """f32 (resolution, resolution, 3) in [-1, 1], resized on the host with
    Pillow's ``filt`` ("lanczos" or "bilinear") and Pillow's rounding."""
    u8 = load_image_u8(path)
    h, w = u8.shape[:2]
    out = apply_resize(torch.from_numpy(u8)[None], resize_weights(h, resolution, filt),
                       resize_weights(w, resolution, filt), half_up=True)
    return out[0].numpy()


def probe_uniform_size(paths: Sequence[str]) -> Optional[Tuple[int, int]]:
    """(w, h) when every image shares one size, else None (headers only)."""
    size = None
    for p in paths:
        s = png_size(_png_path(p))
        if size is None:
            size = s
        elif s != size:
            return None
    return size


class BaseDataset:
    def __init__(self, dataset_folder: str, json_file_name: str, resolution: int, tokenizer):
        self.dataset_folder = dataset_folder
        self.data = load_prompt_json(dataset_folder, json_file_name)
        self.resolution = resolution
        self.tokenizer = tokenizer
        # (w, h) of uniform tiles, resized on the device; None: resized here
        self.source_size = probe_uniform_size(
            [os.path.join(dataset_folder, p) for p, _ in self.data])

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_path, prompt = self.data[index]
        ids = self.tokenizer(prompt)
        path = os.path.join(self.dataset_folder, img_path)
        if self.source_size is not None:
            return {"pixel_u8": load_image_u8(path), "input_ids": ids}
        return {"pixel_values": load_image(path, self.resolution), "input_ids": ids}


class TokenDataset:
    """The token fine-tune's dataset (``agenda_tpu/data/datasets.py:92-150``):
    each prompt gets the new tokens spliced in before their trigger words
    (``data/tokens.insert_new_tokens``), and ``new_tokens_start`` (int32,
    ``starts_width`` = one slot a trigger word, padded with -1) says where.
    Images are resized bilinear, as the reference's token fine-tune does
    (``finetune_sd_token.py:816``): uniform tiles travel as uint8 and the
    step resizes them with ``resize_weights(..., "bilinear")``."""

    def __init__(self, dataset_folder: str, json_file_name: str, resolution: int, tokenizer,
                 word_tokens: Optional[Sequence[str]] = None,
                 new_tokens: Optional[Sequence[str]] = None):
        self.dataset_folder = dataset_folder
        self.data = load_prompt_json(dataset_folder, json_file_name)
        self.resolution = resolution
        self.tokenizer = tokenizer
        self.word_tokens = list(word_tokens or [])
        self.new_tokens = list(new_tokens or [])
        self.starts_width = max(1, len(self.word_tokens))
        self.source_size = probe_uniform_size(
            [os.path.join(dataset_folder, p) for p, _ in self.data])

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_path, prompt = self.data[index]
        starts: List[int] = []
        if self.word_tokens and self.new_tokens:
            prompt, starts = insert_new_tokens(self.tokenizer, prompt, self.word_tokens,
                                               self.new_tokens)
        starts = starts[: self.starts_width]
        starts = starts + [-1] * (self.starts_width - len(starts))
        out = {"input_ids": self.tokenizer(prompt),
               "new_tokens_start": np.asarray(starts, dtype=np.int32)}
        path = os.path.join(self.dataset_folder, img_path)
        if self.source_size is not None:
            out["pixel_u8"] = load_image_u8(path)
        else:
            out["pixel_values"] = load_image(path, self.resolution, "bilinear")
        return out


def _stack(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in batch]) for k in batch[0]}


class DataLoader:
    """Shuffled, epoch-seeded, prefetching batch iterator (drop_last=False)."""

    prefetch = 2  # batches decoded ahead

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 2, pad_to_full: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(0, num_workers)
        # pad_to_full cycles indices so that every batch has batch_size rows
        self.pad_to_full = pad_to_full
        self.epoch = 0
        self._start = 0  # batches of the next epoch to leave out (iter_from)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def batches_for_epoch(self, epoch: int) -> List[np.ndarray]:
        """Index batches of an epoch: a pure function of (seed, epoch)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        out = [idx[i * self.batch_size: (i + 1) * self.batch_size] for i in range(len(self))]
        if self.pad_to_full:
            out = [b if len(b) == self.batch_size
                   else np.concatenate([b, np.resize(idx, self.batch_size - len(b))])
                   for b in out]
        return out

    def iter_from(self, epoch: int, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of ``epoch`` from its ``start``-th on: where a resumed
        run left its epoch (the skipped batches are not read)."""
        self.epoch = epoch
        self._start = start
        return iter(self)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self.batches_for_epoch(self.epoch)[self._start:]
        self._start = 0
        self.epoch += 1
        if self.num_workers == 0:
            for b in batches:
                yield _stack([self.dataset[int(i)] for i in b])
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(_stack([self.dataset[int(i)] for i in b]))
                q.put(None)
            except BaseException as e:  # handed to the consumer
                q.put(("__error__", e))

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
                    raise item[1]
                yield item
        finally:
            stop.set()
