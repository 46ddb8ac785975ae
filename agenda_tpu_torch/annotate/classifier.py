"""ResNet-50 binary-classifier training for label refinement.

Counterpart of ``agenda_tpu/annotate/classifier.py`` (the reference's
``refine_label.py:189-235`` train/evaluate/test loops): BCE-with-logits on
the 1-logit output in f32, masked over the padding rows; Adam without clip
or decay (``optax.adam``; ``train/optim.make_adamw`` with weight decay 0 and
no clip is the same update); flax's batch norm in train mode. Batches are
padded to a fixed size with copies of row 0: those rows go through the
forward, so they move the batch statistics and the running ones, and only
the mask keeps them out of the loss, as in the JAX package.

Compute dtype: bf16 autocast on the card (parameters, optimizer state and
logits stay f32), f32 on the CPU; ``AGENDA_TPU_CLASSIFIER_BF16=0`` keeps f32
on the card too.

``CropFeed`` keeps the resized uint8 crops in pinned host memory and builds
a batch on the device: the host gathers the batch's rows (pad rows too)
into one of two pinned staging buffers, uploads them, and the card flips
the rows from the epoch's draws and divides by 255. The values are the JAX
package's ``arr / 255.0`` and flip, bit for bit: the division is a true
division by a tensor on the device (PyTorch's CUDA division by a CPU scalar
multiplies by its reciprocal instead).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agenda_tpu_torch.models.resnet import ResNet50, init_resnet_, normalize_imagenet
from agenda_tpu_torch.train.optim import AdamState, Optimizer, make_adam  # noqa: F401


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card unless ``AGENDA_TPU_CLASSIFIER_BF16=0``; f32 on the CPU."""
    if os.environ.get("AGENDA_TPU_CLASSIFIER_BF16", "1") != "1":
        return torch.float32
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def init_classifier(generator: torch.Generator, tx: Optimizer, device: torch.device,
                    num_classes: int = 1) -> Tuple[ResNet50, AdamState]:
    """A ResNet-50 drawn from ``generator`` (flax's default initializers) on
    ``device``, and its optimizer state."""
    model = ResNet50(num_classes=num_classes)
    init_resnet_(model, generator)
    model.to(device)
    return model, tx.init(dict(model.named_parameters()))


def _logits(model: ResNet50, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    x = normalize_imagenet(images).permute(0, 3, 1, 2)
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=dtype == torch.bfloat16):
        return model(x)[:, 0].float()


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def make_classifier_train_step(model: ResNet50, tx: Optimizer, dtype: torch.dtype
                               ) -> Callable[..., torch.Tensor]:
    """-> ``step(opt_state, images, labels, mask) -> loss``: images (B, H, W, 3)
    in [0, 1] on the model's device, labels (B,) {0, 1}, mask (B,) 1 for the
    real rows. Updates the model's parameters, its batch-norm statistics and
    ``opt_state`` in place."""
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())

    def step(opt_state: AdamState, images: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        model.train()
        logits = _logits(model, images, dtype)
        per = sigmoid_binary_cross_entropy(logits, labels.float())
        loss = torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        tx.apply(dict(zip(names, grads)), opt_state, params)
        return loss.detach()

    return step


@torch.no_grad()
def classifier_logits(model: ResNet50, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Eval-mode logits (B,) f32 of images (B, H, W, 3) in [0, 1]."""
    model.eval()
    return _logits(model, images, dtype)


def predict(model: ResNet50, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``logit > 0`` (``refine_label.py:216, 232``)."""
    return classifier_logits(model, images, dtype) > 0


def padded_index_batches(n: int, batch_size: int, shuffle: bool,
                         rng: np.random.Generator) -> Iterator[Tuple[np.ndarray, int]]:
    """The JAX package's ``batches_padded`` as indices: yield (indices
    (batch_size,) int64, number of real rows), the rows in order or in the
    order of one ``rng.shuffle``, the last batch padded with index 0 (the
    mask is ``arange(batch_size) < real``)."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, n, batch_size):
        b = idx[i : i + batch_size]
        pad = batch_size - len(b)
        yield (np.concatenate([b, np.zeros(pad, np.int64)]) if pad else b), len(b)


class CropFeed:
    """Batches of resized uint8 crops (N, S, S, 3) as f32 [0, 1] on ``device``."""

    def __init__(self, crops_u8: np.ndarray, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        host = torch.from_numpy(np.ascontiguousarray(crops_u8))
        self.host = host.pin_memory() if self.cuda else host
        self.div = torch.tensor(255.0, device=device)
        self._staging: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None, None]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0
        self.flips: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self.host)

    def upload(self, values: np.ndarray) -> torch.Tensor:
        """A small host array on the device, without a sync on the card."""
        t = torch.from_numpy(np.ascontiguousarray(values))
        return t.pin_memory().to(self.device, non_blocking=True) if self.cuda else t

    def set_flips(self, flips: Optional[np.ndarray]) -> None:
        """The epoch's draws (N,) bool; None for no flips."""
        self.flips = None if flips is None else self.upload(flips)

    def _buffers(self, k: int, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        buf = self._staging[k]
        if buf is None or len(buf[1]) < batch:
            shape = (batch,) + tuple(self.host.shape[1:])
            buf = (torch.empty(shape, dtype=torch.uint8, pin_memory=self.cuda),
                   torch.empty(batch, dtype=torch.int64, pin_memory=self.cuda))
            self._staging[k] = buf
        elif self._events[k] is not None:
            self._events[k].synchronize()  # its previous upload has left the buffer
        return buf

    def batch(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (images (B, S, S, 3) f32 in [0, 1] on the device, idx on the
        device)."""
        k, self._turn = self._turn, self._turn ^ 1
        images, rows = self._buffers(k, len(idx))
        images, rows = images[: len(idx)], rows[: len(idx)]
        rows.copy_(torch.from_numpy(np.asarray(idx, np.int64)))
        torch.index_select(self.host, 0, rows, out=images)
        if self.cuda:
            images = images.to(self.device, non_blocking=True)
            rows = rows.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._events[k] = ev
        x = images.float() / self.div
        if self.flips is not None:
            x = torch.where(self.flips[rows][:, None, None, None], x.flip(2), x)
        return x, rows
