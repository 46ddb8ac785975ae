"""Detector runner: training, checkpoints, batched labelling, mAP.

Counterpart of ``agenda_tpu/detect/runner.py``:

- ``RunnerConfig`` with every field of the JAX package's, so a
  ``config.json`` from either package's ``det_train`` parses in the other;
- ``save_variables``/``load_variables``: the JAX runner's checkpoint, one
  safetensors file of flattened flax variables (``params.<path>``,
  ``batch_stats.<path>`` and, from a trainer with EMA, ``ema_params.<path>``),
  read and written through the port's own safetensors code and mapped to
  and from the model's ``state_dict`` by the family's ``from_flax`` and
  ``to_flax`` (``detect/flax_layout.py``; without a family, the layout
  every family but Faster R-CNN shares), so one file serves both packages. ``load_variables`` returns the params and
  batch statistics, which is what prediction reads, as the JAX ``det_test``
  does; ``read_checkpoint`` returns the EMA too;
- ``DetectorRunner.train``, both paths of the JAX runner (``:314-676``).
  On the host-augmentation path the port's ``DataLoader`` (one producer
  thread, so the dataset sees the reference's order of calls) feeds the
  batches; with ``device_aug`` (``_make_planner``; a recipe the planner
  cannot express warns and takes the host path, ``aug_path`` says which
  ran) the train set goes to the card once as uint8 and ``DeviceAugFeed``
  renders each batch there from the host's plans (``detect/device_aug.py``),
  serially or from ``PlanPrefetcher``'s workers. Either feeds one train step
  a batch (``make_train_step``: the family's train-mode forward and loss,
  its samplers drawing from a generator seeded from (seed, step) as the JAX
  runner folds the step into its key, autograd, the optimizer of
  ``optim.make_optimizer``, the EMA with its ramp
  ``d = ema_decay (1 - exp(-(step + 1) / 2000))`` at the step before its
  increment, flax's batch-norm statistics); ``metrics.jsonl`` at
  ``log_interval`` and the first two steps; validation every
  ``val_interval`` epochs, then every ``val_interval_stage2`` inside the
  mosaic-close window, on the EMA params with the live batch statistics,
  saving ``best_<key>.safetensors``; the recipe switch at ``max_epochs -
  close_mosaic_epochs``; ``latest.safetensors`` and the port's own
  ``train_state_torch.safetensors`` sidecar (the optimizer's buffers, update
  count, epoch, step) each epoch on a writer thread; resume from
  ``latest`` (moments, epoch, step) or weights only from any other file;
  ``pretrained`` imports an mmdet/mmyolo checkpoint over the fresh weights
  first (``io/torch_import.py``, the reference's ``load_from``).
  As in the reference's host path, a resumed run's data loader starts its
  shuffle and the dataset its per-call seeds at 0 again; the device path
  keys its plans and batches on the true epoch, so a resumed run continues
  them;
- ``DetectorRunner._predict_batches``: one batch in flight. The host
  decodes batch i+1 while the card runs batch i; the tiles go up as uint8
  from pinned memory (non-blocking), are resized on the card (bilinear, two
  f32 passes, one rounding, as the JAX device path), and the batch's
  (boxes, scores, valid) come back in one device-to-host copy. The last
  batch is padded with its last tile. A set whose tiles differ in size is
  resized tile by tile on the device (the JAX package resizes those on the
  host), within one level of the JAX host path;
- ``evaluate`` (COCO mAP) and ``test`` (the ``prediction.pkl`` records).

The detector runs in f32 on the card with TF32 off (``allow_tf32=False``
for cuDNN and cuBLAS), as the reference's f32 convolutions, in training
too.

Over several ranks (``mesh``, ``parallel/mesh.py``; ``agenda_tpu/detect/
runner.py:317-321, 687-703``): training takes a global batch of
``batch_size x dp`` in a single process's sample order, and each rank reads
(host path) or renders (device path, from the global batch's plans) its
rows. The step runs under ``parallel.batch_split``, so the batch-norm
statistics, the losses' normalizers and batch size, and the samplers' and
drop path's per-sample draws are the global batch's; the ranks' losses are
shares of the global loss and their gradients are summed. Only rank 0
validates, logs and writes checkpoints. ``test`` splits each batch over the
ranks when the batch divides by the world (else every rank predicts it
whole) and gathers the records, in a single process's order, on every rank;
rank 0 writes them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch._device import full_f32, resolve_device
from agenda_tpu_torch.annotate.records import save_predictions
from agenda_tpu_torch.data.device_resize import resize_levels, resize_weights
from agenda_tpu_torch.detect.coco_eval import coco_map
from agenda_tpu_torch.detect.device_aug import (PLAN_SEED, SELECTORS, AugPlanner, ConcatAugPlanner,
                                                LSJPlanner, PlanPrefetcher, epoch_plans,
                                                render_batch, render_lsj_batch)
from agenda_tpu_torch.detect.flax_layout import flax_to_state_dict, state_dict_to_flax
from agenda_tpu_torch.detect.optim import global_norm, make_optimizer
from agenda_tpu_torch.io.safetensors_io import load_file, save_file
from agenda_tpu_torch.parallel.mesh import (Mesh, all_gather_objects, all_reduce_sum_,
                                            batch_split, shard_batch)


@dataclasses.dataclass
class RunnerConfig:
    output_dir: str = "work_dirs/run"
    max_epochs: int = 100
    batch_size: int = 16
    lr: float = 0.02
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 500
    lr_milestones: Tuple[float, ...] = (0.66, 0.88)
    val_interval: int = 5
    save_best: Tuple[str, ...] = ("bbox_mAP", "bbox_mAP_50")
    clip_grad_norm: Optional[float] = 35.0
    ema_decay: float = 0.0
    seed: int = 0
    log_interval: int = 20
    yolo_optimizer: bool = False
    nesterov: bool = False
    lr_factor: float = 0.01
    warmup_epochs: float = 3.0
    warmup_mim_iter: int = 1000
    warmup_bias_lr: float = 0.1
    warmup_momentum: float = 0.8
    base_total_batch_size: int = 64
    auto_scale_lr: bool = False
    base_batch_size: Optional[int] = None
    close_mosaic_epochs: int = 0
    val_interval_stage2: Optional[int] = None
    device_aug: bool = False
    device_aug_workers: int = 0
    layer_decay_rate: Optional[float] = None
    layer_decay_layers: int = 12


SIDECAR = "train_state_torch.safetensors"
EMA_RAMP_STEPS = 2000.0  # the EMA decay ramps in as 1 - exp(-(step + 1) / 2000)
logger = logging.getLogger("agenda_tpu_torch.detect")


def _st_path(path: str) -> str:
    return path if path.endswith(".safetensors") else path + ".safetensors"


def save_variables(path: str, variables: Dict[str, torch.Tensor],
                   ema: Optional[Dict[str, torch.Tensor]] = None, family=None) -> None:
    """Write a state_dict (and an EMA of its parameters, as flax's
    ``ema_params`` collection) in the JAX runner's checkpoint layout, through
    ``family``'s converter."""
    to_flax = family.to_flax if family is not None else state_dict_to_flax
    flat = to_flax(variables)
    if ema is not None:
        flat.update({"ema_" + k: v for k, v in to_flax(ema).items()})
    save_file(flat, _st_path(path))


def read_checkpoint(path: str, family=None) -> Tuple[Dict[str, torch.Tensor],
                                                     Optional[Dict[str, torch.Tensor]]]:
    """A JAX (or port) detector checkpoint -> (state_dict, EMA of the
    parameters or None), on the CPU, through ``family``'s converter. An
    unknown key raises."""
    from_flax = family.from_flax if family is not None else flax_to_state_dict
    flat = {k: v.float().numpy() for k, v in load_file(_st_path(path)).items()}
    ema_flat = {k[len("ema_"):]: flat.pop(k) for k in list(flat) if k.startswith("ema_params.")}
    ema = None
    if ema_flat:
        ema = {k: v for k, v in from_flax(ema_flat).items()
               if not k.endswith("num_batches_tracked")}
    return from_flax(flat), ema


def load_variables(path: str, family=None) -> Dict[str, torch.Tensor]:
    """The params and batch statistics of a checkpoint as the model's
    state_dict; a trainer's EMA collection is not read, as the JAX
    ``det_test`` does not read it."""
    return read_checkpoint(path, family)[0]


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The train step's generator on ``device``, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


IMPORT_KEYS = {"FasterRCNNFamily": "faster-rcnn", "YOLOv5Family": "yolov5",
               "YOLOv8Family": "yolov8", "ViTDetFamily": "vitdet"}


@dataclasses.dataclass
class TrainState:
    """What a train step reads and updates: parameters (leaf tensors that
    take gradients), batch-norm statistics, torch's ``num_batches_tracked``
    counters (nothing reads them), the EMA of the parameters (None without
    EMA) and the optimizer state."""

    params: Dict[str, torch.Tensor]
    stats: Dict[str, torch.Tensor]
    counters: Dict[str, torch.Tensor]
    ema: Optional[Dict[str, torch.Tensor]]
    opt: Any  # the optimizer's state (optim.SGDState or optim.AdamWState)

    def variables(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The model's state_dict, with the EMA's parameters when asked."""
        params = self.ema if use_ema and self.ema is not None else self.params
        return {**{k: v.detach() for k, v in params.items()}, **self.stats, **self.counters}


def ema_decay_at(ema_decay: float, step: int) -> float:
    """The EMA's decay at ``step`` (before its increment), in f32 as the
    reference computes it."""
    f32 = np.float32
    return float(f32(ema_decay) * (f32(1) - np.exp(-(f32(step) + f32(1)) / f32(EMA_RAMP_STEPS))))


def batch_to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The loader's numpy batch -> the step's tensors on ``dev``."""
    return {k: torch.from_numpy(batch[k]).to(dev, non_blocking=True)
            for k in ("image", "gt_boxes", "gt_valid")}


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class DeviceAugFeed:
    """The device-augmentation path's batches (the JAX runner's plan stream,
    ``agenda_tpu/detect/runner.py:324-358, 495-544``).

    The planner fills the train set's uint8 tensor on the host, and it goes
    to the card once. Each epoch's plans come from ``workers`` processes
    (epochs before ``stop_epoch``) or are made here as the batches are
    taken, from
    ``default_rng((seed + 1) * PLAN_SEED + epoch)`` over
    ``loader.batches_for_epoch(epoch)``: keyed on the true epoch, so a
    resumed run continues the same plans. A batch's plans go up from one of
    two pinned staging buffers without waiting (``SELECTORS`` stay on the
    host for the render), with the passthrough slab only when a sample uses
    it (else zeros kept on the card), and are rendered before the step,
    without autograd."""

    def __init__(self, planner, n_tiles: int, batch_size: int, seed: int, max_gt: int,
                 workers: int, stop_epoch: Optional[int], dev: torch.device,
                 mesh: Optional[Mesh] = None):
        from agenda_tpu_torch.data.datasets import DataLoader

        self.planner, self.dev, self.max_gt, self.mesh = planner, dev, max_gt, mesh
        self.seed_base = (seed + 1) * PLAN_SEED
        # the batches' indices only: nothing augments images on the host
        self.loader = DataLoader(range(n_tiles), batch_size, shuffle=True, seed=seed,
                                 num_workers=0, pad_to_full=True)
        # MedianBlur/CLAHE passthrough slots: about 2% of a batch; 64 covers
        # a batch of 1024 at more than 6 sigma
        self.slots = max(1, min(64, batch_size // 8))
        tiles = planner.dataset_tensor()
        self.data = torch.from_numpy(tiles).to(dev)
        self.zero_scratch = torch.zeros((self.slots, planner.th, planner.tw, 3),
                                        dtype=torch.float32, device=dev)
        logger.info("device aug on: %d tiles (%.0f MB) resident in device memory",
                    self.data.shape[0], self.data.nbytes / 1e6)
        self.prefetcher = None
        if workers > 0:  # its pool starts with the first epoch it prefetches
            self.prefetcher = PlanPrefetcher(planner, self.loader.batches_for_epoch,
                                             self.seed_base, max_gt, self.slots, workers, tiles,
                                             stop_epoch=stop_epoch)
        self._staged: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0

    def plans(self, epoch: int):
        """(packed, scratch or None) of each batch of ``epoch``, in order."""
        pre = self.prefetcher.epoch_batches(epoch) if self.prefetcher is not None else None
        if pre is not None:
            return pre
        rng = np.random.default_rng(self.seed_base + epoch)
        return epoch_plans(self.planner, self.loader.batches_for_epoch(epoch), rng,
                           self.max_gt, self.slots)

    def upload(self, packed: Dict[str, np.ndarray], scratch: Optional[np.ndarray]
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """-> (the plans as tensors, the scratch slab) on the card, the
        selectors on the host."""
        arrays = packed if scratch is None else {**packed, "scratch": scratch}
        if self.dev.type != "cuda":
            out = {k: torch.from_numpy(v) for k, v in arrays.items()}
        else:
            slot, self._slot = self._slot, 1 - self._slot
            if self._copied[slot] is not None:
                self._copied[slot].synchronize()  # this slot's copies of two batches ago
            bufs, out = self._staged[slot], {}
            for k, v in arrays.items():
                if k in SELECTORS:
                    out[k] = torch.from_numpy(v)
                    continue
                buf = bufs.get(k)
                if buf is None or buf.shape != v.shape:
                    buf = bufs[k] = torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                                pin_memory=True)
                buf.numpy()[...] = v
                out[k] = buf.to(self.dev, non_blocking=True)
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record()
        return out, out.pop("scratch", self.zero_scratch)

    def render(self, plans: Dict[str, torch.Tensor], scratch: torch.Tensor) -> torch.Tensor:
        p = self.planner
        with torch.no_grad():
            if "lsj_idx" in plans:
                return render_lsj_batch(self.data, plans, (p.th, p.tw), (p.sh, p.sw))
            return render_batch(self.data, scratch, plans, (p.th, p.tw), separable=p.separable)

    def batches(self, epoch: int):
        """The epoch's train batches on the card: image, gt_boxes, gt_valid
        (with ``mesh``, this rank's rows of the global batch's plans)."""
        for packed, scratch in self.plans(epoch):
            if self.mesh is not None:
                packed = shard_batch(packed, self.mesh)
                if not (packed["pass_slot"] >= 0).any():
                    scratch = None
            plans, slab = self.upload(packed, scratch)
            yield {"image": self.render(plans, slab), "gt_boxes": plans["gt_boxes"],
                   "gt_valid": plans["gt_valid"]}

    def close(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = None


class DetectorRunner:
    def __init__(self, family, cfg: Optional[RunnerConfig] = None, device: Any = "cuda",
                 mesh: Optional[Mesh] = None):
        """``mesh``: the ranks to train and predict over (its device is the
        runner's); one process without it."""
        self.family = family
        self.cfg = cfg or RunnerConfig()
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.is_main = self.mesh is None or self.mesh.is_main

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    def variables_on_device(self, variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The checked variables on the runner's device."""
        self.family.check_variables(variables)
        return {k: v.to(self.device) for k, v in variables.items()}

    # -- training -----------------------------------------------------------

    def _import_key(self) -> str:
        """The family's key for the torch-checkpoint importer."""
        name = type(self.family).__name__
        return IMPORT_KEYS.get(name, name.lower())

    def init_train_state(self, opt, variables: Dict[str, torch.Tensor],
                         ema: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A train state on the runner's device; the EMA starts from ``ema``,
        else from the parameters, when ``ema_decay`` > 0."""
        on_dev = self.variables_on_device(variables)
        fam = self.family
        params = {k: on_dev[k].clone().requires_grad_(True) for k in fam.param_names}
        stats = {k: on_dev[k] for k in fam.stat_names}
        counters = {k: v for k, v in on_dev.items() if k not in params and k not in stats}
        shadow = None
        if self.cfg.ema_decay > 0:
            src = ema if ema is not None else params
            shadow = {k: src[k].detach().to(self.device, copy=True) for k in fam.param_names}
        return TrainState(params, stats, counters, shadow, opt.init(params))

    def make_train_step(self, opt) -> Callable[..., Dict[str, torch.Tensor]]:
        """-> ``step(state, batch, gstep)``: one update of ``state`` in place
        from a batch on the device; returns the step's metrics (0-dim tensors
        on the device: the family's loss parts, loss, grad_norm)."""
        family, ema_decay, seed, dev = self.family, self.cfg.ema_decay, self.cfg.seed, self.device
        mesh = self.mesh

        def step(state: TrainState, batch: Dict[str, torch.Tensor], gstep: int):
            variables = {**state.params, **state.stats, **state.counters}
            names = list(state.params)
            with batch_split(mesh):
                loss, metrics, new_stats = family.loss_fn(variables, batch,
                                                          step_generator(seed, gstep, dev))
                grads = dict(zip(names, torch.autograd.grad(loss, [state.params[k]
                                                                   for k in names])))
            if mesh is not None:  # the ranks' losses are shares of the global one
                all_reduce_sum_(grads.values(), mesh)
                parts = list(metrics)
                total = torch.stack([metrics[k].detach() for k in parts] + [loss.detach()])
                all_reduce_sum_([total], mesh)
                metrics = dict(zip(parts, total[:-1]))
                loss = total[-1]
            opt.update(grads, state.opt, state.params)
            state.stats = new_stats
            if state.ema is not None:
                d = ema_decay_at(ema_decay, gstep)
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, d)  # e d + (1 - d) p
                torch._foreach_add_(ema, torch._foreach_mul(
                    [state.params[k].detach() for k in state.ema], float(np.float32(1) - np.float32(d))))
            out = {k: v.detach() for k, v in metrics.items()}
            out["loss"] = loss.detach()
            out["grad_norm"] = global_norm(list(grads.values()))
            return out

        return step

    def train(self, train_dataset, val_dataset=None, resume: Optional[str] = None,
              pretrained: Optional[str] = None):
        from agenda_tpu_torch.data.datasets import DataLoader
        from agenda_tpu_torch.train.checkpoint import AsyncWriter

        cfg, dev = self.cfg, self.device
        global_bs = cfg.batch_size * self.dp
        rows = None if self.mesh is None else self.mesh.rows(global_bs)
        switch_epoch = cfg.max_epochs - cfg.close_mosaic_epochs \
            if cfg.close_mosaic_epochs > 0 else None
        planner = feed = None
        if cfg.device_aug:
            planner, why = self._make_planner(train_dataset)
            if planner is None:
                logger.warning("device_aug requested but unsupported (%s); "
                               "using the host aug pipeline", why)
        self.aug_path = "host" if planner is None else "device"
        if planner is None:
            loader = DataLoader(train_dataset, global_bs, shuffle=True, seed=cfg.seed,
                                num_workers=1, pad_to_full=True, rows=rows)

            def epoch_batches(epoch):
                return (batch_to_device(b, dev) for b in loader)
        else:
            feed = DeviceAugFeed(planner, len(train_dataset), global_bs, cfg.seed,
                                 train_dataset.max_gt, cfg.device_aug_workers, switch_epoch, dev,
                                 self.mesh)
            loader, epoch_batches = feed.loader, feed.batches
        saver = AsyncWriter()
        try:
            return self._train_loop(train_dataset, val_dataset, resume, pretrained, epoch_batches,
                                    len(loader), switch_epoch, saver)
        finally:
            # the worker pool must not outlive a failed run, and the last
            # checkpoint is complete before the caller goes on
            if feed is not None:
                feed.close()
            saver.wait()

    def _train_loop(self, train_dataset, val_dataset, resume, pretrained, epoch_batches,
                    steps_per_epoch: int, switch_epoch, saver):
        from agenda_tpu_torch.utils.profiling import StepTimer

        cfg, dev = self.cfg, self.device
        global_bs = cfg.batch_size * self.dp
        base_lr = cfg.lr
        if cfg.auto_scale_lr and cfg.base_batch_size:
            base_lr = cfg.lr * global_bs / cfg.base_batch_size
            logger.info("auto_scale_lr: lr %.2e -> %.2e (global_bs %d / base %d)",
                        cfg.lr, base_lr, global_bs, cfg.base_batch_size)
        opt = make_optimizer(cfg, steps_per_epoch, total_bs=global_bs, base_lr=base_lr)

        variables = self.family.init_variables(torch.Generator().manual_seed(cfg.seed))
        if pretrained:
            # a COCO init from a torch checkpoint: the reference's load_from
            from agenda_tpu_torch.io.torch_import import (import_detector_weights,
                                                          load_torch_checkpoint)

            variables, report = import_detector_weights(
                self.family, variables, load_torch_checkpoint(pretrained), self._import_key())
            self.import_report = report
            logger.info("pretrained init from %s: %d tensors imported, %d head tensors "
                        "shape-skipped", pretrained, len(report.imported),
                        len(report.skipped_shape))
        resume_ema, sidecar, start_epoch, gstep = None, None, 0, 0
        if resume:
            variables, resume_ema = read_checkpoint(resume, self.family)
            # the sidecar is written with latest.safetensors and matches only it
            path = os.path.join(os.path.dirname(os.path.abspath(resume)), SIDECAR)
            is_latest = os.path.basename(resume) == "latest.safetensors"
            if is_latest and os.path.exists(path):
                sidecar = load_file(path)
                start_epoch, gstep = int(sidecar["epoch"]) + 1, int(sidecar["gstep"])
                logger.info("resumed optimizer/epoch state: epoch %d, step %d",
                            start_epoch, gstep)
            elif not is_latest:
                logger.info("%s is not latest.safetensors: weights-only resume "
                            "(the train_state sidecar only matches latest)", resume)
            else:
                logger.info("no %s next to %s: weights-only resume", SIDECAR, resume)
        state = self.init_train_state(opt, variables, resume_ema)
        if sidecar is not None:
            state.opt.count = int(sidecar["count"])
            for kind, buffers in opt.buffers(state.opt).items():
                for k, t in buffers.items():
                    t.copy_(sidecar[f"{kind}.{k}"])
        train_step = self.make_train_step(opt)

        best: Dict[str, float] = {k: -1.0 for k in cfg.save_best}
        timer = StepTimer()
        log_path = os.path.join(cfg.output_dir, "metrics.jsonl") if self.is_main else os.devnull
        with open(log_path, "a") as metrics_log, full_f32(dev):
            for epoch in range(start_epoch, cfg.max_epochs):
                if switch_epoch is not None and epoch >= switch_epoch:
                    self._apply_stage2_aug(train_dataset)
                for batch in epoch_batches(epoch):
                    metrics = train_step(state, batch, gstep)
                    gstep += 1
                    if gstep % cfg.log_interval == 0 or gstep <= 2:
                        names = list(metrics)
                        values = torch.stack([metrics[k] for k in names]).tolist()
                        m = dict(zip(names, values))
                        m.update(epoch=epoch, step=gstep, lr=opt.lr_fn(gstep),
                                 sps=timer.tick(gstep))
                        metrics_log.write(json.dumps(m) + "\n")
                        metrics_log.flush()
                        logger.info("e%d s%d loss=%.4f lr=%.2e", epoch, gstep, m["loss"], m["lr"])
                # a tighter val cadence inside the mosaic-close window
                val_every = cfg.val_interval
                if (switch_epoch is not None and epoch >= switch_epoch
                        and cfg.val_interval_stage2 is not None):
                    val_every = cfg.val_interval_stage2
                if not self.is_main:
                    continue  # rank 0 validates and checkpoints
                if val_dataset is not None and (epoch + 1) % val_every == 0:
                    variables = state.variables(use_ema=cfg.ema_decay > 0)
                    results = self.evaluate(variables, val_dataset)
                    logger.info("epoch %d val: %s", epoch,
                                {k: round(v, 4) for k, v in results.items()})
                    metrics_log.write(json.dumps({"epoch": epoch, **results}) + "\n")
                    metrics_log.flush()
                    for key in cfg.save_best:
                        if results.get(key, -1) > best[key]:
                            best[key] = results[key]
                            save_variables(os.path.join(cfg.output_dir, f"best_{key}.safetensors"),
                                           variables, family=self.family)
                # a host snapshot now; the files are written while the next epoch runs
                snap = (_host(state.variables()),
                        None if state.ema is None else _host(state.ema),
                        {kind: _host(b) for kind, b in opt.buffers(state.opt).items()},
                        state.opt.count)
                saver.submit(lambda snap=snap, epoch=epoch, gstep=gstep:
                             self._save_latest(*snap, epoch, gstep), name=f"latest-e{epoch}")
        return state.variables(use_ema=cfg.ema_decay > 0)

    def _save_latest(self, variables, ema, buffers, count: int, epoch: int, gstep: int) -> None:
        """latest.safetensors and its train-state sidecar."""
        out = self.cfg.output_dir
        save_variables(os.path.join(out, "latest.safetensors"), variables, ema, self.family)
        flat = {f"{kind}.{k}": v for kind, b in buffers.items() for k, v in b.items()}
        flat.update(count=torch.tensor(count), epoch=torch.tensor(epoch),
                    gstep=torch.tensor(gstep))
        save_file(flat, os.path.join(out, SIDECAR))

    @staticmethod
    def _make_planner(dataset):
        """-> (planner or None, why not). Device aug needs each part's tile
        cache; an LSJ recipe takes the LSJPlanner, which needs one dataset
        whose tiles share one size."""
        parts = getattr(dataset, "datasets", None)
        for part in (parts or [dataset]):
            aug = getattr(part, "aug", None)
            if aug is None:
                return None, "dataset has no aug recipe"
            if aug.lsj:
                if parts is not None:
                    return None, "LSJ over a ConcatDataset"
                if dataset.source_size() is None:
                    return None, "LSJ needs a uniform source tile size"
                return LSJPlanner(dataset), ""
            if getattr(part, "_scaled_cache", None) is None:
                return None, "tile cache disabled (AGENDA_TORCH_IMG_CACHE_MB)"
        if parts is not None:
            return ConcatAugPlanner(dataset), ""
        return AugPlanner(dataset), ""

    def _apply_stage2_aug(self, dataset) -> None:
        """Switch a (possibly concatenated) train dataset to the stage-2
        (mosaic-closed) recipe; idempotent."""
        from agenda_tpu_torch.detect.augment import stage2_aug

        for part in getattr(dataset, "datasets", [dataset]):
            a = getattr(part, "aug", None)
            if a is not None and not a.standalone_affine:
                part.aug = stage2_aug(a)
                logger.info("mosaic-close: switched train aug to stage-2 "
                            "recipe (mosaic/mixup off, standalone affine)")

    # -- evaluation / test --------------------------------------------------

    def _predict_batches(self, variables, dataset, batch_size: Optional[int] = None,
                         split: bool = False):
        """The records of ``dataset`` in order. With ``split`` and a batch that
        divides by the mesh's world, each rank predicts its rows of every
        batch and the records are gathered on every rank."""
        bs = batch_size or self.cfg.batch_size
        dev = self.device
        cuda = dev.type == "cuda"
        n = len(dataset)
        mesh = self.mesh if split else None
        if mesh is not None and bs % mesh.world:
            mesh = None  # every rank runs the whole batch (runner.py:691)
        params = self.variables_on_device(variables)
        out_w, out_h = dataset.img_scale
        src = dataset.source_size()  # one size: a batched resize; else tile by tile
        weights: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

        def resize_weights_on_device(w: int, h: int):
            if (w, h) not in weights:
                weights[(w, h)] = (
                    torch.from_numpy(resize_weights(h, out_h, "bilinear")).to(dev),
                    torch.from_numpy(resize_weights(w, out_w, "bilinear")).to(dev))
            return weights[(w, h)]

        # two pinned staging buffers each way: batch i's copies may still be
        # in flight while the host fills batch i+1's
        staged_in: List[Optional[torch.Tensor]] = [None, None]
        staged_out: List[Optional[torch.Tensor]] = [None, None]

        def upload(slot: int, images: np.ndarray) -> torch.Tensor:
            if not cuda:
                return torch.from_numpy(images)
            buf = staged_in[slot]
            if buf is None or buf.shape != images.shape:
                buf = staged_in[slot] = torch.empty(images.shape, dtype=torch.uint8,
                                                    pin_memory=True)
            buf.numpy()[...] = images
            return buf.to(dev, non_blocking=True)

        def dispatch(i: int, slot: int):
            lo, hi = i, min(i + bs, n)
            size = bs
            if mesh is not None:  # this rank's rows of the batch padded to bs
                size = bs // mesh.world
                r = mesh.rows(bs)
                lo, hi = i + r.start, min(i + r.stop, n)
                if lo >= hi:
                    return lo, [], None, None
            if src is not None:
                items = [dataset.item_u8(j, expect_size=src) for j in range(lo, hi)]
                pad = size - len(items)
                u8 = np.stack([it["image_u8"] for it in items]
                              + [items[-1]["image_u8"]] * pad)
                wy, wx = resize_weights_on_device(*src)
                x = resize_levels(upload(slot, u8), wy, wx) / 255.0
            else:
                items = [dataset.item_u8(j) for j in range(lo, hi)]
                pad = size - len(items)
                tiles = []
                for it in items + [items[-1]] * pad:
                    u8 = torch.from_numpy(it["image_u8"]).to(dev)
                    h, w = u8.shape[:2]
                    wy, wx = resize_weights_on_device(w, h)
                    tiles.append(resize_levels(u8[None], wy, wx, half_up=True))
                x = torch.cat(tiles) / 255.0
            boxes, scores, valid = self.family.predict_fn(params, x)
            packed = torch.cat([boxes, scores[..., None], valid[..., None].to(boxes.dtype)],
                               dim=-1)
            if not cuda:
                return lo, items, packed, None
            host = staged_out[slot]
            if host is None or host.shape != packed.shape:
                host = staged_out[slot] = torch.empty(packed.shape, dtype=packed.dtype,
                                                      pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return lo, items, host, done

        records = []  # (index in the set, record)

        def collect(pending):
            lo, items, host, done = pending
            if not items:
                return
            if done is not None:
                done.synchronize()
            res = host.numpy()
            for k, it in enumerate(items):
                valid = res[k, :, 5] > 0
                scores = res[k, :, 4]
                keep = valid & (scores > 0)
                records.append((lo + k, {"item": it, "boxes": res[k, :, :4][keep],  # a copy
                                         "scores": scores[keep]}))

        pending = None
        with full_f32(dev):
            for slot, i in enumerate(range(0, n, bs)):
                cur = dispatch(i, slot % 2)
                if pending is not None:
                    collect(pending)
                pending = cur
            if pending is not None:
                collect(pending)
        if mesh is not None:  # every rank's rows, back in the set's order
            records = sorted((r for part in all_gather_objects(records, mesh) for r in part),
                             key=lambda r: r[0])
        return [rec for _, rec in records]

    def evaluate(self, variables, dataset) -> Dict[str, float]:
        recs = self._predict_batches(variables, dataset)
        gts = [r["item"]["gt_boxes"][r["item"]["gt_valid"]] for r in recs]
        return coco_map(gts, [r["boxes"] for r in recs], [r["scores"] for r in recs])

    def test(self, variables, dataset, out_pkl: Optional[str] = None,
             img_dir: Optional[str] = None,
             batch_size: Optional[int] = None) -> List[dict]:
        """Produce prediction records (== mmdet tools/test.py --out)."""
        recs = self._predict_batches(variables, dataset, batch_size=batch_size, split=True)
        out = []
        for r in recs:
            it = r["item"]
            image_id = int(it["image_id"])
            file_name = dataset.file_name(image_id)
            sb = np.asarray(it.get("scale_back", np.ones(4)), np.float32)
            out.append({
                "img_path": os.path.join(img_dir or dataset.img_dir, file_name),
                "gt_instances": {
                    "bboxes": np.asarray(it["gt_boxes"][it["gt_valid"]], np.float32) * sb,
                    "labels": np.zeros(int(it["gt_valid"].sum()), np.int64),
                },
                "pred_instances": {
                    "bboxes": np.asarray(r["boxes"], np.float32) * sb,
                    "scores": np.asarray(r["scores"], np.float32),
                    "labels": np.zeros(len(r["scores"]), np.int64),
                },
            })
        if out_pkl and self.is_main:
            save_predictions(out, out_pkl)
        return out
