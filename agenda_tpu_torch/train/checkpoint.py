"""Training checkpoints: diffusers-layout UNet weights plus the train state,
with rotation, atomic writes, asynchronous writes and resume.

Counterpart of ``agenda_tpu/train/checkpoint.py:34-341``. A checkpoint is a
directory ``<output_dir>/checkpoint-<step>/``:

    unet/config.json, unet/diffusion_pytorch_model.safetensors
        the trained UNet in diffusers layout (a loadable model by itself);
    unet_ema/...            the EMA shadow, the same way (with --use_ema);
    train_state/state.json  {"step": int, "ema_step": int or null,
                             "optimizer": "adam8bit" or "adamw"}, plus
                             "mini_step" under gradient accumulation;
    train_state/optimizer.safetensors
        the optimizer state: "count" (int32), and for each parameter name
        "mu.<name>" / "nu.<name>" (f32 moments) or, for an int8 moment,
        "mu.<name>.q" (int8, the parameter's shape) and "mu.<name>.scale"
        (f32 absmax per 256-element row), and the same for "nu"; under
        accumulation with micro-batches pending, "acc.<name>" (f32).

The token fine-tune's checkpoint (``snapshot_token_state``, after
``agenda_tpu/cli/finetune_sd_token.py:222-239``) holds the whole UNet
(trained and frozen parameters) in ``unet/``, the learned rows as
``learned_embeds_steps_<step>.bin`` when tokens are trained, and the
optimizer state of its {"embedding", "unet.<name>"} parameters with the
step and mini-step; ``load_optimizer_state`` restores it on resume.

This replaces the JAX package's orbax PyTree for the optimizer, step and
EMA step; reading a JAX orbax checkpoint is not supported (see ROADMAP.md).
Under ``--fsdp`` (``parallel/blocks.py``) every rank takes part in the
snapshot, which gathers the block runs into the one-card layout on rank 0,
and a resume takes each rank's runs of it: a checkpoint of any world
resumes at any other.
A checkpoint is written into ``.tmp-checkpoint-<step>`` and renamed into
place, so resume never sees a partial one.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from agenda_tpu_torch.io.configs import unet_config_to_json
from agenda_tpu_torch.io.diffusers_io import _read_tensor_file
from agenda_tpu_torch.io.learned_embeds import save_learned_embeddings
from agenda_tpu_torch.io.safetensors_io import load_file, save_file
from agenda_tpu_torch.train.optim import (
    MIN_QUANTIZE_SIZE,
    MultiStepsState,
    ScaleByAdam8bitState,
    _Quantized,
)

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
_WEIGHTS = "diffusion_pytorch_model"


def list_checkpoints(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    out = []
    for d in os.listdir(output_dir):
        m = _CKPT_RE.match(d)
        if m:
            out.append((int(m.group(1)), os.path.join(output_dir, d)))
    return sorted(out)


def rotate_checkpoints(output_dir: str, total_limit: Optional[int]) -> None:
    """Keep at most total_limit - 1, so that the next save lands within the limit."""
    if total_limit is None:
        return
    ckpts = list_checkpoints(output_dir)
    if len(ckpts) >= total_limit:
        for _, path in ckpts[: len(ckpts) - total_limit + 1]:
            shutil.rmtree(path)


def atomic_checkpoint_dir(output_dir: str, step: int, total_limit: Optional[int],
                          payload_fn) -> str:
    """Write checkpoint-{step}/ atomically: sweep stale ``.tmp-checkpoint-*``
    orphans of crashed runs, rotate, write into a tmp dir, and replace any old
    checkpoint-{step} only just before the rename."""
    if os.path.isdir(output_dir):
        for d in os.listdir(output_dir):
            if d.startswith(".tmp-checkpoint-"):
                shutil.rmtree(os.path.join(output_dir, d), ignore_errors=True)
    rotate_checkpoints(output_dir, total_limit)
    final_path = os.path.join(output_dir, f"checkpoint-{step}")
    path = os.path.join(output_dir, f".tmp-checkpoint-{step}")
    os.makedirs(path)
    payload_fn(path)
    if os.path.exists(final_path):
        shutil.rmtree(final_path)
    os.rename(path, final_path)
    return final_path


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _opt_tensors(opt_state, shard=None,
                 params=None) -> Tuple[str, Dict[str, torch.Tensor], Optional[int]]:
    """(kind, tensors, mini_step or None without accumulation). With
    ``shard`` (the ``BlockRuns`` of ``params``) the sharded leaves' runs are
    gathered into their one-card tensors, on every rank."""
    mini, acc = None, {}
    if isinstance(opt_state, MultiStepsState):
        mini = opt_state.mini_step
        acc = opt_state.acc if mini else {}  # zero at every update boundary
        opt_state = opt_state.inner
    kind = "adam8bit" if isinstance(opt_state, ScaleByAdam8bitState) else "adamw"
    out = {"count": _host(opt_state.count)}
    names = list(params) if shard is not None else list(opt_state.mu)
    for part in ("mu", "nu"):
        moments = getattr(opt_state, part)
        for name in names:
            m = moments.get(name)
            if shard is not None and name in shard.runs:
                shape = params[name].shape
                if kind == "adam8bit" and shard.sizes[name] >= MIN_QUANTIZE_SIZE:
                    nb = -(-shard.sizes[name] // 256)
                    out[f"{part}.{name}.q"] = _host(shard.full(
                        name, None if m is None else m.q, shape, torch.int8))
                    out[f"{part}.{name}.scale"] = _host(shard.full(
                        name, None if m is None else m.scale, (nb,), torch.float32, True))
                else:
                    out[f"{part}.{name}"] = _host(shard.full(name, m, shape, torch.float32))
            elif isinstance(m, _Quantized):
                out[f"{part}.{name}.q"] = _host(m.q)
                out[f"{part}.{name}.scale"] = _host(m.scale)
            else:
                out[f"{part}.{name}"] = _host(m)
    if shard is not None and mini:
        acc = {name: (shard.full(name, acc.get(name), params[name].shape, torch.float32)
                      if name in shard.runs else acc[name]) for name in names}
    out.update({f"acc.{name}": _host(a) for name, a in acc.items()})
    return kind, out, mini


def full_ema(state) -> Optional[Dict[str, torch.Tensor]]:
    """The SD train state's EMA shadow in the one-card layout (gathered from
    the block runs under ``--fsdp``, on every rank), or None without EMA."""
    shard = getattr(state, "shard", None)
    if state.ema is None:
        return None
    if shard is None:
        return state.ema.params
    return {k: (shard.full(k, state.ema.params.get(k), p.shape, torch.float32)
                if k in shard.runs else state.ema.params[k])
            for k, p in state.params.items()}


def snapshot_state(state, ema_as_unet_ema: bool = True) -> dict:
    """Host copies of everything a checkpoint writes (the copy from the card
    waits for the step's work, so the snapshot is of this step)."""
    shard = getattr(state, "shard", None)
    kind, opt, mini = _opt_tensors(state.opt_state, shard, state.params)
    ema = full_ema(state) if ema_as_unet_ema else None
    return {
        "params": {k: _host(v) for k, v in state.params.items()},
        "ema_params": None if ema is None else {k: _host(v) for k, v in ema.items()},
        "optimizer": kind,
        "opt": opt,
        "step": int(state.step),
        "ema_step": None if state.ema is None else int(state.ema.step),
        "mini_step": mini,
        "embedding": None,
    }


def snapshot_token_state(state, tokens) -> dict:
    """The token trainer's snapshot: the whole UNet, the learned rows (named
    by ``tokens``) when tokens are trained, the optimizer and the step."""
    kind, opt, mini = _opt_tensors(state.opt_state)
    params = {**state.unet_frozen, **state.unet_trainable}
    return {
        "params": {k: _host(v) for k, v in params.items()},
        "ema_params": None,
        "optimizer": kind,
        "opt": opt,
        "step": int(state.step),
        "ema_step": None,
        "mini_step": mini,
        "embedding": (None if state.embedding is None
                      else (list(tokens), _host(state.embedding).numpy())),
    }


def _write_unet(path: str, unet_config, tensors: Dict[str, torch.Tensor]) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(unet_config_to_json(unet_config), f, indent=2)
    save_file(tensors, os.path.join(path, _WEIGHTS + ".safetensors"))


def _write_payload(path: str, step: int, unet_config, snap: dict) -> None:
    _write_unet(os.path.join(path, "unet"), unet_config, snap["params"])
    if snap["ema_params"] is not None:
        _write_unet(os.path.join(path, "unet_ema"), unet_config, snap["ema_params"])
    if snap["embedding"] is not None:
        save_learned_embeddings(*snap["embedding"],
                                os.path.join(path, f"learned_embeds_steps_{step}.bin"))
    state_dir = os.path.join(path, "train_state")
    os.makedirs(state_dir)
    save_file(snap["opt"], os.path.join(state_dir, "optimizer.safetensors"))
    meta = {"step": snap["step"], "ema_step": snap["ema_step"], "optimizer": snap["optimizer"]}
    if snap["mini_step"] is not None:
        meta["mini_step"] = snap["mini_step"]
    with open(os.path.join(state_dir, "state.json"), "w") as f:
        json.dump(meta, f)


def write_checkpoint(output_dir: str, step: int, unet_config, snap: dict,
                     total_limit: Optional[int]) -> str:
    return atomic_checkpoint_dir(output_dir, step, total_limit,
                                 lambda path: _write_payload(path, step, unet_config, snap))


def save_checkpoint(output_dir: str, step: int, unet_config, state,
                    total_limit: Optional[int] = None, ema_as_unet_ema: bool = True) -> str:
    """Write checkpoint-{step}/{unet/, unet_ema/, train_state/}. Returns its path."""
    return write_checkpoint(output_dir, step, unet_config,
                            snapshot_state(state, ema_as_unet_ema), total_limit)


class AsyncWriter:
    """One background file-IO job in flight; ``submit`` joins the previous
    one first, and ``wait`` re-raises a writer's exception on the caller."""

    def __init__(self):
        self._thread = None
        self._result = None
        self._error = None

    def submit(self, fn, name: str = "ckpt-write") -> None:
        self.wait()
        self._result = None

        def run():
            try:
                self._result = fn()
            except BaseException as e:  # re-raised from wait()
                self._error = e

        self._thread = threading.Thread(target=run, name=name)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._result

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.wait()
        else:
            try:
                self.wait()
            except Exception:
                logging.getLogger(__name__).exception(
                    "pending checkpoint write failed while unwinding another error")
        return False


class AsyncCheckpointer(AsyncWriter):
    """Checkpoint writes off the training thread: ``save`` takes the host
    snapshot (the copy from the card) and hands the file IO to a writer
    thread; ``wait`` joins it."""

    def save(self, output_dir: str, step: int, unet_config, state,
             total_limit: Optional[int] = None, ema_as_unet_ema: bool = True) -> None:
        self.save_snapshot(output_dir, step, unet_config,
                           snapshot_state(state, ema_as_unet_ema), total_limit)

    def save_snapshot(self, output_dir: str, step: int, unet_config, snap: dict,
                      total_limit: Optional[int] = None) -> None:
        """Write a snapshot already taken (``snapshot_state``'s or
        ``snapshot_token_state``'s)."""
        self.submit(lambda: write_checkpoint(output_dir, step, unet_config, snap, total_limit),
                    name=f"ckpt-write-{step}")


def find_resume_checkpoint(output_dir: str, resume_from: str) -> Optional[Tuple[int, str]]:
    """``resume_from`` is a checkpoint path or name, or 'latest'."""
    if resume_from != "latest":
        base = os.path.basename(os.path.normpath(resume_from))
        m = _CKPT_RE.match(base)
        path = resume_from if os.path.isabs(resume_from) else os.path.join(output_dir, base)
        if m and os.path.isdir(path):
            return int(m.group(1)), path
        return None
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1] if ckpts else None


@torch.no_grad()
def load_optimizer_state(path: str, opt_state, shard=None) -> dict:
    """Restore ``<path>/train_state`` into ``opt_state`` in place (its
    structure stays) and return the checkpoint's state.json; with ``shard``
    (``BlockRuns``) each sharded leaf takes this rank's runs of it."""
    def take(name, t, per_block=False):
        return t if shard is None else shard.take(name, t, per_block)

    with open(os.path.join(path, "train_state", "state.json")) as f:
        meta = json.load(f)
    opt = load_file(os.path.join(path, "train_state", "optimizer.safetensors"))
    outer = opt_state if isinstance(opt_state, MultiStepsState) else None
    inner = outer.inner if outer is not None else opt_state
    kind = "adam8bit" if isinstance(inner, ScaleByAdam8bitState) else "adamw"
    if meta["optimizer"] != kind:
        raise ValueError(f"{path} holds {meta['optimizer']} state; this run uses {kind}")
    inner.count.copy_(opt["count"])
    for part in ("mu", "nu"):
        for name, m in getattr(inner, part).items():
            if isinstance(m, _Quantized):
                m.q.copy_(take(name, opt[f"{part}.{name}.q"]))
                m.scale.copy_(take(name, opt[f"{part}.{name}.scale"], True))
            else:
                m.copy_(take(name, opt[f"{part}.{name}"]))
    if outer is not None:
        outer.mini_step = int(meta.get("mini_step", 0))
        for name, a in outer.acc.items():
            if outer.mini_step:
                a.copy_(take(name, opt[f"acc.{name}"]))
            else:
                a.zero_()
    return meta


@torch.no_grad()
def load_checkpoint(path: str, state) -> Any:
    """Restore a checkpoint into ``state`` (its tensors are overwritten in
    place, so the optimizer keeps its structure) and return it."""
    params = _read_tensor_file(os.path.join(path, "unet", _WEIGHTS))
    if set(params) != set(state.params):
        raise ValueError(f"{path}: the checkpoint's UNet keys differ from the model's")
    for k, p in state.params.items():
        p.copy_(params[k])
    shard = getattr(state, "shard", None)
    meta = load_optimizer_state(path, state.opt_state, shard)
    state.step = int(meta["step"])
    if state.ema is not None:
        ema_file = os.path.join(path, "unet_ema", _WEIGHTS)
        ema = _read_tensor_file(ema_file) if os.path.exists(ema_file + ".safetensors") else params
        for k, e in state.ema.params.items():
            e.copy_(ema[k] if shard is None else shard.take(k, ema[k]))
        state.ema.step.fill_(int(meta["ema_step"] or 0))
    return state
