"""Device resolution: CUDA unless the caller asks for the CPU, never a
fallback; the compute dtype that ``--mixed_precision`` selects; and the
full-f32 arithmetic (no TF32) of the f32 paths on the card."""

from __future__ import annotations

import contextlib

import torch

_SM90 = (9, 0)


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the torch device to run on.

    ``None`` and ``"cuda"`` mean the card; ``"cpu"`` means the CPU. Asking
    for CUDA without a usable GPU raises instead of falling back to the CPU.
    A card of another compute capability than 9.0 raises too: the kernels
    are built for ``sm_90a``, which runs on Hopper only.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if cap != _SM90:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels need sm_90 (Hopper)"
        )
    return torch.device("cuda", index)


def compute_dtype(device: torch.device, mixed_precision: str | None = None) -> torch.dtype:
    """The compute dtype of a ``--mixed_precision`` choice on ``device``.

    "no" gives f32 on every device, as the JAX CLIs compute in f32 under it
    (``agenda_tpu/cli/finetune_sd.py:165``); any other choice (None, "bf16",
    "fp16") gives bf16 on the card (the JAX package's bf16 default) and f32
    on the CPU.
    """
    if mixed_precision == "no" or device.type != "cuda":
        return torch.float32
    return torch.bfloat16


def full_f32(dev: torch.device, benchmark: bool = True):
    """Full f32 convolutions and matmuls on the card (no TF32), cuDNN
    autotuned for the fixed batch shape of a training loop (``benchmark``;
    a one-off pass, such as a validation batch, takes cuDNN's heuristics
    instead of paying the autotuning of every new shape); nothing on the
    CPU."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                                    deterministic=False, allow_tf32=False))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


def full_f32_if(dtype: torch.dtype, dev: torch.device, benchmark: bool = True):
    """``full_f32`` for the f32 compute dtype (``--mixed_precision no``);
    nothing for another."""
    if dtype == torch.float32:
        return full_f32(dev, benchmark)
    return contextlib.nullcontext()
