"""Device resolution: CUDA unless the caller asks for the CPU, never a fallback."""

from __future__ import annotations

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


def compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (the JAX package's bf16 default)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
