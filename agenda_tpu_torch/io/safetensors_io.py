"""Minimal safetensors reader and writer (stdlib + torch only).

File layout: an 8-byte little-endian header length N, N bytes of JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(optionally a ``__metadata__`` entry), then the raw little-endian tensor
bytes. The machine that runs the port is not known to have the
``safetensors`` package, so the port keeps its own copy of the format.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of a .safetensors file into CPU tensors."""
    data = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(data)
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(bytes(data[8 : 8 + n]).decode("utf-8"))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} for {name}")
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data) - base:
            raise ValueError(f"{path}: bad data_offsets for {name}")
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        if int(np.prod(shape, dtype=np.int64)) * size != end - begin:
            raise ValueError(f"{path}: size of {name} does not match its shape")
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        # Tensors share the file's buffer; an unaligned one gets its own copy.
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - begin, offset=base + begin)
        if (base + begin) % size:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor | np.ndarray], path: str) -> None:
    """Write tensors (torch or numpy, any device) to a .safetensors file."""
    header = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        t = t.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {t.dtype} for {name}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)  # keep the body 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
