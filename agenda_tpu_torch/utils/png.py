"""Stdlib PNG writer (and reader for the tests) for 8-bit gray and RGB images.

The machine that runs the port is not known to have Pillow, so the CLI
writes its PNGs with ``zlib`` and ``struct``: signature, IHDR, one IDAT of
filter-type-0 scanlines, IEND.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """Read a PNG this module wrote (8-bit gray/RGB, filter type 0 only)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color = hdr[:4]
    ch = {0: 1, 2: 3}.get(color)
    if depth != 8 or ch is None:
        raise ValueError(f"{path}: only 8-bit gray/RGB is supported")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only filter type 0 is supported")
    img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
