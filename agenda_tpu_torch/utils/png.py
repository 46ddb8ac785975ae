"""Stdlib PNG writer and reader for 8-bit images.

The machine that runs the port is not known to have Pillow, so the CLIs
write their PNGs with ``zlib`` and ``struct`` (signature, IHDR, one IDAT of
filter-type-0 scanlines, IEND) and the trainer reads its training tiles
with ``read_png``: 8-bit gray, gray + alpha, RGB or RGBA, not interlaced,
with any of the five scanline filters (as Pillow and most tools write them).
Palette, 16-bit and interlaced PNGs raise.
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


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels (gray, RGB, gray+A, RGBA)


def _header(data: bytes, path: str):
    if data[:8] != _SIG or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return struct.unpack(">IIBBBBB", data[16:29])


def png_size(path: str):
    """(width, height) from the IHDR chunk, reading only the file's header."""
    with open(path, "rb") as f:
        w, h = _header(f.read(29), path)[:2]
    return w, h


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9) -> (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum over pixels, per byte of a pixel
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown PNG filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG -> uint8 (H, W) for gray, else (H, W, channels)."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, color, _, _, interlace = _header(data, path)
    ch = _CHANNELS.get(color)
    if depth != 8 or ch is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are supported")
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        if data[pos + 4 : pos + 8] == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    if raw[:, 0].any():
        img = _unfilter(raw, h, w * ch, ch, path).reshape(h, w, ch)
    else:
        img = raw[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3), as Pillow's ``convert("RGB")``: gray is repeated and
    alpha is dropped."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
