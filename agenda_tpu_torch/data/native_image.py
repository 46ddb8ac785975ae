"""PNG and JPEG decode through libpng and libjpeg, and the host image passes.

Counterpart of ``agenda_tpu/data/native_image.py``: ``read_header``,
``decode``, ``resize_bilinear``, ``hsv_jitter_inplace`` and
``median_blur_u8`` with the JAX package's signatures, bound with ``ctypes``
to the port's copies of ``native/image_ops.cc`` (``csrc/image_codecs.cc``
for the decode, ``csrc/image_ops.cc`` for the rest; ``utils/host_build.py``
builds both at first use). Where the JAX package falls back to Pillow or
numpy, each of these raises when its library cannot be built.

``load_rgb(path)`` is the port's one image reader (training tiles, the
detectors' tiles and stacks, the refine crops): every PNG form libpng reads
(gray, gray + alpha, RGB, RGBA, palette with or without tRNS, 1-16 bits,
interlaced) and baseline or progressive JPEG, as uint8 RGB with alpha
dropped, whatever the file's extension. A truncated file or a non-image
raises ``ValueError`` naming the path.

A machine without the libpng or libjpeg headers cannot build the decode
(``host_build.MissingHeaders``). There ``load_rgb`` reads PNGs with the
port's stdlib reader (``utils/png.py``: 8-bit, not interlaced, no palette),
and a JPEG, or a PNG that reader refuses, raises naming the missing
library. ``image_size`` reads the size from the header either way.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import numpy as np

from agenda_tpu_torch.utils import host_build
from agenda_tpu_torch.utils.png import png_size, read_rgb

log = logging.getLogger(__name__)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _codec(name: str, argtypes):
    return host_build.load("codecs").function(name, argtypes)


def _op(name: str, argtypes):
    return host_build.load("host").function(name, argtypes)


def read_header(data: bytes) -> Tuple[int, int]:
    """(width, height) from PNG/JPEG bytes."""
    fn = _codec("read_image_header", [_U8P, ctypes.c_int64, _I32P, _I32P])
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = fn(_u8p(buf), len(data), ctypes.byref(w), ctypes.byref(h))
    if rc:
        raise ValueError(f"read_image_header failed rc={rc}")
    return int(w.value), int(h.value)


def decode(data: bytes) -> np.ndarray:
    """PNG/JPEG bytes -> (H, W, 3) uint8 RGB."""
    w, h = read_header(data)
    if w <= 0 or h <= 0:
        raise ValueError(f"bad image size {w}x{h}")
    fn = _codec("decode_rgb8", [_U8P, ctypes.c_int64, _U8P, ctypes.c_int32, ctypes.c_int32])
    out = np.empty((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    rc = fn(_u8p(buf), len(data), _u8p(out), w, h)
    if rc:
        raise ValueError(f"decode_rgb8 failed rc={rc}")
    return out


def resize_bilinear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (out_h, out_w, 3) uint8, Pillow's BILINEAR with its
    coefficients in float (within one level of Pillow's)."""
    fn = _op("resize_bilinear_rgb8", [_U8P, ctypes.c_int32, ctypes.c_int32, _U8P,
                                      ctypes.c_int32, ctypes.c_int32])
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize_bilinear takes (H, W, 3), got {img.shape}")
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = fn(_u8p(img), img.shape[0], img.shape[1], _u8p(out), out_h, out_w)
    if rc:
        raise ValueError(f"resize_bilinear_rgb8 failed rc={rc}")
    return out


def hsv_jitter_inplace(img: np.ndarray, hue_gain: float, sat_gain: float,
                       val_gain: float) -> bool:
    """The fused RGB -> HSV -> gains -> RGB pass over a C-contiguous
    (H, W, 3) float32 image in 0..255, in place (OpenCV's HSV convention,
    the formulas of ``detect/augment.py``'s numpy pair). True once done."""
    if img.dtype != np.float32 or not img.flags["C_CONTIGUOUS"] or img.shape[-1] != 3:
        raise ValueError("hsv_jitter_inplace takes a C-contiguous float32 (..., 3) array")
    fn = _op("hsv_jitter_f32", [_F32P, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                                ctypes.c_float])
    rc = fn(img.ctypes.data_as(_F32P), img.size // 3, float(hue_gain), float(sat_gain),
            float(val_gain))
    if rc:
        raise ValueError(f"hsv_jitter_f32 failed rc={rc}")
    return True


def median_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """uint8 (H, W, 3) median over a k x k window (k odd, at most 63), numpy's
    ``pad(mode="reflect")`` borders: ``np.median`` of the same windows, bit
    for bit (Huang's sliding histogram)."""
    fn = _op("median_blur_u8", [_U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P])
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"median_blur_u8 takes (H, W, 3), got {img.shape}")
    out = np.empty_like(img)
    rc = fn(_u8p(img), img.shape[0], img.shape[1], int(k), _u8p(out))
    if rc:
        raise ValueError(f"median_blur_u8 failed rc={rc} (k={k} must be odd, 1..63)")
    return out


def _codecs_missing() -> Optional[host_build.MissingHeaders]:
    """The decode library's missing headers on this machine, else None (a
    build that fails otherwise raises)."""
    try:
        host_build.load("codecs")
    except host_build.MissingHeaders as e:
        return e
    return None


def load_rgb(path: str) -> np.ndarray:
    """The image at ``path`` as uint8 (H, W, 3) RGB (module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    missing = _codecs_missing()
    if missing is None:
        try:
            return decode(data)
        except ValueError as e:
            raise ValueError(f"{path}: not a readable PNG or JPEG ({e})") from None
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: only PNGs are read on this machine ({missing})")
    try:
        return read_rgb(path)
    except ValueError as e:
        raise ValueError(f"{path}: {e}; the other PNG forms need libpng ({missing})") from None


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of the PNG or JPEG at ``path`` from its header."""
    with open(path, "rb") as f:
        head = f.read(29)
        if head.startswith(_PNG_SIG):
            return png_size(path)
        data = head + f.read()
    missing = _codecs_missing()
    if missing is not None:
        raise ValueError(f"{path}: only PNGs are read on this machine ({missing})")
    try:
        return read_header(data)
    except ValueError as e:
        raise ValueError(f"{path}: not a readable PNG or JPEG ({e})") from None
