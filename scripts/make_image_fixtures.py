"""Write the committed image fixtures under ``tests/data/images/``.

The machine with the card has no Pillow, so the PNG and JPEG forms that the
port's decoder reads are written here once, with Pillow, and committed:
baseline JPEG at 4:2:0 and 4:4:4, progressive and gray JPEG, and palette,
palette + tRNS, 16-bit and interlaced PNG (Pillow writes no interlaced PNG:
that one comes from ``_adam7_png``), each beside its expected pixels
(``<name>.npy``, decoded by the JAX package's native decoder), plus a
512-px RGB PNG whose rows Pillow filters, for timing the labelling decode.
``tests/test_torch_native_image.py`` checks that each ``.npy`` still equals
the JAX decode of its file, and ``chip_smoke.py`` reads them on the card.

    python scripts/make_image_fixtures.py
"""

from __future__ import annotations

import io
import os

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data", "images")
H, W = 32, 40
TILE = 512


def _rgb(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A smooth field with texture: small files, every decode path busy."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(x / (5 + c) + y / (7 + 2 * c)) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def _tile() -> np.ndarray:
    y, x = np.mgrid[0:TILE, 0:TILE].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / (29 + 7 * c)) * np.cos(y / (37 + 5 * c))
                     for c in range(3)], -1)
    return (np.clip(base, 0, 255).astype(np.uint8) // 32) * 32  # few levels: a small file


def forms():
    """name -> encoded bytes."""
    rgb = Image.fromarray(_rgb(0))
    out = {}

    def save(name, im, fmt, **kw):
        b = io.BytesIO()
        im.save(b, fmt, **kw)
        out[name] = b.getvalue()

    save("jpeg_420.jpg", rgb, "JPEG", quality=90, subsampling=2)
    save("jpeg_444.jpg", rgb, "JPEG", quality=90, subsampling=0)
    save("jpeg_progressive.jpg", rgb, "JPEG", quality=85, progressive=True)
    save("jpeg_gray.jpg", rgb.convert("L"), "JPEG", quality=90)
    pal = rgb.convert("P", palette=Image.ADAPTIVE, colors=64)
    save("png_palette.png", pal, "PNG")
    save("png_palette_trns.png", pal, "PNG", transparency=3)
    wide = (_rgb(1).astype(np.uint16)[..., 0] * 257 + np.arange(W, dtype=np.uint16))
    save("png_16bit.png", Image.fromarray(wide.astype(np.uint16)), "PNG")
    out["png_interlaced.png"] = _adam7_png(_rgb(2))  # Pillow writes no Adam7
    save("png_tile_512.png", Image.fromarray(_tile()), "PNG")
    return out


def _adam7_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB Adam7-interlaced PNG, each pass's rows with filter 1 (Sub)."""
    import struct
    import zlib

    h, w = img.shape[:2]
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
              (1, 0, 2, 2), (0, 1, 1, 2)]
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub.reshape(sub.shape[0], -1).astype(np.int32):
            filt = row.copy()
            filt[3:] = (row[3:] - row[:-3]) & 0xFF
            raw += bytes([1]) + filt.astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def main():
    from agenda_tpu.data import native_image

    os.makedirs(OUT, exist_ok=True)
    for name, data in forms().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        if name != "png_tile_512.png":
            np.save(os.path.join(OUT, os.path.splitext(name)[0] + ".npy"),
                    native_image.decode(data))
        print(name, len(data))


if __name__ == "__main__":
    main()
