"""The port's procedural heatmap domain (``agenda_tpu_torch/io/procedural.py``)
against the JAX package's, on the CPU.

Both packages draw from one ``RandomState`` in the same order; the JAX
package draws its RGB tiles with Pillow, the port with its numpy copies of
Pillow's bilinear resize, ellipse rasterizer and rectangle fill. Everything
is held to the bit: ``ann.json``, the heatmap stacks and the RGB tiles (the
files' decoded pixels; the two packages' PNG writers differ).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from agenda_tpu.io import procedural as jproc
from agenda_tpu_torch.io import procedural as tproc

# the stack labeler's train and val settings, and a target-like domain
SETTINGS = {
    "labeler_train": (0, dict(noise=10, p_dim=0.05, p_spurious=0.1)),
    "labeler_val": (7, dict(noise=10, p_dim=0.05, p_spurious=0.1)),
    "target": (3, dict(gain=0.8, bias=20, noise=18, p_dim=0.3, p_spurious=0.5)),
}
N_IMAGES = 8


def _pixels(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_heatmap_domain_equals_jax_to_the_bit(tmp_path, name):
    seed, kw = SETTINGS[name]
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jann = jproc.make_heatmap_domain(jroot, N_IMAGES, seed=seed, **kw)
    tann = tproc.make_heatmap_domain(troot, N_IMAGES, seed=seed, **kw)
    with open(jann) as f, open(tann) as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got["images"]) == N_IMAGES
    for sub in ("images", "daam_stack_heatmaps"):
        assert sorted(os.listdir(os.path.join(troot, sub))) == sorted(
            os.listdir(os.path.join(jroot, sub)))
        for fname in os.listdir(os.path.join(jroot, sub)):
            a = _pixels(os.path.join(jroot, sub, fname))
            b = _pixels(os.path.join(troot, sub, fname))
            assert a.shape == b.shape == (tproc.SIZE, tproc.SIZE, 3), (sub, fname)
            np.testing.assert_array_equal(b, a, err_msg=f"{sub}/{fname}")


def test_ellipse_and_rectangle_fill_as_pillow():
    """The ported rasterizers against Pillow's on random boxes, some off the
    canvas, circles and ellipses, down to a zero-size box (Pillow draws
    nothing there); the rectangle on float corners."""
    rng = np.random.RandomState(0)
    for t in range(600):
        im = np.zeros((40, 40, 3), np.uint8)
        x0, y0 = (int(v) for v in rng.randint(-15, 45, 2))
        a, b = (int(v) for v in rng.randint(0, 30, 2))
        box = [x0, y0, x0 + a, y0 + (a if t % 2 else b)]
        pil = Image.fromarray(im.copy())
        ImageDraw.Draw(pil).ellipse(box, fill=(200, 10, 30))
        tproc.fill_ellipse(im, box, (200, 10, 30))
        np.testing.assert_array_equal(im, np.asarray(pil), err_msg=str(box))
    for _ in range(300):
        im = np.zeros((40, 40, 3), np.uint8)
        c = rng.uniform(-10, 50, 4)
        box = [min(c[0], c[2]), min(c[1], c[3]), max(c[0], c[2]), max(c[1], c[3])]
        pil = Image.fromarray(im.copy())
        ImageDraw.Draw(pil).rectangle(box, fill=(200, 10, 30))
        tproc.fill_rectangle(im, box, (200, 10, 30))
        np.testing.assert_array_equal(im, np.asarray(pil), err_msg=str(box))
    im = np.zeros((20, 20, 3), np.uint8)
    tproc.fill_rectangle(im, [10.7, 10.2, 20.5, 20.9], (1, 2, 3))
    ys, xs = np.nonzero(im[..., 0])
    assert (ys.min(), ys.max(), xs.min(), xs.max()) == (10, 19, 10, 19)  # clipped at 19
