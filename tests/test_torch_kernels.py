"""Kernel-level parity of the PyTorch port (agenda_tpu_torch) against agenda_tpu.

On the CPU the port's wrappers take their plain versions; these tests hold
those against the JAX package's Pallas kernels, run as the JAX tests run
them on the CPU (interpret mode), and against the XLA references. Inputs are
drawn with numpy from a seed and handed to both packages. The CUDA kernels
themselves are held against the plain versions in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from PIL import Image

from agenda_tpu.kernels.attention import attention_reference as jax_attention_reference
from agenda_tpu.kernels.attention import cross_attention_with_probs as jax_cross_attention
from agenda_tpu.kernels.flash import _flash_fwd_impl
from agenda_tpu.kernels.groupnorm import _gn_pallas
from agenda_tpu_torch.generate.resize import (
    cubic_weights,
    resize_bicubic,
    resize_uint8_pil,
)
from agenda_tpu_torch.kernels.attention import (
    attention,
    attention_reference,
    cross_attention_with_probs,
)
from agenda_tpu_torch.kernels.flash import flash_attention_fwd
from agenda_tpu_torch.kernels.groupnorm import group_norm_act

F32_TOL = 2e-5  # f32 on both sides; only the summation order differs


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- flash forward ------------------------------------------------------------


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("d", [40, 80])
def test_flash_plain_matches_pallas_kernel(s, d):
    rng = np.random.RandomState(s + d)
    q, k, v = (_rand(rng, 2, s, 2, d) for _ in range(3))
    out_j, res = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    lse_j = np.asarray(res[-1])[:, 0, :]  # (B*H, 1, S) -> (B*H, S)
    out_t, lse_t = flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out_t.shape == (2, s, 2, d) and lse_t.shape == (4, s)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=F32_TOL, rtol=F32_TOL)


def test_flash_plain_ragged_seq_matches_xla_reference():
    # The Pallas kernel raises for S=576; the port masks any S.
    rng = np.random.RandomState(3)
    q, k, v = (_rand(rng, 1, 576, 2, 40) for _ in range(3))
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, _ = flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def test_flash_wrapper_rejects_bad_input():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, torch.zeros(1, 9, 2, 4), q)
    with pytest.raises(ValueError):
        flash_attention_fwd(q[0], q[0], q[0])


# -- GroupNorm(+SiLU) ---------------------------------------------------------


def _flax_gn(x_nhwc, scale, bias, groups, eps, act):
    y = nn.GroupNorm(num_groups=groups, epsilon=eps).apply(
        {"params": {"scale": scale, "bias": bias}}, x_nhwc)
    return nn.silu(y) if act == "silu" else y


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("b,c,hw,g", [(2, 64, 64, 32), (1, 96, 16, 32), (2, 32, 256, 8)])
def test_groupnorm_plain_matches_pallas_and_flax(b, c, hw, g, eps, act):
    rng = np.random.RandomState(c + hw)
    x = _rand(rng, b, hw, c) * 2.0 + 0.5  # (B, HW, C): the JAX kernel's layout
    scale, bias = _rand(rng, c), _rand(rng, c)
    y_pallas = np.asarray(_gn_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     g, eps, act, interpret=True))
    side = int(np.sqrt(hw))
    y_flax = np.asarray(_flax_gn(jnp.asarray(x.reshape(b, side, side, c)), jnp.asarray(scale),
                                 jnp.asarray(bias), g, eps, act)).reshape(b, hw, c)
    x_nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    y = group_norm_act(x_nchw, torch.from_numpy(scale), torch.from_numpy(bias), g, eps, act)
    y = y.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(y, y_pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y, y_flax, atol=1e-5, rtol=1e-5)


def test_groupnorm_wrapper_rejects_bad_input():
    x = torch.zeros(2, 30, 4, 4)
    with pytest.raises(ValueError):
        group_norm_act(x, torch.ones(30), torch.zeros(30), 32, 1e-5)  # 30 % 32
    with pytest.raises(ValueError):
        group_norm_act(x, torch.ones(30), torch.zeros(30), 10, 1e-5, act="relu")


# -- attention ------------------------------------------------------------------


def test_cross_attention_with_probs_matches_jax():
    rng = np.random.RandomState(5)
    q, k, v = _rand(rng, 2, 64, 2, 16), _rand(rng, 2, 77, 2, 16), _rand(rng, 2, 77, 2, 16)
    out_j, probs_j = jax_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out_t, probs_t = cross_attention_with_probs(*(torch.from_numpy(x) for x in (q, k, v)))
    assert probs_t.shape == (2, 64, 77) and probs_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), atol=1e-6, rtol=1e-5)


def test_masked_attention_and_cpu_dispatch_match_jax():
    rng = np.random.RandomState(6)
    q, k, v = (_rand(rng, 2, 77, 2, 16) for _ in range(3))
    mask = np.triu(np.full((77, 77), -1e9, np.float32), k=1)[None, None]
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(mask))
    out = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)
    unmasked = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(unmasked), atol=F32_TOL, rtol=F32_TOL)


# -- resizes --------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(8, 64), (16, 64), (32, 64), (512, 112),
                                     (16, 8), (32, 112), (8, 8)])
def test_bicubic_resize_matches_jax_image_resize(src, dst):
    rng = np.random.RandomState(src * 1000 + dst)
    x = _rand(rng, 2, 3, src, src)
    ref = jax.image.resize(jnp.asarray(x), (2, 3, dst, dst), method="cubic")
    out = resize_bicubic(torch.from_numpy(x), dst, dst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # the weights are what jax.image builds: rows sum to 1 where samples land inside
    w = cubic_weights(src, dst)
    np.testing.assert_allclose(w.sum(dim=1).numpy(), np.ones(dst), atol=1e-5)


@pytest.mark.parametrize("src,dst", [(64, 112), (8, 112), (112, 64)])
def test_uint8_resize_matches_pillow_bicubic(src, dst):
    rng = np.random.RandomState(src + dst)
    ramp = np.add.outer(np.arange(src), np.arange(src)) * (255.0 / (2 * src - 2))
    for img in (rng.randint(0, 256, (src, src)).astype(np.uint8), ramp.astype(np.uint8)):
        ref = np.asarray(Image.fromarray(img).resize((dst, dst), Image.BICUBIC))
        out = resize_uint8_pil(torch.from_numpy(img)[None], dst, dst)[0].numpy()
        assert out.dtype == np.uint8 and out.shape == (dst, dst)
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
