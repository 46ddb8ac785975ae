"""VAE pretraining's compute dtype (``agenda_tpu_torch.train.vae_pretrain``),
against ``agenda_tpu.train.vae_pretrain``, on the CPU.

The JAX step computes in the dtype of the ``AutoencoderKL`` it is given,
f32 by default (``agenda_tpu/models/vae.py:102-104``); so the port's step,
``measure_scaling_factor`` and ``pretrain_vae`` compute in f32 on the card
unless bf16 is asked for, and in f32 on the CPU whatever is asked.

- The choice: the three entry points default to f32; the step hands its
  ``dtype`` to ``full_f32_if`` (TF32 off on the card for f32) and
  ``_autocast`` (bf16 autocast on the card for bf16), and computes in f32
  on the CPU whatever is asked (no card needed).
- One f32 step against JAX's step on an ``AutoencoderKL`` at its default
  dtype, at a mid-block width above 160 (the wide flash backward's range on
  the card): levels of 32 and 192 channels, 32 px, batch 2, the port given
  the JAX step's normal draw. The loss, reconstruction and KL within
  LOSS_RTOL; each gradient (Adam's first moment after one step, 0.1 g) within
  GRAD_RTOL relative L2 of JAX's, over the tensors whose JAX gradient is not
  float noise (norm above NULL_GRAD of the largest). Both sides run f32 on
  the CPU (JAX's attention through XLA, the port's through the flash
  wrapper's plain version); only the order of summation differs.
"""

import contextlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agenda_tpu.train.vae_pretrain as jvp
import agenda_tpu_torch.train.vae_pretrain as pvp
from agenda_tpu.io.diffusers_io import vae_config_to_json
from agenda_tpu.models.vae import AutoencoderKL as JaxVAE
from agenda_tpu.models.vae import VAEConfig as JaxVAEConfig
from agenda_tpu_torch.io.configs import vae_config_from_json
from agenda_tpu_torch.io.diffusers_io import params_from_jax
from agenda_tpu_torch.models.vae import AutoencoderKL
from agenda_tpu_torch.train.optim import make_adam

LR, KL_WEIGHT = 1e-3, 1e-2
LOSS_RTOL = 1e-5  # loss, recon and KL: f32 on both sides
GRAD_RTOL = 1e-4  # each gradient tensor, relative L2
NULL_GRAD = 1e-4  # of the largest gradient norm: below it, float noise
BS, HW = 2, 32
WIDE = JaxVAEConfig(block_out_channels=(32, 192), layers_per_block=1)


@pytest.mark.filterwarnings("ignore:CUDA is not available")  # bf16 autocast built on the CPU
def test_vae_pretraining_computes_in_f32_on_the_card_by_default(monkeypatch):
    cuda = torch.device("cuda")
    for fn in (pvp.make_vae_pretrain_step, pvp.measure_scaling_factor, pvp.pretrain_vae):
        assert inspect.signature(fn).parameters["dtype"].default is torch.float32, fn
    # what each dtype gives on the card (the contexts are only built, never entered)
    assert isinstance(pvp._autocast(cuda, torch.float32), contextlib.nullcontext)
    assert not isinstance(pvp._autocast(cuda, torch.bfloat16), contextlib.nullcontext)
    assert isinstance(pvp.full_f32_if(torch.bfloat16, cuda), contextlib.nullcontext)

    seen = []
    autocast, full_f32_if = pvp._autocast, pvp.full_f32_if
    monkeypatch.setattr(pvp, "_autocast",
                        lambda device, dtype=None: seen.append(("autocast", dtype))
                        or autocast(device, dtype))
    monkeypatch.setattr(pvp, "full_f32_if",
                        lambda dtype, device, benchmark=True: seen.append(("full_f32", dtype))
                        or full_f32_if(dtype, device, benchmark))
    cfg = vae_config_from_json(vae_config_to_json(JaxVAEConfig.tiny()))
    pixels, eps = torch.zeros(1, 16, 16, 3), torch.zeros(1, 8, 8, 4)
    metrics = []
    for dtype in (None, torch.bfloat16):
        torch.manual_seed(0)
        vae, tx = AutoencoderKL(cfg), make_adam(LR)
        args = () if dtype is None else (dtype,)
        metrics.append(pvp.make_vae_pretrain_step(vae, tx, KL_WEIGHT, *args)(
            tx.init(dict(vae.named_parameters())), pixels, eps))
    f32, bf16 = torch.float32, torch.bfloat16
    assert seen == [("full_f32", f32), ("autocast", f32), ("full_f32", bf16), ("autocast", bf16)]
    # on the CPU neither context does anything: bf16 asked for computes in f32
    assert all(torch.equal(metrics[0][k], metrics[1][k]) for k in metrics[0])
    with pytest.raises(ValueError):
        pvp.make_vae_pretrain_step(vae, tx, KL_WEIGHT, torch.float16)


def test_f32_step_matches_jax_default_dtype_at_a_wide_mid_block():
    jvae = JaxVAE(WIDE)
    assert jvae.dtype == jnp.float32
    params = jvae.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), jax.random.key(1))
    pixels = np.random.default_rng(0).uniform(-1, 1, (BS, HW, HW, 3)).astype(np.float32)
    key = jax.random.key(5)
    tx = optax.adam(LR)
    _, jopt, jm = jvp.make_vae_pretrain_step(jvae, tx, KL_WEIGHT)(
        params, tx.init(params), jnp.asarray(pixels), key)

    vae = AutoencoderKL(vae_config_from_json(vae_config_to_json(WIDE)))
    vae.load_state_dict(params_from_jax(vae_params=jax.tree.map(np.asarray, params["params"]))[1],
                        strict=True)
    assert vae.encoder.mid_block.attentions[0].to_q.weight.shape[0] > 160
    ptx = make_adam(LR)
    popt = ptx.init(dict(vae.named_parameters()))
    eps = np.array(jax.random.normal(key, pvp.latent_shape(vae, BS, HW, HW), jnp.float32))
    pm = pvp.make_vae_pretrain_step(vae, ptx, KL_WEIGHT)(popt, torch.from_numpy(pixels),
                                                         torch.from_numpy(eps))
    for name in ("recon", "kl"):
        np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=LOSS_RTOL)

    jmu = params_from_jax(vae_params=jax.tree.map(np.asarray, jopt[0].mu["params"]))[1]
    top = max(float(v.norm()) for v in jmu.values())
    worst, held = 0.0, 0
    for name, want in jmu.items():
        if float(want.norm()) <= NULL_GRAD * top:
            continue
        held += 1
        worst = max(worst, float((popt.mu[name] - want).norm() / want.norm()))
    print(f"{held} gradients of {len(jmu)} held; worst {worst:.3g} relative L2")
    assert held > len(jmu) // 2 and worst <= GRAD_RTOL, worst
