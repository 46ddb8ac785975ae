"""VAE pretraining (``agenda_tpu_torch.train.vae_pretrain``) against
``agenda_tpu.train.vae_pretrain``, on the CPU in f32, on the tiny VAE config.

- Two ``make_vae_pretrain_step`` steps from one set of weights (the JAX
  init, converted), the port given the JAX package's normal draw for each
  step's key as ``eps``: the loss, its reconstruction and KL terms within
  LOSS_RTOL, Adam's first moments within MU_TOL of each tensor's largest,
  and each tensor's two-step update within UPDATE_RTOL (relative L2). Adam
  moves an element by about lr whatever its gradient's size, so an element
  whose gradient is near the two packages' float noise can move either way:
  the updates are compared tensor by tensor, and every element is held to
  Adam's bound, about 2 lr from the start in two steps. Some gradients
  are zero but for float noise (the bias of a convolution that feeds a
  GroupNorm of one channel a group, the key projection's bias): those
  parameters (first moment below NULL_MU in the JAX run) are held to the
  bound alone.
- ``pretrain_vae``: the batches it draws (``RandomState(seed).randint``)
  equal the JAX function's, and its ``scaling_factor`` formula, given the
  JAX draws, equals the JAX function's within SCALE_RTOL; a short run
  returns a finite scale and reconstruction.
- ``AutoencoderKL.forward`` is ``agenda_tpu``'s ``__call__`` given its draw.
"""

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

LR, KL_WEIGHT = 1e-3, 1e-2  # KL weighted up from 1e-4 so that its gradient shows
LOSS_RTOL = 1e-5  # loss, recon and KL: f32, only the summation order differs
UPDATE_RTOL = 1e-3  # each tensor's two-step update, relative L2 (see the module docstring)
MU_TOL = 1e-4  # Adam's first moments, of the tensor's largest (f32 gradients, two steps)
# two Adam steps: lr, then at most 1.00135 lr (m_hat / sqrt(v_hat) peaks there, at
# g1 = 0.90 g2), plus the f32 rounding of weights near 0.25
ADAM_BOUND = 2.0014 * LR + 1e-7
NULL_MU = 1e-7  # a first moment below it comes from a gradient at the float noise (~1e-9)
FWD_TOL = 1e-4  # forward outputs, as the VAE's encode/decode parity
SCALE_RTOL = 1e-5
N, BS, HW, SEED = 6, 4, 16, 3


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxVAEConfig.tiny()
    jvae = JaxVAE(cfg)
    params = jvae.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), jax.random.key(1))
    images = np.random.default_rng(0).integers(0, 256, (N, HW, HW, 3)).astype(np.uint8)
    return jvae, params, vae_config_from_json(vae_config_to_json(cfg)), images


def _port_vae(port_cfg, params):
    vae = AutoencoderKL(port_cfg)
    state = params_from_jax(vae_params=jax.tree.map(np.asarray, params["params"]))[1]
    vae.load_state_dict(state, strict=True)
    return vae


def _jax_eps(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def test_forward_is_the_jax_call_given_its_draw(tiny):
    jvae, params, port_cfg, images = tiny
    x = images[:2].astype(np.float32) / 127.5 - 1.0
    key = jax.random.key(7)
    recon_j, mean_j, logvar_j = jvae.apply(params, jnp.asarray(x), key)
    vae = _port_vae(port_cfg, params)
    eps = torch.from_numpy(_jax_eps(key, mean_j.shape))
    with torch.no_grad():
        got = vae(torch.from_numpy(x), eps)
    for ours, theirs in zip(got, (recon_j, mean_j, logvar_j)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=FWD_TOL, rtol=FWD_TOL)


def test_two_pretrain_steps_match_jax(tiny):
    jvae, params, port_cfg, images = tiny
    pixels = images.astype(np.float32) / 127.5 - 1.0
    tx = optax.adam(LR)
    jstep = jvp.make_vae_pretrain_step(jvae, tx, KL_WEIGHT)
    jparams, jopt = params, tx.init(params)
    vae = _port_vae(port_cfg, params)
    ptx = make_adam(LR)
    popt = ptx.init(dict(vae.named_parameters()))
    pstep = pvp.make_vae_pretrain_step(vae, ptx, KL_WEIGHT)
    rng = np.random.RandomState(SEED)
    for i in range(2):
        idx = rng.randint(0, N, BS)
        key = jax.random.key(SEED * 100_003 + i)
        eps = _jax_eps(key, pvp.latent_shape(vae, BS, HW, HW))
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(pixels[idx]), key)
        pm = pstep(popt, torch.from_numpy(pixels[idx]), torch.from_numpy(eps))
        np.testing.assert_allclose(float(pm["recon"]), float(jm["recon"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["kl"]), float(jm["kl"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["loss"]),
                                   float(jm["recon"]) + KL_WEIGHT * float(jm["kl"]),
                                   rtol=LOSS_RTOL)
    flat = lambda tree: params_from_jax(vae_params=jax.tree.map(np.asarray, tree))[1]  # noqa: E731
    want, start, jmu = flat(jparams["params"]), flat(params["params"]), flat(jopt[0].mu["params"])
    n_null, worst = 0, 0.0
    for name, p in vae.named_parameters():
        got = p.detach()
        top = float(jmu[name].abs().max())
        # Adam's two steps move every element by at most about 2 lr on each side
        assert (got - start[name]).abs().max() <= ADAM_BOUND, (name, float((got - start[name]).abs().max()))
        assert (want[name] - start[name]).abs().max() <= ADAM_BOUND, name
        if top <= NULL_MU:  # a gradient that is zero but for float noise
            n_null += 1
            continue
        np.testing.assert_allclose(popt.mu[name].numpy(), jmu[name].numpy(), rtol=0,
                                   atol=MU_TOL * top, err_msg=name)
        step_j = want[name] - start[name]
        rel = float((got - want[name]).norm() / step_j.norm())
        worst = max(worst, rel)
        assert rel <= UPDATE_RTOL, (name, rel)
    print(f"{n_null} null parameters of {len(want)}; worst update error {worst:.3g} (relative L2)")
    assert 0 < n_null < len(want) // 2 and int(popt.count) == 2


def test_pretrain_vae_batches_and_scaling_factor_match_jax(tiny, monkeypatch):
    jvae, params, port_cfg, images = tiny
    seen = {"jax": [], "port": []}

    def recorder(side, result, batch_arg):
        def make(*_args):
            def step(*args):
                seen[side].append(np.asarray(args[batch_arg]).copy())
                return result(args)
            return step
        return make

    zero = {"recon": jnp.float32(0.0), "kl": jnp.float32(0.0)}
    monkeypatch.setattr(jvp, "make_vae_pretrain_step",
                        recorder("jax", lambda a: (a[0], a[1], zero), 2))
    monkeypatch.setattr(pvp, "make_vae_pretrain_step", recorder(
        "port", lambda a: {"loss": torch.zeros(()), "recon": torch.zeros(()),
                           "kl": torch.zeros(())}, 1))
    _, jscale, _ = jvp.pretrain_vae(jvae, params, images, steps=3, batch_size=BS, seed=SEED)
    vae = _port_vae(port_cfg, params)
    pvp.pretrain_vae(vae, images, steps=3, batch_size=BS, seed=SEED)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)

    pixels = images.astype(np.float32) / 127.5 - 1.0
    scale = pvp.measure_scaling_factor(
        vae, pixels, BS,
        lambda start, shape: torch.from_numpy(_jax_eps(jax.random.key(start), shape)))
    np.testing.assert_allclose(scale, jscale, rtol=SCALE_RTOL)


def test_pretrain_vae_runs_and_measures_a_finite_scale(tiny):
    _, params, port_cfg, images = tiny
    vae = _port_vae(port_cfg, params)
    before = {n: p.detach().clone() for n, p in vae.named_parameters()}
    out, scale, recon = pvp.pretrain_vae(vae, images, steps=3, batch_size=BS, lr=LR, seed=1)
    assert out is vae and np.isfinite(scale) and scale > 0 and np.isfinite(recon)
    assert any(not torch.equal(p, before[n]) for n, p in vae.named_parameters())
