"""Gradient accumulation of the PyTorch port against optax ``MultiSteps``, on the CPU.

With k = 2, after 2 and 4 micro-batches: the parameters, the moments and
the count of the port's ``multi_steps`` against ``MultiSteps`` around the
JAX package's chains (f32 AdamW; and the port's fused int8 kernel, run once
an update, against the JAX package's unfused int8 chain, which its
``make_optimizer`` selects under accumulation). A mid-accumulation
micro-batch leaves the parameters bitwise as they were. Then the SD train
step with EMA: the shadow blends on the update micro-batch only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agenda_tpu.core import schedules as jsched
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.models import AutoencoderKL as JaxVAE
from agenda_tpu.models import CLIPTextModel as JaxCLIP
from agenda_tpu.models import UNet2DConditionModel as JaxUNet
from agenda_tpu.train import finetune_sd as jtrain
from agenda_tpu.train import optim as joptim
from agenda_tpu_torch.core import schedules as tsched
from agenda_tpu_torch.io.configs import (
    clip_config_from_json,
    clip_config_to_json,
    unet_config_from_json,
    unet_config_to_json,
    vae_config_from_json,
    vae_config_to_json,
)
from agenda_tpu_torch.io.diffusers_io import params_from_jax
from agenda_tpu_torch.io.fabricate import fabricate_pipeline
from agenda_tpu_torch.models.clip_text import CLIPTextModel
from agenda_tpu_torch.models.unet import UNet2DConditionModel
from agenda_tpu_torch.models.vae import AutoencoderKL
from agenda_tpu_torch.train import finetune_sd as ttrain
from agenda_tpu_torch.train import optim as toptim

K = 2  # micro-batches an update
LR = 1e-3
# leaves of the same names and shapes in both packages (the int8 blocks are
# the same 256-element rows of the flat order): two quantized (>= 4096), one
# of them ragged, and two small f32 ones
SHAPES = {"a": (64, 80), "b": (33, 130), "c": (300,), "d": (7, 5)}


def _lr():
    return joptim.lr_schedule("linear", LR, 1, 10), toptim.lr_schedule("linear", LR, 1, 10)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    # gradients large enough that the global-norm clip (1.0) is active
    grads = [{k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(2 * K)]
    return params, grads


def _moments(state):
    """{part.name: f32 values, or (int8 codes, f32 row scales)} of a moment tree."""
    out = {}
    for part in ("mu", "nu"):
        for k, m in getattr(state, part).items():
            if isinstance(m, (toptim._Quantized, joptim._Quantized)):
                out[f"{part}.{k}"] = (np.asarray(m.q, np.int32), np.asarray(m.scale))
            else:
                out[f"{part}.{k}"] = np.asarray(m, np.float32)
    return out


@pytest.mark.parametrize("use_8bit_adam", [False, True])
def test_multi_steps_matches_optax_multisteps(use_8bit_adam):
    """f32 AdamW: params and moments within f32 rounding. int8: the first
    update quantizes moments from values an ulp apart (the clip's g / n *
    max against g * (max / n)), so a code may sit one step apart (at most 1%
    of the codes); the second update then moves such an element differently,
    by at most ~0.2 lr: at most 0.1% of the elements past 1e-6, none past
    0.25 lr."""
    lr_j, lr_t = _lr()
    params, grads = _inputs(1 + use_8bit_adam)
    tx_j = joptim.make_optimizer(lr_j, max_grad_norm=1.0, gradient_accumulation_steps=K,
                                 use_8bit_adam=use_8bit_adam)
    assert isinstance(tx_j, optax.MultiSteps)  # around the unfused chain
    tx_t = toptim.make_optimizer(lr_t, max_grad_norm=1.0, gradient_accumulation_steps=K,
                                 use_8bit_adam=use_8bit_adam)
    assert tx_t.fused == use_8bit_adam
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = tx_j.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = tx_t.init(pt)
    for i, g in enumerate(grads, start=1):
        before = {k: v.clone() for k, v in pt.items()}
        updates, sj = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, updates)
        _, st, gnorm = tx_t.apply({k: torch.from_numpy(v) for k, v in g.items()}, st, pt)
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(g)), rtol=1e-6)
        if i % K:  # mid-accumulation: nothing moves
            assert all(torch.equal(pt[k], before[k]) for k in pt)
            assert st.mini_step == i % K and int(st.count) == i // K
            continue
        assert st.mini_step == 0 and int(st.count) == int(sj.gradient_step) == i // K
        assert all(float(a.abs().max()) == 0.0 for a in st.acc.values())
        inner_j = joptim.extract_adam8bit_state(sj.inner_opt_state) if use_8bit_adam else \
            sj.inner_opt_state[1][0]
        diffs = np.concatenate([np.abs(pt[k].numpy() - np.asarray(pj[k])).reshape(-1)
                                for k in SHAPES])
        got_m, want_m = _moments(st.inner), _moments(inner_j)
        if not use_8bit_adam:
            assert diffs.max() <= 1e-6, diffs.max()
        else:
            assert float(np.mean(diffs > 1e-6)) <= 1e-3 and diffs.max() <= 0.25 * LR, \
                diffs.max()
        for k, want in want_m.items():
            got = got_m[k]
            if isinstance(want, tuple):  # codes one step apart at most, and rarely
                assert np.abs(got[0] - want[0]).max() <= 1, k
                assert float(np.mean(got[0] != want[0])) <= 0.01, k
                np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
            else:  # f32 rounding at the leaf's scale (the clip's ulp)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_checkpoint_mid_accumulation_resumes_exactly(tmp_path):
    """A checkpoint taken with a micro-batch pending keeps the running mean
    and the mini-step: the resumed optimizer ends bitwise where the
    uninterrupted one does."""
    from agenda_tpu_torch.io.configs import UNetConfig
    from agenda_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    _, lr_t = _lr()
    params, grads = _inputs(3)
    for use_8bit_adam in (False, True):
        tx = toptim.make_optimizer(lr_t, gradient_accumulation_steps=K,
                                   use_8bit_adam=use_8bit_adam)

        def fresh():
            p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
            return ttrain.TrainState(params=p, opt_state=tx.init(p), step=0, ema=None)

        def run(state, gs):
            for g in gs:
                tx.apply({k: torch.from_numpy(v) for k, v in g.items()}, state.opt_state,
                         state.params)
                state.step += 1
            return state

        straight = run(fresh(), grads[:3])
        assert straight.opt_state.mini_step == 1
        path = save_checkpoint(str(tmp_path / f"run{int(use_8bit_adam)}"), 1,
                               UNetConfig.tiny(), straight)
        run(straight, grads[3:])
        resumed = load_checkpoint(path, fresh())
        assert resumed.step == 3 and resumed.opt_state.mini_step == 1
        run(resumed, grads[3:])
        assert all(torch.equal(straight.params[k], resumed.params[k]) for k in params)
        assert int(resumed.opt_state.count) == 2 and resumed.opt_state.mini_step == 0


def test_make_optimizer_accumulates_instead_of_raising():
    _, lr_t = _lr()
    for use_8bit_adam in (False, True):
        tx = toptim.make_optimizer(lr_t, gradient_accumulation_steps=4,
                                   use_8bit_adam=use_8bit_adam)
        state = tx.init({"w": torch.zeros(3)})
        assert isinstance(state, toptim.MultiStepsState) and state.mini_step == 0
    assert not isinstance(toptim.make_optimizer(lr_t).init({"w": torch.zeros(3)}),
                          toptim.MultiStepsState)
    with pytest.raises(ValueError):
        toptim.make_optimizer(lr_t, gradient_accumulation_steps=0)


# -- the SD train step with EMA under accumulation ----------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_accum_pipe"))
    fabricate_pipeline(d, tiny=True, seed=5)
    bundle = jax_load_pipeline(d)
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    states = params_from_jax(tree(bundle.unet_params), tree(bundle.vae_params),
                             tree(bundle.text_params))
    return bundle, states


def _batch(bundle):
    rng = np.random.RandomState(6)
    h = bundle.unet_config.sample_size
    moments = np.concatenate([rng.standard_normal((2, h, h, 4)),
                              np.full((2, h, h, 4), -4.0)], -1).astype(np.float32)
    ids = rng.randint(0, bundle.text_config.vocab_size, (2, 77)).astype(np.int32)
    return moments, ids


@pytest.mark.parametrize("use_8bit_adam", [False, True])
def test_sd_step_blends_the_ema_on_updates_only(tiny, use_8bit_adam):
    """2 K micro-batches of the tiny SD step (k = 2, EMA on) against the JAX
    step with ``MultiSteps``, on the JAX key stream's draws: params and EMA
    shadow within the SD step's limits after each update; the EMA step and
    the optimizer count equal the updates; params and shadow bitwise still
    after each mid-accumulation micro-batch. With use_8bit_adam the port
    blends the shadow inside the fused kernel (K5), once an update."""
    bundle, states = tiny
    cfg = bundle.unet_config
    lr_j, lr_t = _lr()
    schedule = jsched.make_schedule()
    tx_j = joptim.make_optimizer(lr_j, gradient_accumulation_steps=K,
                                 use_8bit_adam=use_8bit_adam)
    state_j = jtrain.init_train_state(bundle.unet_params, tx_j, use_ema=True)
    step_j = jax.jit(jtrain.make_train_step(
        JaxUNet(cfg), JaxVAE(bundle.vae_config), JaxCLIP(bundle.text_config), schedule, tx_j,
        jtrain.LossConfig(snr_gamma=5.0), use_ema=True, gradient_accumulation_steps=K))

    unet = UNet2DConditionModel(unet_config_from_json(unet_config_to_json(cfg)))
    unet.load_state_dict({k: v.clone() for k, v in states[0].items()}, strict=True)
    vae = AutoencoderKL(vae_config_from_json(vae_config_to_json(bundle.vae_config)))
    vae.load_state_dict(states[1])
    text = CLIPTextModel(clip_config_from_json(clip_config_to_json(bundle.text_config)))
    text.load_state_dict(states[2])
    tx_t = toptim.make_optimizer(lr_t, gradient_accumulation_steps=K,
                                 use_8bit_adam=use_8bit_adam)
    state_t = ttrain.init_train_state(unet.train(), tx_t, use_ema=True)
    step_t = ttrain.make_train_step(unet, vae.requires_grad_(False), text.requires_grad_(False),
                                    tsched.make_schedule(), tx_t,
                                    ttrain.LossConfig(snr_gamma=5.0), use_ema=True)
    moments, ids = _batch(bundle)
    key = jax.random.key(3)
    shape = (2, cfg.sample_size, cfg.sample_size, 4)
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    for i in range(1, 2 * K + 1):
        k_vae, k_loss = jax.random.split(jax.random.fold_in(key, i - 1))
        k_noise, k_t, _, _ = jax.random.split(k_loss, 4)
        draws = ttrain.StepDraws(
            latent_eps=torch.from_numpy(np.array(jax.random.normal(k_vae, shape, jnp.float32))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
            timesteps=torch.from_numpy(np.asarray(jax.random.randint(
                k_t, (2,), 0, schedule.num_train_timesteps)).astype(np.int64)))
        state_j, _ = step_j(state_j, bundle.vae_params, bundle.text_params,
                            {"latent_moments": jnp.asarray(moments),
                             "input_ids": jnp.asarray(ids)}, key)
        before = {k: (p.detach().clone(), state_t.ema.params[k].clone())
                  for k, p in state_t.params.items()}
        state_t, _ = step_t(state_t, {"latent_moments": torch.from_numpy(moments),
                                      "input_ids": torch.from_numpy(ids.astype(np.int64))},
                            draws=draws)
        updates = i // K
        assert state_t.step == i and int(state_t.opt_state.count) == updates
        assert int(state_t.ema.step) == int(state_j.ema.step) == updates
        if i % K:
            assert all(torch.equal(p, before[k][0]) and torch.equal(state_t.ema.params[k],
                                                                      before[k][1])
                       for k, p in state_t.params.items())
            continue
        want = params_from_jax(tree(state_j.params))[0]
        want_ema = params_from_jax(tree(state_j.ema.params))[0]
        near = 1e-6 if updates == 1 else 0.25 * LR * (updates - 1) + 1e-6
        far = 2 * LR * (1 + 1e-3) + (0 if updates == 1 else near)
        for got, ref in ((state_t.params, want), (state_t.ema.params, want_ema)):
            diffs = np.concatenate([(got[k].detach() - ref[k]).abs().reshape(-1).numpy()
                                    for k in ref])
            assert float(np.mean(diffs > near)) <= 1e-3 and diffs.max() <= far, (
                i, float(np.mean(diffs > near)), diffs.max())
