"""The SD fine-tune of the PyTorch port (agenda_tpu_torch) against agenda_tpu, on the CPU.

The port writes a tiny seeded pipeline; the JAX package reads it and
``params_from_jax`` carries its trees into the port. The same numpy inputs,
and the JAX key stream's random draws, then go through both packages in f32:
the noise functions, EMA, latent sampling, the device resize, the loader's
epoch order, the train step (fused int8 AdamW + EMA, min-SNR), the optimizer
state converter, checkpoints and the CLI. Also the repair of the
cross-attention dispatch: the UNet without DAAM maps.
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agenda_tpu.core import ema as jema
from agenda_tpu.core import schedules as jsched
from agenda_tpu.data.datasets import DataLoader as JaxLoader
from agenda_tpu.data.device_resize import apply_resize as jax_apply_resize
from agenda_tpu.data.device_resize import resize_weights as jax_resize_weights
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.models import AutoencoderKL as JaxVAE
from agenda_tpu.models import CLIPTextModel as JaxCLIP
from agenda_tpu.models import UNet2DConditionModel as JaxUNet
from agenda_tpu.models.vae import sample_latents as jax_sample_latents
from agenda_tpu.train import finetune_sd as jtrain
from agenda_tpu.train import optim as joptim
from agenda_tpu_torch.core import ema as tema
from agenda_tpu_torch.core import schedules as tsched
from agenda_tpu_torch.data.datasets import DataLoader
from agenda_tpu_torch.data.device_resize import apply_resize, resize_weights
from agenda_tpu_torch.io.configs import (
    clip_config_from_json,
    clip_config_to_json,
    unet_config_from_json,
    unet_config_to_json,
    vae_config_from_json,
    vae_config_to_json,
)
from agenda_tpu_torch.io.diffusers_io import opt_state_from_jax, params_from_jax
from agenda_tpu_torch.io.fabricate import fabricate_pipeline
from agenda_tpu_torch.models.clip_text import CLIPTextModel
from agenda_tpu_torch.models.unet import UNet2DConditionModel
from agenda_tpu_torch.models.vae import AutoencoderKL, sample_latents
from agenda_tpu_torch.train import finetune_sd as ttrain
from agenda_tpu_torch.train import optim as toptim
from agenda_tpu_torch.utils.png import write_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4  # f32 on both sides through the tiny models; only the summation order differs
LR = 1e-3
# One int8 log-code step: a factor of 10^(SPAN / 126) between neighbouring codes.
CODE_STEP = 10.0 ** (7.0 / 126.0)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: extra intra-op threads only contend with the
    other test workers' (8 threads each made a step up to 10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_train_pipe"))
    fabricate_pipeline(d, tiny=True, seed=5)
    bundle = jax_load_pipeline(d)
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    states = params_from_jax(tree(bundle.unet_params), tree(bundle.vae_params),
                             tree(bundle.text_params))
    return d, bundle, states


def _port_models(bundle, states):
    def strict(cls, cfg, state):
        m = cls(cfg)
        m.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
        return m

    unet = strict(UNet2DConditionModel, unet_config_from_json(unet_config_to_json(
        bundle.unet_config)), states[0]).train()
    vae = strict(AutoencoderKL, vae_config_from_json(vae_config_to_json(bundle.vae_config)),
                 states[1]).eval().requires_grad_(False)
    text = strict(CLIPTextModel, clip_config_from_json(clip_config_to_json(bundle.text_config)),
                  states[2]).eval().requires_grad_(False)
    return unet, vae, text


# -- the repaired dispatch: cross-attention without DAAM maps -------------------


def test_unet_without_maps_matches_jax(tiny):
    """collect_attn=False sends cross-attention (77 context rows) to the plain
    attention, as the JAX dispatch does; the flash path raised here before."""
    _, bundle, states = tiny
    unet, _, _ = _port_models(bundle, states)
    cfg = bundle.unet_config
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, cfg.sample_size, cfg.sample_size, 4)).astype(np.float32)
    t = np.array([3, 650])
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    eps_j, _ = JaxUNet(cfg).apply(bundle.unet_params, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx))
    with torch.no_grad():
        eps, maps = unet.eval()(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                                collect_attn=False)
    assert maps is None
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_j), atol=TOL, rtol=TOL)


def test_gradient_checkpointing_gives_the_same_gradients(tiny):
    _, bundle, states = tiny
    cfg = bundle.unet_config
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, cfg.sample_size, cfg.sample_size, 4, generator=g)
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, generator=g)
    grads = []
    for remat in (False, True):
        unet, _, _ = _port_models(bundle, states)
        unet.gradient_checkpointing = remat
        eps, _ = unet(x, torch.tensor([5, 900]), ctx)
        eps.square().mean().backward()
        grads.append({k: p.grad for k, p in unet.named_parameters()})
    for k, want in grads[0].items():
        torch.testing.assert_close(grads[1][k], want, rtol=1e-5, atol=1e-7)


def test_generation_cli_without_word_heatmaps(tiny, tmp_path):
    from agenda_tpu_torch.cli import data_generation
    from agenda_tpu_torch.io.fabricate import write_learned_embeds

    d, bundle, _ = tiny
    embeds = str(tmp_path / "e.bin")
    write_learned_embeds(embeds, bundle.text_config.hidden_size)
    stats = data_generation.main(["--device", "cpu", "--pretrained-model-path", d,
                                  "--learnable-tokens-embedding-path", embeds,
                                  "--save-dir", str(tmp_path / "out"), "--num-images", "2",
                                  "--batch-size", "2", "--num-inference-steps", "2",
                                  "--resolution", "32"])
    assert stats["images"] == 2
    assert os.listdir(tmp_path / "out") == ["images"]


# -- the pieces -----------------------------------------------------------------


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_noise_and_snr_functions_match_jax(pred):
    js = jsched.make_schedule(prediction_type=pred)
    ts = tsched.make_schedule(prediction_type=pred)
    rng = np.random.RandomState(2)
    x0, eps = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    t = np.array([0, 417, 999])
    pairs = [
        (jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t)),
         tsched.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(t))),
        (jsched.get_velocity(js, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t)),
         tsched.get_velocity(ts, torch.from_numpy(x0), torch.from_numpy(eps),
                             torch.from_numpy(t))),
        (jsched.compute_snr(js, jnp.asarray(t)), tsched.compute_snr(ts, torch.from_numpy(t))),
        (jsched.min_snr_weights(js, jnp.asarray(t), 5.0),
         tsched.min_snr_weights(ts, torch.from_numpy(t), 5.0)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_ema_matches_jax():
    rng = np.random.RandomState(3)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    js = jema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tema.ema_init(tp)
    assert all(ts.params[k].data_ptr() != tp[k].data_ptr() for k in tp)  # a copy
    for i in range(3):
        new = {k: v + i + 1.0 for k, v in params.items()}
        js = jema.ema_update(js, {k: jnp.asarray(v) for k, v in new.items()}, 0.9)
        tema.ema_update(ts, {k: torch.from_numpy(v) for k, v in new.items()}, 0.9)
        np.testing.assert_allclose(float(tema.ema_decay_at(ts.step, 0.9)),
                                   float(jema.ema_decay_at(js.step, 0.9)), rtol=1e-7)
    assert int(ts.step) == int(js.step) == 3
    for k in params:
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), rtol=1e-6)


def test_sample_latents_matches_jax():
    rng = np.random.RandomState(4)
    mean, logvar = rng.standard_normal((2, 2, 4, 4, 4)).astype(np.float32)
    key = jax.random.key(11)
    want = jax_sample_latents(jnp.asarray(mean), jnp.asarray(logvar), key)
    eps = np.array(jax.random.normal(key, mean.shape, jnp.float32))  # the JAX draw
    got = sample_latents(torch.from_numpy(mean), torch.from_numpy(logvar), torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    own = sample_latents(torch.from_numpy(mean), torch.from_numpy(logvar),
                         generator=torch.Generator().manual_seed(0))
    assert own.shape == mean.shape and bool(torch.isfinite(own).all())


def test_vae_encode_clamps_logvar():
    from agenda_tpu_torch.io.configs import VAEConfig

    vae = AutoencoderKL(VAEConfig.tiny())
    with torch.no_grad():
        vae.quant_conv.bias[4:] = 100.0  # the logvar half
        _, logvar = vae.encode(torch.zeros(1, 16, 16, 3))
    assert float(logvar.max()) == 20.0


@pytest.mark.parametrize("src,dst", [(112, 512), (16, 32), (40, 24)])
def test_device_resize_matches_jax(src, dst):
    np.testing.assert_array_equal(resize_weights(src, dst), jax_resize_weights(src, dst))
    rng = np.random.RandomState(src + dst)
    u8 = rng.randint(0, 256, (2, src, src + 3, 3)).astype(np.uint8)
    wy, wx = resize_weights(src, dst), resize_weights(src + 3, dst)
    want = np.asarray(jax_apply_resize(jnp.asarray(u8), wy, wx))
    got = apply_resize(torch.from_numpy(u8), wy, wx).numpy()
    # both round each pass to uint8 levels; the two einsums may round a value
    # sitting on a .5 boundary apart: one level (2/255 in [-1, 1])
    assert np.abs(got - want).max() <= 2.0 / 255 + 1e-6
    assert np.mean(np.abs(got - want) > 1e-6) < 1e-3


def test_loader_epoch_order_matches_jax():
    class Rows:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"i": np.array(i)}

    for pad in (False, True):
        ours = DataLoader(Rows(), 4, seed=3, num_workers=1, pad_to_full=pad)
        theirs = JaxLoader(Rows(), 4, seed=3, num_workers=1, pad_to_full=pad)
        for epoch in range(3):
            for a, b in zip(ours.batches_for_epoch(epoch), theirs.batches_for_epoch(epoch)):
                np.testing.assert_array_equal(a, b)
        assert [b["i"].tolist() for b in ours] == [b["i"].tolist() for b in theirs]


# -- the train step ---------------------------------------------------------------


def _jax_draws(rng, step, shape, num_train_timesteps):
    """The draws of the JAX step (finetune_sd.py:81-87, 155-157), as numpy."""
    k_vae, k_loss = jax.random.split(jax.random.fold_in(rng, step))
    k_noise, k_t, _, _ = jax.random.split(k_loss, 4)
    return ttrain.StepDraws(
        latent_eps=torch.from_numpy(np.array(jax.random.normal(k_vae, shape, jnp.float32))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        timesteps=torch.from_numpy(np.asarray(
            jax.random.randint(k_t, (shape[0],), 0, num_train_timesteps)).astype(np.int64)))


TRAIN_STEPS = 3
LOSS_CFG = dict(snr_gamma=5.0)


def _train_batch(bundle):
    """A pixel batch (the VAE encodes in the step) as numpy."""
    rng = np.random.RandomState(6)
    s = bundle.unet_config.sample_size * 2  # the tiny VAE downsamples by 2
    pixels = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    ids = rng.randint(0, bundle.text_config.vocab_size, (2, 77)).astype(np.int32)
    return pixels, ids


def _port_view(state_j):
    """The JAX params and EMA shadow in the port's names and layouts."""
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    return params_from_jax(tree(state_j.params))[0], params_from_jax(tree(state_j.ema.params))[0]


@pytest.fixture(scope="module")
def jax_run(tiny):
    return _jax_run(tiny)


def _jax_run(tiny):
    """TRAIN_STEPS steps of the tiny fine-tune in the JAX package: fused int8
    AdamW + EMA, snr_gamma 5. Per step: (params, EMA shadow) in the port's
    layout, the metrics, and the port's draws for that step (the JAX key
    stream's)."""
    _, bundle, _ = tiny
    cfg = bundle.unet_config
    schedule = jsched.make_schedule()
    tx = joptim.make_optimizer(joptim.lr_schedule("constant", LR, 0, 100), use_8bit_adam=True,
                               fused=True)
    state = jtrain.init_train_state(bundle.unet_params, tx, use_ema=True)
    step = jax.jit(jtrain.make_train_step(
        JaxUNet(cfg), JaxVAE(bundle.vae_config), JaxCLIP(bundle.text_config), schedule, tx,
        jtrain.LossConfig(**LOSS_CFG), use_ema=True))
    pixels, ids = _train_batch(bundle)
    batch = {"pixel_values": jnp.asarray(pixels), "input_ids": jnp.asarray(ids)}
    key = jax.random.key(7)
    lat_shape = (2, cfg.sample_size, cfg.sample_size, 4)
    out = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, bundle.vae_params, bundle.text_params, batch, key)
        out.append((*_port_view(state), {k: float(v) for k, v in metrics.items()},
                    _jax_draws(key, i, lat_shape, schedule.num_train_timesteps)))
    return out


def _port_run(tiny, draws, fault=None):
    """The same steps in the port, on the JAX run's draws. ``fault`` plants a
    bug in the trainer, to show that the comparison catches it:
    "skip_update" drops step 2's update, "flip_sign" applies it reversed,
    and "keep_grads" leaves the gradients to accumulate (no ``p.grad = None``)."""
    _, bundle, states = tiny
    unet, vae, text = _port_models(bundle, states)
    tx = toptim.make_optimizer(toptim.lr_schedule("constant", LR, 0, 100), use_8bit_adam=True)
    calls = []

    def apply(grads, opt_state, params, **kw):
        calls.append({k: g.clone() for k, g in grads.items()})
        if fault == "skip_update" and len(calls) == 2:
            opt_state.count.add_(1)
            return params, opt_state, toptim.global_norm(grads), kw.get("ema")
        before = {k: p.detach().clone() for k, p in params.items()}
        out = tx.apply(grads, opt_state, params, **kw)
        if fault == "flip_sign" and len(calls) == 2:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(2 * before[k] - p)
        return out

    tx_t = tx._replace(apply=apply)
    state = ttrain.init_train_state(unet, tx_t, use_ema=True)
    step = ttrain.make_train_step(unet, vae, text, tsched.make_schedule(), tx_t,
                                  ttrain.LossConfig(**LOSS_CFG), use_ema=True)
    pixels, ids = _train_batch(bundle)
    batch = {"pixel_values": torch.from_numpy(pixels),
             "input_ids": torch.from_numpy(ids.astype(np.int64))}
    out = []
    for d in draws:
        if fault == "keep_grads" and calls:
            for k, p in state.params.items():
                p.grad = calls[-1][k].clone()
        state, metrics = step(state, batch, draws=d)
        # the port updates in place: keep a copy of this step's params and shadow
        out.append(({k: p.detach().clone() for k, p in state.params.items()},
                    {k: e.clone() for k, e in state.ema.params.items()},
                    {k: float(v) for k, v in metrics.items()}))
    return out, state


def _flat_diffs(got, want):
    return np.concatenate([(got[k] - want[k]).abs().reshape(-1).numpy() for k in want])


def _step_faults(jax_steps, port_steps):
    """Where the port leaves the JAX run, as a list of (step, what, value, limit).

    Step 1: the moments start at zero codes, so the update uses unquantized
    m and v (optim.py:94-100) in both, and the parameters agree to f32
    rounding. An element whose gradient is within f32 noise of zero may take
    the other sign of the Adam step (u = g / (|g| + eps) at step 1): at most
    0.1% of the elements may differ, by no more than that sign flip, 2 lr.

    Steps i = 2, 3: after step 1 each package quantizes the moments in its
    own layout (flax HWIO / (in, out) against torch OIHW / (out, in)), so the
    dequantized m and v of a transposed leaf differ by up to one code step, a
    factor of 10^(7/126) = 1.137. The Adam step m/sqrt(v) (about lr in size)
    then differs by up to ~0.2 lr on such elements, and by much less on most:
    at most 0.1% of the elements (params and shadow alike) may exceed
    0.25 lr (i - 1), and none the step-1 sign flip plus that, 2 lr +
    0.25 lr (i - 1). A skipped, reversed or accumulated update moves most
    elements by about lr and fails the first limit.
    """
    faults = []
    for i, ((want, want_ema, m_j, _), (got, got_ema, m_t)) in enumerate(
            zip(jax_steps, port_steps), start=1):
        if i == 1:
            loss_rtol, near, far = TOL, 1e-6, 2 * LR * (1 + 1e-3)
            for key in ("loss", "grad_norm"):
                if abs(m_t[key] - m_j[key]) > TOL * abs(m_j[key]):
                    faults.append((i, key, m_t[key], m_j[key]))
        else:
            loss_rtol, near = 1e-2, 0.25 * LR * (i - 1) + 1e-6
            far = 2 * LR + near
        if abs(m_t["loss"] - m_j["loss"]) > loss_rtol * abs(m_j["loss"]):
            faults.append((i, "loss", m_t["loss"], m_j["loss"]))
        for what, diffs in (("params", _flat_diffs(got, want)),
                            ("ema", _flat_diffs(got_ema, want_ema))):
            share = float(np.mean(diffs > near))
            if share > 1e-3:
                faults.append((i, f"{what} share above {near:.3g}", share, 1e-3))
            if diffs.max() > far:
                faults.append((i, f"{what} max", float(diffs.max()), far))
    return faults


def test_train_step_matches_jax(tiny, jax_run):
    """Three steps of the tiny fine-tune against the JAX package, within the
    limits that `_step_faults` derives."""
    runs, state_t = _port_run(tiny, [r[3] for r in jax_run])
    assert _step_faults(jax_run, runs) == []
    assert state_t.step == 3 and int(state_t.ema.step) == 3 and int(state_t.opt_state.count) == 3


@pytest.mark.parametrize("fault", ["skip_update", "flip_sign", "keep_grads"])
def test_train_step_check_catches_a_planted_fault(tiny, jax_run, fault):
    runs, _ = _port_run(tiny, [r[3] for r in jax_run], fault)
    faults = _step_faults(jax_run, runs)
    assert faults and all(f[0] >= 2 for f in faults), faults


def test_opt_state_from_jax_keeps_every_moment_within_one_code(tiny):
    """A JAX int8-AdamW state of the tiny UNet carried into the port's layout.
    Leaves of 64 or more elements are quantized here, so that the tiny UNet's
    1-D leaves (biases, norms) show the bit-for-bit path too."""
    _, bundle, _ = tiny
    rng = np.random.RandomState(8)

    def moment(p):
        m = (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-4, 0, p.shape)).astype(np.float32)
        return joptim._quantize(jnp.asarray(m)) if p.size >= 64 else jnp.asarray(m)

    params = bundle.unet_params["params"]
    state = joptim.ScaleByAdam8bitState(count=jnp.asarray(2, jnp.int32),
                                        mu=jax.tree.map(moment, params),
                                        nu=jax.tree.map(moment, params))
    ours = opt_state_from_jax(jax.tree.map(np.asarray, state))
    names = set(params_from_jax(jax.tree.map(np.asarray, bundle.unet_params))[0])
    assert set(ours.mu) == set(ours.nu) == names and int(ours.count) == 2
    n_q = n_same = 0
    for name, moment in ours.mu.items():
        if not isinstance(moment, toptim._Quantized):
            continue
        n_q += 1
        values = toptim.dequantize(moment).numpy()
        ref = _jax_moment_in_port_layout(state.mu, name)
        # code 0 stands for anything below a block's absmax * 10^-7; the port's
        # blocks are other rows of the leaf, so a value near that floor may
        # fall under it on one side only
        floor = np.abs(ref).max() * 10.0 ** -7 * CODE_STEP
        to_zero = (values == 0) & (np.abs(ref) <= floor)
        ratio = np.abs(values) / np.maximum(np.abs(ref), 1e-30)
        assert np.all(to_zero | ((ratio <= CODE_STEP * 1.0001) & (ratio >= 1 / CODE_STEP / 1.0001)
                                 & (np.sign(values) == np.sign(ref)))), name
        if moment.q.dim() == 1:
            n_same += 1
            jq = _jax_leaf(state.mu, name)
            np.testing.assert_array_equal(moment.q.numpy(), np.asarray(jq.q))
    assert n_q > 10 and n_same > 0


def _jax_leaf(tree, name):
    """The leaf of a flax-shaped tree behind the port's parameter name."""
    parts = name.split(".")
    node = tree
    path = []
    i = 0
    while i < len(parts) - 1:
        if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
            path.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    for p in path:
        node = node[p]
    return node["bias" if parts[-1] == "bias" else ("kernel" if "kernel" in node else "scale")]


def _jax_moment_in_port_layout(tree, name):
    z = _jax_leaf(tree, name)
    values = np.asarray(joptim._dequantize(z))
    if values.ndim == 4:
        return values.transpose(3, 2, 0, 1)
    if values.ndim == 2:
        return values.T
    return values


# -- checkpoints and the CLI ----------------------------------------------------


def _port_trainer(tiny):
    _, bundle, states = tiny
    unet, vae, text = _port_models(bundle, states)
    tx = toptim.make_optimizer(toptim.lr_schedule("constant", LR, 0, 100), use_8bit_adam=True)
    state = ttrain.init_train_state(unet, tx, use_ema=True)
    step = ttrain.make_train_step(unet, vae, text, tsched.make_schedule(), tx,
                                  ttrain.LossConfig(snr_gamma=5.0), use_ema=True)
    cfg = bundle.unet_config
    g = torch.Generator().manual_seed(0)
    batch = {"latent_moments": torch.randn(2, cfg.sample_size, cfg.sample_size, 8, generator=g),
             "input_ids": torch.randint(0, bundle.text_config.vocab_size, (2, 77), generator=g)}
    return bundle, state, step, batch


def _run(state, step, batch, steps):
    for i in steps:
        step(state, batch, generator=torch.Generator().manual_seed(100 + i))
    return state


def test_checkpoint_resume_equals_an_uninterrupted_run(tiny, tmp_path):
    from agenda_tpu_torch.train.checkpoint import (
        find_resume_checkpoint,
        list_checkpoints,
        load_checkpoint,
        save_checkpoint,
    )

    bundle, state, step, batch = _port_trainer(tiny)
    _run(state, step, batch, range(2))
    out = str(tmp_path / "run")
    save_checkpoint(out, 2, bundle.unet_config, state)
    straight = _run(state, step, batch, range(2, 4))

    _, fresh, step2, _ = _port_trainer(tiny)
    found = find_resume_checkpoint(out, "latest")
    assert found[0] == 2 and list_checkpoints(out)[0][0] == 2
    resumed = load_checkpoint(found[1], fresh)
    assert resumed.step == 2 and int(resumed.ema.step) == 2
    _run(resumed, step2, batch, range(2, 4))
    for k, p in straight.params.items():
        assert torch.equal(p, resumed.params[k]), k
        assert torch.equal(straight.ema.params[k], resumed.ema.params[k]), k
    for part in ("mu", "nu"):
        for k, m in getattr(straight.opt_state, part).items():
            r = getattr(resumed.opt_state, part)[k]
            if isinstance(m, toptim._Quantized):
                assert torch.equal(m.q, r.q) and torch.equal(m.scale, r.scale), k
            else:
                assert torch.equal(m, r), k


def test_checkpoint_rotation_and_atomic_directory(tiny, tmp_path):
    from agenda_tpu_torch.train.checkpoint import (
        AsyncCheckpointer,
        atomic_checkpoint_dir,
        list_checkpoints,
    )

    bundle, state, _, _ = _port_trainer(tiny)
    out = str(tmp_path / "run")
    with AsyncCheckpointer() as writer:
        for s in (1, 2, 3):
            writer.save(out, s, bundle.unet_config, state, total_limit=2)
    assert [c[0] for c in list_checkpoints(out)] == [2, 3]
    os.makedirs(os.path.join(out, ".tmp-checkpoint-9"))  # an orphan of a crashed write

    def crash(path):
        with open(os.path.join(path, "partial"), "w") as f:
            f.write("x")
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        atomic_checkpoint_dir(out, 4, None, crash)
    assert [c[0] for c in list_checkpoints(out)] == [2, 3]  # no partial checkpoint-4
    assert not os.path.exists(os.path.join(out, ".tmp-checkpoint-9"))
    ckpt = os.path.join(out, "checkpoint-3")
    assert sorted(os.listdir(ckpt)) == ["train_state", "unet", "unet_ema"]
    with open(os.path.join(ckpt, "train_state", "state.json")) as f:
        assert json.load(f) == {"step": 0, "ema_step": 0, "optimizer": "adam8bit"}


def _write_tiles(d, n):
    os.makedirs(d)
    rng = np.random.RandomState(9)
    prompts = {}
    for i in range(n):
        write_png(os.path.join(d, f"{i}.png"), rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
        prompts[f"{i}.png"] = "an aerial view image with cars in utah"
    with open(os.path.join(d, "train.json"), "w") as f:
        json.dump(prompts, f)


def test_cli_trains_checkpoints_and_exports_on_the_cpu(tiny, tmp_path):
    from agenda_tpu_torch.cli import finetune_sd

    d, bundle, _ = tiny
    data, out = str(tmp_path / "tiles"), str(tmp_path / "out")
    _write_tiles(data, 4)
    stats = finetune_sd.main(["--pretrained_model_name_or_path", d, "--dataset_folder", data,
                              "--json_file_name", "train.json", "--output_dir", out,
                              "--resolution", "32", "--train_batch_size", "2",
                              "--max_train_steps", "3", "--use_8bit_adam", "--use_ema",
                              "--snr_gamma", "5", "--checkpointing_steps", "2", "--seed", "0",
                              "--report_to", "jsonl", "--device", "cpu",
                              "--validation_prompts", "cars", "--validation_steps", "3"])
    assert stats["steps"] == 3 and all(np.isfinite(stats["losses"]))
    assert sorted(os.listdir(os.path.join(out, "checkpoint-2"))) == ["train_state", "unet",
                                                                     "unet_ema"]
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    # validation at step 3 samples 4 images from the EMA shadow through the port's pipeline
    assert len(os.listdir(os.path.join(out, "logs", "images"))) == 4
    exported = jax_load_pipeline(out)  # the JAX package reads the export
    assert exported.unet_config == bundle.unet_config
    before = jax.tree.leaves(bundle.unet_params)
    after = jax.tree.leaves(exported.unet_params)
    assert any(not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(before, after))
    # --fsdp 2 needs a world of two ranks (make_mesh's rule, as the JAX mesh's)
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        finetune_sd.main(["--pretrained_model_name_or_path", d, "--dataset_folder", data,
                          "--json_file_name", "train.json", "--fsdp", "2", "--device", "cpu"])


def _parser_flags(parse_args, required):
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def fake(self, args=None, namespace=None):
        captured["parser"] = self
        return orig(self, required, namespace)

    argparse.ArgumentParser.parse_args = fake
    try:
        parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {s: a for s, a in captured["parser"]._option_string_actions.items()
            if s.startswith("--")}


def test_finetune_cli_flags_match_the_jax_cli_plus_device():
    from agenda_tpu.cli.finetune_sd import parse_args as jax_parse
    from agenda_tpu_torch.cli.finetune_sd import parse_args as port_parse

    required = ["--pretrained_model_name_or_path", "p", "--dataset_folder", "d",
                "--json_file_name", "j.json"]
    theirs, ours = _parser_flags(jax_parse, required), _parser_flags(port_parse, required)
    assert set(ours) - set(theirs) == {"--device", "--dist-backend"}
    for flag in theirs:
        assert ours[flag].default == theirs[flag].default, flag
        assert ours[flag].nargs == theirs[flag].nargs, flag
        assert ours[flag].dest == theirs[flag].dest, flag
    assert ours["--device"].default == "cuda"
    assert vars(jax_parse(required)) == {k: v for k, v in vars(port_parse(required)).items()
                                         if k not in ("device", "dist_backend")}
    with pytest.raises(ValueError):
        port_parse(["--pretrained_model_name_or_path", "p"])


def test_loss_config_and_draws_match_the_jax_fields():
    assert [f.name for f in dataclasses.fields(ttrain.LossConfig)] == [
        f.name for f in dataclasses.fields(jtrain.LossConfig)]
    draws = ttrain.make_draws(torch.Generator().manual_seed(0), (2, 4, 4, 4), 1000,
                              ttrain.LossConfig(noise_offset=0.1, input_perturbation=0.1),
                              torch.device("cpu"))
    assert draws.offset_noise.shape == (2, 1, 1, 4) and draws.perturbation.shape == (2, 4, 4, 4)
    assert int(draws.timesteps.max()) < 1000
