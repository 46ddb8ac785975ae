"""The token fine-tune of the PyTorch port (agenda_tpu_torch) against agenda_tpu, on the CPU.

The same seeded numpy inputs go through both packages in f32: the token
splice, the cross-attention regularization loss (values and gradients),
the parameter split, CLIP with ``inputs_embeds``, ``TokenDataset``'s items,
and three steps of the token trainer with the JAX key stream's draws and
JAX's initial embedding, in stage 1 (tokens + UNet, the UNet-only clip) and
stage 2 (UNet only, no clip). Then the CLI end to end on the tiny fixture:
stage 1, stage 2 from its export, and a resumed run against an
uninterrupted one.
"""

import argparse
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agenda_tpu.core import schedules as jsched
from agenda_tpu.data.datasets import TokenDataset as JaxTokenDataset
from agenda_tpu.data.device_resize import apply_resize as jax_apply_resize
from agenda_tpu.data.device_resize import resize_weights as jax_resize_weights
from agenda_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.models import AutoencoderKL as JaxVAE
from agenda_tpu.models import CLIPTextModel as JaxCLIP
from agenda_tpu.models import UNet2DConditionModel as JaxUNet
from agenda_tpu.train import finetune_sd_token as jtok
from agenda_tpu.train import optim as joptim
from agenda_tpu_torch.core import schedules as tsched
from agenda_tpu_torch.data.datasets import TokenDataset
from agenda_tpu_torch.data.device_resize import apply_resize, resize_weights
from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
from agenda_tpu_torch.io.configs import (
    clip_config_from_json,
    clip_config_to_json,
    unet_config_from_json,
    unet_config_to_json,
    vae_config_from_json,
    vae_config_to_json,
)
from agenda_tpu_torch.io.diffusers_io import load_pipeline, params_from_jax
from agenda_tpu_torch.io.fabricate import fabricate_pipeline
from agenda_tpu_torch.io.learned_embeds import load_learned_embeddings
from agenda_tpu_torch.io.safetensors_io import load_file
from agenda_tpu_torch.models.clip_text import CLIPTextModel
from agenda_tpu_torch.models.unet import UNet2DConditionModel
from agenda_tpu_torch.models.vae import AutoencoderKL
from agenda_tpu_torch.train import finetune_sd as ttrain
from agenda_tpu_torch.train import finetune_sd_token as ttok
from agenda_tpu_torch.train import optim as toptim
from agenda_tpu_torch.utils.png import write_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# After step 1 the two packages' parameters differ where Adam's first step
# g / (|g| + eps) meets a gradient within f32 noise of zero (0.03% of the
# elements, by up to 0.26 lr), and that moves the later steps' metrics in
# proportion to lr: at 1e-4 the worst is 3.9e-6 relative over three steps,
# at 1e-3 bg_loss reads 1.4e-5 at step 2.
LR = 1e-4
METRIC_RTOL = 1e-5  # loss, mse, attn_loss, fg_loss, bg_loss: f32 on both sides
WORDS = ["cars", "Utah", "New Zealand"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: extra intra-op threads only contend with the other test
    workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_token_pipe"))
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


# -- the pieces -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2])
def test_splice_matches_jax(n):
    rng = np.random.RandomState(n)
    base = rng.standard_normal((3, 12, 4)).astype(np.float32)
    emb = rng.standard_normal((2, 4)).astype(np.float32)
    starts = np.array([[2, 7], [-1, 5], [0, -1]], np.int32)  # 0 is not spliced (> 0 guard)
    want = jtok.splice_token_embeddings(jnp.asarray(base), jnp.asarray(starts),
                                        jnp.asarray(emb), n)
    got = ttok.splice_token_embeddings(torch.from_numpy(base), torch.from_numpy(starts),
                                       torch.from_numpy(emb), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.all(got.numpy()[0, 7:7 + n] == emb[1]) and np.all(got.numpy()[2] == base[2])


@pytest.mark.parametrize("starts", [
    [[3, 6, -1], [2, -1, 9], [-1, 4, 5]],  # one sample without the object: not counted
    [[-1, 6, -1], [0, -1, 9], [-1, -1, -1]],  # no valid sample: every loss is 0
])
def test_attn_reg_loss_and_its_gradient_match_jax(starts):
    """Values and the gradient with respect to the maps, f32 both sides."""
    rng = np.random.RandomState(len(starts))
    maps = [rng.uniform(0, 1, (3, 12, h, h)).astype(np.float32) for h in (8, 4, 4)]
    starts = np.asarray(starts, np.int32)

    def jax_total(ms):
        return jtok.attn_reg_loss(ms, jnp.asarray(starts), 1, 0.5)

    want = jax_total([jnp.asarray(m) for m in maps])
    want_grads = jax.grad(lambda ms: jax_total(ms)[0])([jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    got = ttok.attn_reg_loss(tmaps, torch.from_numpy(starts), 1, 0.5)
    got[0].backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-6, atol=1e-9)
    for m, w in zip(tmaps, want_grads):
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)
    if (starts[:, 0] <= 0).all():
        assert float(got[0].detach()) == 0.0


@pytest.mark.parametrize("mode", ["train_unet", "train_cross_attn", "token_only"])
def test_split_unet_params_matches_jax(tiny, mode):
    _, bundle, states = tiny
    unet, _, _ = _port_models(bundle, states)
    flags = (mode == "train_unet", mode == "train_cross_attn")
    trainable_j, frozen_j = jtok.split_unet_params(bundle.unet_params, *flags)
    trainable, frozen = ttok.split_unet_params(unet, *flags)
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    names = lambda t: set(params_from_jax(tree(t))[0]) if t else set()  # noqa: E731
    assert set(trainable) == names(trainable_j) and set(frozen) == names(frozen_j)
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    if mode == "train_cross_attn":
        assert trainable and all(".attn2." in k for k in trainable)
    assert set(ttok.merge_params(trainable, frozen)) == set(dict(unet.named_parameters()))


def test_clip_inputs_embeds_matches_jax_and_takes_a_gradient(tiny):
    """Pre-position embeds through CLIP: the JAX output within 1e-5, and the
    gradient reaches inputs_embeds while every CLIP weight stays frozen."""
    _, bundle, states = tiny
    _, _, text = _port_models(bundle, states)
    cfg = bundle.text_config
    rng = np.random.RandomState(3)
    ids = rng.randint(0, cfg.vocab_size, (2, 77)).astype(np.int32)
    embeds = (rng.standard_normal((2, 77, cfg.hidden_size)) * 0.02).astype(np.float32)
    hidden_j, pooled_j = JaxCLIP(cfg).apply(bundle.text_params, jnp.asarray(ids),
                                            inputs_embeds=jnp.asarray(embeds))
    x = torch.from_numpy(embeds).requires_grad_()
    hidden, pooled = text(torch.from_numpy(ids.astype(np.int64)), inputs_embeds=x)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(hidden_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(pooled_j), atol=1e-5,
                               rtol=1e-5)
    hidden.square().sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    assert all(p.grad is None for p in text.parameters())


def _write_tiles(d, sizes):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(9)
    prompts = ["An aerial view image with cars in Utah",
               "An aerial view image with cars in New Zealand",
               "An aerial view image of a road in Utah"]
    out = {}
    for i, (h, w) in enumerate(sizes):
        write_png(os.path.join(d, f"{i}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        out[f"{i}.png"] = prompts[i % len(prompts)]
    with open(os.path.join(d, "train.json"), "w") as f:
        json.dump(out, f)


@pytest.mark.parametrize("uniform", [True, False])
def test_token_dataset_items_match_jax(tiny, tmp_path, uniform):
    """ids and starts equal; pixels within one uint8 level (1/255 of the
    range, 2/255 in [-1, 1]): uniform tiles travel as uint8 and are resized
    bilinear on the device (against the JAX package's device resize, which
    its trainer runs on them), mixed sizes bilinear on the host (against
    Pillow's, which the JAX dataset calls)."""
    d, _, _ = tiny
    data = str(tmp_path / "tiles")
    _write_tiles(data, [(16, 20)] * 3 if uniform else [(16, 20), (20, 16), (24, 24)])
    new = [f"new_token_v{i}" for i in range(3)]
    tok_j = JaxTokenizer.from_pretrained(os.path.join(d, "tokenizer"))
    tok_t = CLIPTokenizer.from_pretrained(os.path.join(d, "tokenizer"))
    tok_j.add_tokens(new)
    tok_t.add_tokens(new)
    ours = TokenDataset(data, "train.json", 32, tok_t, word_tokens=WORDS, new_tokens=new)
    theirs = JaxTokenDataset(data, "train.json", 32, tok_j, word_tokens=WORDS, new_tokens=new,
                             device_resize=True)
    assert (ours.source_size is None) == (theirs.source_size is None) == (not uniform)
    for i in range(3):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["new_tokens_start"], b["new_tokens_start"])
        assert a["new_tokens_start"].dtype == np.int32 and a["new_tokens_start"].shape == (3,)
        if uniform:
            np.testing.assert_array_equal(a["pixel_u8"], b["pixel_u8"])
            h, w = a["pixel_u8"].shape[:2]
            wy, wx = resize_weights(h, 32, "bilinear"), resize_weights(w, 32, "bilinear")
            np.testing.assert_array_equal(wy, jax_resize_weights(h, 32, "bilinear"))
            got = apply_resize(torch.from_numpy(a["pixel_u8"])[None], wy, wx)[0].numpy()
            want = np.asarray(jax_apply_resize(jnp.asarray(b["pixel_u8"])[None], wy, wx))[0]
        else:
            got, want = a["pixel_values"], b["pixel_values"]
        assert np.abs(got - want).max() <= 2.0 / 255 + 1e-6
    assert ours[0]["new_tokens_start"][0] > 0 and ours[2]["new_tokens_start"][0] == -1


# -- three token steps against the JAX step ------------------------------------------

TOKEN_STEPS = 3
STARTS = np.array([[3, 6, -1], [2, -1, 9]], np.int32)
MODES = {
    "stage1": dict(train_token=True, train_unet=True, train_cross_attn=False),
    "stage2": dict(train_token=False, train_unet=True, train_cross_attn=False),
}


def _token_batch(bundle):
    rng = np.random.RandomState(6)
    s = bundle.unet_config.sample_size * 2  # the tiny VAE downsamples by 2
    pixels = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    ids = rng.randint(0, bundle.text_config.vocab_size - 1, (2, 77)).astype(np.int32)
    return pixels, ids


def _loss_cfg(mode, max_grad_norm):
    return dict(snr_gamma=5.0, with_cross_attn_reg=True, reg_weight=0.5, n_object_embedding=1,
                train_token=MODES[mode]["train_token"], max_grad_norm=max_grad_norm)


def _jax_token_run(tiny, mode, max_grad_norm):
    """TOKEN_STEPS JAX token steps (f32 AdamW); per step the UNet params in
    the port's layout, the embedding, the metrics and the port's draws."""
    _, bundle, _ = tiny
    cfg = bundle.unet_config
    schedule = jsched.make_schedule()
    tx = joptim.make_optimizer(joptim.lr_schedule("constant", LR, 0, 100), max_grad_norm=None)
    flags = MODES[mode]
    state = jtok.init_token_train_state(bundle.unet_params, tx, flags["train_token"],
                                        flags["train_unet"], flags["train_cross_attn"],
                                        n_tokens=3, hidden_size=bundle.text_config.hidden_size,
                                        rng=jax.random.key(4))
    init_emb = None if state.embedding is None else np.array(state.embedding)
    step = jax.jit(jtok.make_token_train_step(
        JaxUNet(cfg), JaxVAE(bundle.vae_config), JaxCLIP(bundle.text_config), schedule, tx,
        jtok.TokenLossConfig(**_loss_cfg(mode, max_grad_norm))))
    pixels, ids = _token_batch(bundle)
    batch = {"pixel_values": jnp.asarray(pixels), "input_ids": jnp.asarray(ids),
             "new_tokens_start": jnp.asarray(STARTS)}
    key = jax.random.key(7)
    shape = (2, cfg.sample_size, cfg.sample_size, 4)
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    out = []
    for i in range(TOKEN_STEPS):
        k_vae, k_noise, k_t, _ = jax.random.split(jax.random.fold_in(key, i), 4)
        draws = ttrain.StepDraws(
            latent_eps=torch.from_numpy(np.array(jax.random.normal(k_vae, shape, jnp.float32))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
            timesteps=torch.from_numpy(np.asarray(jax.random.randint(
                k_t, (2,), 0, schedule.num_train_timesteps)).astype(np.int64)))
        state, metrics = step(state, bundle.vae_params, bundle.text_params, batch, key)
        unet = params_from_jax(tree(jtok.merge_params(state.unet_trainable,
                                                      state.unet_frozen)))[0]
        emb = None if state.embedding is None else torch.from_numpy(np.array(state.embedding))
        out.append((unet, emb, {k: float(v) for k, v in metrics.items()}, draws))
    return init_emb, out


def _port_token_run(tiny, mode, max_grad_norm, init_emb, draws):
    _, bundle, states = tiny
    unet, vae, text = _port_models(bundle, states)
    tx = toptim.make_optimizer(toptim.lr_schedule("constant", LR, 0, 100), max_grad_norm=None)
    flags = MODES[mode]
    state = ttok.init_token_train_state(unet, tx, n_tokens=3,
                                        hidden_size=bundle.text_config.hidden_size,
                                        init_embedding=init_emb, **flags)
    step = ttok.make_token_train_step(unet, vae, text, tsched.make_schedule(), tx,
                                      ttok.TokenLossConfig(**_loss_cfg(mode, max_grad_norm)))
    pixels, ids = _token_batch(bundle)
    batch = {"pixel_values": torch.from_numpy(pixels),
             "input_ids": torch.from_numpy(ids.astype(np.int64)),
             "new_tokens_start": torch.from_numpy(STARTS)}
    out = []
    for d in draws:
        state, metrics = step(state, batch, draws=d)
        params = ttok.merge_params(state.unet_trainable, state.unet_frozen)
        out.append(({k: p.detach().clone() for k, p in params.items()},
                    None if state.embedding is None else state.embedding.detach().clone(),
                    {k: float(v) for k, v in metrics.items()}))
    return state, out


def _param_faults(i, got, want):
    """The SD step's limits (tests/test_torch_train.py::_step_faults): at step
    1 at most 0.1% of elements past f32 rounding and none past the Adam step's
    sign flip, 2 lr; at step i > 1 at most 0.1% past 0.25 lr (i - 1), none
    past 2 lr more."""
    near = 1e-6 if i == 1 else 0.25 * LR * (i - 1) + 1e-6
    far = 2 * LR * (1 + 1e-3) if i == 1 else 2 * LR + near
    diffs = np.concatenate([(got[k] - want[k]).abs().reshape(-1).numpy() for k in want])
    faults = []
    if float(np.mean(diffs > near)) > 1e-3:
        faults.append((i, f"share above {near:.3g}", float(np.mean(diffs > near))))
    if diffs.max() > far:
        faults.append((i, "max", float(diffs.max()), far))
    return faults


@pytest.mark.parametrize("mode,max_grad_norm", [("stage1", 1.0), ("stage1", 1e-3),
                                                ("stage2", 1.0)])
def test_token_step_matches_jax(tiny, mode, max_grad_norm):
    """Three steps against the JAX token step on its key stream's draws and its
    initial embedding: the metrics within 1e-5 relative at every step, the
    UNet parameters and the embedding within the SD step's limits. At
    max_grad_norm 1e-3 the UNet-only clip scales every UNet gradient."""
    init_emb, jax_steps = _jax_token_run(tiny, mode, max_grad_norm)
    state, port_steps = _port_token_run(tiny, mode, max_grad_norm, init_emb,
                                        [s[3] for s in jax_steps])
    faults = []
    for i, ((want, want_emb, m_j, _), (got, got_emb, m_t)) in enumerate(
            zip(jax_steps, port_steps), start=1):
        for key in ("loss", "mse", "attn_loss", "fg_loss", "bg_loss"):
            if abs(m_t[key] - m_j[key]) > METRIC_RTOL * abs(m_j[key]):
                faults.append((i, key, m_t[key], m_j[key]))
        faults += _param_faults(i, got, want)
        if want_emb is not None:
            faults += _param_faults(i, {"embedding": got_emb}, {"embedding": want_emb})
    assert faults == []
    assert state.step == TOKEN_STEPS and int(state.opt_state.count) == TOKEN_STEPS
    assert port_steps[0][2]["attn_loss"] > 0
    if mode == "stage1":
        moved = (port_steps[-1][1] - torch.from_numpy(init_emb)).abs().max()
        assert float(moved) > LR


def test_token_step_clip_is_unet_only_and_only_with_tokens(tiny):
    """The reference's quirk: with tokens training, the UNet's gradient is
    scaled by min(1, max_grad_norm / (||g_unet|| + 1e-6)) and the embedding's
    is not; without tokens nothing is clipped (the optimizer has no clip)."""
    _, bundle, states = tiny
    seen = {}
    for mode in ("stage1", "stage2"):
        unet, vae, text = _port_models(bundle, states)
        tx = toptim.make_optimizer(toptim.lr_schedule("constant", LR, 0, 100),
                                   max_grad_norm=None)

        def spy(grads, opt_state, params, _mode=mode):
            seen[_mode] = {k: g.clone() for k, g in grads.items()}
            return tx.apply(grads, opt_state, params)

        tx_s = tx._replace(apply=spy)
        init = np.zeros((3, bundle.text_config.hidden_size), np.float32)
        state = ttok.init_token_train_state(unet, tx_s, n_tokens=3, init_embedding=init,
                                            hidden_size=bundle.text_config.hidden_size,
                                            **MODES[mode])
        step = ttok.make_token_train_step(unet, vae, text, tsched.make_schedule(), tx_s,
                                          ttok.TokenLossConfig(**_loss_cfg(mode, 1e-4)))
        pixels, ids = _token_batch(bundle)
        step(state, {"pixel_values": torch.from_numpy(pixels),
                     "input_ids": torch.from_numpy(ids.astype(np.int64)),
                     "new_tokens_start": torch.from_numpy(STARTS)},
             generator=torch.Generator().manual_seed(0))
    unet_norm = toptim.global_norm({k: g for k, g in seen["stage1"].items() if k != "embedding"})
    assert abs(float(unet_norm) - 1e-4) < 1e-9
    assert float(seen["stage1"]["embedding"].norm()) > 1e-4
    assert float(toptim.global_norm(seen["stage2"])) > 1e-2
    assert "embedding" not in seen["stage2"]


# -- the CLI ----------------------------------------------------------------------------


def _cli_args(d, data, out, steps, *extra):
    return ["--pretrained_model_name_or_path", d, "--dataset_folder", data,
            "--json_file_name", "train.json", "--output_dir", out, "--resolution", "32",
            "--train_batch_size", "2", "--max_train_steps", str(steps), "--snr_gamma", "5",
            "--reg_weight", "0.5", "--n_object_embedding", "1", "--object_token", "new_token",
            "--initialize_token", *WORDS, "--with_cross_attn_reg", "--train_unet",
            "--seed", "0", "--report_to", "jsonl", "--device", "cpu",
            "--dataloader_num_workers", "1", *extra]


def _unet_tensors(path):
    return load_pipeline(path).unet_state


def test_token_cli_stage1_stage2_and_resume(tiny, tmp_path):
    from agenda_tpu_torch.cli import finetune_sd_token

    d, bundle, _ = tiny
    data = str(tmp_path / "tiles")
    _write_tiles(data, [(16, 16)] * 4)
    one = str(tmp_path / "stage1")
    stats = finetune_sd_token.main(_cli_args(
        d, data, one, 4, "--train_token", "--checkpointing_steps", "2",
        "--validation_prompts", "An aerial view image with {} cars in {} Utah",
        "--num_validation_images", "1", "--validation_steps", "4"))
    assert stats["steps"] == 4 and all(np.isfinite(stats["losses"]))
    assert all(a > 0 for a in stats["attn_losses"])
    assert sorted(os.listdir(os.path.join(one, "checkpoint-2"))) == [
        "learned_embeds_steps_2.bin", "train_state", "unet"]
    assert len(os.listdir(os.path.join(one, "logs", "images"))) == 1  # the validation image
    learned = load_learned_embeddings(os.path.join(one, "learned_embeds_steps_4.bin"))
    assert list(learned) == [f"new_token_v{i}" for i in range(3)]
    export = os.path.join(one, "full_model_step_4")
    exported = load_pipeline(export)
    tok = CLIPTokenizer.from_pretrained(exported.tokenizer_dir)
    ids = tok.convert_tokens_to_ids(list(learned))
    table = exported.text_state["text_model.embeddings.token_embedding.weight"].numpy()
    assert exported.text_config.vocab_size == table.shape[0] == max(ids) + 1
    for t, i in zip(learned, ids):
        np.testing.assert_array_equal(table[i], learned[t])
    # the JAX package reads the export, its added tokens included
    jax_export = jax_load_pipeline(export)
    assert jax_export.unet_config == bundle.unet_config
    assert JaxTokenizer.from_pretrained(jax_export.tokenizer_dir).convert_tokens_to_ids(
        list(learned)) == ids

    # stage 2 from the export: frozen learned rows, the UNet trains
    two = str(tmp_path / "stage2")
    stats2 = finetune_sd_token.main(_cli_args(
        export, data, two, 2, "--embedding_path",
        os.path.join(one, "learned_embeds_steps_4.bin")))
    assert stats2["steps"] == 2 and stats2["object_tokens"] == list(learned)
    assert all(a > 0 for a in stats2["attn_losses"])
    assert sorted(os.listdir(two)) == ["full_model_step_2", "logs"]
    table2 = load_pipeline(os.path.join(two, "full_model_step_2")).text_state[
        "text_model.embeddings.token_embedding.weight"].numpy()
    np.testing.assert_array_equal(table2, table)  # the rows stay as stage 1 left them

    # a run resumed from checkpoint-2 ends where the uninterrupted one did
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(one, "checkpoint-2"), os.path.join(resumed, "checkpoint-2"))
    stats3 = finetune_sd_token.main(_cli_args(
        d, data, resumed, 4, "--train_token", "--resume_from_checkpoint", "latest",
        "--checkpointing_steps", "100"))
    assert stats3["steps"] == 2 and stats3["global_step"] == 4
    np.testing.assert_array_equal(stats3["losses"], stats["losses"][2:])
    again = load_learned_embeddings(os.path.join(resumed, "learned_embeds_steps_4.bin"))
    for t in learned:
        np.testing.assert_array_equal(again[t], learned[t])
    a, b = _unet_tensors(export), _unet_tensors(os.path.join(resumed, "full_model_step_4"))
    assert all(torch.equal(a[k], b[k]) for k in a)

    # --load_from_checkpoint starts the UNet from checkpoint-2's: at lr 0 the
    # update moves nothing, so the export is that UNet
    loaded = str(tmp_path / "loaded")
    finetune_sd_token.main(_cli_args(
        d, data, loaded, 1, "--train_token", "--learning_rate", "0", "--adam_weight_decay", "0",
        "--load_from_checkpoint", os.path.join(one, "checkpoint-2")))
    from agenda_tpu_torch.io.diffusers_io import load_unet

    _, ckpt_unet = load_unet(os.path.join(one, "checkpoint-2"))
    out = _unet_tensors(os.path.join(loaded, "full_model_step_1"))
    assert set(out) == set(ckpt_unet) and all(torch.equal(out[k], ckpt_unet[k]) for k in out)
    assert not all(torch.equal(out[k], v) for k, v in load_pipeline(d).unet_state.items())


def test_token_cli_accumulates_with_the_int8_adamw(tiny, tmp_path, monkeypatch):
    """Stage 1 under --use_8bit_adam --gradient_accumulation_steps 2: the
    global step counts updates, a mid-accumulation micro-batch leaves every
    trained tensor bitwise as it was, the fused int8 update runs once an
    update, the (3, hidden) embedding keeps f32 moments while the UNet's
    large leaves are int8, and a run resumed from checkpoint-1 ends where
    the uninterrupted one does."""
    from agenda_tpu_torch.cli import finetune_sd_token
    from agenda_tpu_torch.kernels.fused_adamw import FusedLeaves

    d, _, _ = tiny
    data = str(tmp_path / "tiles")
    _write_tiles(data, [(16, 16)] * 4)
    trained = []  # after each micro-batch: (mini_step, inner count, trained tensors)
    make_step = ttok.make_token_train_step

    def recording_step(*a, **kw):
        step_fn = make_step(*a, **kw)

        def step(state, batch, **skw):
            if not trained:
                trained.append((0, 0, _trained(state)))
            state, metrics = step_fn(state, batch, **skw)
            trained.append((state.opt_state.mini_step, int(state.opt_state.inner.count),
                            _trained(state)))
            return state, metrics

        return step

    def _trained(state):
        return {"embedding": state.embedding.detach().clone(),
                **{k: v.detach().clone() for k, v in state.unet_trainable.items()}}

    fused_calls = []
    fused_call = FusedLeaves.__call__

    def counting_call(self, grads, *a, **kw):
        fused_calls.append(len(grads))
        return fused_call(self, grads, *a, **kw)

    monkeypatch.setattr(ttok, "make_token_train_step", recording_step)
    monkeypatch.setattr(FusedLeaves, "__call__", counting_call)
    extra = ("--train_token", "--use_8bit_adam", "--gradient_accumulation_steps", "2")
    out = str(tmp_path / "accum")
    stats = finetune_sd_token.main(_cli_args(d, data, out, 2, *extra,
                                             "--checkpointing_steps", "1"))
    assert stats["steps"] == stats["global_step"] == 2 and stats["micro_batches"] == 4
    assert len(stats["losses"]) == 4 and all(np.isfinite(stats["losses"]))
    assert [(m, c) for m, c, _ in trained] == [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2)]
    for before, after, moved in zip(trained, trained[1:], (False, True, False, True)):
        same = [torch.equal(before[2][k], after[2][k]) for k in before[2]]
        assert (not any(same)) if moved else all(same)
    quantized = [k for k, v in trained[0][2].items() if v.numel() >= toptim.MIN_QUANTIZE_SIZE]
    assert quantized and "embedding" not in quantized
    assert fused_calls == [len(quantized)] * 2  # one fused update an update
    for step in (1, 2):
        with open(os.path.join(out, f"checkpoint-{step}", "train_state", "state.json")) as f:
            assert json.load(f) == {"step": 2 * step, "ema_step": None,
                                    "optimizer": "adam8bit", "mini_step": 0}
    opt = load_file(os.path.join(out, "checkpoint-2", "train_state", "optimizer.safetensors"))
    assert opt["mu.embedding"].dtype == torch.float32 and "mu.embedding.q" not in opt
    assert all(opt[f"mu.unet.{k}.q"].dtype == torch.int8 for k in quantized)

    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(out, "checkpoint-1"), os.path.join(resumed, "checkpoint-1"))
    again = finetune_sd_token.main(_cli_args(d, data, resumed, 2, *extra,
                                             "--resume_from_checkpoint", "latest",
                                             "--checkpointing_steps", "100"))
    assert again["steps"] == 1 and again["global_step"] == 2 and again["micro_batches"] == 4
    np.testing.assert_array_equal(again["losses"], stats["losses"][2:])
    want = load_learned_embeddings(os.path.join(out, "learned_embeds_steps_2.bin"))
    got = load_learned_embeddings(os.path.join(resumed, "learned_embeds_steps_2.bin"))
    assert all(np.array_equal(got[t], want[t]) for t in want)
    a = _unet_tensors(os.path.join(out, "full_model_step_2"))
    b = _unet_tensors(os.path.join(resumed, "full_model_step_2"))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_token_cli_refuses_what_the_reference_refuses(tiny):
    from agenda_tpu_torch.cli.finetune_sd_token import parse_args

    base = ["--pretrained_model_name_or_path", "p", "--dataset_folder", "d",
            "--json_file_name", "j.json"]
    for extra in ([], ["--train_unet", "--train_cross_attn", "--initialize_token", "cars"],
                  ["--train_unet"],
                  ["--train_unet", "--initialize_token", "cars", "--load_from_checkpoint", "a",
                   "--resume_from_checkpoint", "b"]):
        with pytest.raises(ValueError):
            parse_args(base + extra)
    with pytest.raises(ValueError):
        parse_args(["--pretrained_model_name_or_path", "p", "--train_unet"])
    from agenda_tpu_torch.cli import finetune_sd_token

    # --fsdp 2 needs a world of two ranks (make_mesh's rule, as the JAX mesh's)
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        finetune_sd_token.main(base + ["--train_unet", "--initialize_token", "cars",
                                       "--fsdp", "2", "--device", "cpu"])


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


def test_token_cli_flags_match_the_jax_cli_plus_device():
    from agenda_tpu.cli.finetune_sd_token import parse_args as jax_parse
    from agenda_tpu_torch.cli.finetune_sd_token import parse_args as port_parse

    required = ["--pretrained_model_name_or_path", "p", "--dataset_folder", "d",
                "--json_file_name", "j.json", "--train_token", "--initialize_token", "cars"]
    theirs, ours = _parser_flags(jax_parse, required), _parser_flags(port_parse, required)
    assert set(ours) - set(theirs) == {"--device", "--dist-backend"}
    for flag in theirs:
        assert ours[flag].default == theirs[flag].default, flag
        assert ours[flag].nargs == theirs[flag].nargs, flag
        assert ours[flag].dest == theirs[flag].dest, flag
    assert ours["--device"].default == "cuda"
    assert vars(jax_parse(required)) == {k: v for k, v in vars(port_parse(required)).items()
                                         if k not in ("device", "dist_backend")}


def test_token_loss_config_matches_the_jax_fields():
    import dataclasses

    assert [f.name for f in dataclasses.fields(ttok.TokenLossConfig)] == [
        f.name for f in dataclasses.fields(jtok.TokenLossConfig)]
