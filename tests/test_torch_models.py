"""Model-level parity of the PyTorch port (agenda_tpu_torch) against agenda_tpu.

The port writes a tiny seeded pipeline directory; the JAX package reads it
(its own importer), and ``params_from_jax`` carries the JAX parameter trees
into the port's modules (strict load). The same numpy inputs then go through
both packages in f32 on the CPU: UNet eps and every DAAM map, VAE decode and
encode, CLIP hidden states and pooled output, and the samplers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agenda_tpu.core import schedules as jsched
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.models import AutoencoderKL as JaxVAE
from agenda_tpu.models import CLIPTextModel as JaxCLIP
from agenda_tpu.models import UNet2DConditionModel as JaxUNet
from agenda_tpu.models.layers import timestep_embedding as jax_timestep_embedding
from agenda_tpu_torch.core import schedules as tsched
from agenda_tpu_torch.io.diffusers_io import load_pipeline, params_from_jax
from agenda_tpu_torch.io.fabricate import fabricate_pipeline
from agenda_tpu_torch.models.clip_text import CLIPTextModel
from agenda_tpu_torch.models.layers import timestep_embedding
from agenda_tpu_torch.models.unet import UNet2DConditionModel
from agenda_tpu_torch.models.vae import AutoencoderKL

TOL = 1e-4  # f32 on both sides through ~20 layers; only the summation order differs


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_port_pipe"))
    fabricate_pipeline(d, tiny=True, seed=3)
    bundle = jax_load_pipeline(d)
    tree = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    states = params_from_jax(tree(bundle.unet_params), tree(bundle.vae_params),
                             tree(bundle.text_params))
    return d, bundle, states


def _strict(module_cls, cfg, state):
    m = module_cls(cfg)
    m.load_state_dict(state, strict=True)
    return m.eval()


def test_params_from_jax_matches_the_port_loader(tiny):
    """The port's own loader and the JAX importer + params_from_jax agree on
    every tensor (key maps and HWIO/(I,O) transposes)."""
    d, _, states = tiny
    own = load_pipeline(d)
    for ours, theirs in zip((own.unet_state, own.vae_state, own.text_state), states):
        assert set(ours) == set(theirs)
        for k in ours:
            assert torch.equal(ours[k], theirs[k]), k


def test_timestep_embedding_matches_jax():
    t = np.array([1, 7, 421, 981])
    ref = jax_timestep_embedding(jnp.asarray(t), 320)
    out = timestep_embedding(torch.from_numpy(t), 320)
    # sin/cos of f32 arguments up to ~1000, whose ulp is 6e-5: the two
    # libraries' range reductions differ by about that much
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_unet_eps_and_every_daam_map_match_jax(tiny):
    _, bundle, (unet_sd, _, _) = tiny
    cfg = bundle.unet_config
    rng = np.random.RandomState(0)
    s = cfg.sample_size
    x = rng.standard_normal((2, s, s, 4)).astype(np.float32)
    t = np.array([7, 421])
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    eps_j, maps_j = JaxUNet(cfg).apply(bundle.unet_params, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(ctx), collect_attn=True)
    from agenda_tpu_torch.io.configs import unet_config_from_json, unet_config_to_json

    unet = _strict(UNet2DConditionModel, unet_config_from_json(unet_config_to_json(cfg)),
                   unet_sd)
    with torch.no_grad():
        eps, maps = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         collect_attn=True)
    assert eps.dtype == torch.float32 and eps.shape == x.shape
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_j), atol=TOL, rtol=TOL)
    assert len(maps) == len(maps_j) == 4  # 1 down, 1 mid, 2 up, in that order
    for m, mj in zip(maps, maps_j):
        assert m.shape == mj.shape
        np.testing.assert_allclose(m.numpy(), np.asarray(mj), atol=1e-6, rtol=1e-4)


def test_vae_decode_and_encode_match_jax(tiny):
    _, bundle, (_, vae_sd, _) = tiny
    from agenda_tpu_torch.io.configs import vae_config_from_json, vae_config_to_json

    vae = _strict(AutoencoderKL, vae_config_from_json(vae_config_to_json(bundle.vae_config)),
                  vae_sd)
    jvae = JaxVAE(bundle.vae_config)
    rng = np.random.RandomState(1)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ref = jvae.apply(bundle.vae_params, jnp.asarray(z), method="decode")
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    assert out.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    mean_j, logvar_j = jvae.apply(bundle.vae_params, jnp.asarray(img), method="encode")
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(img))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=TOL, rtol=TOL)


def test_clip_text_matches_jax(tiny):
    _, bundle, (_, _, text_sd) = tiny
    from agenda_tpu_torch.data.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(bundle.tokenizer_dir)
    ids = tok(["an aerial view image with cars in utah", ""]).astype(np.int64)
    hidden_j, pooled_j = JaxCLIP(bundle.text_config).apply(bundle.text_params,
                                                          jnp.asarray(ids, jnp.int32))
    from agenda_tpu_torch.io.configs import clip_config_from_json, clip_config_to_json

    clip = _strict(CLIPTextModel, clip_config_from_json(clip_config_to_json(bundle.text_config)),
                   text_sd)
    with torch.no_grad():
        hidden, pooled = clip(torch.from_numpy(ids))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(hidden_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scheduler", ["pndm", "ddim"])
def test_sampler_steps_match_jax(scheduler):
    """Drive both samplers with the same eps sequence over the full table."""
    js, ts = jsched.make_schedule(), tsched.make_schedule()
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    n = 20
    table_fn = "plms_timesteps" if scheduler == "pndm" else "ddim_timesteps"
    table = getattr(tsched, table_fn)(ts, n)
    np.testing.assert_array_equal(table, getattr(jsched, table_fn)(js, n))
    assert len(table) == (n + 1 if scheduler == "pndm" else n)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jstate, tstate = jsched.plms_init_state(x.shape), tsched.plms_init_state()
    for t in table.tolist():
        eps = rng.standard_normal(x.shape).astype(np.float32)
        if scheduler == "pndm":
            jstate, xj = jsched.plms_step(js, jstate, jnp.asarray(eps), xj, jnp.asarray(t), n)
            tstate, xt = tsched.plms_step(ts, tstate, torch.from_numpy(eps), xt, t, n)
        else:
            ratio = js.num_train_timesteps // n
            xj = jsched.ddim_step(js, jnp.asarray(eps), jnp.asarray(t), t - ratio, xj)
            xt = tsched.ddim_step(ts, torch.from_numpy(eps), t, t - ratio, xt)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, rtol=1e-5)


def test_legacy_vae_attention_names_load_like_the_jax_importer(tiny, tmp_path):
    """Pre-0.13 diffusers VAEs spell the mid attention query/key/value/proj_attn."""
    from agenda_tpu.io.diffusers_io import vae_torch_to_flax
    from agenda_tpu_torch.io.diffusers_io import rename_legacy_vae_keys
    from agenda_tpu_torch.io.safetensors_io import load_file

    d, _, (_, vae_sd, _) = tiny
    current = load_file(os.path.join(d, "vae", "diffusion_pytorch_model.safetensors"))
    legacy = {}
    for k, v in current.items():
        for new, old in (("to_q.", "query."), ("to_k.", "key."), ("to_v.", "value."),
                         ("to_out.0.", "proj_attn.")):
            if "attentions" in k and new in k:
                k = k.replace(new, old)
        legacy[k] = v
    assert any("proj_attn" in k for k in legacy)
    renamed = rename_legacy_vae_keys(legacy)
    assert set(renamed) == set(vae_sd)
    jax_tree = vae_torch_to_flax({k: v.numpy() for k, v in legacy.items()})
    ours = params_from_jax(None, jax.tree.map(np.asarray, jax_tree), None)[1]
    for k in vae_sd:
        assert torch.equal(renamed[k], ours[k]), k
