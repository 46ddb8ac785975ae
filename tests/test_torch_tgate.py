"""TGATE sampling (arXiv:2404.02747) in the port against agenda_tpu, on the CPU in f32.

Both packages load the JAX package's tiny fixture (``make_tiny_pipeline_dir``):

- the UNet: the tiny UNet's four cross-attention layers (the SD-1.x
  topology's sixteen) in traversal order; ``collect_cross`` leaves eps as it
  is, replaying a call's own contributions gives that call's eps within
  REPLAY_TOL (``tests/test_tgate.py:39-80``), a perturbed cache changes eps,
  and the port's contributions equal the JAX package's within
  CROSS_ATOL / CROSS_RTOL;
- the sampler: the port, handed the JAX latents, against the JAX
  ``_sample_fn`` with ``tgate_step=2`` of 4 steps, for PLMS (whose timestep
  table has T + 1 entries, so the gate's heatmap counts ``len(table) - m``
  times) and DDIM: images within one level (uint8 by rounding), f32 heatmaps
  within HEAT_ATOL / HEAT_RTOL, word maps within one level (truncation), and
  the UNet's batch at every step (2B up to the gate, B after it);
- the CLI: ``--tgate-step`` reaches the sampler and writes the JAX CLI's
  file tree.

The tolerances are those of the exact sampler's parity
(``tests/test_torch_pipeline.py``).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agenda_tpu.data.tokens import compute_token_merge_indices as jax_merge_indices
from agenda_tpu.generate.pipeline import StableDiffusionPipeline as JaxPipeline
from agenda_tpu.io.learned_embeds import save_learned_embeddings
from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline
from agenda_tpu_torch.io.configs import UNetConfig
from agenda_tpu_torch.models.unet import UNet2DConditionModel

from fixtures import make_tiny_pipeline_dir
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPT = "an aerial view image with cars in utah"
WORDS = ["cars", "utah"]
SEEDS = [0, 1]
RES = 32  # tiny VAE factor 2 -> 16x16 latents
STEPS, GATE = 4, 2
REPLAY_TOL = 1e-6  # eps: a replayed call against the call that collected
CROSS_ATOL, CROSS_RTOL = 1e-5, 1e-4  # the contributions, port against JAX (f32)
HEAT_ATOL, HEAT_RTOL = 1e-6, 1e-4  # f32 heatmaps, as the exact sampler's parity


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_tgate_pipe"))
    make_tiny_pipeline_dir(d)
    return d


@pytest.fixture(scope="module")
def pipes(fixture_dir):
    return (JaxPipeline.from_pretrained(fixture_dir, dtype=jnp.float32),
            StableDiffusionPipeline.from_pretrained(fixture_dir, device="cpu"))


def _unet_inputs(hidden):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, hidden)).astype(np.float32)
    return x, np.array([5.0, 5.0], np.float32), ctx


def test_collect_and_replay_match_jax(pipes):
    jp, tp = pipes
    x, t, ctx = _unet_inputs(tp.unet.config.cross_attention_dim)
    xt, tt, ct = (torch.from_numpy(a) for a in (x, t, ctx))
    with torch.no_grad():
        eps_ref, _ = tp.unet(xt, tt, ct)
        eps_col, _, cross = tp.unet(xt, tt, ct, collect_cross=True)
        assert len(cross) == 4  # 1 down + 1 mid + 2 up cross-attention layers
        torch.testing.assert_close(eps_col, eps_ref, rtol=0, atol=0)
        eps_replay, _ = tp.unet(xt, tt, ct, cached_cross=cross)
        torch.testing.assert_close(eps_replay, eps_col, rtol=REPLAY_TOL, atol=REPLAY_TOL)
        eps_bad, _ = tp.unet(xt, tt, ct, cached_cross=[c + 1.0 for c in cross])
        assert not torch.allclose(eps_bad, eps_col)
        with pytest.raises(AssertionError):
            tp.unet(xt, tt, ct, collect_cross=True, cached_cross=cross)

    jeps, _, jcross = jp.unet.apply(jp.unet_params, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(ctx), collect_cross=True)
    assert [tuple(c.shape) for c in cross] == [tuple(c.shape) for c in jcross]
    for ours, theirs in zip(cross, jcross):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=CROSS_ATOL,
                                   rtol=CROSS_RTOL)
    np.testing.assert_allclose(eps_col.numpy(), np.asarray(jeps), atol=CROSS_ATOL,
                               rtol=CROSS_RTOL)


def test_cross_layer_count_of_the_sd_topology():
    """SD-1.x: 6 down + 1 mid + 9 up = 16 cross-attention layers."""
    cfg = UNetConfig(sample_size=8, block_out_channels=(8, 8, 8, 8), layers_per_block=2,
                     attention_head_dim=1, cross_attention_dim=8)
    unet = UNet2DConditionModel(cfg).eval()
    with torch.no_grad():
        _, _, cross = unet(torch.zeros(1, 8, 8, 4), torch.tensor([1.0]), torch.zeros(1, 7, 8),
                           collect_cross=True)
    assert len(cross) == 16


def _jax_sample(jp, steps, tgate_step):
    """The JAX sampler's (latents, images u8, f32 heatmaps, word maps u8)."""
    b = len(SEEDS)
    idx = [jax_merge_indices(jp.tokenizer, PROMPT, w)[0] for w in WORDS]
    k = max(len(x) for x in idx)
    ids = np.zeros((len(WORDS), k), np.int32)
    mask = np.zeros((len(WORDS), k), np.float32)
    for i, xs in enumerate(idx):
        ids[i, : len(xs)] = xs
        mask[i, : len(xs)] = 1.0
    context = jp.encode_prompts([""] * b + [PROMPT] * b)
    lat = jp._latents_fn(jnp.asarray(SEEDS, jnp.uint32), RES // 2, RES // 2)
    images, heat, wmaps = jp._sample_fn(
        jp.unet_params, jp.vae_params, context, lat, jnp.asarray(jp.timestep_table(steps)),
        jnp.float32(7.5), jnp.asarray(ids), jnp.asarray(mask), True, jp.scheduler_type, steps,
        112, tgate_step=tgate_step)
    return np.asarray(lat), np.asarray(images), np.asarray(heat), np.asarray(wmaps)


@pytest.mark.parametrize("scheduler", ["pndm", "ddim"])
def test_tgate_sampler_matches_jax_given_its_latents(pipes, scheduler, monkeypatch):
    jp, tp = pipes
    jp = dataclasses.replace(jp, scheduler_type=scheduler)
    tp = dataclasses.replace(tp, scheduler_type=scheduler)
    lat, images_j, heat_j, wmaps_j = _jax_sample(jp, STEPS, GATE)

    batches = []
    forward = tp.unet.forward

    def counted(sample, *args, **kwargs):
        batches.append(sample.shape[0])
        return forward(sample, *args, **kwargs)

    monkeypatch.setattr(tp.unet, "forward", counted)
    kw = dict(num_inference_steps=STEPS, height=RES, width=RES, out_size=112, latents=lat,
              tgate_step=GATE)
    images, heat = tp(PROMPT, SEEDS, collect_heatmaps=True, **kw)
    n = len(tp.timestep_table(STEPS))
    assert n == STEPS + (scheduler == "pndm")
    assert batches == [4] * (GATE + 1) + [2] * (n - GATE - 1)
    # the word maps as generate_async makes them from these heatmaps
    wmaps = tp._word_maps(torch.from_numpy(heat), PROMPT, WORDS, 0).numpy()
    wmaps = {w: wmaps[:, i] for i, w in enumerate(WORDS)}

    assert images.shape == images_j.shape == (2, 112, 112, 3) and images.dtype == np.uint8
    assert np.abs(images.astype(int) - images_j.astype(int)).max() <= 1
    assert heat.shape == heat_j.shape == (2, 77, 8, 8)
    np.testing.assert_allclose(heat, heat_j, atol=HEAT_ATOL, rtol=HEAT_RTOL)
    for i, w in enumerate(WORDS):
        assert wmaps[w].shape == (2, 8, 8) and wmaps[w].dtype == np.uint8
        assert np.abs(wmaps[w].astype(int) - wmaps_j[:, i].astype(int)).max() <= 1


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_tgate_step_reaches_the_sampler_and_writes_the_jax_tree(fixture_dir, tmp_path,
                                                                    monkeypatch):
    from agenda_tpu.cli import data_generation as jax_cli
    from agenda_tpu_torch.cli import data_generation as port_cli

    embeds = str(tmp_path / "embeds.bin")
    rng = np.random.RandomState(0)
    save_learned_embeddings(["new_token_v0", "new_token_v1"],
                            rng.standard_normal((2, 32)).astype(np.float32) * 0.02, embeds)
    args = ["--pretrained-model-path", fixture_dir, "--learnable-tokens-embedding-path", embeds,
            "--prompt", "an aerial view image with {} cars in {} utah",
            "--initialize_token", "cars", "utah", "--word_token_heatmaps", "cars",
            "--num-images", "2", "--batch-size", "2", "--num-inference-steps", "3",
            "--image-size", "112", "--resolution", str(RES), "--tgate-step", "1"]
    assert port_cli.parse_args(["--save-dir", "x"]).tgate_step == 0  # off by default

    seen = []
    generate = StableDiffusionPipeline.generate_async

    def spy(self, *a, **kw):
        seen.append(kw["tgate_step"])
        return generate(self, *a, **kw)

    monkeypatch.setattr(StableDiffusionPipeline, "generate_async", spy)
    jax_cli.main(["--save-dir", str(tmp_path / "jax"), *args])
    port_cli.main(["--save-dir", str(tmp_path / "port"), *args, "--device", "cpu"])
    assert seen == [1]
    tree = _tree(str(tmp_path / "port"))
    assert tree == _tree(str(tmp_path / "jax")) and len(tree) == 2 * 2  # images, daam_cars
