"""Pipeline-level parity of the PyTorch port (agenda_tpu_torch) against agenda_tpu.

Both packages load the JAX package's tiny fixture (``make_tiny_pipeline_dir``)
and sample in f32 on the CPU. The port is handed the JAX latents (jax
threefry cannot be reproduced in torch), then images, f32 heatmaps and word
maps are compared for PLMS and DDIM. Also: the port's CLI writes the same
file tree as the JAX CLI, its flags are a superset of the JAX CLI's, its
safetensors and PNG files agree with the safetensors and Pillow packages,
and its tokenizer copy agrees with the original.
"""

import argparse
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from agenda_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from agenda_tpu.data.tokens import compute_token_merge_indices as jax_merge_indices
from agenda_tpu.generate.pipeline import StableDiffusionPipeline as JaxPipeline
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.io.learned_embeds import save_learned_embeddings
from agenda_tpu_torch.data.tokenizer import CLIPTokenizer
from agenda_tpu_torch.data.tokens import compute_token_merge_indices
from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline
from agenda_tpu_torch.io.diffusers_io import load_pipeline
from agenda_tpu_torch.io.safetensors_io import load_file, save_file
from agenda_tpu_torch.utils.png import encode_png, read_png, write_png

from fixtures import make_tiny_pipeline_dir

PROMPT = "an aerial view image with cars in utah"
WORDS = ["cars", "utah"]
SEEDS = [0, 1]
RES = 32  # tiny VAE factor 2 -> 16x16 latents; maps at 16 and 8 resized to latent_hw 8


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny_jax_pipe"))
    make_tiny_pipeline_dir(d)
    return d


@pytest.fixture(scope="module")
def pipes(fixture_dir):
    return (JaxPipeline.from_pretrained(fixture_dir, dtype=jnp.float32),
            StableDiffusionPipeline.from_pretrained(fixture_dir, device="cpu"))


def test_port_loads_the_jax_fixture_tensor_for_tensor(fixture_dir):
    """Every tensor the JAX importer reads, the port reads too (same layout)."""
    from agenda_tpu.io.diffusers_io import unet_flax_to_torch

    bundle = jax_load_pipeline(fixture_dir)
    own = load_pipeline(fixture_dir)
    ref = unet_flax_to_torch(bundle.unet_params)
    assert set(ref) == set(own.unet_state)
    for k, v in ref.items():
        np.testing.assert_array_equal(own.unet_state[k].numpy(), np.asarray(v))


def _jax_sample(jp, steps):
    """The JAX sampler's (images u8, f32 heatmaps, word maps u8) and its latents."""
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
        112)
    return np.asarray(lat), np.asarray(images), np.asarray(heat), np.asarray(wmaps)


@pytest.mark.parametrize("scheduler,steps", [("pndm", 3), ("ddim", 2)])
def test_pipeline_matches_jax_given_its_latents(pipes, scheduler, steps):
    jp, tp = pipes
    jp = dataclasses.replace(jp, scheduler_type=scheduler)
    tp = dataclasses.replace(tp, scheduler_type=scheduler)
    lat, images_j, heat_j, wmaps_j = _jax_sample(jp, steps)
    kw = dict(num_inference_steps=steps, height=RES, width=RES, out_size=112, latents=lat)
    images, heat = tp(PROMPT, SEEDS, collect_heatmaps=True, **kw)
    images_w, wmaps = tp(PROMPT, SEEDS, words=WORDS, **kw)
    assert images.shape == images_j.shape == (2, 112, 112, 3) and images.dtype == np.uint8
    np.testing.assert_array_equal(images, images_w)
    # uint8 by rounding: f32 differences of ~1e-6 may flip a rounding boundary
    assert np.abs(images.astype(int) - images_j.astype(int)).max() <= 1
    assert heat.shape == heat_j.shape == (2, 77, 8, 8)
    np.testing.assert_allclose(heat, heat_j, atol=1e-6, rtol=1e-4)
    for i, w in enumerate(WORDS):
        assert wmaps[w].shape == (2, 8, 8) and wmaps[w].dtype == np.uint8
        # truncation to uint8 can drop a value sitting on an integer by one
        assert np.abs(wmaps[w].astype(int) - wmaps_j[:, i].astype(int)).max() <= 1


def test_generate_without_latents_uses_per_seed_generators(pipes):
    _, tp = pipes
    a = tp.initial_latents([5, 6], 4, 4)
    b = tp.initial_latents([6], 4, 4)
    assert a.shape == (2, 4, 4, 4)
    np.testing.assert_array_equal(a[1].numpy(), b[0].numpy())  # a seed's draw is its own
    images, maps = tp(PROMPT, [5, 6], num_inference_steps=2, height=RES, width=RES,
                      words=["cars"], heatmap_size=112)
    assert images.shape == (2, RES, RES, 3) and maps["cars"].shape == (2, 112, 112)


def _cli_args(fixture_dir, embeds, out, extra=()):
    return ["--save-dir", out, "--pretrained-model-path", fixture_dir,
            "--learnable-tokens-embedding-path", embeds,
            "--prompt", "an aerial view image with {} cars in {} utah",
            "--initialize_token", "cars", "utah", "--word_token_heatmaps", "cars",
            "--store_learnable_token_heatmaps", "--num-images", "3", "--batch-size", "2",
            "--num-inference-steps", "2", "--image-size", "112", "--resolution", str(RES),
            *extra]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_cli_writes_the_same_tree_as_the_jax_cli(fixture_dir, tmp_path):
    from agenda_tpu.cli import data_generation as jax_cli
    from agenda_tpu_torch.cli import data_generation as port_cli

    embeds = str(tmp_path / "embeds.bin")
    rng = np.random.RandomState(0)
    save_learned_embeddings(["new_token_v0", "new_token_v1"],
                            rng.standard_normal((2, 32)).astype(np.float32) * 0.02, embeds)
    jax_cli.main(_cli_args(fixture_dir, embeds, str(tmp_path / "jax")))
    port_cli.main(_cli_args(fixture_dir, embeds, str(tmp_path / "port"), ["--device", "cpu"]))
    tree = _tree(str(tmp_path / "port"))
    assert tree == _tree(str(tmp_path / "jax"))
    assert len(tree) == 4 * 3  # images, daam_cars, daam_new_token_v0, daam_new_token_v1
    for rel in tree:
        ours = read_png(str(tmp_path / "port" / rel))
        theirs = np.asarray(Image.open(str(tmp_path / "jax" / rel)))
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.uint8
    # TGATE is accepted (tests/test_torch_tgate.py runs it)
    assert port_cli.parse_args(_cli_args(fixture_dir, embeds, str(tmp_path / "t"),
                                         ["--tgate-step", "5"])).tgate_step == 5


def _parser_flags(parse_args):
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def fake(self, args=None, namespace=None):
        captured["parser"] = self
        return orig(self, [], namespace)

    argparse.ArgumentParser.parse_args = fake
    try:
        parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {s: a for s, a in captured["parser"]._option_string_actions.items()
            if s.startswith("--")}


def test_cli_flags_match_the_jax_cli_plus_device():
    from agenda_tpu.cli.data_generation import parse_args as jax_parse
    from agenda_tpu_torch.cli.data_generation import parse_args as port_parse

    theirs, ours = _parser_flags(jax_parse), _parser_flags(port_parse)
    assert set(ours) - set(theirs) == {"--device"}
    assert set(theirs) <= set(ours)
    for flag in theirs:
        assert ours[flag].default == theirs[flag].default, flag
        assert ours[flag].nargs == theirs[flag].nargs, flag
    assert ours["--device"].default == "cuda"
    assert port_parse(["--device", "cpu"]).device == "cpu"


def test_safetensors_round_trip_against_the_package(tmp_path):
    import safetensors.numpy
    import safetensors.torch

    rng = np.random.RandomState(0)
    tensors = {
        "a.weight": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "b.half": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
        "c.bf16": torch.randn(2, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
        "d.ids": torch.arange(11, dtype=torch.int64).reshape(1, 11),
        "e.u8": torch.arange(5, dtype=torch.uint8),
        "f.empty": torch.zeros((0, 4)),
    }
    ours = str(tmp_path / "ours.safetensors")
    save_file(tensors, ours)
    back = safetensors.torch.load_file(ours)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    theirs = str(tmp_path / "theirs.safetensors")
    safetensors.torch.save_file(tensors, theirs, metadata={"format": "pt"})
    read = load_file(theirs)
    for k, v in tensors.items():
        assert read[k].dtype == v.dtype and torch.equal(read[k], v), k
    np_file = str(tmp_path / "np.safetensors")
    safetensors.numpy.save_file({"x": rng.standard_normal((4, 4)).astype(np.float32)}, np_file)
    assert load_file(np_file)["x"].shape == (4, 4)


def test_png_writer_against_pillow(tmp_path):
    rng = np.random.RandomState(1)
    for img in (rng.randint(0, 256, (13, 17)).astype(np.uint8),
                rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)):
        path = str(tmp_path / f"x{img.ndim}.png")
        write_png(path, img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))


def test_tokenizer_copy_matches_the_original(fixture_dir):
    tok_dir = os.path.join(fixture_dir, "tokenizer")
    ours, theirs = CLIPTokenizer.from_pretrained(tok_dir), JaxTokenizer.from_pretrained(tok_dir)
    for t in (ours, theirs):
        t.add_tokens(["new_token_v0", "new_token_v1"])
    prompts = [PROMPT, "An aerial view image with new_token_v0 cars in new_token_v1 Utah",
               "", "linz!! 123 cars's"]
    np.testing.assert_array_equal(ours(prompts), theirs(prompts))
    for w in ("cars", "aerial", "utah", "new_token_v1"):
        assert (compute_token_merge_indices(ours, prompts[1], w)
                == jax_merge_indices(theirs, prompts[1], w))
    assert ours.decode(ours(prompts[1])) == theirs.decode(theirs(prompts[1]))
