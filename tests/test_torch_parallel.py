"""The port over several ranks (``agenda_tpu_torch.parallel``) against one
process and against the JAX package on a 2-device mesh, on the CPU.

Two ranks run in spawned processes over gloo (``torch_parallel_workers``),
every job of this file in one spawn, while this process computes the
references (the JAX package on ``make_mesh(devices=jax.devices()[:2])``, and
the port in one process over the same global batch). Tiny sizes throughout:
the fabricated tiny SD pipeline, YOLOv8n and Faster R-CNN at 64 px.

Tolerances, each the one the single-process parity tests state for the same
computation (only the order of the sums differs over two ranks):

- generation (the exact and the TGATE sampler): images within one level,
  word maps within one level (``tests/test_torch_pipeline.py``);
- the SD step (int8 AdamW + EMA) against one process and against JAX:
  ``tests/test_torch_train.py::_step_faults`` (at step 1 the parameters and
  the EMA within f32 rounding but for at most 0.1% of the elements, by the
  Adam step's sign flip at most, 2 lr; later steps one int8 code step);
  a ``--fsdp 2`` checkpoint resumed at world 1 gives the gathered state
  exactly, and its next step the same limits;
- the token step, world 2 against world 1: the metrics within
  ``METRIC_RTOL`` and the parameters within the same limits
  (``tests/test_torch_token_train.py``);
- YOLOv8n's f32 step against JAX's: the loss and its parts within
  ``SPLIT_LOSS_RTOL``, the gradients within 1.5e-2 of their rms, the batch
  statistics as ``tests/test_torch_det_train.py`` holds them; Faster
  R-CNN's step in float64: the loss and parts within 1e-6, the gradients
  within 1e-5 of their rms, the batch statistics within 1e-5
  (``tests/test_torch_det_families.py``); YOLOv8's ``DetectorRunner.train``
  against one process: the logged losses of step 1 within 1e-5 and of step
  2 within 1e-3 relative (``tests/test_torch_device_aug.py``);
- ``det_test``'s records: the same images in the same order, detections
  matched within the detector tests' box and score limits.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agenda_tpu.parallel.mesh as jax_mesh
import torch_parallel_workers as W
from agenda_tpu.core import schedules as jsched
from agenda_tpu.detect.families import build_family as jax_build_family
from agenda_tpu.detect.faster_rcnn import FasterRCNN as JaxFasterRCNN
from agenda_tpu.generate.pipeline import StableDiffusionPipeline as JaxPipeline
from agenda_tpu.io.diffusers_io import _flatten as jax_flatten
from agenda_tpu.io.diffusers_io import load_pipeline as jax_load_pipeline
from agenda_tpu.models import AutoencoderKL as JaxVAE
from agenda_tpu.models import CLIPTextModel as JaxCLIP
from agenda_tpu.models import UNet2DConditionModel as JaxUNet
from agenda_tpu.train import finetune_sd as jtrain
from agenda_tpu.train import optim as joptim
from agenda_tpu_torch.annotate.records import load_predictions
from agenda_tpu_torch.cli import data_generation, det_test
from agenda_tpu_torch.cli import pipeline as port_pipeline
from agenda_tpu_torch.core.schedules import make_schedule
from agenda_tpu_torch.data.datasets import DataLoader
from agenda_tpu_torch.detect.configs import DatasetSpec, preset
from agenda_tpu_torch.detect.fabricate import (calibrate_batch_norm, fabricate_detector,
                                               write_square_set)
from agenda_tpu_torch.detect.families import build_family
from agenda_tpu_torch.detect.runner import DetectorRunner
from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline
from agenda_tpu_torch.io.fabricate import fabricate_pipeline, write_learned_embeds
from agenda_tpu_torch.io.diffusers_io import load_pipeline
from agenda_tpu_torch.parallel import mesh as pmesh
from agenda_tpu_torch.parallel.blocks import BlockRuns, block_runs
from agenda_tpu_torch.train import finetune_sd as ttrain
from agenda_tpu_torch.train.checkpoint import load_checkpoint
from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer
from agenda_tpu_torch.utils.png import read_png, write_png
from test_torch_det_families import (FRCNN, STEP64_GRAD_TOL_RMS, STEP64_LOSS_RTOL,
                                     _compare_step, _families, _jax_vars, _rel,
                                     _two_stage_draws, _weights)
from test_torch_det_train import GRAD_TOL_RMS, STATS_ATOL, STATS_RTOL
from test_torch_detect import _assert_records_match
from test_torch_device_aug import LOSS_RTOL, STEP2_RTOL
from test_torch_native import native_library  # noqa: F401 (the fixture)
from test_torch_orchestrator import _cfg as chain_config
from test_torch_orchestrator import make_chain_fixtures
from test_torch_token_train import METRIC_RTOL, _param_faults
from test_torch_train import LR, _jax_draws, _step_faults, _train_batch

PROMPT = "an aerial view image with cars in utah"
WORDS = ["cars", "utah"]
SEEDS = [0, 1]
RES = 32  # the tiny pipeline: 16x16 latents
GEN_KW = dict(num_inference_steps=3, height=RES, width=RES, out_size=112)
SD_STEPS = 2
FSDP_MIN = 512  # leaves of 512 elements shard here (84 of the tiny UNet's 208)
TOKEN_LR, TOKEN_STEPS = 1e-4, 2
# four samples: rank 0's both valid, rank 1's one (the regularizer's normalizer is 3)
TOKEN_STARTS = np.array([[3, 6, -1], [2, -1, 9], [4, 7, -1], [0, -1, 8]], np.int32)
DET_IMG, DET_MAX_GT = 64, 8
YOLO = dict(img_size=DET_IMG, max_gt=DET_MAX_GT)
# YOLOv8's f32 step split over two ranks against JAX's on two devices: the
# single-process limits of tests/test_torch_det_train.py for the gradients
# and statistics; for the loss and its parts that file's LOSS_RTOL (the port
# against JAX on one device) plus what each package's own split moves them,
# 1.1e-6 (the port, two ranks against one process) and 3.3e-6 (JAX, two
# devices against one), read on the largest of a YOLOv8n loss's parts.
SPLIT_LOSS_RTOL = 2 * LOSS_RTOL
DEADLINE_S = 300  # after the references: the ranks take about 60 s alone


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: extra intra-op threads in this process only contend with
    the ranks' and the other test workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax2():
    return jax_mesh.make_mesh(devices=jax.devices()[:2])


def _cli_args(pipe, embeds, out, batch):
    return ["--save-dir", out, "--pretrained-model-path", pipe,
            "--learnable-tokens-embedding-path", embeds,
            "--prompt", "an aerial view image with {} cars in {} utah",
            "--initialize_token", "cars", "utah", "--word_token_heatmaps", "cars",
            "--store_learnable_token_heatmaps", "--num-images", "3", "--batch-size", str(batch),
            "--num-inference-steps", "2", "--image-size", "112", "--resolution", str(RES)]


def _token_batch(bundle):
    rng = np.random.RandomState(6)
    s = bundle.unet_config.sample_size * 2
    return {"pixel_values": torch.from_numpy(rng.uniform(-1, 1, (4, s, s, 3)).astype(np.float32)),
            "input_ids": torch.from_numpy(rng.randint(0, bundle.text_config.vocab_size - 1,
                                                      (4, 77)).astype(np.int64)),
            "new_tokens_start": torch.from_numpy(TOKEN_STARTS)}


def _token_draws(shape, steps, seed=11):
    g = torch.Generator().manual_seed(seed)
    return [{"latent_eps": torch.randn(shape, generator=g), "noise": torch.randn(shape, generator=g),
             "timesteps": torch.randint(0, 1000, (shape[0],), generator=g)} for _ in range(steps)]


def _draw_dict(d):
    return {"latent_eps": d.latent_eps, "noise": d.noise, "timesteps": d.timesteps}


def _det_config(make, spec, train, out, batch):
    cfg = make("synthetic_heatmap", "yolov8", [spec(train, "ann.json")],
               img_scale=(DET_IMG, DET_IMG), max_gt=DET_MAX_GT, output_dir=out)
    cfg.runner.batch_size, cfg.runner.max_epochs, cfg.runner.log_interval = batch, 1, 1
    cfg.runner.close_mosaic_epochs, cfg.runner.device_aug = 0, True
    cfg.runner.warmup_bias_lr = cfg.runner.lr  # a step the size of the others
    os.makedirs(out, exist_ok=True)
    return cfg


def _box_batch(counts, img, max_gt, seed=3):
    """An image a count of ``counts`` with that many GT boxes (bright
    rectangles on noise); a rank's half then holds other box counts than
    the other's (different normalizers a rank)."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    image = rng.uniform(0, 0.3, (b, img, img, 3)).astype(np.float32)
    gt = np.zeros((b, max_gt, 4), np.float32)
    valid = np.zeros((b, max_gt), bool)
    for i, n in enumerate(counts):
        wh = rng.uniform(img / 6, img / 2, (n, 2))
        xy = rng.uniform(0, img - wh)
        gt[i, :n] = np.concatenate([xy, xy + wh], axis=1)
        valid[i, :n] = True
        for x1, y1, x2, y2 in gt[i, :n].astype(int):
            image[i, y1:y2, x1:x2] = rng.uniform(0.6, 1.0, 3)
    return {"image": image, "gt_boxes": gt, "gt_valid": valid}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, native_library):  # noqa: F811
    """Every job on two ranks, and this process's references meanwhile."""
    root = tmp_path_factory.mktemp("parallel")
    out = str(root / "results")
    os.makedirs(out)
    pipe = str(root / "pipe")
    fabricate_pipeline(pipe, tiny=True, seed=5)
    bundle = jax_load_pipeline(pipe)
    port_bundle = load_pipeline(pipe)
    embeds = str(root / "learned_embeds.bin")
    write_learned_embeds(embeds, port_bundle.text_config.hidden_size, seed=0)
    ref = {"root": root, "pipe": pipe, "out": out}

    # generation: the JAX latents of SEEDS
    jp = JaxPipeline.from_pretrained(pipe, dtype=jnp.float32)
    lat = np.asarray(jp._latents_fn(jnp.asarray(SEEDS, jnp.uint32), RES // 2, RES // 2))
    # the SD step: the JAX key stream's draws for a global batch of 2
    pixels, ids = _train_batch(bundle)
    sd_batch = {"pixel_values": torch.from_numpy(pixels),
                "input_ids": torch.from_numpy(ids.astype(np.int64))}
    key = jax.random.key(7)
    lat_shape = (2, bundle.unet_config.sample_size, bundle.unet_config.sample_size, 4)
    draws = [_draw_dict(_jax_draws(key, i, lat_shape, 1000)) for i in range(SD_STEPS + 1)]
    sd_kw = dict(pipe_dir=pipe, batch=sd_batch, lr=LR, generator_seeds=(17,))
    # the token step
    token_batch = _token_batch(port_bundle)
    token_draws = _token_draws((4,) + lat_shape[1:], TOKEN_STEPS)
    init_emb = 0.02 * np.random.default_rng(4).standard_normal(
        (3, port_bundle.text_config.hidden_size)).astype(np.float32)
    token_kw = dict(pipe_dir=pipe, batch=token_batch, draws=token_draws, lr=TOKEN_LR,
                    init_embedding=init_emb)
    # YOLOv8's runner: 8 tiles, a global batch of 4, one epoch of 2 steps
    train = str(root / "det_train")
    write_square_set(train, 8, seed=1)
    _, init = fabricate_detector(str(root / "det_init"), img_size=DET_IMG, batch_size=4)
    common = str(root / "det_init" / "common.safetensors")
    os.rename(init, common)
    port_cfg = _det_config(preset, DatasetSpec, train, str(root / "det_port"), 2)
    port_cfg_path = str(root / "det_port.json")
    port_cfg.to_json(port_cfg_path)
    # YOLOv8n's step in f32 over 4 images (boxes 1, 4 | 2, 2), calibrated weights
    yolo = build_family("yolov8", model=YOLO)
    gen = torch.Generator().manual_seed(0)
    yolo_state = calibrate_batch_norm(yolo, yolo.init_variables(gen),
                                      torch.rand(8, DET_IMG, DET_IMG, 3, generator=gen))
    yolo_batch = _box_batch((1, 4, 2, 2), DET_IMG, DET_MAX_GT)
    # Faster R-CNN's step in float64: the JAX draws for the global batch of 2
    jfam, fam = _families("faster-rcnn", FRCNN)
    flat, state = _weights(jfam, fam)
    frcnn_batch = _box_batch((1, 3), FRCNN["img_size"], FRCNN["max_gt"])
    n_rois = FRCNN["num_proposals"] + FRCNN["max_gt"]
    with jax.enable_x64(True):
        frcnn_draws = _two_stage_draws(jax.random.key(7), fam.anchors_np.shape[0], n_rois,
                                       three=False)
    # det_test: 10 tiles at batch 4 (the last batch padded; its rows on rank 0 only)
    data = str(root / "det_data")
    write_square_set(data, 10, seed=2)
    cfg_path, ckpt = fabricate_detector(str(root / "det_work"), img_size=64, batch_size=4,
                                        test=DatasetSpec(data, "ann.json"))
    test_args = ["--config", cfg_path, "--checkpoint", ckpt]
    # the SD CLI with --fsdp 2
    tiles = str(root / "tiles")
    os.makedirs(tiles)
    rng = np.random.RandomState(9)
    for i in range(4):
        write_png(os.path.join(tiles, f"{i}.png"), rng.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    with open(os.path.join(tiles, "train.json"), "w") as f:
        json.dump({f"{i}.png": "an aerial view image with cars in utah" for i in range(4)}, f)
    ft_args = ["--pretrained_model_name_or_path", pipe, "--dataset_folder", tiles,
               "--json_file_name", "train.json", "--output_dir", str(root / "ft"),
               "--resolution", str(RES), "--train_batch_size", "2", "--max_train_steps", "2",
               "--use_8bit_adam", "--use_ema", "--snr_gamma", "5", "--checkpointing_steps", "2",
               "--seed", "0", "--report_to", "jsonl", "--fsdp", "2"]
    ref["ft_out"] = str(root / "ft")
    # the same CLI at a global batch of 1, which the world of 2 does not divide
    ft1_args = [a if a != str(root / "ft") else str(root / "ft1") for a in ft_args]
    ft1_args[ft1_args.index("--train_batch_size") + 1] = "1"
    ft1_args[ft1_args.index("--max_train_steps") + 1] = "1"
    # the SD step under --fsdp 2 at a global batch of 1: both ranks take the sample
    sd1_batch = {k: v[:1] for k, v in sd_batch.items()}
    sd1_draws = [{k: v[:1] for k, v in d.items()} for d in draws[:SD_STEPS]]
    sd1_kw = dict(pipe_dir=pipe, batch=sd1_batch, draws=sd1_draws, lr=LR, generator_seeds=(17,))
    # the orchestrator's tiny chain up to the target's labels
    chain_root = str(root / "chain")
    make_chain_fixtures(chain_root)
    chain_cfg = chain_config(port_pipeline.PipelineConfig, chain_root)
    chain_path = os.path.join(chain_root, "cfg.json")
    chain_cfg.to_json(chain_path)
    ref["chain_cfg"] = chain_cfg

    jobs = [
        ("generation", "generation", dict(pipe_dir=pipe, prompt=PROMPT, seeds=SEEDS, words=WORDS,
                                          latents=lat, kw=GEN_KW,
                                          cli_argv=_cli_args(pipe, embeds, str(root / "gen2"), 1))),
        ("sd_fsdp1", "sd", dict(fsdp=1, draws=draws[:SD_STEPS], **sd_kw)),
        ("sd_fsdp2", "sd", dict(fsdp=2, draws=draws[:SD_STEPS], fsdp_min=FSDP_MIN,
                                ckpt_dir=str(root / "ckpt"), after_ckpt=draws[SD_STEPS:],
                                **sd_kw)),
        ("token", "token", token_kw),
        ("yolov8_step", "family_step", dict(name="yolov8", model=YOLO, state=yolo_state,
                                            batch=_tensors(yolo_batch), dtype=torch.float32)),
        ("two_stage", "family_step", dict(name="faster-rcnn", model=FRCNN, state=state,
                                          batch=_tensors(frcnn_batch), draws=frcnn_draws)),
        ("split_draws", "split_draws", dict(name="faster-rcnn", model=FRCNN, seed=3,
                                            batch=_tensors(_split_draws_batch()))),
        ("runner_train", "runner_train", dict(config_json=port_cfg_path, resume=common)),
        ("det_test", "det_test", dict(argv=test_args + ["--out", str(root / "w2.pkl")])),
        ("finetune_cli", "finetune_cli", dict(argv=ft_args)),
        ("sd_fsdp2_b1", "sd", dict(fsdp=2, fsdp_min=FSDP_MIN, **sd1_kw)),
        ("finetune_cli_b1", "finetune_cli", dict(argv=ft1_args)),
        ("chain", "chain", dict(argv=["--config", chain_path, "--device", "cpu",
                                      "--until-stage", "label_synthetic_target"])),
    ]
    procs = W.start_ranks(jobs, out)
    try:
        # generation: JAX on the 2-device mesh, the port in one process
        jp.mesh = _jax2()
        ref["gen_jax"] = jp(PROMPT, SEEDS, words=WORDS, **GEN_KW)
        tp = StableDiffusionPipeline.from_pretrained(pipe, device="cpu")
        ref["gen_port"] = tp(PROMPT, SEEDS, words=WORDS, latents=lat, **GEN_KW)
        ref["gen_tgate"] = tp(PROMPT, SEEDS, words=WORDS, latents=lat, tgate_step=1, **GEN_KW)
        data_generation.main(_cli_args(pipe, embeds, str(root / "gen1"), 2) + ["--device", "cpu"])
        # the SD step: JAX on the 2-device mesh, the port in one process
        ref["sd_jax"] = _jax_sd_steps(bundle, pixels, ids, key)
        ref["sd_port"], _ = W.sd_run(draws=draws[:SD_STEPS], **sd_kw)
        ref["sd_draws"] = draws
        ref["sd1_port"], _ = W.sd_run(**sd1_kw)
        # the token step in one process
        ref["token"] = W.token_run(**token_kw)
        # YOLOv8's runner in one process over the same global batch of 4
        cfg1 = _det_config(preset, DatasetSpec, train, str(root / "det_one"), 4)
        runner = DetectorRunner(cfg1.build_family(), cfg1.runner, device="cpu")
        ref["runner_one"] = runner.train(cfg1.build_train_dataset(), resume=common)
        with open(root / "det_one" / "metrics.jsonl") as f:
            ref["runner_losses"] = [r for r in map(json.loads, f) if "loss" in r]
        # the detector steps: JAX's loss and gradients on the 2-device mesh
        jyolo = jax_build_family("yolov8", model=dict(YOLO))
        ref["yolov8_step"] = _jax_family_step(jyolo, yolo.to_flax(yolo_state), yolo_batch,
                                              None, np.float32)
        with jax.enable_x64(True):
            jfam.model = JaxFasterRCNN(jfam.config, dtype=jnp.float64)
            ref["two_stage"] = _jax_family_step(jfam, flat, frcnn_batch, jax.random.key(7),
                                                np.float64)
        # det_test in one process
        ref["det_test"] = det_test.main(test_args + ["--out", str(root / "w1.pkl"),
                                                     "--device", "cpu"])
        ref["w2_pkl"] = str(root / "w2.pkl")
    finally:
        W.join_ranks(procs, DEADLINE_S)
    return ref


def _jax_sd_steps(bundle, pixels, ids, key):
    """SD_STEPS steps of the JAX fine-tune (fused int8 AdamW + EMA) with the
    batch sharded over a 2-device mesh: per step (params, EMA) in the port's
    layout and the metrics."""
    from test_torch_train import _port_view

    mesh = _jax2()
    cfg = bundle.unet_config
    tx = joptim.make_optimizer(joptim.lr_schedule("constant", LR, 0, 100), use_8bit_adam=True,
                               fused=True)
    state = jax_mesh.replicate(jtrain.init_train_state(bundle.unet_params, tx, use_ema=True),
                               mesh)
    step = jax.jit(jtrain.make_train_step(
        JaxUNet(cfg), JaxVAE(bundle.vae_config), JaxCLIP(bundle.text_config),
        jsched.make_schedule(), tx, jtrain.LossConfig(snr_gamma=5.0), use_ema=True))
    batch = jax_mesh.shard_batch({"pixel_values": pixels, "input_ids": ids}, mesh)
    vae, text = (jax_mesh.replicate(p, mesh) for p in (bundle.vae_params, bundle.text_params))
    out = []
    for _ in range(SD_STEPS):
        state, metrics = step(state, vae, text, batch, key)
        out.append((*_port_view(state), {k: float(v) for k, v in metrics.items()}))
    return out


def _jax_family_step(jfam, flat, batch, rng, dtype):
    """A JAX family's loss, parts, gradients and new statistics (flax names)
    with the batch sharded over a 2-device mesh."""
    jv = _jax_vars(flat, dtype)
    mesh = _jax2()
    sharded = jax_mesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)

    def lf(p):
        loss, (metrics, bs) = jfam.loss_fn({"params": p, "batch_stats": jv["batch_stats"]},
                                           sharded, rng)
        return loss, (metrics, bs)

    (loss, (metrics, bs)), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        jax_mesh.replicate(jv["params"], mesh))
    g = {"params." + ".".join(k): np.asarray(v) for k, v in jax_flatten(grads).items()}
    s = {"batch_stats." + ".".join(k): np.asarray(v) for k, v in jax_flatten(bs).items()}
    return float(loss), {k: float(v) for k, v in metrics.items()}, g, s


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _split_draws_batch():
    return _box_batch((1, 3, 2, 2), FRCNN["img_size"], FRCNN["max_gt"])


# -- the mesh and its leaf rules (no ranks) ----------------------------------------


def test_make_mesh_at_world_1_is_the_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.fsdp, mesh.world, mesh.rank, mesh.backend) == (1, 1, 1, 0, None)
    assert mesh.rows(6) == slice(0, 6)
    batch = {"x": np.arange(6), "s": np.float32(2)}
    assert pmesh.shard_batch(batch, mesh)["x"].tolist() == list(range(6))
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.make_mesh(fsdp=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 != 1"):
        pmesh.make_mesh(dp=2, device="cpu")
    t = torch.ones(3, requires_grad=True)
    with pmesh.batch_split(mesh):  # world 1: no split, no collective
        assert pmesh.split_mesh() is None
        assert pmesh.global_sum(t) is t and pmesh.global_rows(3) == (3, slice(None))
        assert torch.equal(pmesh.batch_mean(torch.arange(4.0)), torch.tensor(1.5))


def test_leaf_selection_and_block_runs_match_the_jax_rules():
    """At a min_size low enough that leaves shard, the port selects exactly
    the leaves for which agenda_tpu's param_sharding_rules gives a non-empty
    spec, on the tiny UNet's shapes (and a few made up); each selected leaf's
    fsdp runs cover it once, at 256-element block boundaries."""
    from jax.sharding import PartitionSpec as P

    from agenda_tpu_torch.io.configs import UNetConfig
    from agenda_tpu_torch.models.unet import UNet2DConditionModel

    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.tiny())
    shapes = {k: tuple(p.shape) for k, p in unet.named_parameters()}
    shapes.update({"odd": (3, 5, 7, 11), "ragged": (1000, 77), "flat": (300,), "scalar": ()})
    for fsdp in (2, 4):
        jmesh = jax_mesh.make_mesh(dp=1, fsdp=fsdp, devices=jax.devices()[:fsdp])
        leaves = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        specs = jax_mesh.param_sharding_rules(leaves, jmesh, min_size=FSDP_MIN)
        rules = pmesh.param_sharding_rules(shapes, fsdp, min_size=FSDP_MIN)
        want = {k for k, s in specs.items() if s.spec != P()}
        assert {k for k, axis in rules.items() if axis is not None} == want
        assert {"ragged", "conv_in.weight"} <= want and "odd" not in want
        for k in want:  # the axis is JAX's too
            assert s_axis(specs[k].spec) == rules[k], k
        for rank in range(fsdp):
            mesh = pmesh.Mesh(dp=1, fsdp=fsdp, rank=rank, device=torch.device("cpu"))
            runs = BlockRuns({k: torch.empty(s) for k, s in shapes.items()}, mesh, FSDP_MIN)
            assert set(runs.sharded) == want
    for n in (1152, 77000, 73728, 65536 + 1, 300):
        for fsdp in (2, 3, 4):
            runs = block_runs(n, fsdp)
            assert runs[0][0] == 0 and runs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))  # contiguous, once
            nonempty = [(s, e) for s, e in runs if e > s]
            assert all(s % 256 == 0 for s, e in nonempty)  # whole blocks
            assert all(e % 256 == 0 for s, e in nonempty if e < n)
            per = -(-(-(-n // 256)) // fsdp) * 256  # ceil(blocks / fsdp) blocks a run
            assert max(e - s for s, e in runs) <= per


def s_axis(spec):
    return next(i for i, a in enumerate(spec) if a is not None)


def test_loader_rows_are_the_single_process_rows(tmp_path):
    """Each rank's rows of the detector's host-augmented global batch are
    the ones one process reads (the augmentation seeds count the calls, and
    the rows a rank skips are counted through skip_call)."""
    train = str(tmp_path / "t")
    write_square_set(train, 7, seed=1)
    cfg = preset("synthetic_heatmap", "yolov8", [DatasetSpec(train, "ann.json")],
                 img_scale=(64, 64), max_gt=8)

    def batches(rows):
        loader = DataLoader(cfg.build_train_dataset(), 4, shuffle=True, seed=3, num_workers=1,
                            pad_to_full=True, rows=rows)
        return [b for _ in range(2) for b in loader]  # two epochs

    whole = batches(None)
    halves = [batches(slice(0, 2)), batches(slice(2, 4))]
    assert len(whole) == 4
    for i, b in enumerate(whole):
        for k in ("image", "gt_boxes", "gt_valid"):
            np.testing.assert_array_equal(np.concatenate([halves[0][i][k], halves[1][i][k]]),
                                          b[k], err_msg=k)


# -- two ranks -----------------------------------------------------------------


def test_generation_over_two_ranks_matches_one_process_and_the_jax_mesh(ranks):
    """1 seed a rank: each rank's images and word maps are the one-process
    batch's rows and the JAX pipeline's on its 2-device mesh; TGATE splits
    the same way; the CLI at --batch-size 1 a rank writes the file tree one
    process writes at --batch-size 2."""
    got = W.result(ranks["out"], "generation")
    assert [g["rows"] for g in got] == [slice(0, 1), slice(1, 2)]
    images = np.concatenate([g["exact"][0] for g in got])
    maps = {w: np.concatenate([g["exact"][1][w] for g in got]) for w in WORDS}
    for want_images, want_maps in (ranks["gen_port"], ranks["gen_jax"]):
        assert images.shape == want_images.shape == (2, 112, 112, 3)
        assert np.abs(images.astype(int) - want_images.astype(int)).max() <= 1
        for w in WORDS:
            assert np.abs(maps[w].astype(int) - np.asarray(want_maps[w]).astype(int)).max() <= 1
    tg_images = np.concatenate([g["tgate"][0] for g in got])
    assert np.abs(tg_images.astype(int) - ranks["gen_tgate"][0].astype(int)).max() <= 1
    root = ranks["root"]

    def tree(d):
        return sorted(os.path.relpath(os.path.join(p, f), d)
                      for p, _, files in os.walk(d) for f in files)

    one, two = str(root / "gen1"), str(root / "gen2")
    assert tree(one) == tree(two) and len(tree(one)) == 3 * 4  # images + 3 heatmap words
    for rel in tree(one):
        a, b = read_png(os.path.join(one, rel)), read_png(os.path.join(two, rel))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, rel


@pytest.mark.parametrize("job", ["sd_fsdp1", "sd_fsdp2"])
def test_sd_step_over_two_ranks_matches_one_process_and_the_jax_mesh(ranks, job):
    """Two steps on the JAX key stream's draws (a rank's rows of them) and one
    on the step's own generator (the global batch's draws, a rank's rows)
    against one process over the same global batch of 2, the first two also
    against the JAX step on its 2-device mesh; both ranks hold the same
    parameters and EMA. Under --fsdp 2 the optimizer state and EMA of 84
    leaves are a rank's block runs."""
    (steps0, info0), (steps1, info1) = W.result(ranks["out"], job)
    steps0 = steps0[:SD_STEPS + 1]
    assert _step_faults([s + (None,) for s in ranks["sd_port"]], steps0) == []
    assert _step_faults([s + (None,) for s in ranks["sd_jax"]], steps0[:SD_STEPS]) == []
    for a, b in zip(steps0, steps1):
        for k in a[0]:
            assert torch.equal(a[0][k], b[0][k]) and torch.equal(a[1][k], b[1][k]), k
    total = sum(p.numel() for p in steps0[0][0].values())
    if job == "sd_fsdp1":
        assert info0["sharded"] == [] and info0["opt_numel"] == info0["ema_numel"] == total
    else:
        assert len(info0["sharded"]) == 84 and "conv_in.weight" in info0["sharded"]
        assert info0["opt_numel"] + info1["opt_numel"] < 1.1 * total  # runs, not copies
        assert max(info0["ema_numel"], info1["ema_numel"]) < 0.75 * total


def test_fsdp2_at_a_global_batch_of_1_matches_one_process(ranks):
    """--fsdp 2 on two ranks at a global batch of 1, which the world does not
    divide: the batch splits over dp alone (JAX's ``P("dp")``), both ranks
    take the sample, and the gradient counts it once. Two steps on given
    draws and one on the step's own generator against one process, within
    ``_step_faults``; both ranks hold the same parameters and EMA, and the
    optimizer state is still split in block runs. The CLI at
    ``--train_batch_size 1 --fsdp 2`` trains."""
    (steps0, info0), (steps1, info1) = W.result(ranks["out"], "sd_fsdp2_b1")
    assert len(steps0) == len(ranks["sd1_port"]) == SD_STEPS + 1
    assert _step_faults([s + (None,) for s in ranks["sd1_port"]], steps0) == []
    for a, b in zip(steps0, steps1):
        for k in a[0]:
            assert torch.equal(a[0][k], b[0][k]) and torch.equal(a[1][k], b[1][k]), k
    assert len(info0["sharded"]) == 84
    total = sum(p.numel() for p in steps0[0][0].values())
    assert info0["opt_numel"] + info1["opt_numel"] < 1.1 * total
    cli = W.result(ranks["out"], "finetune_cli_b1")
    assert cli[0] == cli[1]
    assert cli[0]["steps"] == cli[0]["global_step"] == 1 and np.isfinite(cli[0]["losses"]).all()


def test_fsdp2_checkpoint_resumes_at_world_1(ranks):
    """The --fsdp 2 ranks' checkpoint after 3 steps, loaded by one process:
    the gathered parameters and EMA exactly, the counters, and a fourth step
    from it against the ranks' fourth step (step 1's limits: both start from
    the same state)."""
    (steps0, _), _ = W.result(ranks["out"], "sd_fsdp2")
    _, unet, vae, text = W.port_models(ranks["pipe"])
    tx = make_optimizer(lr_schedule("constant", LR, 0, 100), use_8bit_adam=True)
    state = ttrain.init_train_state(unet, tx, True)
    load_checkpoint(str(ranks["root"] / "ckpt" / f"checkpoint-{SD_STEPS + 1}"), state)
    params, ema, _ = steps0[SD_STEPS]
    for k, p in state.params.items():
        assert torch.equal(p.detach(), params[k]) and torch.equal(state.ema.params[k], ema[k]), k
    assert state.step == SD_STEPS + 1 == int(state.ema.step) == int(state.opt_state.count)
    step = ttrain.make_train_step(unet, vae, text, make_schedule(), tx,
                                  ttrain.LossConfig(snr_gamma=5.0), use_ema=True)
    pixels, ids = _train_batch(jax_load_pipeline(ranks["pipe"]))
    batch = {"pixel_values": torch.from_numpy(pixels),
             "input_ids": torch.from_numpy(ids.astype(np.int64))}
    state, metrics = step(state, batch, draws=ttrain.StepDraws(**ranks["sd_draws"][SD_STEPS]))
    got = ({k: p.detach().clone() for k, p in state.params.items()},
           {k: e.clone() for k, e in state.ema.params.items()},
           {k: float(v) for k, v in metrics.items()})
    assert _step_faults([steps0[SD_STEPS + 1] + (None,)], [got]) == []


def test_token_step_over_two_ranks_matches_one_process(ranks):
    """Two stage-1 steps at a global batch of 4, whose halves hold 2 and 1
    valid samples: the regularizer divides by the global 3 and the metrics,
    the UNet and the embedding are one process's."""
    got, other = W.result(ranks["out"], "token")
    faults = []
    for i, ((p, emb, m), (wp, wemb, wm)) in enumerate(zip(got, ranks["token"]), start=1):
        for key in ("loss", "mse", "attn_loss", "fg_loss", "bg_loss"):
            if abs(m[key] - wm[key]) > METRIC_RTOL * abs(wm[key]):
                faults.append((i, key, m[key], wm[key]))
        faults += _param_faults(i, p, wp) + _param_faults(i, {"e": emb}, {"e": wemb})
    assert faults == []
    assert got[0][2]["attn_loss"] > 0 and other[-1][2] == got[-1][2]


def test_yolov8_step_over_two_ranks_matches_the_jax_mesh(ranks):
    """YOLOv8n's f32 step over 4 images, 2 a rank (boxes 1, 4 | 2, 2): the
    global batch-norm statistics, the TAL normalizer and the global batch
    size make the ranks' summed loss and gradients and their statistics
    JAX's on its 2-device mesh."""
    got, other = W.result(ranks["out"], "yolov8_step")
    loss, parts, grads, stats = got
    jloss, jparts, jgrads, jstats = ranks["yolov8_step"]
    assert loss == pytest.approx(jloss, rel=SPLIT_LOSS_RTOL)
    assert set(parts) == {"cls", "iou", "dfl"} and other == (loss, parts)
    for k in parts:
        assert parts[k] == pytest.approx(jparts[k], rel=SPLIT_LOSS_RTOL), k
    assert set(grads) == set(jgrads) and set(stats) == set(jstats)
    worst = max((_rel(grads[k], jgrads[k]), k) for k in jgrads if np.any(jgrads[k]))
    assert worst[0] <= GRAD_TOL_RMS, worst
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=k)


def test_yolov8_runner_train_over_two_ranks_matches_one_process(ranks):
    """DetectorRunner.train (device augmentation, batch 2 a rank, one epoch of
    2 steps) against one process over the same global batch of 4: the logged
    losses (step 1 within LOSS_RTOL, step 2 within STEP2_RTOL); both ranks end
    with the same variables. The weights themselves are not compared: after
    two steps this fresh YOLOv8n's moves follow f32 summation order (one
    process at another thread count moves some kernels by more than their
    rms), as tests/test_torch_device_aug.py compares losses only."""
    got = W.result(ranks["out"], "runner_train")
    assert got[0]["aug_path"] == "device"
    losses, want = got[0]["losses"], ranks["runner_losses"]
    assert [r["step"] for r in losses] == [r["step"] for r in want] == [1, 2]
    for (g, w), rtol in zip(zip(losses, want), (LOSS_RTOL, STEP2_RTOL)):
        for k in ("loss", "cls", "iou", "dfl"):
            assert g[k] == pytest.approx(w[k], rel=rtol), (g["step"], k)
    assert set(got[0]["final"]) == set(ranks["runner_one"])
    for k, v in got[0]["final"].items():
        assert torch.equal(v, got[1]["final"][k]), k


def test_faster_rcnn_step_over_two_ranks_matches_the_jax_mesh_in_float64(ranks):
    """One image a rank, with 1 and 3 GT boxes: the global batch-norm
    statistics, the RCNN's global normalizer and the per-image RPN means
    make the ranks' summed loss and gradients JAX's on its 2-device mesh."""
    got = W.result(ranks["out"], "two_stage")
    _compare_step(got[0], ranks["two_stage"], STEP64_LOSS_RTOL, STEP64_GRAD_TOL_RMS,
                  ("rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg"))
    assert got[0][0] == got[1][0] and min(got[0][1].values()) > 0


def test_two_stage_and_drop_path_draws_over_two_ranks_are_the_global_rows(ranks):
    """Faster R-CNN's samplers' uniforms and ViTDet's drop-path mask drawn on
    two ranks (two images each) are one process's draws for the global batch
    of 4, each rank's rows of them."""
    got = W.result(ranks["out"], "split_draws")
    want = W.split_draws("faster-rcnn", FRCNN, _tensors(_split_draws_batch()), 3)
    assert set(want) == {"rpn_pos", "rpn_neg", "rcnn_pos", "rcnn_neg", "drop_path"}
    for r, g in enumerate(got):
        assert set(g) == set(want)
        for k, v in want.items():
            assert torch.equal(g[k], v[2 * r:2 * r + 2]), (r, k)


def test_det_test_over_two_ranks_writes_the_one_process_records(ranks):
    """10 tiles at batch 4: each batch split over the ranks (the last, 2
    tiles, all on rank 0); rank 0's prediction.pkl holds one process's
    records in its order."""
    n = W.result(ranks["out"], "det_test")
    assert n == [10, 10]
    _assert_records_match(load_predictions(ranks["w2_pkl"]), ranks["det_test"])


def test_finetune_cli_with_fsdp_2_trains_checkpoints_and_exports(ranks):
    """finetune_sd.main --fsdp 2 on two ranks: 2 steps of the global batch
    of 2, checkpoint-2 in the one-card layout, the export loads."""
    got = W.result(ranks["out"], "finetune_cli")
    assert got[0] == got[1]  # every rank's metrics are the global batch's
    assert got[0]["steps"] == got[0]["global_step"] == got[0]["ema_step"] == 2
    assert all(np.isfinite(got[0]["losses"]))
    out = ranks["ft_out"]
    assert sorted(os.listdir(os.path.join(out, "checkpoint-2"))) == ["train_state", "unet",
                                                                     "unet_ema"]
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    exported = load_pipeline(out)
    start = load_pipeline(ranks["pipe"])
    assert set(exported.unet_state) == set(start.unet_state)
    assert any(not torch.equal(exported.unet_state[k], start.unet_state[k])
               for k in start.unet_state)


def test_pipeline_over_two_ranks_runs_the_chain_to_the_target_labels(ranks):
    """cli/pipeline on two ranks: the fine-tunes, generation, detector
    training and labelling on both ranks, the host stages on rank 0 alone;
    one manifest line a stage, and the stages' outputs."""
    assert W.result(ranks["out"], "chain") == [0, 0]
    cfg = ranks["chain_cfg"]
    wd = cfg.work_dir
    names = [s.name for s in port_pipeline.build_stages(cfg)]
    with open(os.path.join(wd, "pipeline_manifest.jsonl")) as f:
        entries = [json.loads(line) for line in f]
    assert [e["stage"] for e in entries] == names[: names.index("label_synthetic_target") + 1]
    assert os.path.exists(os.path.join(wd, "sd-finetune", "model_index.json"))
    assert len(os.listdir(os.path.join(wd, "Synthetic", "LINZ-with-cars", "images"))) == 4
    assert os.path.isdir(os.path.join(wd, "Synthetic", "UGRC-with-cars", "daam_stack_heatmaps"))
    pred = os.path.join(wd, "work_dirs", "yolov8_synthetic_heatmap", "prediction_syn_target.pkl")
    assert len(load_predictions(pred)) == 4
