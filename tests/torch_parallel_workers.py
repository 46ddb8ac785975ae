"""The ranks of ``tests/test_torch_parallel.py``: jobs that run in spawned
processes, one a rank, over a gloo process group on the CPU.

This module imports torch and the port only (a spawned rank imports it to
find its job): the JAX side of each comparison stays in the test process.
``start_ranks`` spawns the ranks with ``torchrun``'s environment (each call
its own free port) and returns at once, so the test process can compute its
references while the ranks run; ``join_ranks`` waits for them within a
deadline, kills a rank that hangs, and raises a rank's error with its
traceback. Each job returns a picklable result, which rank r writes to
``<out>/<job>.<r>.pt``.
"""

from __future__ import annotations

import os
import socket
import time
import traceback
from typing import Dict, List

import torch

RANK_TIMEOUT_S = 120  # a collective that waits longer than this fails its rank


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(jobs: List[tuple], out: str, world: int = 2):
    """Spawn ``world`` ranks that run ``jobs`` ((tag, job name, kwargs)) in
    order; a job's result is read back by its tag."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(jobs, rank, world, port, out), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, deadline_s: float) -> None:
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"{len(hung)} rank(s) still running after {deadline_s} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")


def result(out: str, job: str, world: int = 2) -> List:
    """Every rank's result of the job tagged ``job``; a rank's error raises
    with its traceback."""
    got = []
    for rank in range(world):
        path = os.path.join(out, f"{job}.{rank}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {rank} wrote no result for {job}")
        r = torch.load(path, weights_only=False)
        if "error" in r:
            raise RuntimeError(f"rank {rank}, {job}:\n{r['error']}")
        got.append(r["ok"])
    return got


def _rank_main(jobs, rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from agenda_tpu_torch.parallel.mesh import make_mesh

    make_mesh(device="cpu", backend="gloo", timeout_s=RANK_TIMEOUT_S)
    try:
        for tag, name, kw in jobs:
            try:
                res = {"ok": JOBS[name](**kw)}
            except Exception:
                res = {"error": traceback.format_exc()}
            torch.save(res, os.path.join(out, f"{tag}.{rank}.pt"))
            if "error" in res:
                return  # the other ranks fail at their next collective
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


# -- shared by the ranks and the test process -------------------------------------


def port_models(pipe_dir: str):
    """The tiny pipeline's UNet (train mode), VAE and text encoder in f32 on
    the CPU, from the port's own loader."""
    from agenda_tpu_torch.io.diffusers_io import load_pipeline
    from agenda_tpu_torch.models.clip_text import CLIPTextModel
    from agenda_tpu_torch.models.unet import UNet2DConditionModel
    from agenda_tpu_torch.models.vae import AutoencoderKL

    bundle = load_pipeline(pipe_dir)

    def strict(cls, cfg, state):
        m = cls(cfg)
        m.load_state_dict({k: v.float().clone() for k, v in state.items()}, strict=True)
        return m

    unet = strict(UNet2DConditionModel, bundle.unet_config, bundle.unet_state).train()
    vae = strict(AutoencoderKL, bundle.vae_config, bundle.vae_state).eval().requires_grad_(False)
    text = strict(CLIPTextModel, bundle.text_config,
                  bundle.text_state).eval().requires_grad_(False)
    return bundle, unet, vae, text


def _rows(tensors: Dict[str, torch.Tensor], rows) -> Dict[str, torch.Tensor]:
    return {k: v[rows] for k, v in tensors.items()}


def sd_run(pipe_dir: str, batch, draws, lr: float, mesh=None, fsdp_min: int = 2 ** 16,
           generator_seeds=(), ckpt_dir=None, after_ckpt=()):
    """Steps of the SD fine-tune (fused int8 AdamW + EMA, snr_gamma 5) over the
    global ``batch``, this rank's rows of it: one step a draw of ``draws``
    (global StepDraws fields as dicts), then one a seed of
    ``generator_seeds`` with the step's own draws; with ``ckpt_dir`` a
    checkpoint there after those, then a step a draw of ``after_ckpt``.
    Per step: (params, EMA shadow, metrics), the one-card layout. A global
    batch that the world does not divide splits over dp alone
    (``Mesh.for_batch``)."""
    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.train import finetune_sd as ttrain
    from agenda_tpu_torch.train.checkpoint import full_ema, snapshot_state, write_checkpoint
    from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer

    bundle, unet, vae, text = port_models(pipe_dir)
    if mesh is not None:  # over dp alone when the world does not divide the batch
        mesh = mesh.for_batch(len(batch["input_ids"]))
    tx = make_optimizer(lr_schedule("constant", lr, 0, 100), use_8bit_adam=True)
    state = ttrain.init_train_state(unet, tx, True, mesh, min_shard_size=fsdp_min)
    step = ttrain.make_train_step(unet, vae, text, make_schedule(), tx,
                                  ttrain.LossConfig(snr_gamma=5.0), use_ema=True, mesh=mesh)
    rows = slice(None) if mesh is None else mesh.rows(len(batch["input_ids"]))
    local = _rows(batch, rows)
    out = []

    def record(metrics):
        out.append(({k: p.detach().clone() for k, p in state.params.items()},
                    {k: e.detach().clone() for k, e in full_ema(state).items()},
                    {k: float(v) for k, v in metrics.items()}))

    for d in draws:
        state, metrics = step(state, local, draws=ttrain.StepDraws(**_rows(d, rows)))
        record(metrics)
    for s in generator_seeds:
        state, metrics = step(state, local, generator=torch.Generator().manual_seed(s))
        record(metrics)
    info = {"opt_numel": sum(p.numel() for p in state.opt_params.values()),
            "ema_numel": sum(e.numel() for e in state.ema.params.values()),
            "sharded": [] if state.shard is None else state.shard.sharded}
    if ckpt_dir is not None:
        snap = snapshot_state(state)
        if mesh is None or mesh.is_main:
            write_checkpoint(ckpt_dir, state.step, bundle.unet_config, snap, None)
        for d in after_ckpt:
            state, metrics = step(state, local, draws=ttrain.StepDraws(**_rows(d, rows)))
            record(metrics)
    return out, info


def token_run(pipe_dir: str, batch, draws, lr: float, init_embedding, mesh=None):
    """Stage-1 token steps (tokens + UNet + the regularizer, f32 AdamW) over
    this rank's rows of the global ``batch``: per step (UNet params,
    embedding, metrics)."""
    from agenda_tpu_torch.core.schedules import make_schedule
    from agenda_tpu_torch.train import finetune_sd as ttrain
    from agenda_tpu_torch.train import finetune_sd_token as ttok
    from agenda_tpu_torch.train.optim import lr_schedule, make_optimizer

    bundle, unet, vae, text = port_models(pipe_dir)
    tx = make_optimizer(lr_schedule("constant", lr, 0, 100), max_grad_norm=None)
    state = ttok.init_token_train_state(unet, tx, True, True, False, n_tokens=3,
                                        hidden_size=bundle.text_config.hidden_size,
                                        init_embedding=init_embedding)
    cfg = ttok.TokenLossConfig(snr_gamma=5.0, with_cross_attn_reg=True, reg_weight=0.5,
                               train_token=True, max_grad_norm=1.0)
    step = ttok.make_token_train_step(unet, vae, text, make_schedule(), tx, cfg, mesh=mesh)
    rows = slice(None) if mesh is None else mesh.rows(len(batch["input_ids"]))
    local = _rows(batch, rows)
    out = []
    for d in draws:
        state, metrics = step(state, local, draws=ttrain.StepDraws(**_rows(d, rows)))
        params = ttok.merge_params(state.unet_trainable, state.unet_frozen)
        out.append(({k: p.detach().clone() for k, p in params.items()},
                    state.embedding.detach().clone(), {k: float(v) for k, v in metrics.items()}))
    return out


def family_step(name: str, model: dict, state: Dict[str, torch.Tensor], batch, draws=None,
                dtype=torch.float64, mesh=None):
    """A detector family's loss, parts, gradients (flax names, summed over
    the ranks) and new batch statistics in ``dtype`` from this rank's rows
    of the global ``batch`` (and ``draws``, a two-stage family's samplers'
    uniforms)."""
    from agenda_tpu_torch.detect.families import build_family
    from agenda_tpu_torch.parallel.mesh import all_reduce_sum_, batch_split

    fam = build_family(name, model=dict(model))
    state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    params = {k: state[k].clone().requires_grad_(True) for k in fam.param_names}
    rows = slice(None) if mesh is None else mesh.rows(len(batch["gt_boxes"]))
    tb = _rows({"image": batch["image"].to(dtype), "gt_boxes": batch["gt_boxes"],
                "gt_valid": batch["gt_valid"]}, rows)
    names = list(params)
    with batch_split(mesh):
        if draws is None:
            loss, parts, stats = fam.loss_fn({**state, **params}, tb)
        else:
            loss, parts, stats = fam.loss_with_draws(
                {**state, **params}, tb, _rows({k: v.to(dtype) for k, v in draws.items()}, rows))
        grads = torch.autograd.grad(loss, [params[k] for k in names])
    vals = torch.stack([loss.detach()] + [parts[k].detach() for k in sorted(parts)])
    if mesh is not None:
        all_reduce_sum_(list(grads) + [vals], mesh)
    return (float(vals[0]), dict(zip(sorted(parts), vals[1:].tolist())),
            fam.to_flax(dict(zip(names, grads))),
            fam.to_flax({k: v.detach() for k, v in stats.items()}))


def split_draws(name: str, model: dict, batch, seed: int, mesh=None):
    """A two-stage family's samplers' uniforms and ViTDet's drop-path mask
    for this rank's rows of ``batch``, from a generator seeded ``seed``."""
    from agenda_tpu_torch.detect.families import build_family
    from agenda_tpu_torch.detect.vitdet import drop_path
    from agenda_tpu_torch.parallel.mesh import batch_split

    fam = build_family(name, model=dict(model))
    rows = slice(None) if mesh is None else mesh.rows(len(batch["gt_boxes"]))
    gen = torch.Generator().manual_seed(seed)
    with batch_split(mesh):
        draws = fam.draw(gen, _rows(batch, rows))
        kept = drop_path(torch.ones(len(batch["gt_boxes"][rows]), 1, 1, 1), 0.5, gen)
    return {**draws, "drop_path": kept}


# -- the jobs -------------------------------------------------------------------


def _mesh(fsdp: int = 1):
    from agenda_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(fsdp=fsdp, device="cpu", backend="gloo")


def job_generation(pipe_dir: str, prompt: str, seeds, words, latents, kw: dict, cli_argv):
    """This rank's rows of the exact and the TGATE sampler's batch, then the
    generation CLI split over the ranks."""
    from agenda_tpu_torch.cli import data_generation
    from agenda_tpu_torch.generate.pipeline import StableDiffusionPipeline

    mesh = _mesh()
    pipe = StableDiffusionPipeline.from_pretrained(pipe_dir, device="cpu")
    pipe.mesh = mesh
    exact = pipe(prompt, seeds, words=words, latents=latents, **kw)
    tgate = pipe(prompt, seeds, words=words, latents=latents, tgate_step=1, **kw)
    data_generation.main(cli_argv + ["--device", "cpu", "--dist-backend", "gloo"])
    return {"rows": mesh.rows(len(seeds)), "exact": exact, "tgate": tgate}


def job_sd(**kw):
    mesh = _mesh(kw.pop("fsdp"))
    return sd_run(mesh=mesh, **kw)


def job_token(**kw):
    return token_run(mesh=_mesh(), **kw)


def job_family_step(**kw):
    mesh = _mesh()
    out = family_step(mesh=mesh, **kw)
    return out if mesh.is_main else out[:2]  # the summed loss and parts on every rank


def job_split_draws(**kw):
    return split_draws(mesh=_mesh(), **kw)


def job_runner_train(config_json: str, resume: str):
    """``DetectorRunner.train`` from a config, over the ranks: rank 0's logged
    losses and the final variables."""
    import json

    from agenda_tpu_torch.detect.configs import DetectionConfig
    from agenda_tpu_torch.detect.runner import DetectorRunner

    cfg = DetectionConfig.from_json(config_json)
    runner = DetectorRunner(cfg.build_family(), cfg.runner, mesh=_mesh())
    final = runner.train(cfg.build_train_dataset(), resume=resume)
    path = os.path.join(cfg.runner.output_dir, "metrics.jsonl")
    losses = []
    if runner.is_main:
        with open(path) as f:
            losses = [r for r in map(json.loads, f) if "loss" in r]
    return {"losses": losses, "aug_path": runner.aug_path,
            "final": {k: v.clone() for k, v in final.items()}}


def job_det_test(argv):
    from agenda_tpu_torch.cli import det_test

    return len(det_test.main(argv + ["--device", "cpu", "--dist-backend", "gloo"]))


def job_finetune_cli(argv):
    from agenda_tpu_torch.cli import finetune_sd

    stats = finetune_sd.main(argv + ["--device", "cpu", "--dist-backend", "gloo"])
    return {k: stats[k] for k in ("steps", "losses", "global_step", "micro_batches", "ema_step")}


def job_chain(argv):
    from agenda_tpu_torch.cli import pipeline

    return pipeline.main(argv)


JOBS = {
    "generation": job_generation,
    "sd": job_sd,
    "token": job_token,
    "family_step": job_family_step,
    "split_draws": job_split_draws,
    "runner_train": job_runner_train,
    "det_test": job_det_test,
    "finetune_cli": job_finetune_cli,
    "chain": job_chain,
}
