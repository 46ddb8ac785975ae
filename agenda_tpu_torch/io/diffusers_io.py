"""diffusers-layout pipeline directories: load, save, and the JAX key maps.

Layout (as ``agenda_tpu/io/diffusers_io.py`` reads and writes it)::

    <dir>/model_index.json
    <dir>/unet/config.json + diffusion_pytorch_model.safetensors
    <dir>/vae/config.json + diffusion_pytorch_model.safetensors
    <dir>/text_encoder/config.json + model.safetensors
    <dir>/tokenizer/vocab.json + merges.txt + tokenizer_config.json
    <dir>/scheduler/scheduler_config.json

The port's modules are named after the diffusers keys, so the safetensors
load straight into them with no transposes. ``params_from_jax`` is the
port's own copy of the JAX package's key maps (``diffusers_io.py:95-285``):
it turns flax parameter trees, given as numpy, into the port's state dicts
(conv HWIO -> OIHW, dense (I, O) -> (O, I), embedding tables verbatim).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch.io.configs import (
    CLIPTextConfig,
    UNetConfig,
    VAEConfig,
    clip_config_from_json,
    clip_config_to_json,
    unet_config_from_json,
    unet_config_to_json,
    vae_config_from_json,
    vae_config_to_json,
)
from agenda_tpu_torch.io.safetensors_io import load_file, save_file

StateDict = Dict[str, torch.Tensor]

# Legacy (pre-0.13 diffusers) VAE mid-attention names -> current names.
_VAE_ATTN_RENAMES = {
    "query": "to_q",
    "key": "to_k",
    "value": "to_v",
    "proj_attn": "to_out.0",
}


def _read_tensor_file(path_base: str) -> StateDict:
    """Read <base>.safetensors, or a legacy <base>.bin, as f32 CPU tensors."""
    st = path_base + ".safetensors"
    if os.path.exists(st):
        sd = load_file(st)
    elif os.path.exists(path_base + ".bin"):
        sd = torch.load(path_base + ".bin", map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"No {path_base}.safetensors or .bin")
    return {k: (v.float() if v.is_floating_point() else v) for k, v in sd.items()}


def rename_legacy_vae_keys(sd: StateDict) -> StateDict:
    out = {}
    for key, value in sd.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-2] in _VAE_ATTN_RENAMES:
            key = ".".join(parts[:-2] + [_VAE_ATTN_RENAMES[parts[-2]], parts[-1]])
        out[key] = value
    return out


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class PipelineBundle:
    """Everything a pipeline directory provides, as torch-layout state dicts."""

    unet_config: UNetConfig
    unet_state: StateDict
    vae_config: VAEConfig
    vae_state: StateDict
    text_config: CLIPTextConfig
    text_state: StateDict
    tokenizer_dir: str
    scheduler_config: dict


def load_pipeline(model_dir: str) -> PipelineBundle:
    def sub(name):
        return os.path.join(model_dir, name)

    text_state = _read_tensor_file(os.path.join(sub("text_encoder"), "model"))
    text_state = {k: v for k, v in text_state.items() if not k.endswith("position_ids")}
    sched_path = os.path.join(sub("scheduler"), "scheduler_config.json")
    return PipelineBundle(
        unet_config=unet_config_from_json(_load_json(os.path.join(sub("unet"), "config.json"))),
        unet_state=_read_tensor_file(os.path.join(sub("unet"), "diffusion_pytorch_model")),
        vae_config=vae_config_from_json(_load_json(os.path.join(sub("vae"), "config.json"))),
        vae_state=rename_legacy_vae_keys(
            _read_tensor_file(os.path.join(sub("vae"), "diffusion_pytorch_model"))),
        text_config=clip_config_from_json(
            _load_json(os.path.join(sub("text_encoder"), "config.json"))),
        text_state=text_state,
        tokenizer_dir=sub("tokenizer"),
        scheduler_config=_load_json(sched_path) if os.path.exists(sched_path) else {},
    )


# SD-1.x's PNDM scheduler config
_SCHEDULER_CONFIG = {
    "_class_name": "PNDMScheduler",
    "beta_end": 0.012,
    "beta_schedule": "scaled_linear",
    "beta_start": 0.00085,
    "num_train_timesteps": 1000,
    "set_alpha_to_one": False,
    "skip_prk_steps": True,
    "steps_offset": 1,
    "prediction_type": "epsilon",
}


def save_pipeline(
    out_dir: str,
    unet_config: UNetConfig,
    unet_state: StateDict,
    vae_config: VAEConfig,
    vae_state: StateDict,
    text_config: CLIPTextConfig,
    text_state: StateDict,
    tokenizer_dir: str,
) -> None:
    """Write a diffusers-layout pipeline directory with SD-1.x's PNDM scheduler;
    the tokenizer files are copied from ``tokenizer_dir`` unless they are
    already in place."""
    os.makedirs(out_dir, exist_ok=True)

    def dump(subdir, cfg_json, tensors, fname):
        d = os.path.join(out_dir, subdir)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg_json, f, indent=2)
        save_file(tensors, os.path.join(d, fname))

    dump("unet", unet_config_to_json(unet_config), unet_state,
         "diffusion_pytorch_model.safetensors")
    dump("vae", vae_config_to_json(vae_config), vae_state, "diffusion_pytorch_model.safetensors")
    dump("text_encoder", clip_config_to_json(text_config), text_state, "model.safetensors")
    dst = os.path.join(out_dir, "tokenizer")
    if os.path.abspath(tokenizer_dir) != os.path.abspath(dst):
        shutil.copytree(tokenizer_dir, dst, dirs_exist_ok=True)
    os.makedirs(os.path.join(out_dir, "scheduler"), exist_ok=True)
    with open(os.path.join(out_dir, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(_SCHEDULER_CONFIG, f, indent=2)
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump(
            {
                "_class_name": "StableDiffusionPipeline",
                "_diffusers_version": "0.27.0",
                "scheduler": ["diffusers", _SCHEDULER_CONFIG["_class_name"]],
                "text_encoder": ["transformers", "CLIPTextModel"],
                "tokenizer": ["transformers", "CLIPTokenizer"],
                "unet": ["diffusers", "UNet2DConditionModel"],
                "vae": ["diffusers", "AutoencoderKL"],
                "safety_checker": [None, None],
                "feature_extractor": [None, None],
            },
            f,
            indent=2,
        )


# -- flax parameter trees -> torch state dicts -------------------------------


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf_to_torch(leaf: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """flax leaf -> (torch leaf, torch layout)."""
    if leaf == "kernel":
        if value.ndim == 4:  # conv HWIO -> OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.transpose(1, 0)  # dense (I, O) -> (O, I)
    if leaf == "scale":
        return "weight", value
    if leaf == "bias":
        return "bias", value
    raise ValueError(f"Unhandled flax leaf {leaf}")


def _indexed(name: str) -> str:
    """'down_blocks_0.resnets_1' -> 'down_blocks.0.resnets.1'."""
    return re.sub(r"_(\d+)(?=\.|$)", r".\1", name)


def _unet_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for path, value in _flatten(params.get("params", params)).items():
        name = _indexed(".".join(path[:-1]))
        # the time-embedding MLP keeps its literal names
        name = name.replace("linear.1", "linear_1").replace("linear.2", "linear_2")
        leaf, v = _leaf_to_torch(path[-1], value)
        out[f"{name}.{leaf}"] = v
    return out


def _vae_middle(mid: str) -> str:
    """'down_blocks_0_resnets_0' -> 'down_blocks.0.resnets.0'."""
    for two_word in ("down_blocks_", "up_blocks_", "mid_block_"):
        if mid.startswith(two_word):
            return two_word[:-1] + "." + mid[len(two_word):].replace("_", ".")
    return mid.replace("_", ".")


def _vae_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for path, value in _flatten(params.get("params", params)).items():
        parts = list(path[:-1])
        if parts[0] in ("encoder", "decoder") and len(parts) > 2:
            parts = [parts[0]] + _vae_middle(parts[1]).split(".") + parts[2:]
        name = _indexed(".".join(parts))
        leaf, v = _leaf_to_torch(path[-1], value)
        out[f"{name}.{leaf}"] = v
    return out


def _clip_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for path, value in _flatten(params.get("params", params)).items():
        if path == ("token_embedding",):
            out["text_model.embeddings.token_embedding.weight"] = value
            continue
        if path == ("position_embedding",):
            out["text_model.embeddings.position_embedding.weight"] = value
            continue
        name = _indexed(".".join(path[:-1]))
        if name.startswith("layers."):
            mod = name.split(".")[-1]
            if mod in ("q_proj", "k_proj", "v_proj", "out_proj"):
                name = name.replace(mod, f"self_attn.{mod}")
            elif mod in ("fc1", "fc2"):
                name = name.replace(mod, f"mlp.{mod}")
            name = "text_model.encoder." + name
        else:
            name = "text_model." + name
        leaf, v = _leaf_to_torch(path[-1], value)
        out[f"{name}.{leaf}"] = v
    return out


def params_from_jax(
    unet_params: Optional[Dict[str, Any]] = None,
    vae_params: Optional[Dict[str, Any]] = None,
    text_params: Optional[Dict[str, Any]] = None,
) -> Tuple[Optional[StateDict], Optional[StateDict], Optional[StateDict]]:
    """flax parameter trees (numpy leaves) -> the port's state dicts."""

    def conv(fn, tree):
        if tree is None:
            return None
        return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in fn(tree).items()}

    return (conv(_unet_from_flax, unet_params), conv(_vae_from_flax, vae_params),
            conv(_clip_from_flax, text_params))
