"""Diffusion schedule, the training-side noise functions, and the DDIM /
PLMS samplers used by generation.

Counterpart of ``agenda_tpu/core/schedules.py``: the tables (``:46-83``),
``add_noise``, ``get_velocity``, ``compute_snr`` and ``min_snr_weights``
(``:89-147``), and the samplers (``:175-366``). The training functions take
timesteps as a device tensor and gather from a device copy of the f32
alpha-bar table, so a train step never waits on the host. The JAX version carries the PLMS state through ``lax.scan`` and
picks the multistep order with ``lax.switch``; here the loop is Python, so
the step counter lives on the host and the order is a plain branch. The
sampler state (latents and the eps history) stays f32 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """f32 beta / alpha-bar tables (numpy, length num_train_timesteps)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    steps_offset: int = 1

    @property
    def final_alpha_cumprod(self) -> float:
        # set_alpha_to_one=False in the SD config: clamp to alphas_cumprod[0].
        return self.alphas_cumprod[0]

    def abar(self, t: int) -> np.float32:
        """alpha-bar at t, or the final value for t < 0."""
        return self.alphas_cumprod[t] if t >= 0 else self.final_alpha_cumprod


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "epsilon",
    steps_offset: int = 1,
) -> DiffusionSchedule:
    """Build the beta/alpha tables (diffusers DDPMScheduler math, f64 -> f32)."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
            ** 2
        )
    elif beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps

        def f(u):
            return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

        betas = np.minimum(1.0 - f(t[1:]) / f(t[:-1]), 0.999)
    else:
        raise ValueError(f"Unknown beta_schedule: {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=betas.astype(np.float32),
        alphas_cumprod=alphas_cumprod.astype(np.float32),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
        steps_offset=steps_offset,
    )


_TABLES: Dict[Tuple[int, str], torch.Tensor] = {}


def _abar_table(schedule: DiffusionSchedule, device: torch.device) -> torch.Tensor:
    """The f32 alpha-bar table on ``device``, copied there once."""
    key = (id(schedule.alphas_cumprod), str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(np.asarray(schedule.alphas_cumprod, np.float32)).to(device)
    return _TABLES[key]


def _extract(schedule: DiffusionSchedule, timesteps: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep alpha-bar, shaped to broadcast against an ndim tensor."""
    vals = _abar_table(schedule, timesteps.device)[timesteps.long()]
    return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))


def add_noise(schedule: DiffusionSchedule, samples: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps, f32."""
    abar = _extract(schedule, timesteps, samples.dim())
    return torch.sqrt(abar) * samples.float() + torch.sqrt(1.0 - abar) * noise.float()


def get_velocity(schedule: DiffusionSchedule, samples: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """v-prediction target v = sqrt(abar) eps - sqrt(1 - abar) x_0, f32."""
    abar = _extract(schedule, timesteps, samples.dim())
    return torch.sqrt(abar) * noise.float() - torch.sqrt(1.0 - abar) * samples.float()


def compute_snr(schedule: DiffusionSchedule, timesteps: torch.Tensor) -> torch.Tensor:
    """Per-timestep SNR = abar / (1 - abar), f32."""
    abar = _abar_table(schedule, timesteps.device)[timesteps.long()]
    return abar / (1.0 - abar)


def min_snr_weights(schedule: DiffusionSchedule, timesteps: torch.Tensor,
                    snr_gamma: float) -> torch.Tensor:
    """Min-SNR-gamma loss weights: min(snr, gamma) / snr for epsilon
    prediction, min(snr, gamma) / (snr + 1) for v-prediction."""
    snr = compute_snr(schedule, timesteps)
    w = torch.clamp(snr, max=float(np.float32(snr_gamma)))
    if schedule.prediction_type == "epsilon":
        return w / snr
    if schedule.prediction_type == "v_prediction":
        return w / (snr + 1.0)
    raise ValueError(f"Unknown prediction_type: {schedule.prediction_type}")


def _f32(x) -> float:
    """Round a host scalar through f32, as the JAX package's f32 tables do."""
    return float(np.float32(x))


def pred_original_sample(
    schedule: DiffusionSchedule, model_output: torch.Tensor, sample: torch.Tensor, t: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pred_x0, pred_eps) from a model output under the prediction type."""
    abar = np.float32(schedule.abar(t))
    sqrt_abar = _f32(np.sqrt(abar))
    sqrt_1m = _f32(np.sqrt(np.float32(1.0) - abar))
    if schedule.prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sqrt_1m * eps) / sqrt_abar
    elif schedule.prediction_type == "v_prediction":
        x0 = sqrt_abar * sample - sqrt_1m * model_output
        eps = sqrt_abar * model_output + sqrt_1m * sample
    else:
        raise ValueError(f"Unknown prediction_type: {schedule.prediction_type}")
    return x0, eps


# -- DDIM ------------------------------------------------------------------


def ddim_timesteps(schedule: DiffusionSchedule, num_inference_steps: int) -> np.ndarray:
    """Descending table: diffusers DDIMScheduler 'leading' spacing + steps_offset."""
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + schedule.steps_offset


def ddim_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    timestep: int,
    prev_timestep: int,
    sample: torch.Tensor,
) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update x_t -> x_{t_prev}."""
    abar_prev = np.float32(schedule.abar(prev_timestep))
    x0, eps = pred_original_sample(schedule, model_output, sample, timestep)
    return (_f32(np.sqrt(abar_prev)) * x0
            + _f32(np.sqrt(np.float32(1.0) - abar_prev)) * eps)


# -- PLMS (PNDM with skip_prk_steps=True), the SD-1.x default ---------------


@dataclasses.dataclass
class PLMSState:
    ets: List[torch.Tensor]  # past eps predictions, newest last (at most 4)
    counter: int = 0
    cur_sample: Optional[torch.Tensor] = None  # sample saved at counter 0


def plms_timesteps(schedule: DiffusionSchedule, num_inference_steps: int) -> np.ndarray:
    """PLMS table (descending) with the duplicated bootstrap step: T+1 entries."""
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round().astype(np.int64)
    ts = ts + schedule.steps_offset
    plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
    return plms.copy()


def plms_init_state() -> PLMSState:
    return PLMSState(ets=[])


def _plms_prev_sample(
    schedule: DiffusionSchedule,
    sample: torch.Tensor,
    timestep: int,
    prev_timestep: int,
    model_output: torch.Tensor,
) -> torch.Tensor:
    """diffusers PNDMScheduler._get_prev_sample, in f32 scalars."""
    one = np.float32(1.0)
    abar_t = np.float32(schedule.abar(timestep))
    abar_prev = np.float32(schedule.abar(prev_timestep))
    beta_t = one - abar_t
    beta_prev = one - abar_prev
    if schedule.prediction_type == "v_prediction":
        model_output = (_f32(np.sqrt(abar_t)) * model_output
                        + _f32(np.sqrt(beta_t)) * sample)
    elif schedule.prediction_type != "epsilon":
        raise ValueError(f"PLMS supports epsilon/v_prediction, got {schedule.prediction_type}")
    sample_coeff = np.sqrt(abar_prev / abar_t, dtype=np.float32)
    denom = (abar_t * np.sqrt(beta_prev, dtype=np.float32)
             + np.sqrt(abar_t * beta_t * abar_prev, dtype=np.float32))
    return float(sample_coeff) * sample - model_output * _f32(abar_prev - abar_t) / float(denom)


def plms_step(
    schedule: DiffusionSchedule,
    state: PLMSState,
    model_output: torch.Tensor,
    sample: torch.Tensor,
    timestep: int,
    num_inference_steps: int,
) -> Tuple[PLMSState, torch.Tensor]:
    """diffusers PNDMScheduler.step_plms (skip_prk_steps=True).

    Counter 0 runs order 1 and saves the sample; counter 1 repeats the first
    timestep with the average of the two outputs; later steps use orders 2-4
    by the number of buffered outputs.
    """
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    t = int(timestep)
    counter = state.counter
    model_output = model_output.float()
    ets = list(state.ets)
    if counter == 1:
        prev_t, eff_t, eff_sample = t, t + step_ratio, state.cur_sample
        eff_output = (model_output + ets[-1]) / 2.0
    else:
        ets = (ets + [model_output])[-4:]
        prev_t, eff_t, eff_sample = t - step_ratio, t, sample
        if counter == 0:
            eff_output = model_output
        elif len(ets) == 2:
            eff_output = (3.0 * ets[-1] - ets[-2]) / 2.0
        elif len(ets) == 3:
            eff_output = (23.0 * ets[-1] - 16.0 * ets[-2] + 5.0 * ets[-3]) / 12.0
        else:
            eff_output = (55.0 * ets[-1] - 59.0 * ets[-2] + 37.0 * ets[-3]
                          - 9.0 * ets[-4]) / 24.0
    prev_sample = _plms_prev_sample(schedule, eff_sample, eff_t, prev_t, eff_output)
    new_state = PLMSState(
        ets=ets,
        counter=counter + 1,
        cur_sample=sample if counter == 0 else state.cur_sample,
    )
    return new_state, prev_sample
