"""DDIM scheduler: precomputed numpy tables and a pure torch step.

Counterpart of ``latentsync_tpu/ops/ddim.py`` (diffusers DDIMScheduler
semantics: scaled_linear betas 0.00085→0.012, 1000 train steps,
"leading" spacing with steps_offset 1, eta = 0, epsilon prediction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import SchedulerConfig


def make_beta_schedule(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule}")


@dataclass(frozen=True)
class DDIMScheduler:
    config: SchedulerConfig
    alphas_cumprod: np.ndarray  # (T,) float32
    final_alpha_cumprod: float

    @classmethod
    def create(cls, config: SchedulerConfig = SchedulerConfig()) -> "DDIMScheduler":
        alphas_cumprod = np.cumprod(1.0 - make_beta_schedule(config))
        final = 1.0 if config.set_alpha_to_one else float(alphas_cumprod[0])
        return cls(config=config, alphas_cumprod=alphas_cumprod.astype(np.float32),
                   final_alpha_cumprod=final)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        t = self.config
        if t.timestep_spacing == "leading":
            ratio = t.num_train_timesteps // num_inference_steps
            steps = (np.arange(num_inference_steps) * ratio).round()[::-1]
            steps = steps + t.steps_offset
        elif t.timestep_spacing == "trailing":
            ratio = t.num_train_timesteps / num_inference_steps
            steps = np.round(np.arange(t.num_train_timesteps, 0, -ratio)) - 1
        else:
            raise ValueError(f"unknown spacing {t.timestep_spacing}")
        return steps.astype(np.int32)

    def step_tables(self, num_inference_steps: int):
        """(timesteps, alpha_t, alpha_prev) numpy arrays."""
        steps = self.timesteps(num_inference_steps)
        ratio = self.config.num_train_timesteps // num_inference_steps
        prev = steps - ratio
        alpha_t = self.alphas_cumprod[steps]
        alpha_prev = np.where(prev >= 0, self.alphas_cumprod[np.clip(prev, 0, None)],
                              self.final_alpha_cumprod).astype(np.float32)
        return steps, alpha_t.astype(np.float32), alpha_prev

    @staticmethod
    def step(eps: torch.Tensor, sample: torch.Tensor, alpha_t: float,
             alpha_prev: float) -> torch.Tensor:
        """One deterministic DDIM update x_t → x_{t-1}, in at least f32.
        alpha_t/alpha_prev are float32 scalars from `step_tables`."""
        acc = torch.promote_types(sample.dtype, torch.float32)
        x = sample.to(acc)
        e = eps.to(acc)
        a_t = torch.tensor(alpha_t, dtype=torch.float32)
        a_p = torch.tensor(alpha_prev, dtype=torch.float32)
        x0 = (x - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
        prev = torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * e
        return prev.to(sample.dtype)
