"""Noise schedule and the ZTSNR Karras-Euler sampler, in PyTorch.

Port of the sampling half of ``sdxl_training_improvements_tpu/training/
schedules.py``: the Karras sigma ramp with the ZTSNR sigma_max of 20000,
the boundary scalings c_skip/c_out/c_in, the ``NoiseSchedule`` table the
sampler reads, the denoiser composition per prediction type, and
``sample_ztsnr`` as a Python loop over sigma pairs.  The training-side
operations (noising, targets, MinSNR, timestep sampling) come with the
training port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

ZTSNR_SIGMA_MAX = 20000.0


def karras_sigmas(n_sigmas: int, sigma_min: float, sigma_max: float,
                  rho: float = 7.0) -> torch.Tensor:
    """Karras et al. (2022) ramp, descending from sigma_max to sigma_min,
    fp32: (max^(1/rho) + ramp*(min^(1/rho) - max^(1/rho)))^rho."""
    ramp = torch.linspace(0.0, 1.0, n_sigmas, dtype=torch.float32)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def karras_scalings(sigma: float, sigma_data: float = 1.0
                    ) -> Tuple[float, float, float]:
    """Boundary-condition scalings (c_skip, c_out, c_in)."""
    var = sigma ** 2 + sigma_data ** 2
    return (sigma_data ** 2 / var, -sigma * sigma_data / math.sqrt(var),
            1.0 / math.sqrt(var))


@dataclass(frozen=True)
class NoiseSchedule:
    """The trained schedule: ``sigmas[t]`` (descending, fp32, on the CPU)
    indexed by integer timestep, so t = 0 is the highest sigma."""

    sigmas: torch.Tensor
    num_timesteps: int
    sigma_data: float
    use_ztsnr: bool
    prediction_type: str  # "epsilon" | "v_prediction"
    min_snr_gamma: Optional[float]
    rho: float = 7.0

    @classmethod
    def create(cls, *, num_timesteps: int = 1000, sigma_min: float = 0.002,
               sigma_max: float = 20000.0, rho: float = 7.0,
               use_ztsnr: bool = True, sigma_data: float = 1.0,
               prediction_type: str = "v_prediction",
               min_snr_gamma: Optional[float] = 5.0) -> "NoiseSchedule":
        eff_sigma_max = ZTSNR_SIGMA_MAX if use_ztsnr else sigma_max
        return cls(sigmas=karras_sigmas(num_timesteps, sigma_min,
                                        eff_sigma_max, rho),
                   num_timesteps=num_timesteps, sigma_data=sigma_data,
                   use_ztsnr=use_ztsnr, prediction_type=prediction_type,
                   min_snr_gamma=min_snr_gamma, rho=rho)


def make_denoised_fn(model_fn, schedule: NoiseSchedule):
    """D(x, sigma), the clean-image estimate implied by the raw network:
    v_prediction composes D = c_skip*x + c_out*F(c_in*x, sigma); epsilon
    (no input scaling in training) gives D = x - sigma*F(x, sigma)."""
    if schedule.prediction_type == "epsilon":
        return lambda x, sigma: x - sigma * model_fn(x, sigma)

    def denoised(x, sigma):
        c_skip, c_out, c_in = karras_scalings(sigma, schedule.sigma_data)
        return c_skip * x + c_out * model_fn(c_in * x, sigma)
    return denoised


def sample_ztsnr(model_fn, latent_shape: Tuple[int, ...],
                 schedule: NoiseSchedule, num_steps: int = 28,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Karras-Euler text-to-image walk with exactly ``num_steps`` model
    calls; ``model_fn(x, sigma)`` is the raw network in sigma space, sigma
    a Python float.

    v_prediction: the first call treats the start as sigma = inf
    (c_skip -> 0, c_out -> -sigma_data): x = sigmas[0]*n - sigma_data *
    F(n, inf); Euler steps then walk every adjacent pair of the ramp.
    epsilon: plain Karras-Euler on D = x - sigma*F down the ramp extended
    to sigma = 0.

    ``noise`` is the initial N(0, 1) draw of ``latent_shape``; when None it
    is drawn from ``generator`` on ``device``.
    """
    sigmas = karras_sigmas(
        num_steps, float(schedule.sigmas[-1]),
        ZTSNR_SIGMA_MAX if schedule.use_ztsnr else float(schedule.sigmas[0]),
        rho=schedule.rho).tolist()
    if noise is None:
        noise = torch.randn(latent_shape, generator=generator, device=device,
                            dtype=torch.float32)
    elif tuple(noise.shape) != tuple(latent_shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != "
                         f"{tuple(latent_shape)}")
    n = noise.float()

    if schedule.prediction_type == "epsilon":
        ramp = sigmas + [0.0]
        x = ramp[0] * n
        for sigma_i, sigma_next in zip(ramp[:-1], ramp[1:]):
            x = x + (sigma_next - sigma_i) * model_fn(x, sigma_i)
        return x

    x = sigmas[0] * n - schedule.sigma_data * model_fn(n, math.inf)
    denoise = make_denoised_fn(model_fn, schedule)
    for sigma_i, sigma_next in zip(sigmas[:-1], sigmas[1:]):
        d = (x - denoise(x, sigma_i)) / sigma_i
        x = x + (sigma_next - sigma_i) * d
    return x
