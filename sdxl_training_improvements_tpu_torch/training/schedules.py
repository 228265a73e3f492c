"""Noise schedule, training numerics and the ZTSNR Karras-Euler sampler,
in PyTorch.

Port of ``sdxl_training_improvements_tpu/training/schedules.py``: the
Karras sigma ramp with the ZTSNR sigma_max of 20000, the boundary scalings
c_skip/c_out/c_in, the ``NoiseSchedule`` table; its training operations
(noising with the ZTSNR clamp, the reference's velocity (eps - x)/sigma,
SNR and MinSNR, timestep sampling), the flow-matching numerics
(logit-normal times, the OT path and its target), timestep-bias weights
and SDXL time ids; and the sampler: the denoiser composition per
prediction type and ``sample_ztsnr`` as a Python loop over sigma pairs.
Random draws take an explicit ``torch.Generator``; the schedule table
stays on the CPU and is moved to the timesteps' device when indexed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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

    @classmethod
    def from_config(cls, config) -> "NoiseSchedule":
        m = config.model
        return cls.create(num_timesteps=m.num_timesteps,
                          sigma_min=m.sigma_min, sigma_max=m.sigma_max,
                          rho=m.rho, use_ztsnr=m.use_ztsnr,
                          prediction_type=config.training.prediction_type,
                          min_snr_gamma=m.min_snr_gamma)

    # ---------------------------------------------------------- training
    def timestep_to_sigma(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.sigmas.to(timesteps.device)[timesteps]

    def sample_timesteps(self, generator: Optional[torch.Generator],
                         batch_size: int,
                         weights: Optional[torch.Tensor] = None,
                         device=None) -> torch.Tensor:
        """Uniform integer timesteps, or categorical under ``weights``."""
        if weights is None:
            return torch.randint(0, self.num_timesteps, (batch_size,),
                                 generator=generator, device=device)
        return torch.multinomial(weights.to(device), batch_size,
                                 replacement=True, generator=generator)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """x + sigma * eps, clamped to +-20000 under ZTSNR."""
        sigma = _bcast(self.timestep_to_sigma(timesteps), sample)
        noisy = sample + sigma * noise.to(sigma.dtype)
        if self.use_ztsnr:
            noisy = torch.clamp(noisy, -ZTSNR_SIGMA_MAX, ZTSNR_SIGMA_MAX)
        return noisy

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """The reference's v-target: (eps - x) / sigma."""
        sigma = _bcast(self.timestep_to_sigma(timesteps), sample)
        return (noise.to(sigma.dtype) - sample) / sigma

    def get_snr(self, timesteps: torch.Tensor) -> torch.Tensor:
        """(sigma_data / sigma)^2."""
        return (self.sigma_data / self.timestep_to_sigma(timesteps)) ** 2

    def min_snr_weight(self, timesteps: torch.Tensor) -> torch.Tensor:
        """min(snr, gamma) per MinSNR; ones when it is off."""
        if self.min_snr_gamma is None:
            return torch.ones(timesteps.shape, dtype=torch.float32,
                              device=timesteps.device)
        return torch.clamp(self.get_snr(timesteps),
                           max=float(self.min_snr_gamma))


def _bcast(per_example: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, 1, 1, ...] fp32, to broadcast against ``like``."""
    shape = (per_example.shape[0],) + (1,) * (like.dim() - 1)
    return per_example.reshape(shape).float()


# ------------------------------------------------------- flow matching
def sample_logit_normal(generator: Optional[torch.Generator], shape,
                        mean: float = 0.0, std: float = 1.0,
                        device=None) -> torch.Tensor:
    """sigmoid(mean + std * N(0, 1)), fp32."""
    normal = torch.randn(shape, generator=generator, device=device,
                         dtype=torch.float32)
    return torch.sigmoid(mean + std * normal)


def optimal_transport_path(x0: torch.Tensor, x1: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
    """(1 - t) x0 + t x1 with t per example."""
    tb = _bcast(t, x0).to(x0.dtype)
    return (1.0 - tb) * x0 + tb * x1


def flow_matching_target(x0: torch.Tensor, x1: torch.Tensor
                         ) -> torch.Tensor:
    """The straight path's velocity x1 - x0."""
    return x1 - x0


# ---------------------------------------------------- timestep weights
def generate_timestep_weights(num_timesteps: int, bias_strategy: str = "none",
                              bias_portion: float = 0.25,
                              bias_multiplier: float = 2.0,
                              bias_begin: Optional[int] = None,
                              bias_end: Optional[int] = None
                              ) -> torch.Tensor:
    """Normalized sampling weights over timesteps, fp32."""
    weights = torch.ones(num_timesteps, dtype=torch.float32)
    if bias_strategy == "none":
        return weights / weights.sum()
    if bias_multiplier <= 0:
        raise ValueError("Timestep bias multiplier must be positive; use "
                         "bias_strategy='none' to disable biasing.")
    num_to_bias = int(bias_portion * num_timesteps)
    idx = torch.arange(num_timesteps)
    if bias_strategy == "later":
        mask = idx >= num_timesteps - num_to_bias
    elif bias_strategy == "earlier":
        mask = idx < num_to_bias
    elif bias_strategy == "range":
        if bias_begin is None or bias_end is None:
            raise ValueError("bias_begin and bias_end must be specified for "
                             "range strategy")
        if bias_begin < 0 or bias_end > num_timesteps:
            raise ValueError(f"Bias range must be within [0, "
                             f"{num_timesteps}], got [{bias_begin}, "
                             f"{bias_end}]")
        mask = (idx >= bias_begin) & (idx < bias_end)
    else:
        raise ValueError(f"Unknown bias strategy: {bias_strategy}. "
                         "Must be one of: none, earlier, later, range")
    weights = torch.where(mask, weights * bias_multiplier, weights)
    return weights / weights.sum()


def get_add_time_ids(original_sizes: Sequence, crop_top_lefts: Sequence,
                     target_sizes: Sequence,
                     dtype=torch.float32) -> torch.Tensor:
    """[B, 6] = (orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w) rows."""
    rows = [list(o) + list(c) + list(t)
            for o, c, t in zip(original_sizes, crop_top_lefts, target_sizes)]
    return torch.tensor(rows, dtype=dtype)


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
