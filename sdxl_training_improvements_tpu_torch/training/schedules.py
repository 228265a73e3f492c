"""Noise schedule, training numerics and the ZTSNR Karras-Euler sampler,
in PyTorch.

Port of ``sdxl_training_improvements_tpu/training/schedules.py``: the
Karras sigma ramp with the ZTSNR sigma_max of 20000, the boundary scalings
c_skip/c_out/c_in, the ``NoiseSchedule`` table; its training operations
(noising with the ZTSNR clamp, the reference's velocity (eps - x)/sigma,
SNR and MinSNR, timestep sampling), the flow-matching numerics
(logit-normal times, the OT path and its target), timestep-bias weights
and SDXL time ids; and the samplers: the denoiser composition per
prediction type, the ZTSNR Karras-Euler walk ``sample_ztsnr``, DPM++(2M)
``sample_dpmpp_2m`` and the flow-matching Euler ODE ``sample_flow``, each a
Python loop over its grid, with the img2img entry (``init`` +
``strength``), the base->refiner handoff (``denoising_start`` /
``denoising_end``) and the per-step state ``aux0`` that DeepCache
threads.  Random draws take an explicit ``noise`` or ``torch.Generator``;
the schedule table stays on the CPU and is moved to the timesteps' device
when indexed.
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
    aux_fn = _make_aux_denoised_fn(_wrap_aux(model_fn, False), schedule)
    return lambda x, sigma: aux_fn(x, sigma, None)[0]


def _wrap_aux(model_fn, has_aux: bool):
    """A sampler's model_fn in the aux-threading form ``(x, sigma, aux) ->
    (out, aux)``: ``has_aux`` means it has that form already (DeepCache's
    per-step (step, deep feature) state); otherwise it is the plain
    ``(x, sigma) -> out``."""
    if has_aux:
        return model_fn
    return lambda x, sigma, aux: (model_fn(x, sigma), aux)


def _make_aux_denoised_fn(aux_model_fn, schedule: NoiseSchedule):
    if schedule.prediction_type == "epsilon":
        def denoised(x, sigma, aux):
            f, aux = aux_model_fn(x, sigma, aux)
            return x - sigma * f, aux
        return denoised

    def denoised(x, sigma, aux):
        c_skip, c_out, c_in = karras_scalings(sigma, schedule.sigma_data)
        f, aux = aux_model_fn(c_in * x, sigma, aux)
        return c_skip * x + c_out * f, aux
    return denoised


def _sigma_ramp(schedule: NoiseSchedule, num_steps: int) -> list:
    """The sampler's Karras ramp from the trained sigma range (sigma_max
    the ZTSNR 20000 under ZTSNR), as Python floats of the fp32 values."""
    return karras_sigmas(
        num_steps, float(schedule.sigmas[-1]),
        ZTSNR_SIGMA_MAX if schedule.use_ztsnr else float(schedule.sigmas[0]),
        rho=schedule.rho).tolist()


def _entry(num_steps: int, init, strength: float,
           denoising_start: Optional[float]) -> Tuple[int, bool]:
    """(ramp index the walk starts at, whether ``init`` is already noisy):
    ``denoising_start`` s enters at round(s*(n-1)) with the handed-off
    noisy latents; img2img at round((1-strength)*n) from the noised
    init; otherwise 0."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    if denoising_start is not None and init is None:
        raise ValueError("denoising_start requires init (the noisy latents "
                         "handed off by the denoising_end stage)")
    if denoising_start is not None:
        if not 0.0 <= denoising_start < 1.0:
            raise ValueError(f"denoising_start in [0,1): {denoising_start}")
        return min(int(round(denoising_start * (num_steps - 1))),
                   num_steps - 1), True
    if init is not None and strength < 1.0:
        return min(int(round((1.0 - strength) * num_steps)),
                   num_steps - 1), False
    return 0, False


def _check_end(denoising_end: Optional[float]) -> None:
    if denoising_end is not None and not 0.0 < denoising_end <= 1.0:
        raise ValueError(f"denoising_end in (0,1]: {denoising_end}")


def _noise(latent_shape, noise, generator, device) -> torch.Tensor:
    """The sampler's N(0, 1) draw of ``latent_shape``: ``noise`` when
    given, else from ``generator`` on ``device``; fp32."""
    if noise is None:
        return torch.randn(latent_shape, generator=generator, device=device,
                           dtype=torch.float32)
    if tuple(noise.shape) != tuple(latent_shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != "
                         f"{tuple(latent_shape)}")
    return noise.float()


def sample_ztsnr(model_fn, latent_shape: Tuple[int, ...],
                 schedule: NoiseSchedule, num_steps: int = 28,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None, init: Optional[torch.Tensor] = None,
                 strength: float = 1.0,
                 denoising_start: Optional[float] = None,
                 denoising_end: Optional[float] = None,
                 aux0=None) -> torch.Tensor:
    """Karras-Euler walk (JAX ``training/schedules.py:281-408``);
    ``model_fn(x, sigma)`` is the raw network in sigma space, sigma a
    Python float.

    v_prediction: the first call treats the start as sigma = inf
    (c_skip -> 0, c_out -> -sigma_data): x = sigmas[0]*n - sigma_data *
    F(n, inf); Euler steps then walk every adjacent pair of the ramp, so
    text-to-image makes exactly ``num_steps`` model calls.  epsilon: plain
    Karras-Euler on D = x - sigma*F down the ramp extended to sigma = 0.

    img2img (``init`` clean latents, ``strength`` < 1): the walk enters at
    ramp index i0 = round((1-strength)*num_steps) from init + sigma*n.
    ``denoising_end`` e stops at ramp index round(e*(num_steps-1)) and
    returns the still-noisy latents; ``denoising_start`` s takes ``init``
    as those noisy latents at index round(s*(num_steps-1)) and walks the
    rest (both stages must sample the same ramp).  ``aux0``, when given,
    makes ``model_fn(x, sigma, aux) -> (out, aux)`` and threads the state
    through the walk.

    ``noise`` is the N(0, 1) draw of ``latent_shape`` (drawn whether or not
    the walk uses it, as in JAX); when None it is drawn from ``generator``
    on ``device``.
    """
    sigmas = _sigma_ramp(schedule, num_steps)
    i0, noisy_init = _entry(num_steps, init, strength, denoising_start)
    _check_end(denoising_end)
    i_end = num_steps  # exclusive bound of the sigma indices walked
    if denoising_end is not None:
        i_end = max(i0 + 1, int(round(denoising_end * (num_steps - 1))) + 1)
    n = _noise(latent_shape, noise, generator, device)
    fn = _wrap_aux(model_fn, aux0 is not None)
    aux = aux0

    if schedule.prediction_type == "epsilon":
        ramp = sigmas + [0.0]
        if init is None:
            x = ramp[0] * n
        elif noisy_init:
            x = init.float()
        else:
            x = init.float() + ramp[i0] * n
        hi = (len(ramp) if denoising_end is None or denoising_end >= 1.0
              else i_end)
        for sigma_i, sigma_next in zip(ramp[i0:hi - 1], ramp[i0 + 1:hi]):
            d, aux = fn(x, sigma_i, aux)  # d = eps_hat = (x - D)/sigma
            x = x + (sigma_next - sigma_i) * d
        return x

    if init is None:
        f0, aux = fn(n, math.inf, aux)
        x = sigmas[0] * n - schedule.sigma_data * f0
    elif noisy_init:
        x = init.float()
    else:
        x = init.float() + sigmas[i0] * n
        if schedule.use_ztsnr:
            x = torch.clamp(x, -ZTSNR_SIGMA_MAX, ZTSNR_SIGMA_MAX)
    denoise = _make_aux_denoised_fn(fn, schedule)
    for sigma_i, sigma_next in zip(sigmas[i0:i_end - 1],
                                   sigmas[i0 + 1:i_end]):
        den, aux = denoise(x, sigma_i, aux)
        x = x + (sigma_next - sigma_i) * ((x - den) / sigma_i)
    return x


def sample_dpmpp_2m(model_fn, latent_shape: Tuple[int, ...],
                    schedule: NoiseSchedule, num_steps: int = 14,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    device=None, init: Optional[torch.Tensor] = None,
                    strength: float = 1.0,
                    denoising_start: Optional[float] = None,
                    denoising_end: Optional[float] = None,
                    aux0=None) -> torch.Tensor:
    """DPM-Solver++(2M) in log-sigma space (JAX ``training/schedules.py:
    409-511``; Lu et al., arXiv 2211.01095), with ``sample_ztsnr``'s
    surface and entry rules.  Per step (lambda = -ln sigma, h =
    lambda_next - lambda_i): x <- (sigma_next/sigma_i) x - expm1(-h) D~,
    D~ = (1 + 1/2r) D_i - (1/2r) D_prev with r = h_prev/h; plain D_i on the
    first step and on a step to sigma = 0 (the epsilon ramp's last), where
    h is infinite and the ratio 0.  v_prediction starts with the ZTSNR
    infinite-sigma call; its ramp does not reach 0."""
    sigmas = _sigma_ramp(schedule, num_steps)
    eps_mode = schedule.prediction_type == "epsilon"
    ramp = sigmas + [0.0] if eps_mode else sigmas
    i0, noisy_init = _entry(num_steps, init, strength, denoising_start)
    _check_end(denoising_end)
    i_end = len(ramp)
    if denoising_end is not None and denoising_end < 1.0:
        i_end = max(i0 + 2, int(round(denoising_end * (num_steps - 1))) + 1)
    n = _noise(latent_shape, noise, generator, device)
    fn = _wrap_aux(model_fn, aux0 is not None)
    aux = aux0
    if init is None:
        if eps_mode:
            x = ramp[0] * n
        else:
            f0, aux = fn(n, math.inf, aux)
            x = sigmas[0] * n - schedule.sigma_data * f0
    elif noisy_init:
        x = init.float()
    else:
        x = init.float() + ramp[i0] * n
        if schedule.use_ztsnr and not eps_mode:
            x = torch.clamp(x, -ZTSNR_SIGMA_MAX, ZTSNR_SIGMA_MAX)

    denoise = _make_aux_denoised_fn(fn, schedule)

    def lam(sigma):  # -ln sigma, with a guard at the terminal 0
        return -math.log(max(sigma, 1e-20))

    old_d, h_prev = None, 1.0
    for sigma_i, sigma_next in zip(ramp[i0:i_end - 1], ramp[i0 + 1:i_end]):
        d, aux = denoise(x, sigma_i, aux)
        h = lam(sigma_next) - lam(sigma_i)
        if old_d is None or sigma_next <= 0.0:
            dt = d
        else:
            r = h_prev / (1.0 if h == 0 else h)
            dt = (1.0 + 1.0 / (2.0 * r)) * d - (1.0 / (2.0 * r)) * old_d
        ratio = 0.0 if sigma_next <= 0.0 else sigma_next / sigma_i
        x = ratio * x - math.expm1(-h) * dt
        old_d, h_prev = d, h
    return x


def sample_flow(model_fn, latent_shape: Tuple[int, ...],
                num_steps: int = 28, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device=None,
                init: Optional[torch.Tensor] = None,
                strength: float = 1.0) -> torch.Tensor:
    """Euler ODE for flow-matching models (JAX ``training/schedules.py:
    512-550``): dx/dt = v(x, t) from t = 0 (noise) to t = 1 (data) on the
    OT path x_t = (1-t) x0 + t x1, ``model_fn(x, t)`` the CFG velocity at
    a scalar t in [0, 1] (an fp32 0-d tensor), ``num_steps`` calls.
    img2img: start at t0 = 1 - strength from (1-t0) noise + t0 init and
    take round(strength*num_steps) steps (at least 1)."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    x = _noise(latent_shape, noise, generator, device)
    if init is None or strength >= 1.0:
        t0, n_run = 0.0, num_steps
    else:
        t0 = 1.0 - strength
        x = (1.0 - t0) * x + t0 * init.float()
        n_run = max(1, int(round(strength * num_steps)))
    dt = (1.0 - t0) / n_run
    ts = t0 + torch.arange(n_run, dtype=torch.float32) * dt
    for t in ts:
        x = x + dt * model_fn(x, t)
    return x
