"""Pure-bf16 AdamW with stochastic rounding, per-leaf layout, hash noise.

Port of ``sdxl_training_improvements_tpu/training/optimizers/
adamw_bf16.py`` (``layout="per_leaf"``, ``noise="hash"``, bf16 or int8
moments).
Per bf16 parameter: bf16 ``exp_avg``, ``exp_avg_sq`` and ``shift`` (the
stochastic-rounding residual carried forward) and an fp32
``accumulated_decay``, whose starting phase is uniform * 5e-3.  Each step:

* bf16 leaves run the chain of ``ops/fused_adamw.py`` (the fused CUDA
  kernel on the card, the plain chain on the CPU) with two uint32 seeds
  drawn per leaf, as JAX's ``_noise_planes`` does for "hash";
* fp32 leaves (the norms) run exact AdamW with no bias correction on m
  and ``sqrt(1 - beta2**t)`` on the step (``f32_update`` / ``f32_delta``);
  this is why ``torch.optim.AdamW`` is not used;
* weight decay is batched: ``accumulated_decay`` accrues wd * lr per step
  and fires as ``shift -= acc * p'`` once it exceeds 5e-3; the decision
  is taken on the host.

``moments="int8"`` (``optimizer.moments_8bit``; JAX ``:305-327``) stores
``exp_avg`` and ``exp_avg_sq`` of each bf16 leaf as 8-bit log codes plus
one fp32 scale (``ops/quantize.py``: ``{"q", "s"}``), 4 instead of 6 state
bytes a parameter: the update dequantizes both to bf16, runs the same
fused chain (the CUDA kernel on the card) and quantizes them again.  fp32
leaves and the shift stay exact.

``update`` returns the per-parameter deltas (bf16 ``p' - p`` for bf16
leaves) and the new state; the train step adds the deltas in the
parameters' dtype, as JAX's ``optax.apply_updates`` does.  The moments
and shift of bf16 leaves are updated in place on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.ops.fused_adamw import (
    fused_adamw_update)
from sdxl_training_improvements_tpu_torch.ops.quantize import (
    dequantize_8bit, quantize_8bit, quantized_zeros)

DECAY_THRESHOLD = 5e-3
Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclass
class AdamWBF16State:
    step: int
    # a bf16 leaf's moments under int8 are {"q": codes, "s": scale}
    exp_avg: Dict[str, Moment]
    exp_avg_sq: Dict[str, Moment]
    shift: Dict[str, torch.Tensor]
    # 0-d fp32 CPU tensors; fp32 leaves keep theirs unused, as in JAX
    accumulated_decay: Dict[str, torch.Tensor]
    generator: torch.Generator  # CPU; draws the phases, then the seeds


class AdamWBF16:
    """``init(params)`` and ``update(grads, state, params, seeds=None)``
    over dicts of tensors keyed by parameter name."""

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 seed: int = 0, moments: str = "bf16"):
        if moments not in ("bf16", "int8"):
            raise ValueError(f"moments must be 'bf16' or 'int8', got "
                             f"{moments!r}")
        self.moments = moments
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.seed = seed

    @staticmethod
    def _validate(params: Mapping[str, torch.Tensor]) -> None:
        """JAX's ``_validate``: bf16 leaves, or fp32 norms, only (an fp16
        UNet takes plain ``adamw``)."""
        for name, p in params.items():
            if p.dtype not in (torch.bfloat16, torch.float32):
                raise ValueError("adamw_bf16 requires bfloat16 (or float32 "
                                 f"norm) params, got {p.dtype} for {name}")

    # ------------------------------------------------------------ state
    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWBF16State:
        self._validate(params)
        gen = torch.Generator().manual_seed(self.seed)
        phases = torch.rand(len(params), generator=gen) * DECAY_THRESHOLD

        def zeros():  # same shape and strides as the parameter
            return {n: torch.zeros_like(p) for n, p in params.items()}

        def moments(signed: bool):
            return {n: quantized_zeros(p, signed) if self._quantized(p)
                    else torch.zeros_like(p) for n, p in params.items()}

        return AdamWBF16State(
            step=0, exp_avg=moments(True), exp_avg_sq=moments(False),
            shift=zeros(),
            accumulated_decay={n: phases[i].clone()
                               for i, n in enumerate(params)},
            generator=gen)

    def _quantized(self, p: torch.Tensor) -> bool:
        return self.moments == "int8" and p.dtype == torch.bfloat16

    def lr_eff(self, step: int) -> float:
        """``lr * sqrt(1 - beta2**step)`` in fp32 arithmetic, as JAX's
        ``cur_lr * denom_correction``.  The power is rounded once to fp32
        (XLA's ``pow``); ``torch.pow`` would multiply out small integer
        exponents with a rounding per product."""
        b2t = np.float32(float(np.float32(self.beta2)) ** step)
        dc = np.sqrt(np.float32(1.0) - b2t, dtype=np.float32)
        return float(np.float32(self.lr) * dc)

    # ----------------------------------------------------------- update
    def update(self, grads: Mapping[str, torch.Tensor],
               state: AdamWBF16State, params: Mapping[str, torch.Tensor],
               seeds: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], AdamWBF16State]:
        """One step.  Two uint32 seeds are drawn per leaf, in ``params``'
        order (fp32 leaves ignore theirs, as in JAX); ``seeds`` ([n_leaves,
        2]) replaces the draw, so a test can hand in JAX's.  A leaf that is
        neither bf16 nor fp32 raises before any leaf is updated."""
        self._validate(params)
        step = state.step + 1
        lr_eff = self.lr_eff(step)
        if seeds is None:
            seeds = torch.randint(0, 2 ** 32, (len(params), 2),
                                  generator=state.generator,
                                  dtype=torch.int64)
        seed_rows: List[List[int]] = seeds.tolist()
        deltas: Dict[str, torch.Tensor] = {}
        for (name, p), (seed0, seed1) in zip(params.items(), seed_rows):
            g = grads[name]
            m, v = state.exp_avg[name], state.exp_avg_sq[name]
            if p.dtype == torch.float32:
                deltas[name], state.exp_avg[name], state.exp_avg_sq[name] = \
                    self._f32_leaf(p, g, m, v, lr_eff)
                continue
            acc = state.accumulated_decay[name] + self.weight_decay * self.lr
            fire = bool(acc > DECAY_THRESHOLD)
            quantized = self._quantized(p)
            if quantized:
                m = _like(p, dequantize_8bit(m, signed=True))
                v = _like(p, dequantize_8bit(v, signed=False))
            deltas[name], m, v, sh = fused_adamw_update(
                p, g, m, v, state.shift[name], lr_eff,
                float(acc) if fire else 0.0, seed0, seed1, self.beta1,
                self.beta2, self.eps)
            if quantized:
                m, v = quantize_8bit(m, signed=True), quantize_8bit(
                    v, signed=False)
            state.exp_avg[name], state.exp_avg_sq[name] = m, v
            state.shift[name] = sh
            state.accumulated_decay[name] = torch.zeros_like(acc) if fire \
                else acc
        state.step = step
        return deltas, state

    def _f32_leaf(self, p, g, m, v, lr_eff: float):
        """JAX ``f32_update`` + ``f32_delta``: exact fp32 AdamW."""
        b1, b2 = self.beta1, self.beta2
        g32 = g.float()
        m = m * b1 + (1.0 - b1) * g32
        v = v * b2 + (1.0 - b2) * g32 * g32
        delta = (-lr_eff) * m / (torch.sqrt(v) + self.eps) \
            - self.weight_decay * self.lr * p
        return delta, m, v


def _like(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` with ``p``'s strides: the fused kernel takes one layout, and
    on the card the decode's elementwise ops returned other strides for
    some leaves (a ValueError from ``fused_adamw_cuda`` on an H100)."""
    if t.stride() == p.stride():
        return t
    return torch.empty_like(p, dtype=t.dtype).copy_(t)
