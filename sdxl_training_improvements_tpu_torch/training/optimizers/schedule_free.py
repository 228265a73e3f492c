"""Schedule-free AdamW with Kahan-compensated parameter writes.

Port of ``sdxl_training_improvements_tpu/training/optimizers/
schedule_free.py``.  Per parameter: an fp32 ``exp_avg_sq``, the fp32
schedule-free iterate ``z`` and an fp32 Kahan compensation.  Step k (from
0):

* ``sched = (k + 1) / warmup`` while ``k < warmup``, else 1; the step
  size ``lr * sched`` (the bias correction of the second moment divides
  ``v`` when ``correct_bias``: the reference's sqrt folding);
* ``x = (p - (1 - b1) z) / b1`` recovered from the parameters, which hold
  ``y = (1 - b1) z + b1 x``; ``z -= step * (g / denom + wd * p)``; ``x =
  (1 - c) x + c z`` with ``c = 1 / (k + 1)``; the new ``y``;
* with ``kahan_sum`` the update carries the compensation: ``upd = y - p +
  comp``, ``p' = dtype(p + upd)``, ``comp = upd - (p' - p)``.

``update`` returns deltas in the parameters' dtypes.  Scalars are formed
in fp32 arithmetic as XLA forms JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_F = np.float32


@dataclass
class ScheduleFreeKahanState:
    step: int
    exp_avg_sq: Dict[str, torch.Tensor]
    z: Dict[str, torch.Tensor]  # fp32 schedule-free iterate
    kahan_comp: Dict[str, torch.Tensor]  # compensation of the writes


class AdamWScheduleFreeKahan:
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2,
                 warmup_steps: int = 0, kahan_sum: bool = True,
                 correct_bias: bool = True):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.kahan_sum = kahan_sum
        self.correct_bias = correct_bias

    def init(self, params: Mapping[str, torch.Tensor]
             ) -> ScheduleFreeKahanState:
        def zeros():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        return ScheduleFreeKahanState(
            step=0, exp_avg_sq=zeros(),
            z={n: p.detach().to(torch.float32, copy=True)
               for n, p in params.items()},
            kahan_comp=zeros())

    def scalars(self, k: int) -> Tuple[float, float, float]:
        """(step size, 1 - beta2^(k+1), c) of step ``k``, in fp32."""
        kf = _F(k)
        sched = ((kf + _F(1.0)) / _F(max(self.warmup_steps, 1))
                 if k < self.warmup_steps else _F(1.0))
        bc2 = _F(1.0) - _F(float(_F(self.beta2)) ** (k + 1))
        return (float(_F(self.lr) * sched), float(bc2),
                float(_F(1.0) / (kf + _F(1.0))))

    def update(self, grads: Mapping[str, torch.Tensor],
               state: ScheduleFreeKahanState,
               params: Mapping[str, torch.Tensor], zero=None
               ) -> Tuple[Dict[str, torch.Tensor], ScheduleFreeKahanState]:
        """One step.  Elementwise, so a ZeRO chunk (``zero``, ignored)
        updates as its slice of the whole leaf."""
        step_size, bc2, c = self.scalars(state.step)
        b1, b2 = self.beta1, self.beta2
        deltas: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for n, p in params.items():
                g32, p32 = grads[n].float(), p.detach().float()
                v = state.exp_avg_sq[n].mul_(b2).add_(g32 * g32,
                                                      alpha=1.0 - b2)
                denom = torch.sqrt(v / bc2 if self.correct_bias else v) \
                    + self.eps
                z = state.z[n]
                x = (p32 - (1.0 - b1) * z) / b1
                z.sub_(step_size * (g32 / denom + self.weight_decay * p32))
                x = (1.0 - c) * x + c * z
                upd = (1.0 - b1) * z + b1 * x - p32
                if self.kahan_sum:
                    upd = upd + state.kahan_comp[n]
                    new_p = (p32 + upd).to(p.dtype).float()
                    state.kahan_comp[n] = upd - (new_p - p32)
                    upd = new_p - p32
                deltas[n] = upd.to(p.dtype)
        state.step += 1
        return deltas, state


def schedule_free_eval_params(state: ScheduleFreeKahanState,
                              params: Mapping[str, torch.Tensor],
                              beta1: float = 0.9
                              ) -> Dict[str, torch.Tensor]:
    """The averaged x sequence for evaluation: ``x = (y - (1 - b1) z) /
    b1`` in the parameters' dtypes."""
    with torch.no_grad():
        return {n: ((p.float() - (1.0 - beta1) * state.z[n]) / beta1
                    ).to(p.dtype) for n, p in params.items()}
