"""Plain AdamW: ``optimizer_type: "adamw"``, the fp32-state baseline.

Port of what JAX's ``make_optimizer`` builds for it (``training/
optimizers/__init__.py``): ``optax.adamw(lr, b1, b2, eps, weight_decay)``,
that is ``scale_by_adam`` (``eps_root`` 0, ``mu_dtype`` None), then
``add_decayed_weights`` on every leaf, then ``scale_by_learning_rate``.
It is written as the plain per-leaf update, as ``AdamWBF16._f32_leaf`` is,
not as ``torch.optim``'s fused kernel, so each operation rounds where
optax's does, with each Python scalar rounded to the dtype of the array
it meets (``_weak``):

* mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, the moments
  starting as zeros in each parameter's dtype and taking the dtype the
  arithmetic promotes to, as optax's do (an fp16 leaf with the trainer's
  fp32 gradients holds fp32 moments from its first step on);
* mu_hat = mu / (1 - b1^t) and nu_hat = nu / (1 - b2^t), the correction
  formed in fp32 and rounded to the moment's dtype before the division;
* update = -lr (mu_hat / (sqrt(nu_hat) + eps) + weight_decay p).

``update`` returns the per-parameter deltas and the new state; the train
step adds the deltas to the parameters in their dtype, as
``optax.apply_updates`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


@dataclass
class AdamWState:
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _weak(c: float, t: torch.Tensor) -> float:
    """The Python scalar ``c`` rounded to ``t``'s dtype, as JAX converts a
    weakly typed scalar before it meets an array (torch would keep it in
    fp32 against a 16-bit tensor)."""
    return float(torch.tensor(c, dtype=torch.float64).to(t.dtype))


def _bias_correction(beta: float, step: int, dtype: torch.dtype) -> float:
    """1 - beta**step in fp32 (the power rounded once, as XLA's ``pow``),
    then rounded to ``dtype``, as optax's ``tree_bias_correction``."""
    power = np.float32(float(np.float32(beta)) ** step)
    corr = torch.tensor(float(np.float32(1.0) - power), dtype=torch.float32)
    return float(corr.to(dtype))


class AdamW:
    """``init(params)`` and ``update(grads, state, params)`` over dicts of
    tensors keyed by parameter name."""

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            step=0, mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor], zero=None
               ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        """One step.  Elementwise, so a ZeRO chunk (``zero``, ignored)
        updates as its slice of the whole leaf."""
        step = state.step + 1
        b1, b2 = self.beta1, self.beta2
        deltas: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name]
                m, v = state.mu[name], state.nu[name]
                g2 = g * g
                mu = _weak(1 - b1, g) * g + _weak(b1, m) * m
                nu = _weak(1 - b2, g2) * g2 + _weak(b2, v) * v
                mu_hat = mu / _bias_correction(b1, step, mu.dtype)
                nu_hat = nu / _bias_correction(b2, step, nu.dtype)
                root = torch.sqrt(nu_hat)
                u = mu_hat / (root + _weak(self.eps, root))
                u = u + _weak(self.weight_decay, p) * p
                deltas[name] = _weak(-self.lr, u) * u
                state.mu[name], state.nu[name] = mu, nu
        state.step = step
        return deltas, state
