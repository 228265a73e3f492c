"""Weight EMA as a wrapper over any optimizer of the port.

Port of ``sdxl_training_improvements_tpu/training/optimizers/ema.py``
(``with_ema``, ``ema_eval_params``, ``unwrap_ema``).  The wrapper runs the
inner update, forms the new parameters ``p + delta`` in their dtype (as
the train step will) and tracks ``ema = d * ema + (1 - d) * p'`` in an fp32
shadow, with the warmup ``d = min(decay, (1 + t) / (10 + t))``.  The
shadow is a copy: it never aliases a parameter (an fp32 leaf included).
The shadow's update is plain fp32 (XLA fuses it into one FMA: an ulp
apart a step at most).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch



@dataclass
class EMAState:
    inner: Any
    ema: Dict[str, torch.Tensor]  # fp32 shadow of the parameters
    count: int


def ema_factor(decay: float, count: int, warmup: bool = True) -> float:
    """``d`` of step ``count`` in fp32 arithmetic, as JAX forms it."""
    if not warmup:
        return float(np.float32(decay))
    c = np.float32(count)
    ramp = (np.float32(1.0) + c) / (np.float32(10.0) + c)
    return float(min(np.float32(decay), ramp))


class EMA:
    """``with_ema(inner, decay)``: ``init(params)`` and ``update(grads,
    state, params, **kw)`` (keywords go to the inner update)."""

    def __init__(self, inner, decay: float = 0.9999, warmup: bool = True):
        self.inner = inner
        self.decay = decay
        self.warmup = warmup

    def init(self, params: Mapping[str, torch.Tensor]) -> EMAState:
        return EMAState(
            inner=self.inner.init(params),
            ema={n: p.detach().to(torch.float32, copy=True)
                 for n, p in params.items()},
            count=0)

    def update(self, grads: Mapping[str, torch.Tensor], state: EMAState,
               params: Mapping[str, torch.Tensor], **kw
               ) -> Tuple[Dict[str, torch.Tensor], EMAState]:
        """One step; the shadow's update is elementwise, so a ZeRO chunk
        (``zero=``, handed to the inner update) tracks its slice."""
        deltas, state.inner = self.inner.update(grads, state.inner, params,
                                                **kw)
        state.count += 1
        d = ema_factor(self.decay, state.count, self.warmup)
        keep = float(np.float32(1.0) - np.float32(d))
        with torch.no_grad():
            for n, p in params.items():
                new_p = p.detach().float() + deltas[n].float()
                state.ema[n] = torch.add(state.ema[n] * d, new_p,
                                         alpha=keep)
        return deltas, state


def with_ema(inner, decay: float = 0.9999, warmup: bool = True) -> EMA:
    return EMA(inner, decay=decay, warmup=warmup)


def ema_eval_params(opt_state, params: Mapping[str, torch.Tensor]
                    ) -> Mapping[str, torch.Tensor]:
    """The shadow cast to the parameters' dtypes (the weights to ship);
    ``params`` when the state is not an EMA's."""
    if isinstance(opt_state, EMAState):
        return {n: opt_state.ema[n].to(p.dtype) for n, p in params.items()}
    return params


def unwrap_ema(opt_state):
    """The inner optimizer's state."""
    return opt_state.inner if isinstance(opt_state, EMAState) else opt_state
