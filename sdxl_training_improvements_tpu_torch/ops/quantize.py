"""8-bit log-code quantization for optimizer moments.

Port of ``sdxl_training_improvements_tpu/ops/quantize.py`` (no Pallas
kernel there: the JAX package computes it as elementwise XLA, and so does
the port, in plain PyTorch on either device).  ``adamw_bf16``'s int8
moments store each bf16 leaf's ``exp_avg`` and ``exp_avg_sq`` as one uint8
code per element plus one fp32 scale per leaf: 4 instead of 6 state bytes
a parameter.

The code is log-spaced: 0, then values log-uniform over ``_DECADES``
decades up to the leaf's absmax, so the error is a constant fraction of
each element's own value (about 3.7% at half a step unsigned, 7.5%
signed).  Both directions are arithmetic, with no table:

* unsigned: ``q=0 -> 0``; ``q in 1..255 -> 10^(-D + D*(q-1)/254)``
* signed:   ``q in 0..126 -> -10^(-D*q/126)``; ``q=127 -> 0``;
  ``q in 128..255 -> 10^(-D + D*(q-128)/127)``

Non-finite elements are left out of the absmax and take the top code of
their sign (NaN the top positive code), so a corrupt element stays
confined to itself.

The arithmetic is the form XLA compiles JAX's expressions into (read
from the optimised HLO of the jitted JAX functions): constant factors
folded (``exp2(log2(10) * y)`` is ``exp(y * f32(ln 10))``, ``log2(x) /
log2(10)`` is ``log(x) * f32(log10 e)``, ``8 * (q - 1) / 254`` is ``(q -
1) * f32(8 / 254)``) and the decode's ``(q - c) * step - D`` one FMA.
That FMA needs no emulation: an integer below 256 times an fp32 step, less
8, is exact in fp64, so one rounding to fp32 is the FMA's result.  XLA's
CPU ``exp`` and ``log`` are its own polynomials, not torch's, so a value
can still differ in its last bits; the tests count the codes and the
bf16 values that move because of it.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_DECADES = 8.0
_LOG2_10 = math.log2(10.0)
_ZERO_CUTOFF = 0.5 * 10.0 ** (-_DECADES)
_F = np.float32
# the folded constants of XLA's compiled form, in fp32 arithmetic
_LN10 = float(_F(_F(_LOG2_10) * _F(math.log(2.0))))  # exp2(log2(10) * y)
_LOG10_E = float(_F(math.log10(math.e)))  # log2(x) / log2(10)
_STEP_U = float(_F(_DECADES) / _F(254.0))
_STEP_P = float(_F(_DECADES) / _F(127.0))
_STEP_N = float(_F(-_DECADES) / _F(126.0) * _F(_LN10))


def _f(x: float) -> float:
    """A Python scalar as JAX's weak type meets an fp32 array."""
    return float(_F(x))


def _log_value(q: torch.Tensor, zero: float, step: float) -> torch.Tensor:
    """fp32 ``(q - zero) * step - D`` rounded once (the FMA), from the
    uint8 codes: exact in fp64 before the one rounding."""
    return ((q.double() - zero) * step - _DECADES).float()


def _decode_unsigned(q: torch.Tensor) -> torch.Tensor:
    w = torch.exp(_log_value(q, 1.0, _STEP_U) * _LN10)
    return torch.where(q == 0, torch.zeros_like(w), w)


def _decode_signed(q: torch.Tensor) -> torch.Tensor:
    neg = -torch.exp(q.float() * _STEP_N)
    pos = torch.exp(_log_value(q, 128.0, _STEP_P) * _LN10)
    zero = torch.zeros_like(pos)
    return torch.where(q < 127, neg, torch.where(q == 127, zero, pos))


def quantize_8bit(x: torch.Tensor, signed: bool = True,
                  absmax_reduce=None) -> Dict[str, torch.Tensor]:
    """``{"q": uint8 codes (x.shape, x's strides), "s": fp32 0-d scale}``:
    nearest code in log space after absmax normalisation; an all-zero
    input gets scale 1.  ``absmax_reduce`` turns ``x``'s absmax into the
    whole leaf's when ``x`` is a ZeRO chunk (a MAX over the leaf's
    shards), so the chunks' codes are the whole leaf's."""
    x32 = x.float()
    finite = torch.isfinite(x32)
    absmax = torch.where(finite, x32, torch.zeros_like(x32)).abs().amax()
    if absmax_reduce is not None:
        absmax = absmax_reduce(absmax)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    one = torch.ones_like(x32)
    y = torch.where(finite, x32 / scale, torch.where(x32 < 0, -one, one))
    ay = y.abs()
    l10 = torch.log(torch.clamp(ay, min=_f(1e-38))) * _LOG10_E
    if signed:
        jneg = torch.clamp(torch.round((-l10) * _f(126.0 / _DECADES)),
                           0.0, 126.0)
        kpos = torch.clamp(torch.round((l10 + _DECADES) * _f(
            127.0 / _DECADES)), 0.0, 127.0) + 128.0
        q = torch.where(y < 0, jneg, kpos)
        q = torch.where(ay < _f(_ZERO_CUTOFF), torch.full_like(q, 127.0), q)
    else:
        q = torch.clamp(torch.round((l10 + _DECADES) * _f(
            254.0 / _DECADES)), 0.0, 254.0) + 1.0
        q = torch.where(ay < _f(_ZERO_CUTOFF), torch.zeros_like(q), q)
    return {"q": q.to(torch.uint8), "s": scale}


def dequantize_8bit(qs: Dict[str, torch.Tensor], signed: bool = True,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    q = qs["q"]
    w = _decode_signed(q) if signed else _decode_unsigned(q)
    return (w * qs["s"]).to(dtype)


def quantized_zeros(like: torch.Tensor, signed: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """The codes of an all-zero tensor shaped, strided and placed like
    ``like``, with scale 1."""
    zero_idx = 127 if signed else 0
    return {"q": torch.full_like(like, zero_idx, dtype=torch.uint8),
            "s": torch.ones((), dtype=torch.float32, device=like.device)}

