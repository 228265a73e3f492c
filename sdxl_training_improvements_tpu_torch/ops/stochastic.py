"""Stochastic rounding fp32 -> bf16 and the counter-hash noise, in PyTorch.

Port of ``sdxl_training_improvements_tpu/ops/stochastic.py``: add a random
16-bit integer to the fp32 bit pattern, drop the low 16 bits and read the
high half as bf16, so that E[round(x)] = x.  The noise is lowbias32 of
(element index ^ seed), Wellons' 32-bit avalanche hash.

Everything is integer arithmetic or single fp32 roundings, so the port is
bit-exact against the JAX functions as the JAX optimizer runs them, jitted:
XLA:CPU contracts ``other * alpha + acc`` into one fused multiply-add, and
``add_stochastic_bits`` does the same (``fma_f32``, an exact emulation; a
CPU tensor has no FMA op).  uint32 arithmetic is done in int64 and masked
to 32 bits, as ``torch.uint32`` has no complete operator coverage: a
product of two values below 2**32 can wrap int64, but the low 32 bits of
the wrapped product are still the uint32 product.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """Wellons' lowbias32 over int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def counter_noise(seed: int, n: int, device=None, base: int = 0
                  ) -> torch.Tensor:
    """``lowbias32(i ^ seed)`` for i in [base, base + n): uniform uint32
    values held in int64 (JAX ``counter_noise``; ``base`` > 0 gives a
    ZeRO chunk the noise of its place in the whole leaf).  The index is
    taken mod 2**32, as the kernel's 32-bit index."""
    i = torch.arange(base, base + n, dtype=torch.int64, device=device) & _M32
    return lowbias32(i ^ (int(seed) & _M32))


def counter_noise_at(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """``lowbias32(i ^ seed)`` at the int64 indices ``idx`` (mod 2**32):
    a strided slice's noise (``ops/fused_adamw.py`` ``IndexMap``)."""
    return lowbias32((idx & _M32) ^ (int(seed) & _M32))


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` with one rounding, as an FMA instruction gives.

    In float64 the product of two fp32 values is exact and the sum is
    rounded once; TwoSum recovers that rounding's exact error e.  Rounding
    the float64 sum to fp32 is then right unless the sum sits exactly
    halfway between two fp32 values with e != 0: the exact value lies on
    the side of e, and the other neighbour is taken when e points to it."""
    a = a.double()
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
    c = c.double()
    prod = a * b
    s = prod + c
    bv = s - c
    e = (prod - bv) + (c - (s - bv))
    r = s.float()
    d = s - r.double()
    nb = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf).float())
    tie = (d != 0) & (d == (nb.double() - r.double()) * 0.5)
    return torch.where(tie & (e != 0) & ((e > 0) == (d > 0)), nb, r)


def stochastic_round_bits(x: torch.Tensor, noise: torch.Tensor
                          ) -> torch.Tensor:
    """Round fp32 ``x`` to bf16 with the low 16 bits of ``noise``:
    bits = bits(x) + (noise & 0xFFFF), keep the high 16 bits."""
    bits = x.float().view(torch.int32).to(torch.int64) & _M32
    hi = ((bits + (noise & 0xFFFF)) >> 16) & 0xFFFF
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def add_stochastic_bits(acc_bf16, other, noise, alpha: float = 1.0):
    """bf16 accumulator += alpha * other, fp32 arithmetic, stochastic
    rounding; ``alpha * other + acc`` is one fused multiply-add (a plain
    add when alpha is 1, which XLA folds), as the jitted JAX chain."""
    if alpha == 1.0:
        result = other.float() + acc_bf16.float()
    else:
        result = fma_f32(other.float(), alpha, acc_bf16.float())
    return stochastic_round_bits(result, noise)


def addcdiv_stochastic_bits(acc_bf16, numer, denom, noise,
                            value: float = 1.0):
    """bf16 accumulator += value * numer / denom, fp32 arithmetic,
    stochastic rounding; JAX's order: (value * numer) / denom + acc."""
    result = acc_bf16.float() + value * numer.float() / denom.float()
    return stochastic_round_bits(result, noise)
