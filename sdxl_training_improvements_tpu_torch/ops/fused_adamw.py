"""Fused bf16 stochastic-rounding AdamW: the plain chain and the CUDA
kernel's wrapper.

Port of ``sdxl_training_improvements_tpu/ops/fused_adamw.py``.  The kernel
(``csrc/fused_adamw.cu``) replaces the Pallas ``_fused_kernel``; its source
note gives the design.  It is held to the XLA chain that the JAX optimizer
runs by default (``training/optimizers/adamw_bf16.py::bf16_update``,
``noise="hash"``), bit for bit, and not to the Pallas kernel's own choices:
that kernel draws the TPU's hardware random bits and rounds ``g`` to bf16.

* ``adamw_bf16_chain`` — the plain chain on given noise planes (the tests
  hand it zero planes to meet the Pallas kernel's interpret mode).
* ``fused_adamw_reference`` — the chain with the counter-hash planes: the
  CPU path and the oracle of the kernel.
* ``fused_adamw_cuda`` — the kernel's wrapper.
* ``fused_adamw_update`` — the dispatcher by device.

All take p, m, v, shift in bf16 and g in fp32 (the gradient accumulator)
or bf16, and return ``(delta, m, v, shift)`` with ``delta = bf16(p' - p)``:
the optimizer hands back the delta and the train step adds it, as JAX's
``optax.apply_updates`` does.  The noise index is the element's position
in memory, so a channels-last leaf gets the same noise on both paths.

Rounding: the JAX chain, jitted by XLA:CPU, computes three of its
``a * b + c`` forms as fused multiply-adds (measured against the JAX
optimizer over 2**20 elements: each form with two roundings disagrees on
some elements, the fused form on none): the first moment's
``(1 - b1) * g + bf16(m * b1)``, the second moment's
``((1 - b2) * g) * g + v * b2`` and the decay's ``shift - acc * p'``.  The
chain here and the kernel compute exactly those three as FMAs and every
other operation with its own rounding.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.ops.stochastic import (
    add_stochastic_bits, addcdiv_stochastic_bits, counter_noise, fma_f32)

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def memory_order(x: torch.Tensor) -> torch.Tensor:
    """A 1-D view of a dense tensor in memory order."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    y = x.permute(order)
    if not y.is_contiguous():
        raise ValueError(f"tensor with strides {x.stride()} is not dense")
    return y.reshape(-1)


def noise_planes(seed0: int, seed1: int, n: int, device=None):
    """The four 16-bit noise planes of one leaf (JAX ``_noise_planes``,
    "hash"): (n0, n0 >> 16, n1, n1 >> 16)."""
    n0 = counter_noise(seed0, n, device)
    n1 = counter_noise(seed1, n, device)
    return n0, n0 >> 16, n1, n1 >> 16


def adamw_bf16_chain(p, g, m, v, shift, lr_eff: float, decay_amt: float,
                     noise: Sequence[torch.Tensor], beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8) -> Quad:
    """The per-element chain of ``bf16_update`` in JAX's order.
    ``lr_eff = lr * sqrt(1 - beta2**t)``; ``decay_amt`` is the accumulated
    decay when it fires this step, else 0."""
    g32 = g.float()
    m_scaled = (m.float() * beta1).to(torch.bfloat16)
    m = add_stochastic_bits(m_scaled, g32, noise[0], alpha=1.0 - beta1)
    v = fma_f32((1.0 - beta2) * g32, g32, v.float() * beta2
                ).to(torch.bfloat16)
    denom = torch.sqrt(v.float()) + eps
    shift = addcdiv_stochastic_bits(shift, m, denom, noise[1],
                                    value=-lr_eff)
    p_new = add_stochastic_bits(p, shift, noise[2])
    shift = add_stochastic_bits(shift, p.float() - p_new.float(), noise[3])
    shift = fma_f32(p_new.float(), -decay_amt, shift.float()
                    ).to(torch.bfloat16)
    delta = (p_new.float() - p.float()).to(torch.bfloat16)
    return delta, m, v, shift


def fused_adamw_reference(p, g, m, v, shift, lr_eff: float, decay_amt: float,
                          seed0: int, seed1: int, beta1: float = 0.9,
                          beta2: float = 0.999, eps: float = 1e-8) -> Quad:
    """Plain version of the kernel: the chain with the counter-hash noise
    over each element's memory position.  Returns new tensors."""
    flat = [memory_order(x) for x in (p, g, m, v, shift)]
    noise = noise_planes(seed0, seed1, p.numel(), p.device)
    outs = adamw_bf16_chain(*flat, lr_eff, decay_amt, noise, beta1, beta2,
                            eps)
    shaped = []
    for out in outs:
        y = torch.empty_like(p)
        memory_order(y).copy_(out)
        shaped.append(y)
    return tuple(shaped)


@functools.lru_cache(maxsize=None)
def _library():
    from sdxl_training_improvements_tpu_torch.ops import _build
    fn = _build.load("fused_adamw").fused_adamw_bf16
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_float] * 2 + [ctypes.c_uint32] * 2
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _f32(x: float) -> float:
    """A Python float rounded to fp32, as JAX casts a weak-typed scalar."""
    return float(np.float32(x))


def fused_adamw_cuda(p, g, m, v, shift, lr_eff: float, decay_amt: float,
                     seed0: int, seed1: int, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8) -> Quad:
    """Launch the kernel.  ``m``, ``v`` and ``shift`` are updated in place
    and returned with a new ``delta``; raises on what it does not take."""
    if p.device.type != "cuda":
        raise ValueError(f"fused AdamW kernel needs CUDA tensors, got "
                         f"{p.device}")
    for name, x in (("p", p), ("m", m), ("v", v), ("shift", shift)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"fused AdamW kernel takes bf16 {name}, got "
                            f"{x.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused AdamW kernel takes fp32 or bf16 g, got "
                        f"{g.dtype}")
    for x in (g, m, v, shift):
        if (x.device != p.device or x.shape != p.shape
                or x.stride() != p.stride()):
            raise ValueError("p, g, m, v, shift must share device, shape "
                             "and strides")
    memory_order(p)  # dense
    n = p.numel()
    if n >= 2 ** 32:
        raise ValueError(f"{n} elements: the noise index is 32-bit")
    delta = torch.empty_like(p)
    fn = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(p.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
                m.data_ptr(), v.data_ptr(), shift.data_ptr(),
                delta.data_ptr(), n, _f32(-lr_eff), _f32(decay_amt),
                int(seed0) & 0xFFFFFFFF, int(seed1) & 0xFFFFFFFF,
                _f32(beta1), _f32(1.0 - beta1), _f32(beta2),
                _f32(1.0 - beta2), _f32(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw launch failed: cudaError_t {rc}")
    fused_adamw_cuda.launches += 1
    return delta, m, v, shift


fused_adamw_cuda.launches = 0


def fused_adamw_update(p, g, m, v, shift, lr_eff: float, decay_amt: float,
                       seed0: int, seed1: int, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8) -> Quad:
    """The plain chain for CPU tensors, the kernel for CUDA tensors."""
    args = (p, g, m, v, shift, lr_eff, decay_amt, seed0, seed1, beta1,
            beta2, eps)
    if p.device.type == "cpu":
        return fused_adamw_reference(*args)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: no kernel for {p.device}")
    return fused_adamw_cuda(*args)
