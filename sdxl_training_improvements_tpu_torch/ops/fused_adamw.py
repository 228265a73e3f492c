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
* ``fused_adamw_reference`` — the chain with the counter-hash planes of
  two seeds ("hash"), or with two drawn uint32 planes (``planes``,
  "rbg"): the CPU path and the oracle of the kernel.
* ``fused_adamw_cuda`` — the kernel's wrapper; ``planes`` selects the rbg
  variant (a template parameter of the same kernel).
* ``fused_adamw_update`` — the dispatcher by device.
* ``draw_planes`` — the rbg planes of n elements from a generator.

``decay`` (a [k] fp32 tensor) replaces ``decay_amt`` with one amount per
slice of ``numel // k`` elements in memory order: the stacked layout's
per-leaf decay.

All take p, m, v, shift in bf16 and g in fp32 (the gradient accumulator)
or bf16, and return ``(delta, m, v, shift)`` with ``delta = bf16(p' - p)``:
the optimizer hands back the delta and the train step adds it, as JAX's
``optax.apply_updates`` does.  The noise index is the element's position
in memory, so a channels-last leaf gets the same noise on both paths;
``base`` adds an offset to it, so that a ZeRO chunk (``parallel/zero.py``:
a contiguous run of a leaf in memory order) draws the noise of its
elements' places in the whole leaf, and the chunks' updates, joined, are
the whole leaf's.  ``imap`` (an ``IndexMap``) goes one step further for
a megatron slice (``parallel/mesh.py`` ``TPSplit``), which is a strided
set of its leaf's elements: element i of the launch is element
``base + i`` of the slice, and its noise index is that element's place
in the whole leaf, ``imap(base + i)``.  The rbg planes are drawn for the
whole leaf and gathered through the same map by the caller.

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

import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.ops.stochastic import (
    add_stochastic_bits, addcdiv_stochastic_bits, counter_noise,
    counter_noise_at, fma_f32)

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class IndexMap:
    """A slice's element j (in its memory order) -> its index in the whole
    leaf's memory order: ``off + (j // run) * stride + j % run``, plus
    ``jump`` where ``j % run >= half`` (the gate half of a GEGLU row).  A
    contiguous slice has ``run == stride`` and ``half == run``."""
    off: int
    run: int
    stride: int
    half: int
    jump: int = 0

    @property
    def contiguous(self) -> bool:
        return self.run == self.stride and self.half >= self.run

    def indices(self, first: int, n: int, device=None) -> torch.Tensor:
        """The whole leaf's indices of slice elements [first, first + n),
        int64."""
        j = torch.arange(first, first + n, dtype=torch.int64, device=device)
        q, r = j // self.run, j % self.run
        return (self.off + q * self.stride + r
                + torch.where(r >= self.half, self.jump, 0))


def memory_order(x: torch.Tensor) -> torch.Tensor:
    """A 1-D view of a dense tensor in memory order."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    y = x.permute(order)
    if not y.is_contiguous():
        raise ValueError(f"tensor with strides {x.stride()} is not dense")
    return y.reshape(-1)


def noise_planes(seed0: int, seed1: int, n: int, device=None,
                 base: int = 0, imap: Optional[IndexMap] = None):
    """The four 16-bit noise planes of one leaf, or of n elements of it
    from ``base`` on, or of a slice's elements through ``imap`` (JAX
    ``_noise_planes``, "hash"): (n0, n0 >> 16, n1, n1 >> 16)."""
    if imap is None:
        n0 = counter_noise(seed0, n, device, base)
        n1 = counter_noise(seed1, n, device, base)
    else:
        idx = imap.indices(base, n, device)
        n0 = counter_noise_at(seed0, idx)
        n1 = counter_noise_at(seed1, idx)
    return n0, n0 >> 16, n1, n1 >> 16


def draw_planes(n: int, generator: torch.Generator) -> torch.Tensor:
    """Two planes of n uniform 32-bit words ("rbg" noise), [2, n] int32,
    drawn on the generator's device."""
    return torch.randint(-2 ** 31, 2 ** 31, (2, n), dtype=torch.int32,
                         generator=generator, device=generator.device)


def plane_noise(planes: torch.Tensor):
    """The four 16-bit noise planes (JAX ``_noise_planes``, "rbg") of two
    uint32 planes, [2, n] int32 or int64: (n0, n0 >> 16, n1, n1 >> 16) as
    values in [0, 2**32) held in int64."""
    n0, n1 = (x.to(torch.int64) & 0xFFFFFFFF for x in planes)
    return n0, n0 >> 16, n1, n1 >> 16


def _per_element(decay, n: int):
    """A [k] per-slice decay as one amount per element of n."""
    if not isinstance(decay, torch.Tensor):
        return decay
    return decay.float().repeat_interleave(n // decay.numel())


def adamw_bf16_chain(p, g, m, v, shift, lr_eff: float, decay_amt,
                     noise: Sequence[torch.Tensor], beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8) -> Quad:
    """The per-element chain of ``bf16_update`` in JAX's order.
    ``lr_eff = lr * sqrt(1 - beta2**t)``; ``decay_amt`` is the accumulated
    decay when it fires this step, else 0 (a float, or a tensor of one
    amount per element)."""
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
                          beta2: float = 0.999, eps: float = 1e-8,
                          planes=None, decay=None, base: int = 0,
                          imap: Optional[IndexMap] = None) -> Quad:
    """Plain version of the kernel: the chain with the counter-hash noise
    over each element's memory position plus ``base`` (through ``imap``
    when given), or with ``planes`` ([2, n]) in its place; ``decay``
    ([k]) as in the module docstring.  Returns new tensors."""
    flat = [memory_order(x) for x in (p, g, m, v, shift)]
    noise = (plane_noise(planes) if planes is not None
             else noise_planes(seed0, seed1, p.numel(), p.device, base,
                               imap))
    if decay is not None:
        decay_amt = _per_element(decay, p.numel())
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
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int64]
                   + [ctypes.c_uint32] * 2 + [ctypes.c_int64]
                   + [ctypes.c_uint32] * 5 + [ctypes.c_void_p]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _f32(x: float) -> float:
    """A Python float rounded to fp32, as JAX casts a weak-typed scalar."""
    return float(np.float32(x))


def fused_adamw_cuda(p, g, m, v, shift, lr_eff: float, decay_amt: float,
                     seed0: int, seed1: int, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8,
                     planes=None, decay=None, base: int = 0,
                     imap: Optional[IndexMap] = None) -> Quad:
    """Launch the kernel (its rbg variant with ``planes``, [2, n] int32 on
    p's device; ``base`` and ``imap`` place the hash noise's index, as in
    ``fused_adamw_reference``: a strided ``imap`` takes the kernel's
    strided instantiation).  ``m``, ``v`` and ``shift`` are updated in
    place and returned with a new ``delta``; raises on what it does not
    take."""
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
    if base < 0 or base + n > 2 ** 32:
        raise ValueError(f"elements [{base}, {base + n}): the noise index "
                         "is 32-bit")
    strided = (0, 0, 0, 0, 0)  # (off, run, stride, half, jump): none
    if imap is not None and planes is None:
        if imap.contiguous:  # a plain offset: the base instantiation
            base += imap.off
        else:
            last = base + n - 1
            top = (imap.off + (last // imap.run) * imap.stride
                   + imap.run - 1 + imap.jump)
            if top >= 2 ** 32 or min(imap.run, imap.half) < 1:
                raise ValueError(f"index map {imap} reaches {top}: the "
                                 "noise index is 32-bit")
            strided = (imap.off, imap.run, imap.stride, imap.half,
                       imap.jump)
        if base + n > 2 ** 32:
            raise ValueError(f"elements [{base}, {base + n}): the noise "
                             "index is 32-bit")
    if planes is not None and (
            planes.dtype != torch.int32 or planes.shape != (2, n)
            or planes.device != p.device or not planes.is_contiguous()):
        raise ValueError("planes must be a contiguous [2, n] int32 tensor "
                         "on p's device")
    slice_n = 0
    if decay is not None:
        if (decay.dtype != torch.float32 or decay.dim() != 1
                or decay.device != p.device or n % decay.numel()
                or not decay.is_contiguous()):
            raise ValueError("decay must be a contiguous [k] fp32 tensor "
                             "on p's device with k dividing numel")
        slice_n = n // decay.numel()
    delta = torch.empty_like(p)
    fn = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(p.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
                m.data_ptr(), v.data_ptr(), shift.data_ptr(),
                delta.data_ptr(), n, _f32(-lr_eff), _f32(decay_amt),
                decay.data_ptr() if decay is not None else None, slice_n,
                int(seed0) & 0xFFFFFFFF, int(seed1) & 0xFFFFFFFF, int(base),
                *strided,
                planes.data_ptr() if planes is not None else None,
                _f32(beta1), _f32(1.0 - beta1), _f32(beta2),
                _f32(1.0 - beta2), _f32(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw launch failed: cudaError_t {rc}")
    fused_adamw_cuda.launches += 1
    fused_adamw_cuda.launches_by_noise[
        "rbg" if planes is not None else "strided" if strided[1]
        else "hash"] += 1
    return delta, m, v, shift


# launches in all, and of each variant: "hash" (a whole leaf or a
# contiguous piece of one), "strided" (hash noise through a strided index
# map: its own instantiation), "rbg"
fused_adamw_cuda.launches = 0
fused_adamw_cuda.launches_by_noise = collections.Counter()


def fused_adamw_update(p, g, m, v, shift, lr_eff: float, decay_amt: float,
                       seed0: int, seed1: int, beta1: float = 0.9,
                       beta2: float = 0.999, eps: float = 1e-8,
                       planes=None, decay=None, base: int = 0,
                       imap: Optional[IndexMap] = None) -> Quad:
    """The plain chain for CPU tensors, the kernel for CUDA tensors."""
    args = (p, g, m, v, shift, lr_eff, decay_amt, seed0, seed1, beta1,
            beta2, eps)
    kw = dict(planes=planes, decay=decay, base=base, imap=imap)
    if p.device.type == "cpu":
        return fused_adamw_reference(*args, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_update: no kernel for {p.device}")
    return fused_adamw_cuda(*args, **kw)
