"""Flash-attention forward: the plain version and the CUDA kernel's wrapper.

Port of the forward half of ``sdxl_training_improvements_tpu/ops/
flash_attention.py``.  The kernel (``csrc/flash_fwd.cu``) replaces the
Pallas ``_fwd_kernel``; its source note gives the design.  The backward
kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) belong to training and
are not ported yet; the logsumexp is returned for them.

Layout at this module's functions: q [B, S, H, D], k and v [B, T, H, D]
(the JAX package's layout), out [B, S, H, D], lse [B, H, S] fp32.  The
dispatch by device is ``ops/attention.py::dot_product_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (out, lse): fp32 logits and softmax, probabilities cast to
    v's dtype before the value product, as the Pallas kernel does."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype), lse


@functools.lru_cache(maxsize=None)
def _library():
    """The C launcher, built and loaded at first use."""
    from sdxl_training_improvements_tpu_torch.ops import _build
    fn = _build.load("flash_fwd").flash_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _addressable(x: torch.Tensor) -> torch.Tensor:
    """x with a unit last stride and 16-byte aligned rows, copying only
    when the given strides do not allow 16-byte loads."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def flash_attention_fwd_cuda(q, k, v, scale: Optional[float] = None):
    """Launch the CUDA kernel; raises on what it does not take."""
    b, s, h, d = q.shape
    t = k.shape[1]
    if k.shape != (b, t, h, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    for x in (q, k, v):
        if x.dtype != torch.bfloat16 or x.device != q.device:
            raise TypeError("flash kernel takes bf16 q, k, v on one device")
    if t < 1 or s < 1:
        raise ValueError("empty sequence")
    if b * h > 65535:  # grid.y of the launch
        raise ValueError(f"batch * heads = {b * h} exceeds 65535")
    scale = d ** -0.5 if scale is None else scale
    q, k, v = _addressable(q), _addressable(k), _addressable(v)
    out = torch.empty((b, s, h, d), device=q.device, dtype=torch.bfloat16)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    strides = (ctypes.c_int64 * 12)(
        *[x.stride(i) for x in (q, k, v, out) for i in range(3)])
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, s, t, d, strides, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {rc}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0
