"""Flash attention: plain versions, the CUDA kernels' wrappers and the
``torch.autograd.Function`` that joins them.

Port of ``sdxl_training_improvements_tpu/ops/flash_attention.py``.

* forward: ``csrc/flash_fwd.cu`` replaces the Pallas ``_fwd_kernel``;
* backward: ``csrc/flash_bwd.cu`` replaces ``_bwd_dq_kernel`` (dq, a block
  per q tile looping over kv tiles) and ``_bwd_dkv_kernel`` (dk and dv, a
  block per kv tile looping over q tiles).  Both recompute the
  probabilities from (q, k, lse); Delta = rowsum(dO * O) is a plain torch
  op, as JAX forms it outside Pallas.
* ``FlashAttention`` saves (q, k, v, out, lse) in the forward, as
  ``_flash_core_fwd`` does, and runs the two backward kernels.

Each source note gives its kernel's design.  Layout at this module's
functions: q [B, S, H, D], k and v [B, T, H, D] (the JAX package's
layout), out [B, S, H, D], lse [B, H, S] fp32.  The dispatch by device is
``ops/attention.py::dot_product_attention``.
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
    v's dtype before the value product, as the Pallas kernel does.  The
    probabilities are exp(x - max) / sum, as the kernels' online softmax
    forms them: exp(x - lse) loses |lse| * 2**-24 of relative precision,
    which the backward's Delta = rowsum(dO * out) would inherit."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_delta(out: torch.Tensor, dout: torch.Tensor
                              ) -> torch.Tensor:
    """Delta = rowsum(dO * O) in fp32, [B, H, S] (JAX ``_bwd`` forms it
    outside the kernels too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, dout, lse, delta, scale: float):
    """fp32 P = exp(q k^T * scale - lse) and dS = P * (dP - Delta) * scale
    with dP = dO v^T, each [B, H, S, T]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale: float):
    """Plain version of the dq kernel: dq = dS k, fp32, in q's dtype."""
    _, ds = _bwd_probs(q, k, v, dout, lse, delta, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale: float):
    """Plain version of the dk/dv kernel: dk = dS^T q, dv = P^T dO, fp32,
    in k's dtype."""
    p, ds = _bwd_probs(q, k, v, dout, lse, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  scale: Optional[float] = None):
    """Plain (dq, dk, dv), fp32 throughout, the backward's formulas:
    P = exp(q k^T * scale - lse), dP = dO v^T, dS = P * (dP - Delta) *
    scale, dq = dS k, dk = dS^T q, dv = P^T dO."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = flash_attention_bwd_delta(out, dout)
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv


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


def _check(q, k, v, *more):
    """Raise on what the kernels do not take: bf16 [B, S, H, D] q and
    [B, T, H, D] k, v (and more tensors shaped like q) on one card."""
    b, s, h, d = q.shape
    t = k.shape[1]
    if k.shape != (b, t, h, d) or v.shape != k.shape or any(
            x.shape != q.shape for x in more):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    for x in (q, k, v) + more:
        if x.dtype != torch.bfloat16 or x.device != q.device:
            raise TypeError("flash kernel takes bf16 q, k, v on one device")
    if t < 1 or s < 1:
        raise ValueError("empty sequence")
    if b * h > 65535:  # grid.y of the launch
        raise ValueError(f"batch * heads = {b * h} exceeds 65535")


def flash_attention_fwd_cuda(q, k, v, scale: Optional[float] = None):
    """Launch the CUDA kernel; raises on what it does not take."""
    _check(q, k, v)
    b, s, h, d = q.shape
    t = k.shape[1]
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


@functools.lru_cache(maxsize=None)
def _bwd_library():
    """The two backward launchers, built and loaded at first use."""
    from sdxl_training_improvements_tpu_torch.ops import _build
    lib = _build.load("flash_bwd")
    for fn in (lib.flash_bwd_dq_bf16, lib.flash_bwd_dkv_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_inputs(q, k, v, dout, lse, delta):
    """The backward kernels' inputs, checked and laid out for them: bf16
    q, dO [B, S, H, D] and k, v [B, T, H, D] on one card, lse and delta
    [B, H, S] fp32; raises on anything else."""
    _check(q, k, v, dout)
    b, s, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, s) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{name} must be [B, H, S] fp32 on q's device, "
                             f"got {tuple(x.shape)} {x.dtype} {x.device}")
    return (*(_addressable(x) for x in (q, k, v, dout)), lse.contiguous(),
            delta.contiguous())


def _bwd_launch(fn, name, q, k, v, dout, lse, delta, dq, dk, dv, scale):
    """One backward launcher over (batch, seq, head)-strided bf16 tensors;
    the outputs it does not write are None."""
    b, s, h, d = q.shape
    t = k.shape[1]
    tensors = (q, k, v, dout, dq, dk, dv)
    strides = (ctypes.c_int64 * 21)(
        *[0 if x is None else x.stride(i) for x in tensors for i in range(3)])
    ptrs = [0 if x is None else x.data_ptr()
            for x in (q, k, v, dout, lse, delta, dq, dk, dv)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, b, h, s, t, d, strides, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, scale: float):
    """Launch the dq kernel (Pallas ``_bwd_dq_kernel``); raises on what it
    does not take."""
    q, k, v, dout, lse, delta = _bwd_inputs(q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, device=q.device, dtype=torch.bfloat16)
    _bwd_launch(_bwd_library().flash_bwd_dq_bf16, "flash_bwd_dq", q, k, v,
                dout, lse, delta, dq, None, None, scale)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, scale: float):
    """Launch the dk/dv kernel (Pallas ``_bwd_dkv_kernel``); raises on what
    it does not take."""
    q, k, v, dout, lse, delta = _bwd_inputs(q, k, v, dout, lse, delta)
    dk = torch.empty(k.shape, device=k.device, dtype=torch.bfloat16)
    dv = torch.empty_like(dk)
    _bwd_launch(_bwd_library().flash_bwd_dkv_bf16, "flash_bwd_dkv", q, k, v,
                dout, lse, delta, None, dk, dv, scale)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                             scale: Optional[float] = None):
    """(dq, dk, dv) in bf16 through the two backward kernels; raises on
    what they do not take."""
    _check(q, k, v, out, dout)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = flash_attention_bwd_delta(out, dout)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = softmax(q k^T * scale) v through the flash kernels; the
    forward saves (q, k, v, out, lse) as ``_flash_core_fwd`` does.  The
    kernel functions are looked up at call time, so a test can put the
    plain versions in their place."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, S, H, D]; k, v [B, T, H, D] -> [B, S, H, D], differentiable."""
    return FlashAttention.apply(q, k, v,
                                q.shape[-1] ** -0.5 if scale is None
                                else scale)
