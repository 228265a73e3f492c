"""Attention dispatch for the UNet.

Port of ``sdxl_training_improvements_tpu/ops/attention.py``.  On the card
the hand-written flash kernels are the UNet's attention at every ``attn1``
/ ``attn2`` site, forward and backward (``ops/flash_attention.py::
FlashAttention``); on the CPU the plain path runs, differentiable by
autograd.  The JAX module's
``chunked`` path (a bounded-memory XLA workaround) has no port: the flash
kernel never materialises the scores.

Layout: [B, S, H, D]; softmax in fp32 whatever the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from sdxl_training_improvements_tpu_torch.ops.flash_attention import (
    flash_attention)


def dot_product_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain attention, fp32 softmax. q [B, S, H, D]; k, v [B, T, H, D]."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The flash kernels for CUDA tensors, the plain path for CPU
    tensors; both carry the gradient."""
    if q.device.type == "cpu":
        return dot_product_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"dot_product_attention: no kernel for {q.device}")
    return flash_attention(q, k, v)
