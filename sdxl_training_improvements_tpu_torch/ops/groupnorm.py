"""Fused GroupNorm + SiLU for the UNet and VAE resblocks.

Port of ``sdxl_training_improvements_tpu/ops/groupnorm.py``:

* ``groupnorm_silu_reference`` — the plain PyTorch version (fp32
  statistics, fp32 interior, output in the input dtype).  The CPU path and
  the oracle the Triton kernels are held against on the card.
* ``gn_silu_stats_cuda`` / ``gn_silu_apply_cuda`` — two Triton kernels
  that replace all three Pallas kernels of the JAX module:
  ``_gn_silu_kernel`` (single-block, ``groupnorm.py:110``),
  ``_gn_stats_kernel`` (``:148``) and ``_gn_apply_kernel`` (``:161``).
* ``GroupNormSiLU`` — the ``torch.autograd.Function`` around the kernels:
  the forward launches them, the backward recomputes the plain version
  and takes its VJP, as JAX's ``_fused_bwd`` does (there is no Pallas
  backward kernel).
* ``groupnorm_silu`` — the dispatcher: a CPU tensor goes to the plain
  version, differentiable by autograd; a CUDA tensor to the Function.
* ``norm_arith_bf16`` — the trace-time switch of the JAX module: with it
  on, a bf16 input keeps the normalize/affine arithmetic in bf16 in the
  plain versions (here and in ``models/layers.py``); the UNet sets it from
  its config (on iff remat).

Design.  The TPU split into a single-block kernel and a chunked two-pass
pair exists only because one image's tile has to fit VMEM.  On Hopper one
design covers every size: a **stats** kernel over (batch, group, spatial
chunk) that reduces each chunk, and an **apply** kernel over (batch,
S-block, C-block) that merges its image's chunk statistics into mean and
rstd, normalizes, applies the affine and the SiLU and stores in the input
dtype.  Two launches and no host-side combine: at the UNet's sizes a call
is a few microseconds of device time, so launch count matters.
The kernels take fp32 (the VAE, an fp32 UNet), bf16 and fp16 (the UNet
under each ``training.mixed_precision``): they load any of them, compute
in fp32 and store in the input's dtype.
Both kernels are bound by HBM bytes (one read of x for the statistics, one
read and one write for the apply: ~3 passes over the activation).  The
stats grid is sized to keep ~1k programs in flight so a [2, 1024, 2560]
tile and a [1, 1048576, 128] VAE tile both fill the 132 SMs; the apply
kernel reads and writes full 16-byte channel runs, coalesced.

Numerics.  The Pallas kernels use the single-pass E[x^2]-E[x]^2 form.  Over
the million elements of one VAE group at 1024^2 that form cancels in fp32,
so the stats kernel computes each block's mean and centred second moment
exactly in registers and merges blocks, and the apply kernel merges chunks,
with Chan's parallel mean/M2 formula.  It is the same function (the group
variance), computed the way ``groupnorm_silu_reference`` (``jnp.var``,
two-pass) computes it.  The interior stays fp32 for bf16 inputs, as the
Pallas kernel's does (it ignores the JAX remat-gated bf16 interior).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import functools

import torch

_NORM_ARITH_BF16 = contextvars.ContextVar("sdxl_norm_arith_bf16",
                                          default=False)


def norm_arith_bf16_enabled() -> bool:
    return _NORM_ARITH_BF16.get()


@contextlib.contextmanager
def norm_arith_bf16(enabled: bool):
    """Within the block, bf16 inputs keep the plain norms' normalize/affine
    arithmetic in bf16 (fp32 statistics either way)."""
    tok = _NORM_ARITH_BF16.set(bool(enabled))
    try:
        yield
    finally:
        _NORM_ARITH_BF16.reset(tok)


def group_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """groupnorm(x) * scale + bias on channels-last [B, ..., C], computed
    and returned in fp32 (two-pass statistics)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale.float() + bias.float()


def normalize_bf16(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    """The ``norm_arith_bf16`` interior of JAX's norms: fp32 single-pass
    statistics over ``dims`` (E[x^2] - E[x]^2), then (x - mean) * rstd in
    x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = torch.clamp(x32.square().mean(dim=dims, keepdim=True)
                      - mean.square(), min=0.0)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)


def group_norm_bf16(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, num_groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """The ``norm_arith_bf16`` branch of JAX ``group_norm``: fp32
    single-pass statistics, normalize and affine in the input dtype."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, num_groups, c // num_groups)
    xhat = normalize_bf16(xg, (1, 3), eps).reshape(x.shape)
    return xhat * scale.to(x.dtype) + bias.to(x.dtype)


def groupnorm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, num_groups: int = 32,
                             eps: float = 1e-5) -> torch.Tensor:
    """silu(groupnorm(x) * scale + bias) on channels-last [B, ..., C]:
    fp32 interior, or the bf16 one for a bf16 input under
    ``norm_arith_bf16``."""
    if x.dtype == torch.bfloat16 and norm_arith_bf16_enabled():
        y = group_norm_bf16(x, scale, bias, num_groups, eps)
        return y * torch.sigmoid(y)
    y = group_norm_f32(x, scale, bias, num_groups, eps)
    return (y * torch.sigmoid(y)).to(x.dtype)


# ---------------------------------------------------------------------------
# Triton kernels (built at first launch; triton is imported only there)
# ---------------------------------------------------------------------------

_STATS_TARGET_PROGRAMS = 1024


@functools.lru_cache(maxsize=None)
def _kernels():
    """(triton, stats_kernel, apply_kernel), defined at first launch."""
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, mean_ptr, m2_ptr, S, C, CG, G, CHUNK_S,
                     N_CHUNKS, BLOCK_S: tl.constexpr,
                     BLOCK_CG: tl.constexpr):
        b = tl.program_id(0)
        g = tl.program_id(1)
        chunk = tl.program_id(2)
        s0 = chunk * CHUNK_S
        s_end = tl.minimum(s0 + CHUNK_S, S)
        cols = tl.arange(0, BLOCK_CG)
        cmask = cols < CG
        base = x_ptr + b.to(tl.int64) * S * C + g * CG
        zero = tl.sum(tl.zeros([BLOCK_CG], tl.float32), axis=0)
        n = zero
        mean = zero
        m2 = zero
        for s in range(s0, s_end, BLOCK_S):
            rows = s + tl.arange(0, BLOCK_S)
            mask = (rows < s_end)[:, None] & cmask[None, :]
            x = tl.load(base + rows.to(tl.int64)[:, None] * C + cols[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            nb = (tl.minimum(s_end - s, BLOCK_S) * CG).to(tl.float32)
            mb = tl.sum(tl.sum(x, axis=1), axis=0) / nb
            d = tl.where(mask, x - mb, 0.0)
            m2b = tl.sum(tl.sum(d * d, axis=1), axis=0)
            # Chan et al.: merge (n, mean, m2) with the block's (nb, mb, m2b)
            tot = n + nb
            delta = mb - mean
            mean = mean + delta * (nb / tot)
            m2 = m2 + m2b + delta * delta * (n * nb / tot)
            n = tot
        out = (b * N_CHUNKS + chunk) * G + g
        tl.store(mean_ptr + out, mean)
        tl.store(m2_ptr + out, m2)

    @triton.jit
    def apply_kernel(x_ptr, y_ptr, mean_ptr, m2_ptr, scale_ptr, bias_ptr,
                     S, C, CG, G, N_CHUNKS, CHUNK_N, LAST_N, eps,
                     BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        rows = tl.program_id(1) * BLOCK_S + tl.arange(0, BLOCK_S)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        # merge the image's chunk statistics (Chan) for these channels
        part = b * N_CHUNKS * G + cols // CG
        n = tl.zeros([BLOCK_C], tl.float32)
        mean = tl.zeros([BLOCK_C], tl.float32)
        m2 = tl.zeros([BLOCK_C], tl.float32)
        for ch in range(0, N_CHUNKS):
            mc = tl.load(mean_ptr + part + ch * G, mask=cmask, other=0.0)
            m2c = tl.load(m2_ptr + part + ch * G, mask=cmask, other=0.0)
            nc = tl.where(ch == N_CHUNKS - 1, LAST_N, CHUNK_N)
            tot = n + nc
            delta = mc - mean
            mean = mean + delta * (nc / tot)
            m2 = m2 + m2c + delta * delta * (n * nc / tot)
            n = tot
        rstd = tl.rsqrt(m2 / n + eps)
        w = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        bb = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        mask = (rows < S)[:, None] & cmask[None, :]
        offs = (b.to(tl.int64) * S * C + rows.to(tl.int64)[:, None] * C
                + cols[None, :])
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * (rstd * w)[None, :] + bb[None, :]
        y = y * tl.sigmoid(y)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, stats_kernel, apply_kernel


def _check_cuda_input(x3, scale, bias, num_groups):
    if x3.device.type != "cuda":
        raise ValueError(f"GN+SiLU kernel needs a CUDA tensor, got {x3.device}")
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError("GN+SiLU kernel wants a contiguous [B, S, C] tensor")
    if x3.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"GN+SiLU kernel takes fp32, bf16 or fp16, got "
                        f"{x3.dtype}")
    c = x3.shape[-1]
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of {num_groups} groups")
    for t in (scale, bias):
        if t.device != x3.device or t.shape != (c,) or not t.is_contiguous():
            raise ValueError("scale/bias must be contiguous [C] on x's device")


def gn_silu_stats_cuda(x3: torch.Tensor, num_groups: int):
    """Launch the stats kernel.  Returns the per-chunk mean and M2, each
    [B, n_chunks, G] fp32, and the element counts of a full chunk and of
    the last chunk."""
    triton, stats_kernel, _ = _kernels()
    b, s, c = x3.shape
    cg = c // num_groups
    block_cg = triton.next_power_of_2(cg)
    block_s = max(16, 4096 // block_cg)
    want = triton.cdiv(_STATS_TARGET_PROGRAMS, b * num_groups)
    n_chunks = max(1, min(triton.cdiv(s, block_s), want))
    chunk_s = triton.cdiv(triton.cdiv(s, n_chunks), block_s) * block_s
    n_chunks = triton.cdiv(s, chunk_s)
    mean = torch.empty((b, n_chunks, num_groups), device=x3.device,
                       dtype=torch.float32)
    m2 = torch.empty_like(mean)
    stats_kernel[(b, num_groups, n_chunks)](
        x3, mean, m2, s, c, cg, num_groups, chunk_s, n_chunks,
        BLOCK_S=block_s, BLOCK_CG=block_cg, num_warps=4)
    gn_silu_stats_cuda.launches += 1
    gn_silu_stats_cuda.launches_by_dtype[x3.dtype] += 1
    return mean, m2, chunk_s * cg, (s - chunk_s * (n_chunks - 1)) * cg


# launches in all, and of each dtype's specialisation
gn_silu_stats_cuda.launches = 0
gn_silu_stats_cuda.launches_by_dtype = collections.Counter()


def combine_chunk_stats(mean, m2, chunk_n: int, last_n: int, eps: float):
    """Plain form of the merge the apply kernel does: Chan's parallel
    formula over the chunks' (mean, M2) -> per-group mean and rstd, each
    [B, G] fp32."""
    n = torch.full((mean.shape[1],), float(chunk_n), device=mean.device)
    n[-1] = float(last_n)
    total = n.sum()
    n = n[None, :, None]
    mu = (mean * n).sum(dim=1) / total
    m2_all = m2.sum(dim=1) + (n * (mean - mu[:, None, :]) ** 2).sum(dim=1)
    return mu, torch.rsqrt(m2_all / total + eps)


def gn_silu_apply_cuda(x3, mean, m2, chunk_n: int, last_n: int, scale, bias,
                       num_groups: int, eps: float):
    """Launch the apply kernel: merge the chunk statistics, then
    silu((x - mean) * rstd * scale + bias) in x's dtype."""
    triton, _, apply_kernel = _kernels()
    b, s, c = x3.shape
    y = torch.empty_like(x3)
    block_c = min(128, triton.next_power_of_2(c))
    block_s = 64
    grid = (b, triton.cdiv(s, block_s), triton.cdiv(c, block_c))
    apply_kernel[grid](x3, y, mean, m2, scale, bias, s, c, c // num_groups,
                       num_groups, mean.shape[1], float(chunk_n),
                       float(last_n), float(eps), BLOCK_S=block_s,
                       BLOCK_C=block_c, num_warps=4)
    gn_silu_apply_cuda.launches += 1
    gn_silu_apply_cuda.launches_by_dtype[x3.dtype] += 1
    return y


gn_silu_apply_cuda.launches = 0
gn_silu_apply_cuda.launches_by_dtype = collections.Counter()


def groupnorm_silu_cuda(x3, scale, bias, num_groups: int = 32,
                        eps: float = 1e-5):
    _check_cuda_input(x3, scale, bias, num_groups)
    mean, m2, chunk_n, last_n = gn_silu_stats_cuda(x3, num_groups)
    return gn_silu_apply_cuda(x3, mean, m2, chunk_n, last_n, scale, bias,
                              num_groups, eps)


class GroupNormSiLU(torch.autograd.Function):
    """Forward through the kernels on [B, S, C]; backward through the VJP
    of the plain version with its fp32 interior, recomputed from the saved
    (x, scale, bias) as JAX ``_fused_bwd`` does.  ``groupnorm_silu_cuda``
    is looked up at call time, so a test can put the plain version in its
    place."""

    @staticmethod
    def forward(ctx, x3, scale, bias, num_groups, eps):
        ctx.save_for_backward(x3, scale, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return groupnorm_silu_cuda(x3, scale, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, dy):
        x3, scale, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x3, scale, bias)]
        with torch.enable_grad(), norm_arith_bf16(False):
            y = groupnorm_silu_reference(*leaves, ctx.num_groups, ctx.eps)
        dx, dscale, dbias = torch.autograd.grad(y, leaves, dy)
        return dx, dscale, dbias, None, None


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Dispatcher over channels-last [B, ..., C]: the plain version for a
    CPU tensor, the Triton kernels (through ``GroupNormSiLU``) for a CUDA
    tensor; both carry the gradient."""
    if x.device.type == "cpu":
        return groupnorm_silu_reference(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: no kernel for {x.device}")
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    return GroupNormSiLU.apply(x3, scale, bias, num_groups,
                               eps).reshape(x.shape)
