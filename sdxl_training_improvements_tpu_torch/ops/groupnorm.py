"""Fused GroupNorm + SiLU for the UNet and VAE resblocks.

Port of ``sdxl_training_improvements_tpu/ops/groupnorm.py``:

* ``groupnorm_silu_reference`` — the plain PyTorch version (fp32
  statistics, fp32 interior, output in the input dtype): the CPU path and
  the oracle of the forward kernel.  ``group_stats_reference`` gives its
  per-(image, group) mean and rstd, ``gn_silu_fwd_reference`` the three
  outputs of the forward kernel together.
* ``groupnorm_silu_backward_reference`` — the plain backward in closed
  form (fp32): the oracle of the backward kernel.
* ``gn_silu_fwd_cuda`` / ``gn_silu_bwd_cuda`` — the wrappers of the two
  CUDA kernels of ``csrc/groupnorm.cu``.  The forward replaces all three
  Pallas kernels of the JAX module: ``_gn_silu_kernel`` (single-block,
  ``groupnorm.py:110``), ``_gn_stats_kernel`` (``:148``) and
  ``_gn_apply_kernel`` (``:161``), and returns the statistics too.  The
  backward has no Pallas counterpart: JAX's ``_fused_bwd`` (``:251``) is
  ``jax.vjp`` of the plain reference.
* ``gn_silu_op`` — the operator ``sdxl::gn_silu`` (``torch.library.
  custom_op``): the forward kernel for a CUDA tensor, the plain version
  for a CPU tensor, returning (y, mean, rstd); its autograd saves (x,
  scale, bias, mean, rstd) and runs the backward kernel (a CPU tensor:
  the plain version's VJP).
* ``groupnorm_silu`` — the entry point over channels-last [B, ..., C].
* ``norm_arith_bf16`` — the trace-time switch of the JAX module: with it
  on, a bf16 input keeps the normalize/affine arithmetic in bf16 in the
  plain versions (here and in ``models/layers.py``); the UNet sets it from
  its config (on iff remat).

Design.  The TPU split into a single-block kernel and a chunked pair
exists only because one image's tile has to fit VMEM.  On Hopper both
kernels are bound by device-memory bytes (forward: x read, y written;
backward: x and dy read, dx written), and both need a whole image's
reduction before its first output.  Each is one cooperative launch of as
many blocks as the card holds at once: phase 1 streams a row chunk per
block into per-group partials, one grid barrier, phase 2 merges the
image's partials and streams the chunk again (from L2 where it still
sits) to write the output.  One launch per call and no host-side merge;
the source note of ``csrc/groupnorm.cu`` gives the details.  The kernels
take fp32 (the VAE, an fp32 UNet), bf16 and fp16 (the UNet under each
``training.mixed_precision``): they load any of them, compute in fp32 and
store in the input's dtype; scale and bias are read in fp32.

Numerics.  The Pallas kernels use the single-pass E[x^2]-E[x]^2 form.
Over the million elements of one VAE group at 1024^2 that form cancels in
fp32, so the forward kernel keeps Welford's mean and centred second moment
per channel and merges them into groups and chunks with Chan's parallel
formula (``combine_chunk_stats`` is the plain form of its chunk merge).
It is the same function (the group variance), computed the way
``groupnorm_silu_reference`` (``jnp.var``, two-pass) computes it.  The
interior stays fp32 for bf16 inputs, as the Pallas kernel's does (it
ignores the JAX remat-gated bf16 interior), and the backward is that of
the fp32 interior.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
from typing import Tuple

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


def group_stats_reference(x: torch.Tensor, num_groups: int = 32,
                          eps: float = 1e-5):
    """Per-(image, group) mean and rstd = 1 / sqrt(var + eps) of
    channels-last [B, ..., C], each [B, G] fp32 (two-pass variance)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)
    return mean, torch.rsqrt(var + eps)


def gn_silu_fwd_reference(x3, scale, bias, num_groups: int = 32,
                          eps: float = 1e-5):
    """Plain form of the forward kernel's outputs: (y, mean, rstd)."""
    with norm_arith_bf16(False):
        y = groupnorm_silu_reference(x3, scale, bias, num_groups, eps)
    return (y, *group_stats_reference(x3, num_groups, eps))


def groupnorm_silu_backward_reference(dy, x, scale, bias, mean, rstd,
                                      num_groups: int = 32):
    """Plain backward of the fp32-interior GN+SiLU in closed form, given
    the forward's per-(image, group) ``mean`` and ``rstd`` ([B, G]):
    xhat = (x - mean) rstd, z = xhat scale + bias, s = sigmoid(z),
    dz = dy s (1 + z (1 - s)), dxhat = dz scale; over the N elements of a
    group dx = rstd (dxhat - sum(dxhat) / N - xhat sum(dxhat xhat) / N);
    dscale = sum(dz xhat), dbias = sum(dz) over images and positions.
    fp32 throughout; dx in x's dtype, dscale and dbias in the
    parameters'."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    grouped = (b, -1, num_groups, cg)
    x4, dy4 = x.reshape(grouped).float(), dy.reshape(grouped).float()
    mu, r = mean[:, None, :, None], rstd[:, None, :, None]
    w = scale.float().reshape(num_groups, cg)
    xhat = (x4 - mu) * r
    z = xhat * w + bias.float().reshape(num_groups, cg)
    s = torch.sigmoid(z)
    dz = dy4 * s * (1 + z * (1 - s))
    dxhat = dz * w
    n = x4.shape[1] * cg
    a = dxhat.sum(dim=(1, 3), keepdim=True) / n
    bg = (dxhat * xhat).sum(dim=(1, 3), keepdim=True) / n
    dx = r * (dxhat - a - xhat * bg)
    dscale = (dz * xhat).sum(dim=(0, 1)).reshape(c)
    dbias = dz.sum(dim=(0, 1)).reshape(c)
    return (dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(bias.dtype))


def combine_chunk_stats(mean, m2, chunk_n: int, last_n: int, eps: float):
    """Plain form of the forward kernel's merge of an image's chunks:
    Chan's parallel formula over all chunks at once (the count-weighted
    mean first, then the chunks' M2 plus their spread about it) from the
    chunks' (mean, M2), each [B, n_chunks, G], of ``chunk_n`` elements
    each (``last_n`` in the last) -> per-group mean and rstd, each [B, G]
    fp32."""
    n = torch.full((mean.shape[1],), float(chunk_n), device=mean.device)
    n[-1] = float(last_n)
    total = n.sum()
    n = n[None, :, None]
    mu = (mean * n).sum(dim=1) / total
    m2_all = m2.sum(dim=1) + (n * (mean - mu[:, None, :]) ** 2).sum(dim=1)
    return mu, torch.rsqrt(m2_all / total + eps)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/groupnorm.cu, built and loaded at first launch)
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from sdxl_training_improvements_tpu_torch.ops import _build
    lib = _build.load("groupnorm")
    ints = [ctypes.c_int] * 4
    lib.gn_silu_workspace_floats.argtypes = ints + [ctypes.c_int] * 2
    lib.gn_silu_workspace_floats.restype = ctypes.c_int64
    for suffix in _SUFFIX.values():
        fwd = getattr(lib, f"gn_silu_fwd_{suffix}")
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] + ints
                        + [ctypes.c_float, ctypes.c_void_p])
        bwd = getattr(lib, f"gn_silu_bwd_{suffix}")
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] + ints
                        + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
    return lib


def _check(x3, scale, bias, num_groups):
    """Raise on what the kernels do not take: a contiguous [B, S, C] CUDA
    tensor of fp32, bf16 or fp16 with C a multiple of the groups and of 8
    (16-byte vectors), and [C] scale and bias on its device."""
    if x3.device.type != "cuda":
        raise ValueError(f"GN+SiLU kernel needs a CUDA tensor, got "
                         f"{x3.device}")
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError("GN+SiLU kernel wants a contiguous [B, S, C] tensor")
    if x3.dtype not in _SUFFIX:
        raise TypeError(f"GN+SiLU kernel takes fp32, bf16 or fp16, got "
                        f"{x3.dtype}")
    c = x3.shape[-1]
    if c % num_groups or c % 8:
        raise ValueError(f"C={c} is not a multiple of {num_groups} groups "
                         "and of 8")
    for t in (scale, bias):
        if t.device != x3.device or t.shape != (c,):
            raise ValueError("scale/bias must be [C] on x's device")


def _workspace(x3, num_groups: int, backward: bool) -> torch.Tensor:
    b, s, c = x3.shape
    with torch.cuda.device(x3.device):
        n = _library().gn_silu_workspace_floats(
            b, s, c, num_groups, _DTYPE_CODE[x3.dtype], int(backward))
    if n < 0:
        raise ValueError(f"GN+SiLU kernel does not take [{b}, {s}, {c}] "
                         f"with {num_groups} groups (C <= 4096, at most "
                         "128 groups)")
    return torch.empty(n, device=x3.device, dtype=torch.float32)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def gn_silu_fwd_cuda(x3, scale, bias, num_groups: int = 32,
                     eps: float = 1e-5):
    """Launch the forward kernel: (y in x's dtype, mean, rstd [B, G]
    fp32); raises on what it does not take."""
    _check(x3, scale, bias, num_groups)
    b, s, c = x3.shape
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    y = torch.empty_like(x3)
    mean = torch.empty((b, num_groups), device=x3.device,
                       dtype=torch.float32)
    rstd = torch.empty_like(mean)
    ws = _workspace(x3, num_groups, backward=False)
    name = f"gn_silu_fwd_{_SUFFIX[x3.dtype]}"
    with torch.cuda.device(x3.device):
        rc = getattr(_library(), name)(
            x3.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), ws.data_ptr(), ws.numel(), b,
            s, c, num_groups, float(eps),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name)
    gn_silu_fwd_cuda.launches += 1
    gn_silu_fwd_cuda.launches_by_dtype[x3.dtype] += 1
    return y, mean, rstd


# launches in all, and of each dtype's instantiation
gn_silu_fwd_cuda.launches = 0
gn_silu_fwd_cuda.launches_by_dtype = collections.Counter()


def gn_silu_bwd_cuda(dy, x3, scale, bias, mean, rstd, num_groups: int = 32):
    """Launch the backward kernel: (dx in x's dtype, dscale, dbias in the
    parameters' dtypes) from the forward's [B, G] fp32 ``mean`` and
    ``rstd``; raises on what it does not take.  A ``dy`` that is not
    contiguous is copied first (counted in ``dy_copies``)."""
    _check(x3, scale, bias, num_groups)
    b, s, c = x3.shape
    if dy.shape != x3.shape or dy.dtype != x3.dtype or \
            dy.device != x3.device:
        raise ValueError("dy must match x in shape, dtype and device")
    for t in (mean, rstd):
        if (t.shape != (b, num_groups) or t.dtype != torch.float32
                or t.device != x3.device):
            raise ValueError("mean/rstd must be [B, G] fp32 on x's device")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        gn_silu_bwd_cuda.dy_copies += 1
    w, bb = scale.float().contiguous(), bias.float().contiguous()
    mean, rstd = mean.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x3)
    dscale = torch.empty(c, device=x3.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    ws = _workspace(x3, num_groups, backward=True)
    name = f"gn_silu_bwd_{_SUFFIX[x3.dtype]}"
    with torch.cuda.device(x3.device):
        rc = getattr(_library(), name)(
            dy.data_ptr(), x3.data_ptr(), w.data_ptr(), bb.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), ws.data_ptr(), ws.numel(),
            b, s, c, num_groups, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name)
    gn_silu_bwd_cuda.launches += 1
    gn_silu_bwd_cuda.launches_by_dtype[x3.dtype] += 1
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


gn_silu_bwd_cuda.launches = 0
gn_silu_bwd_cuda.launches_by_dtype = collections.Counter()
gn_silu_bwd_cuda.dy_copies = 0


def _uses_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU tensor (the
    plain versions); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"groupnorm_silu: no kernel for {x.device}")


@torch.library.custom_op("sdxl::gn_silu", mutates_args=())
def gn_silu_op(x3: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, bf16_interior: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GN+SiLU of [B, S, C] as one operator: (y, mean, rstd [B, G] fp32).
    A CUDA tensor launches the forward kernel (``gn_silu_fwd_cuda``, looked
    up at call time, so a test can put the plain version in its place); a
    CPU tensor takes the plain version, with the bf16 interior when
    ``bf16_interior`` (the caller's ``norm_arith_bf16``).  Being one
    operator is what lets a remat policy save y (``models/unet.py``): the
    policy sees each operator as it dispatches, and a launch through
    ctypes is none."""
    if _uses_kernel(x3):
        return gn_silu_fwd_cuda(x3, scale, bias, num_groups, eps)
    with norm_arith_bf16(bf16_interior):
        y = groupnorm_silu_reference(x3, scale, bias, num_groups, eps)
    return (y, *group_stats_reference(x3, num_groups, eps))


@gn_silu_op.register_fake
def _(x3, scale, bias, num_groups, eps, bf16_interior):
    stats = x3.new_empty((x3.shape[0], num_groups), dtype=torch.float32)
    return torch.empty_like(x3), stats, torch.empty_like(stats)


def _gn_silu_setup(ctx, inputs, output):
    x3, scale, bias, num_groups, eps, bf16_interior = inputs
    ctx.save_for_backward(x3, scale, bias, output[1], output[2])
    ctx.set_materialize_grads(False)  # no zero gradients for mean, rstd
    ctx.num_groups, ctx.eps, ctx.bf16_interior = (num_groups, eps,
                                                  bf16_interior)


def _gn_silu_backward(ctx, dy, _dmean, _drstd):
    """The backward kernel for CUDA tensors; for CPU tensors the VJP of
    the plain version (what JAX's ``_fused_bwd`` is), recomputed here, so
    the CPU gradients are autograd's through the plain ops."""
    x3, scale, bias, mean, rstd = ctx.saved_tensors
    if _uses_kernel(x3):
        dx, dscale, dbias = gn_silu_bwd_cuda(dy, x3, scale, bias, mean, rstd,
                                             ctx.num_groups)
    else:
        with torch.enable_grad(), norm_arith_bf16(ctx.bf16_interior):
            xs = [t.detach().requires_grad_() for t in (x3, scale, bias)]
            y = groupnorm_silu_reference(*xs, ctx.num_groups, ctx.eps)
            dx, dscale, dbias = torch.autograd.grad(y, xs, dy)
    return dx, dscale, dbias, None, None, None


torch.library.register_autograd("sdxl::gn_silu", _gn_silu_backward,
                                setup_context=_gn_silu_setup)


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GN+SiLU over channels-last [B, ..., C] through ``gn_silu_op``: the
    kernels for a CUDA tensor, the plain version for a CPU tensor; both
    carry the gradient; any other device raises."""
    _uses_kernel(x)
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    y, _, _ = gn_silu_op(x3, scale, bias, num_groups, eps,
                         norm_arith_bf16_enabled())
    return y.reshape(x.shape)
