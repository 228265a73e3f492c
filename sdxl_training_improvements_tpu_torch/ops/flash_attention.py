"""Flash attention: plain versions, the CUDA kernels' wrappers and the
``torch.autograd.Function`` that joins them.

Port of ``sdxl_training_improvements_tpu/ops/flash_attention.py``.  The
Pallas kernels take any dtype; here each of the UNet's precisions
(``training.mixed_precision``) has its kernels, picked by the inputs'
dtype: bf16 and fp16 run the two instantiations of the Hopper kernels
below; fp32 the forward of ``csrc/flash_f32.cu`` and the backward of
``csrc/flash_bwd_f32.cu``, the same split and warp-specialised shape on
TF32 wgmma, each operand split into two TF32 parts so that the products
keep fp32's accuracy (their shared tiles, splitting pass and products:
``csrc/flash_f32_common.cuh``).  Any other dtype raises.

* forward: ``csrc/flash_fwd.cu`` replaces the Pallas ``_fwd_kernel``: a
  block per (b*h, 128-row q tile) with a TMA producer warp and two
  consumer warpgroups that stream K/V tiles through an mbarrier ring,
  multiply with wgmma and take turns on the tensor cores;
* backward: ``csrc/flash_bwd.cu`` replaces ``_bwd_dq_kernel`` (dq, a block
  per q tile looping over kv tiles) and ``_bwd_dkv_kernel`` (dk and dv, a
  block per kv tile looping over q tiles, the q loop split over several
  blocks when the kv tiles alone cannot fill the card: ``plan_dkv_splits``).
  Both recompute the probabilities from (q, k, lse), read their inputs
  through TMA tensor maps and multiply with wgmma; Delta = rowsum(dO * O)
  is a plain torch op, as JAX forms it outside Pallas.
* ``FlashAttention`` saves (q, k, v, out, lse) in the forward, as
  ``_flash_core_fwd`` does, and runs the two backward kernels.

Each launcher (``LAUNCHERS[kind][dtype]``) counts its launches; each
wrapper counts its own over all dtypes.

Each source note gives its kernel's design.  Layout at this module's
functions: q [B, S, H, D], k and v [B, T, H, D] (the JAX package's
layout), out [B, S, H, D] in q's dtype, lse [B, H, S] fp32.  The dispatch
by device is ``ops/attention.py::dot_product_attention``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
DKV_KV_ROWS = 128  # rows of the dk/dv kernels' kv tile (kOwn)
H100_SMS = 132


def dkv_q_rows(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Rows of the q tiles the dk/dv kernel of ``dtype`` streams at head
    dim ``d`` (``Cfg<D>::kStream`` of ``csrc/flash_bwd.cu`` for bf16 and
    fp16, of ``csrc/flash_bwd_f32.cu`` for fp32)."""
    if dtype == torch.float32:
        return 32 if d <= 64 else 16
    return 128 if d <= 64 else 64


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


def plan_dkv_splits(b: int, h: int, s: int, t: int, d: int,
                    sms: int = H100_SMS,
                    dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(splits, q tiles per split) of the q loop of ``dtype``'s dk/dv
    kernel: enough splits that the grid of (kv tiles, batch * heads,
    splits) blocks covers ``sms`` SMs, none of them empty, and 1 when the
    kv tiles alone do."""
    kv_tiles = -(-t // DKV_KV_ROWS)
    q_tiles = -(-s // dkv_q_rows(d, dtype))
    want = min(q_tiles, -(-sms // (b * h * kv_tiles)))
    per = -(-q_tiles // want)
    return -(-q_tiles // per), per


def flash_bwd_dkv_split_reference(q, k, v, dout, lse, delta, scale: float,
                                  splits: int, per: int):
    """Plain version of the split dk/dv path: fp32 partials over q chunks
    of ``per`` q tiles of q's dtype's kernel, summed in split order, then
    cast to k's dtype."""
    rows = per * dkv_q_rows(q.shape[-1], q.dtype)
    dk = dv = 0.0
    for i in range(splits):
        sl = slice(i * rows, (i + 1) * rows)
        p, ds = _bwd_probs(q[:, sl], k, v, dout[:, sl], lse[..., sl],
                           delta[..., sl], scale)
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q[:, sl].float())
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, dout[:, sl].float())
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


class Launcher:
    """One C launcher of a kernel instantiation, built and loaded at its
    first call; ``launches`` counts its successful launches."""

    def __init__(self, library: str, symbol: str, n_ptr: int, n_int: int):
        self.library, self.symbol = library, symbol
        self.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                         + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                            ctypes.c_void_p])
        self.launches = 0

    @functools.cached_property
    def fn(self):
        from sdxl_training_improvements_tpu_torch.ops import _build
        fn = getattr(_build.load(self.library), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        _raise_on(self.fn(*args), self.symbol)
        self.launches += 1


_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float32: "f32"}


def _launchers(kind: str, args) -> dict:
    """The launchers of one kernel by dtype, each with its (pointer, int)
    argument counts in ``args``: the 16-bit instantiations in
    ``csrc/flash_{fwd,bwd}.cu`` (the fp16 backward with the max|dO|
    pointer more), the fp32 kernels in ``csrc/flash_f32.cu`` (forward)
    and ``csrc/flash_bwd_f32.cu`` (dq, dk/dv)."""
    lib16, lib32 = (("flash_fwd", "flash_f32") if kind == "fwd"
                    else ("flash_bwd", "flash_bwd_f32"))
    symbol = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
    return {dt: Launcher(lib32 if dt == torch.float32 else lib16,
                         f"{symbol}_{_SUFFIX[dt]}", *args[dt])
            for dt in DTYPES}


_BF16, _F16, _F32 = DTYPES
LAUNCHERS = {
    "fwd": _launchers("fwd", {_BF16: (5, 5), _F16: (5, 5), _F32: (5, 5)}),
    "dq": _launchers("dq", {_BF16: (7, 5), _F16: (8, 5), _F32: (7, 5)}),
    "dkv": _launchers("dkv", {_BF16: (10, 7), _F16: (11, 7),
                              _F32: (10, 7)})}


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """x's (batch, seq, head) element strides, a dim of size 1 given the
    stride a contiguous tensor would have (its stride is never used, and
    TMA needs every stride to be a multiple of 16 bytes)."""
    b, n, h, d = x.shape
    sb, sn, sh, _ = x.stride()
    return (sb if b > 1 else n * h * d, sn if n > 1 else h * d,
            sh if h > 1 else d)


def tma_addressable(x: torch.Tensor) -> bool:
    """Whether a [B, N, H, D] tensor meets TMA's conditions: a 16-byte
    aligned base, (batch, seq, head) strides that are multiples of 16 bytes
    and a unit head-dim stride."""
    per = 16 // x.element_size()  # elements in 16 bytes
    sb, sn, sh = _strides(x)
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0 and sb % per == 0
            and sn % per == 0 and sh % per == 0)


def _addressable(x: torch.Tensor) -> torch.Tensor:
    """x itself where the kernels can read it in place (their TMA maps),
    else a contiguous copy."""
    return x if tma_addressable(x) else x.contiguous()


def _raise_on(rc: int, name: str) -> None:
    if rc >= 100000:  # hopper::kEncodeError + the driver's CUresult
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: "
                           f"CUresult {rc - 100000}")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _check(q, k, v, *more):
    """Raise on what the kernels do not take: [B, S, H, D] q and
    [B, T, H, D] k, v (and more tensors shaped like q) of one dtype in
    ``DTYPES`` on one card."""
    b, s, h, d = q.shape
    t = k.shape[1]
    if k.shape != (b, t, h, d) or v.shape != k.shape or any(
            x.shape != q.shape for x in more):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for x in (q, k, v) + more:
        if (x.dtype not in DTYPES or x.dtype != q.dtype
                or x.device != q.device):
            raise TypeError(
                "flash kernels take q, k, v of one dtype (bf16, fp16 or "
                f"fp32) on one device, got {x.dtype} on {x.device} with "
                f"q {q.dtype} on {q.device}")
    if t < 1 or s < 1:
        raise ValueError("empty sequence")
    if b * h > 65535:  # grid.y of the launch
        raise ValueError(f"batch * heads = {b * h} exceeds 65535")
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")


def flash_attention_fwd_cuda(q, k, v, scale: Optional[float] = None):
    """Launch the CUDA kernel of q's dtype; raises on what it does not take
    (the 16-bit kernel takes the row max of the unscaled scores, so scale
    must be > 0)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not scale > 0:
        raise ValueError(f"flash forward needs scale > 0, got {scale}")
    _check(q, k, v)
    b, s, h, d = q.shape
    t = k.shape[1]
    q, k, v = _addressable(q), _addressable(k), _addressable(v)
    out = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    strides = (ctypes.c_int64 * 12)(
        *(_strides(q) + _strides(k) + _strides(v) + _strides(out)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHERS["fwd"][q.dtype](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, s, t, d, strides, float(scale), stream)
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def _bwd_inputs(q, k, v, dout, lse, delta):
    """The backward kernels' inputs, checked and laid out for them: q, dO
    [B, S, H, D] and k, v [B, T, H, D] of one dtype on one card, lse and
    delta [B, H, S] fp32; raises on anything else."""
    _check(q, k, v, dout)
    b, s, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, s) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{name} must be [B, H, S] fp32 on q's device, "
                             f"got {tuple(x.shape)} {x.dtype} {x.device}")
    return (*(_addressable(x) for x in (q, k, v, dout)), lse.contiguous(),
            delta.contiguous())


def dout_absmax(dout: torch.Tensor) -> Optional[torch.Tensor]:
    """max|dO| as a 0-d fp32 tensor on dO's device (no host
    synchronisation) for an fp16 dO, else None.  The fp16 backward kernels
    scale dS by a power of two derived from it, as fp16's range ends at
    6e-8 (``csrc/flash_bwd.cu``)."""
    if dout.dtype != torch.float16:
        return None
    return torch.linalg.vector_norm(dout, float("inf"), dtype=torch.float32)


def _bwd_strides(q, k, v, dout, *outs):
    """The 21 (batch, seq, head) strides of q, k, v, dO, dq, dk, dv (0 for
    an output a launcher does not write)."""
    return (ctypes.c_int64 * 21)(
        *(_strides(q) + _strides(k) + _strides(v) + _strides(dout)),
        *(i for x in outs for i in (_strides(x) if x is not None
                                    else (0, 0, 0))))


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, scale: float,
                      absmax: Optional[torch.Tensor] = None):
    """Launch the dq kernel of q's dtype (Pallas ``_bwd_dq_kernel``);
    raises on what it does not take.  ``absmax`` is ``dout_absmax(dout)``
    (formed here for fp16 when not given)."""
    q, k, v, dout, lse, delta = _bwd_inputs(q, k, v, dout, lse, delta)
    b, s, h, d = q.shape
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    strides = _bwd_strides(q, k, v, dout, dq, None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHERS["dq"][q.dtype](
            *(x.data_ptr() for x in (q, k, v, dout, lse, delta)),
            *_absmax_ptr(dout, absmax), dq.data_ptr(), b, h, s, k.shape[1],
            d, strides, float(scale), stream)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def _absmax_ptr(dout, absmax) -> Tuple[int, ...]:
    """The fp16 launchers' max|dO| pointer (none for bf16)."""
    if dout.dtype != torch.float16:
        return ()
    if absmax is None:
        absmax = dout_absmax(dout)
    if (absmax.shape != () or absmax.dtype != torch.float32
            or absmax.device != dout.device):
        raise ValueError("absmax must be a 0-d fp32 tensor on dO's device")
    return (absmax.data_ptr(),)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, scale: float,
                       absmax: Optional[torch.Tensor] = None):
    """Launch the dk/dv kernel of q's dtype (Pallas ``_bwd_dkv_kernel``);
    raises on what it does not take.  The kernels split their q loop as
    ``plan_dkv_splits`` says for their own q tiles and sum the fp32
    partials by the reduction kernel of the same source.  ``absmax`` as
    for ``flash_bwd_dq_cuda``."""
    q, k, v, dout, lse, delta = _bwd_inputs(q, k, v, dout, lse, delta)
    b, s, h, d = q.shape
    t = k.shape[1]
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty_like(dk)
    launch = LAUNCHERS["dkv"][q.dtype]
    splits, per = plan_dkv_splits(b, h, s, t, d, _sm_count(q.device),
                                  q.dtype)
    # fp32 partial dk and dv of each split, [2, splits, B*H, T, D]
    part = (torch.empty((2, splits, b * h, t, d), device=k.device,
                        dtype=torch.float32) if splits > 1 else None)
    part_ptrs = ((part[0].data_ptr(), part[1].data_ptr())
                 if part is not None else (0, 0))
    strides = _bwd_strides(q, k, v, dout, None, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(*(x.data_ptr() for x in (q, k, v, dout, lse, delta)),
               *_absmax_ptr(dout, absmax), dk.data_ptr(), dv.data_ptr(),
               *part_ptrs, b, h, s, t, d, splits, per, strides, float(scale),
               stream)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                             scale: Optional[float] = None):
    """(dq, dk, dv) in q's dtype through the two backward kernels; raises
    on what they do not take."""
    _check(q, k, v, out, dout)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    delta = flash_attention_bwd_delta(out, dout)
    absmax = dout_absmax(dout)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, scale, absmax)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, absmax)
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
