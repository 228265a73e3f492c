"""PyTorch port: the flash-attention backward's plain version against JAX.

``flash_attention_bwd_reference`` is the oracle of the CUDA backward
kernels (``csrc/flash_bwd.cu``).  Here it is held against the JAX Pallas
backward (``_bwd``, through ``jax.grad`` of ``flash_attention`` under
``pltpu.force_tpu_interpret_mode()``) and against ``jax.grad`` of the plain
``dot_product_attention_reference``, at the shapes and the tolerance of
``tests/test_flash_attention.py``: atol 5e-5 / rtol 5e-4, including the
77-token kv edge and logits scaled by 50.

One exception, measured: with q scaled by 50 the logits reach ~214, and a
backward that recomputes P = exp(x - lse) in fp32 loses |lse| * 2**-24 of
P's relative precision.  JAX's own Pallas backward then misses ``jax.grad``
of the plain path on dk by 1.38 times the bar (and float64 by 1.30 times);
the port's plain backward meets the Pallas one at the bar in all three
gradients, and the plain path's dk at twice the bar.

In fp16 the plain backward (fp32 inside, gradients rounded to fp16) meets
the Pallas one within two fp16 ulps at |gradient| < 2: atol and rtol 2e-3
(measured one ulp, up to 9.8e-4).

The fp32 kernels (``csrc/flash_bwd_f32.cu``) multiply on the tensor cores'
TF32 path with every operand split into two TF32 parts.  That contract is
emulated here (``_split_tf32_bwd``: rounding to nearest TF32 by integer
ops on the fp32 bits, the three products in the kernels' order) and held
against the Pallas backward at the card's fp32 bars: atol 5e-5 / rtol
5e-4, and 1e-4 of max |gradient| (``chip_smoke.FLASH_BWD_TOL``); with q
scaled by 50 the contract misses the first, measured, and is held to the
second.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdxl_training_improvements_tpu.ops.attention import (
    dot_product_attention_reference)
from sdxl_training_improvements_tpu.ops.flash_attention import flash_attention
from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF

ATOL, RTOL = 5e-5, 5e-4
MAX_REL = 1e-4  # chip_smoke.FLASH_BWD_TOL[fp32]


def _inputs(s, t, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = q_scale * rng.standard_normal((1, s, 2, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, t, 2, 64)).astype(np.float32)
            for _ in range(2))
    cot = rng.standard_normal((1, s, 2, 64)).astype(np.float32)
    return q, k, v, cot


def _jax_grads(fn, q, k, v, cot):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * cot)
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("s,t,q_scale", [(128, 128, 1.0), (256, 77, 1.0),
                                         (128, 128, 50.0)])
def test_bwd_reference_matches_jax(s, t, q_scale):
    q, k, v, cot = _inputs(s, t, seed=s + t, q_scale=q_scale)
    with pltpu.force_tpu_interpret_mode():
        pallas = _jax_grads(lambda *a: flash_attention(
            *a, block_q=128, block_k=128), q, k, v, cot)
    plain = _jax_grads(dot_product_attention_reference, q, k, v, cot)

    tq, tk, tv, tcot = map(torch.from_numpy, (q, k, v, cot))
    out, lse = TF.flash_attention_fwd_reference(tq, tk, tv)
    ours = TF.flash_attention_bwd_reference(tq, tk, tv, out, lse, tcot)
    for name, a, p, r in zip("qkv", ours, pallas, plain):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(p), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name} vs Pallas")
        widen = 2.0 if (name, q_scale) == ("k", 50.0) else 1.0
        np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                   atol=widen * ATOL, rtol=widen * RTOL,
                                   err_msg=f"d{name} vs jax.grad")


def test_bwd_kernel_wrappers_refuse_what_they_do_not_take():
    """Each backward wrapper checks its own inputs before any launch: a
    CPU tensor, a wrong dtype or a misshapen lse raises."""
    q, k, v, dout = (torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
                     for _ in range(4))
    lse = delta = torch.zeros(1, 2, 8)
    for fn in (TF.flash_bwd_dq_cuda, TF.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, dout, lse, delta, 0.25)
        with pytest.raises(ValueError, match="head dim"):
            fn(*(x[..., :8] for x in (q, k, v, dout)), lse, delta, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_attention_bwd_cuda(q, k, v, q, lse, dout)
    assert TF.flash_bwd_dq_cuda.launches == TF.flash_bwd_dkv_cuda.launches \
        == 0


def test_bwd_delta_is_rowsum_of_dout_times_out():
    rng = np.random.default_rng(0)
    out, dout = (torch.from_numpy(rng.standard_normal((2, 5, 3, 16)).astype(
        np.float32)) for _ in range(2))
    delta = TF.flash_attention_bwd_delta(out, dout)
    assert delta.shape == (2, 3, 5) and delta.is_contiguous()
    torch.testing.assert_close(delta, (out * dout).sum(-1).transpose(1, 2))


_BF16, _F32 = torch.bfloat16, torch.float32
_PLANS = [(4, 10, 4096, 4096, 64, 1, 1), (4, 20, 1024, 1024, 64, 1, 1),
          (4, 10, 4096, 77, 64, 4, 4), (4, 20, 1024, 77, 64, 2, 2),
          (1, 2, 1000, 77, 64, 8, 32), (1, 2, 1000, 77, 128, 16, 63)]


@pytest.mark.parametrize("b,h,s,t,d,splits,dtype", [
    *(pytest.param(*c[:6], _BF16, id="-".join(map(str, c[:6])))
      for c in _PLANS),
    *(pytest.param(*c[:5], c[6], _F32, id="fp32-" + "-".join(
        map(str, c[:5] + c[6:]))) for c in _PLANS)])
def test_dkv_split_planner(b, h, s, t, d, splits, dtype):
    """The SDXL training sites (b4): no split where the kv tiles fill the
    H100's 132 SMs (T = 4096, 1024), a split of the q loop where they do
    not (the T = 77 cross-attention), with a grid that then covers every
    SM (or gives every q tile its own block) and no split left empty; for
    the 16-bit kernels' q tiles (128 rows, 64 at D = 128) and the fp32
    kernel's (32, 16 at D = 128)."""
    got, per = TF.plan_dkv_splits(b, h, s, t, d, dtype=dtype)
    q_tiles = -(-s // TF.dkv_q_rows(d, dtype))
    kv_tiles = -(-t // TF.DKV_KV_ROWS)
    assert got == splits
    assert (got - 1) * per < q_tiles <= got * per
    if got > 1:
        assert b * h * kv_tiles * got >= TF.H100_SMS or per == 1


@pytest.mark.parametrize("s,t,dtype", [
    pytest.param(512, 77, _BF16, id="512-77"),
    pytest.param(300, 130, _BF16, id="300-130"),
    pytest.param(512, 77, _F32, id="fp32-512-77"),
    pytest.param(300, 130, _F32, id="fp32-300-130")])
def test_dkv_split_reference_matches_unsplit_and_jax(s, t, dtype):
    """The split path's plain version (fp32 partials over q chunks of the
    q tiles of ``dtype``'s kernel, summed in order) against the unsplit
    plain dk/dv (fp32 sums in another order: atol 1e-5, rtol 1e-5) and the
    JAX Pallas backward in interpret mode (the file's bar, atol 5e-5 /
    rtol 5e-4)."""
    q, k, v, cot = _inputs(s, t, seed=s * t)
    with pltpu.force_tpu_interpret_mode():
        pallas = _jax_grads(lambda *a: flash_attention(
            *a, block_q=128, block_k=128), q, k, v, cot)
    tq, tk, tv, tcot = map(torch.from_numpy, (q, k, v, cot))
    out, lse = TF.flash_attention_fwd_reference(tq, tk, tv)
    delta = TF.flash_attention_bwd_delta(out, tcot)
    args = (tq, tk, tv, tcot, lse, delta, 64 ** -0.5)
    splits, per = TF.plan_dkv_splits(1, 2, s, t, 64, dtype=dtype)
    assert splits > 1
    # the reference counts q tiles of its inputs' dtype, fp32 here
    per_f32 = per * TF.dkv_q_rows(64, dtype) // TF.dkv_q_rows(64, _F32)
    split = TF.flash_bwd_dkv_split_reference(*args, splits, per_f32)
    whole = TF.flash_bwd_dkv_reference(*args)
    for name, a, w, p in zip(("dk", "dv"), split, whole, pallas[1:]):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(p), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name} vs Pallas")


def test_tma_addressable_views():
    """TMA's conditions on CPU views: a 16-byte aligned base, (batch, seq,
    head) strides in multiples of 16 bytes (a size-1 dim's stride never
    counts) and a unit head-dim stride; ``_addressable`` copies only the
    views that fail them."""
    bf16 = dict(dtype=torch.bfloat16)
    proj = torch.zeros(2, 77, 2 * 4 * 64, **bf16)
    ok = [torch.zeros(2, 8, 4, 64, **bf16),
          proj.view(2, 77, 2, 4, 64)[:, :, 1],          # k, v of a fused kv
          torch.zeros(2, 8, 4, 72, **bf16)[..., :64],   # padded rows
          torch.zeros(1, 8, 1, 64, **bf16).as_strided(
              (1, 8, 1, 64), (3, 64, 5, 1))]             # odd size-1 strides
    bad = [torch.zeros(2, 8, 4, 72, **bf16)[..., 4:68],  # base off by 8 B
           torch.zeros(2, 8, 4, 68, **bf16)[..., :64],   # 136-byte rows
           torch.zeros(2, 8, 64, 4, **bf16).transpose(2, 3)]
    for x in ok:
        assert TF.tma_addressable(x)
        assert TF._addressable(x) is x
    for x in bad:
        assert not TF.tma_addressable(x)
        y = TF._addressable(x)
        assert TF.tma_addressable(y) and torch.equal(y, x)
    assert TF._strides(ok[3]) == (8 * 64, 64, 64)


def test_tma_addressable_fp32_views():
    """The same conditions for fp32, whose 16 bytes are 4 elements: the
    fp32 backward kernels read through TMA too, so a view whose strides
    are not multiples of 4 elements is copied and a fused projection's
    k, v views are read in place."""
    proj = torch.zeros(2, 77, 2 * 4 * 64)
    ok = [proj.view(2, 77, 2, 4, 64)[:, :, 1],
          torch.zeros(2, 8, 4, 68)[..., :64]]            # 272-byte rows
    bad = [torch.zeros(2, 8, 4, 66)[..., :64],           # 264-byte rows
           torch.zeros(2, 8, 4, 68)[..., 2:66]]          # base off by 8 B
    for x in ok:
        assert TF.tma_addressable(x) and TF._addressable(x) is x
    for x in bad:
        assert not TF.tma_addressable(x)
        y = TF._addressable(x)
        assert TF.tma_addressable(y) and torch.equal(y, x)


@pytest.mark.parametrize("s,t", [(128, 128), (256, 77)])
def test_bwd_reference_fp16_matches_pallas(s, t):
    rng = np.random.default_rng(s + t)
    q, k, v, cot = (rng.standard_normal((1, n, 2, 64)).astype(np.float16)
                    for n in (s, t, t, s))

    def loss(q, k, v):
        out = flash_attention(q, k, v, block_q=128, block_k=128)
        return jnp.sum(out.astype(jnp.float32) * cot.astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        pallas = jax.grad(loss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tcot = map(torch.from_numpy, (q, k, v, cot))
    out, lse = TF.flash_attention_fwd_reference(tq, tk, tv)
    ours = TF.flash_attention_bwd_reference(tq, tk, tv, out, lse, tcot)
    for name, a, p in zip("qkv", ours, pallas):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(p).astype(np.float32),
                                   atol=2e-3, rtol=2e-3,
                                   err_msg=f"d{name} vs Pallas")



def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest TF32, ties away from zero (``cvt.rna.tf32``),
    by integer ops on its fp32 bits: add half of the 13 dropped bits, then
    clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the fp32 kernels form it: each operand as hi = tf32(x) and
    lo = tf32(x - hi), the two small products first, then hi @ hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _split_tf32_bwd(q, k, v, dout, lse, delta, scale, mm=_split_mm):
    """(dq, dk, dv) of the fp32 kernels' arithmetic: every product of the
    backward through ``mm``; P = exp(S * scale - lse) and dS in fp32."""
    qh, kh, vh, oh = (x.transpose(1, 2) for x in (q, k, v, dout))
    p = torch.exp(mm(qh, kh.transpose(-1, -2)) * scale - lse[..., None])
    dp = mm(oh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    grads = (mm(ds, kh), mm(ds.transpose(-1, -2), qh),
             mm(p.transpose(-1, -2), oh))
    return [g.transpose(1, 2) for g in grads]


@pytest.mark.parametrize("s,t,q_scale", [(128, 128, 1.0), (256, 77, 1.0),
                                         (128, 128, 50.0)])
def test_split_tf32_backward_matches_pallas(s, t, q_scale):
    """The fp32 kernels' contract, emulated: products of split TF32
    operands meet the Pallas backward (interpret mode) at the card's fp32
    bars, 1e-4 of max |gradient| and atol 5e-5 / rtol 5e-4, including the
    77-token kv edge; the same arithmetic with one TF32 part per operand
    misses the first.  With q scaled by 50 (logits to ~214) the second bar
    is fp32's alone: the split holds each operand to 2^-22 where fp32
    holds 2^-24, and dk and dv land up to 7.8e-5 beyond atol / rtol of the
    Pallas backward (7.2e-5 beyond those of a float64 backward, which the
    plain fp32 backward meets); that case is held to the first bar."""
    q, k, v, cot = _inputs(s, t, seed=s + t, q_scale=q_scale)
    with pltpu.force_tpu_interpret_mode():
        pallas = _jax_grads(lambda *a: flash_attention(
            *a, block_q=128, block_k=128), q, k, v, cot)
    tq, tk, tv, tcot = map(torch.from_numpy, (q, k, v, cot))
    out, lse = TF.flash_attention_fwd_reference(tq, tk, tv)
    delta = TF.flash_attention_bwd_delta(out, tcot)
    args = (tq, tk, tv, tcot, lse, delta, 64 ** -0.5)
    ours = _split_tf32_bwd(*args)
    one_part = _split_tf32_bwd(*args, mm=lambda a, b: _tf32(a) @ _tf32(b))
    worst = 0.0
    for name, a, a1, p in zip("qkv", ours, one_part, pallas):
        p = np.asarray(p)
        if q_scale == 1.0:
            np.testing.assert_allclose(a.numpy(), p, atol=ATOL, rtol=RTOL,
                                       err_msg=f"d{name} vs Pallas")
        assert np.abs(a.numpy() - p).max() <= MAX_REL * np.abs(p).max(), name
        worst = max(worst, np.abs(a1.numpy() - p).max() / np.abs(p).max())
    assert worst > MAX_REL, worst
