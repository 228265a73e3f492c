"""PyTorch port: the flash-attention forward's host side and its plain
version against JAX.

The CUDA forwards (``csrc/flash_fwd.cu`` for bf16 and fp16,
``csrc/flash_f32.cu`` for fp32) run only on the card
(``tests/test_torch_kernels.py``, every head dim and S, T on both sides of
their tiles; their shared-memory budgets are ``static_assert``s of the
build).  Here, on the CPU: the wrapper's refusals, and the plain forward,
which is the kernels' oracle, against the Pallas ``_fwd`` in interpret mode
at q and kv lengths that straddle the kernel's 128-row tiles (fp32, 2e-5,
as ``tests/test_torch_attention.py``), and in fp16, where the Pallas
kernel rounds the unnormalised probabilities to fp16 and the plain version
the normalised ones: out within two fp16 ulps at |out| < 1 (atol and rtol
1e-3, measured one ulp, 4.9e-4), lse (fp32) at 2e-5.

The fp32 kernel multiplies on the tensor cores' TF32 path with every
operand split into two TF32 parts, in 128-row q tiles and 64-row kv tiles
(32 at D = 128).  That contract is emulated here (``_split_tf32_fwd``: the
kernel's kv loop, online softmax and products, with the backward tests'
rounding to TF32) and held against the Pallas forward at the fp32 bar,
2e-5 for out and lse (measured 4.8e-7-1.3e-6), at S, T on both sides of
the tiles and the 77-token edge; with one TF32 part an operand it misses
that bar (measured 2.1e-4-1.0e-3).  With q scaled by 50 (logits to ~240)
S's absolute error becomes P's relative one through exp(S * scale - m):
the emulated contract misses 2e-5 (out 4.9e-5-6.1e-5, 1.4e-5 of max
|out|; lse 6.1e-5-9.2e-5, 3.8e-7 of max |lse|, measured) and is held to
the card test's bar for that case, 1e-4 of max |out| and 4e-6 of max
|lse|: the kernel adds the tensor cores' truncating accumulation, up to
an ulp of S at each of its 3 D / 8 products (4e-6 = 2^-18 of lse).
"""
import numpy as np
import pytest
import torch
from test_torch_attention import _jax_fwd
from test_torch_flash_bwd import _split_mm, _tf32

from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF

TOL = 2e-5
# q scaled by 50: out within 1e-4 of max |out|, lse within 4e-6 of max
# |lse| (tests/test_torch_kernels.py: FWD_LARGE_LOGIT_TOL)
LARGE_OUT_REL, LARGE_LSE_REL = 1e-4, 4e-6


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("args,err,match", [
    ((_bf16(1, 8, 2, 64),) * 3, ValueError, "CUDA"),
    # bf16, fp16 and fp32 have kernels; float64 has none
    ((torch.zeros(1, 8, 2, 64, dtype=torch.float64),) * 3, TypeError,
     "bf16"),
    ((_bf16(1, 8, 2, 48),) * 3, ValueError, "head dim"),
    ((_bf16(1, 1, 1, 16).expand(1, 1, 65536, 16),) * 3, ValueError,
     "exceeds 65535"),
    ((_bf16(1, 8, 2, 64),) * 3 + (-0.125,), ValueError, "scale > 0"),
])
def test_fwd_wrapper_refuses_what_the_kernel_does_not_take(args, err, match):
    before = TF.flash_attention_fwd_cuda.launches
    with pytest.raises(err, match=match):
        TF.flash_attention_fwd_cuda(*args)
    assert TF.flash_attention_fwd_cuda.launches == before


@pytest.mark.parametrize("s", [127, 128, 129, 257])
@pytest.mark.parametrize("t", [77, 128, 129])
def test_plain_fwd_matches_pallas_at_tile_edges(s, t):
    rng = np.random.default_rng(s * 1000 + t)
    q, k, v = (rng.standard_normal((1, n, 2, 64)).astype(np.float32)
               for n in (s, t, t))
    ref_out, ref_lse = _jax_fwd(q, k, v)
    out, lse = TF.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s,t", [(127, 77), (129, 129), (257, 128)])
def test_plain_fwd_fp16_matches_pallas(s, t):
    rng = np.random.default_rng(s * 1000 + t)
    q, k, v = (rng.standard_normal((1, n, 2, 64)).astype(np.float16)
               for n in (s, t, t))
    ref_out, ref_lse = _jax_fwd(q, k, v)
    out, lse = TF.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q, k, v)))
    assert out.dtype == torch.float16 and ref_out.dtype == np.float16
    np.testing.assert_allclose(out.float().numpy(),
                               ref_out.astype(np.float32), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=TOL, rtol=TOL)


def _split_tf32_fwd(q, k, v, scale, mm=_split_mm):
    """(out, lse) of the fp32 kernel's arithmetic: S = q k^T through
    ``mm`` on each kv tile of the kernel (64 rows, 32 at D = 128), the
    online softmax (running max m, sum l, alpha = exp(m_old - m_new)), P v
    through ``mm`` added to the rescaled running O; lse = m + log l."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    b, h, s, d = qh.shape
    rows = 64 if d <= 64 else 32
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    for n0 in range(0, kh.shape[2], rows):
        sc = mm(qh, kh[:, :, n0:n0 + rows].transpose(-1, -2)) * scale
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(sc - mx)
        m = mx
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vh[:, :, n0:n0 + rows])
    return (acc / l).transpose(1, 2), (m + torch.log(l))[..., 0]


def _one_part_mm(a, b):
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("s,t,d", [(127, 63, 64), (129, 65, 64),
                                   (128, 77, 64), (257, 129, 64),
                                   (129, 33, 128), (127, 77, 16)])
def test_split_tf32_forward_matches_pallas(s, t, d):
    """The fp32 kernel's contract, emulated, meets the Pallas forward
    (interpret mode) at 2e-5 for out and lse, at q and kv lengths on both
    sides of its tiles; the same arithmetic with one TF32 part an operand
    misses that bar."""
    rng = np.random.default_rng(s * 1000 + t + d)
    q, k, v = (rng.standard_normal((1, n, 2, d)).astype(np.float32)
               for n in (s, t, t))
    ref_out, ref_lse = _jax_fwd(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _split_tf32_fwd(tq, tk, tv, d ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=TOL, rtol=TOL)
    out1, lse1 = _split_tf32_fwd(tq, tk, tv, d ** -0.5, mm=_one_part_mm)
    worst = max(np.abs(out1.numpy() - ref_out).max(),
                np.abs(lse1.numpy() - ref_lse).max())
    assert worst > 5 * TOL, worst


@pytest.mark.parametrize("s,t", [(128, 77), (256, 256)])
def test_split_tf32_forward_large_logits(s, t):
    """q scaled by 50 (logits to ~220): the emulated contract misses 2e-5
    and meets 1e-4 of max |out| and 4e-6 of max |lse| against the Pallas
    forward, the bar of the card test's large-logit case; the plain fp32
    forward meets 2e-5 there."""
    rng = np.random.default_rng(s + t)
    q, k, v = (rng.standard_normal((1, n, 2, 64)).astype(np.float32)
               for n in (s, t, t))
    q = 50 * q
    ref_out, ref_lse = _jax_fwd(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _split_tf32_fwd(tq, tk, tv, 64 ** -0.5)
    out_err = np.abs(out.numpy() - ref_out).max()
    lse_err = np.abs(lse.numpy() - ref_lse).max()
    assert max(out_err, lse_err) > TOL
    assert out_err <= LARGE_OUT_REL * np.abs(ref_out).max(), out_err
    assert lse_err <= LARGE_LSE_REL * np.abs(ref_lse).max(), lse_err
    plain_out, plain_lse = TF.flash_attention_fwd_reference(tq, tk, tv)
    np.testing.assert_allclose(plain_out.numpy(), ref_out, atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(plain_lse.numpy(), ref_lse, atol=TOL,
                               rtol=TOL)
