"""PyTorch port: the flash-attention forward's host side and its plain
version against JAX.

The CUDA forward (``csrc/flash_fwd.cu``) runs only on the card
(``tests/test_torch_kernels.py``, every head dim and S, T on both sides of
its 128-row tiles; its shared-memory budget is a ``static_assert`` of the
build).  Here, on the CPU: the wrapper's refusals, and the plain forward,
which is the kernel's oracle, against the Pallas ``_fwd`` in interpret mode
at q and kv lengths that straddle the kernel's 128-row tiles (fp32, 2e-5,
as ``tests/test_torch_attention.py``), and in fp16, where the Pallas
kernel rounds the unnormalised probabilities to fp16 and the plain version
the normalised ones: out within two fp16 ulps at |out| < 1 (atol and rtol
1e-3, measured one ulp, 4.9e-4), lse (fp32) at 2e-5.
"""
import numpy as np
import pytest
import torch
from test_torch_attention import _jax_fwd

from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF

TOL = 2e-5


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
