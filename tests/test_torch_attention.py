"""PyTorch port: flash-attention forward and attention dispatch against the
JAX package.

The port's plain ``(out, lse)`` is held against the Pallas ``_fwd`` kernel
run in interpret mode (fp32, 2e-5, as ``test_flash_attention.py``),
including the ragged T = 77 edge and large logits.  The CUDA kernel is
held against this plain version on the card (``test_torch_kernels.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdxl_training_improvements_tpu.ops import attention as JA
from sdxl_training_improvements_tpu.ops import flash_attention as JF
from sdxl_training_improvements_tpu_torch.ops import attention as TA
from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF

TOL = 2e-5


def _qkv(b, s, t, h, d, seed=0, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, n, h, d)) * scale).astype(dtype)
                 for n in (s, t, t))


def _jax_fwd(q, k, v, block=128):
    """The Pallas forward on [BH, S, D] with S and T padded to the block,
    columns >= T masked (what ``flash_attention`` feeds it)."""
    b, s, h, d = q.shape
    t = k.shape[1]

    def to3(x, n):
        x3 = np.transpose(x, (0, 2, 1, 3)).reshape(b * h, n, d)
        pad = -n % block
        return jnp.asarray(np.pad(x3, [(0, 0), (0, pad), (0, 0)]))

    with pltpu.force_tpu_interpret_mode():
        out, lse = JF._fwd(to3(q, s), to3(k, t), to3(v, t), d ** -0.5,
                           block, block, t)
    out = np.asarray(out)[:, :s].reshape(b, h, s, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse)[:, :s, 0].reshape(b, h, s)


@pytest.mark.parametrize("s,t,d,scale", [
    (128, 128, 64, 1.0),
    (256, 77, 64, 1.0),    # the text-token kv edge
    (300, 300, 64, 1.0),   # ragged q and kv
    (64, 77, 16, 1.0),     # the tiny config's head dim
    (128, 77, 64, 6.0),    # large logits (|q.k|/8 up to ~100)
])
def test_plain_fwd_matches_pallas(s, t, d, scale):
    q, k, v = _qkv(2, s, t, 2, d, seed=s + t, scale=scale)
    ref_out, ref_lse = _jax_fwd(q, k, v)
    out, lse = TF.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q, k, v)))
    assert out.shape == (2, s, 2, d) and lse.shape == (2, 2, s)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s,t", [(64, 64), (96, 77)])
def test_attention_reference_matches_jax(s, t):
    q, k, v = _qkv(2, s, t, 4, 16, seed=7)
    ref = JA.dot_product_attention_reference(*map(jnp.asarray, (q, k, v)))
    out = TA.dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_flash_plain_and_attention_plain_agree():
    """The flash plain form and the UNet's plain attention are the same
    function (the kernel is a drop-in for the UNet's attention)."""
    q, k, v = map(torch.from_numpy, _qkv(1, 70, 77, 3, 32, seed=8))
    out, _ = TF.flash_attention_fwd_reference(q, k, v)
    torch.testing.assert_close(out, TA.dot_product_attention_reference(
        q, k, v), atol=1e-6, rtol=1e-6)
