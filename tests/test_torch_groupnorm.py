"""PyTorch port: GroupNorm+SiLU against the JAX package.

The port's plain version is held against ``groupnorm_silu_reference`` and
against the Pallas kernels run in interpret mode, as ``test_groupnorm.py``
runs them.  fp32 tolerance rtol 2e-4 / atol 2e-5; bf16 input against the
fp32 reference at atol 2e-2 (the bf16 rounding of the output).  The Triton
kernels are held against this plain version on the card
(``test_torch_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdxl_training_improvements_tpu.ops import groupnorm as JG
from sdxl_training_improvements_tpu_torch.ops import groupnorm as TG

RTOL, ATOL = 2e-4, 2e-5


def _inputs(shape, seed=0, offset=1.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + offset).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _port(x, scale, bias, groups, eps, dtype=torch.float32):
    return TG.groupnorm_silu(torch.from_numpy(x).to(dtype),
                             torch.from_numpy(scale), torch.from_numpy(bias),
                             groups, eps)


@pytest.mark.parametrize("shape,groups,eps", [
    ((2, 6, 6, 320), 32, 1e-5),   # UNet: C/G = 10
    ((2, 4, 4, 640), 32, 1e-5),   # C/G = 20
    ((1, 8, 8, 128), 32, 1e-6),   # VAE eps, C/G = 4
    ((2, 5, 3, 16), 8, 1e-6),     # tiny VAE groups
])
def test_plain_matches_jax_reference(shape, groups, eps):
    x, scale, bias = _inputs(shape)
    ref = JG.groupnorm_silu_reference(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), groups, eps)
    out = _port(x, scale, bias, groups, eps)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("s,c,groups,eps", [(64, 320, 32, 1e-5),
                                            (48, 64, 8, 1e-6)])
def test_plain_matches_pallas_single_block(s, c, groups, eps):
    x, scale, bias = _inputs((2, s, c), seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = JG._gn_silu_pallas(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), groups, eps)
    out = _port(x, scale, bias, groups, eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_plain_matches_pallas_chunked():
    x, scale, bias = _inputs((2, 128, 320), seed=2)
    with pltpu.force_tpu_interpret_mode():
        ref = JG._gn_silu_pallas_chunked(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias), 32, 1e-6, 4)
    out = _port(x, scale, bias, 32, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_bf16_input_against_fp32_oracle():
    """bf16 in, bf16 out with an fp32 interior: the fp32 reference on the
    same (bf16-representable) values is the oracle, as for the Pallas
    kernel."""
    x, scale, bias = _inputs((1, 128, 64), seed=3)
    xb = torch.from_numpy(x).bfloat16()
    ref = JG.groupnorm_silu_reference(jnp.asarray(xb.float().numpy()),
                                      jnp.asarray(scale), jnp.asarray(bias),
                                      32, 1e-5)
    out = TG.groupnorm_silu(xb, torch.from_numpy(scale),
                            torch.from_numpy(bias), 32, 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               atol=2e-2)


@pytest.mark.parametrize("n_rows,chunk_rows", [(1000, 96), (256, 256),
                                               (4096, 512)])
def test_chan_merge_of_chunk_stats(n_rows, chunk_rows):
    """The merge the apply kernel does (plain form ``combine_chunk_stats``)
    gives the two-pass mean and rstd, also where E[x^2]-E[x]^2 cancels
    (mean 300, std 1)."""
    rng = np.random.default_rng(4)
    b, g, cg = 2, 4, 8
    x = torch.from_numpy(rng.standard_normal((b, n_rows, g, cg)) + 300.0
                         ).float()
    n_chunks = -(-n_rows // chunk_rows)
    parts = [x[:, i * chunk_rows:(i + 1) * chunk_rows]
             for i in range(n_chunks)]
    mean = torch.stack([p.mean(dim=(1, 3)) for p in parts], dim=1)
    m2 = torch.stack([((p - p.mean(dim=(1, 3), keepdim=True)) ** 2
                       ).sum(dim=(1, 3)) for p in parts], dim=1)
    last = parts[-1].shape[1] * cg
    mu, rstd = TG.combine_chunk_stats(mean, m2, chunk_rows * cg, last, 1e-6)
    var, ref_mu = torch.var_mean(x.double(), dim=(1, 3), correction=0)
    np.testing.assert_allclose(mu.numpy(), ref_mu.numpy(), rtol=1e-6)
    np.testing.assert_allclose(rstd.numpy(),
                               torch.rsqrt(var + 1e-6).numpy(), rtol=1e-4)
