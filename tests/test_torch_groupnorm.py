"""PyTorch port: GroupNorm+SiLU against the JAX package.

The port's plain version is held against ``groupnorm_silu_reference`` and
against the Pallas kernels run in interpret mode, as ``test_groupnorm.py``
runs them.  fp32 tolerance rtol 2e-4 / atol 2e-5; bf16 input against the
fp32 reference at atol 2e-2 (the bf16 rounding of the output).  The plain
statistics (``group_stats_reference``) against JAX's mean and
1 / sqrt(var + eps) at rtol 1e-5.  The closed-form plain backward
(``groupnorm_silu_backward_reference``) against ``jax.vjp`` of the JAX
reference and against torch autograd of the port's, in fp32: dx, dscale
and dbias within 1e-5 of max |reference| (closed form against autodiff,
summation order only); with bf16 or fp16 x and dy, dx within one output
ulp of the fp32 oracle on the same values.  The CUDA kernels are held
against these plain versions on the card (``test_torch_kernels.py``,
``test_torch_train_kernels.py``, ``chip_smoke.py``).
"""
import jax
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


def _stats_jax(x, groups, eps):
    b, c = x.shape[0], x.shape[-1]
    xg = jnp.asarray(x).reshape(b, -1, groups, c // groups)
    return (np.asarray(jnp.mean(xg, axis=(1, 3))),
            np.asarray(1.0 / jnp.sqrt(jnp.var(xg, axis=(1, 3)) + eps)))


@pytest.mark.parametrize("shape,groups,eps", [
    ((2, 6, 6, 320), 32, 1e-5),
    ((1, 8, 8, 128), 32, 1e-6),
    ((2, 5, 3, 16), 8, 1e-6),
])
def test_group_stats_reference_matches_jax(shape, groups, eps):
    x = _inputs(shape, seed=6, offset=3.0)[0]
    mean, rstd = TG.group_stats_reference(torch.from_numpy(x), groups, eps)
    ref_mean, ref_rstd = _stats_jax(x, groups, eps)
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == (shape[0], groups)
    np.testing.assert_allclose(mean.numpy(), ref_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), ref_rstd, rtol=1e-5)


def test_fwd_reference_is_the_fp32_interior_with_its_statistics():
    """The forward kernel's plain form: y of the fp32 interior (also for a
    bf16 input under ``norm_arith_bf16``) and the two-pass statistics."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((2, 64, 320)))
    xb = x.bfloat16()
    with TG.norm_arith_bf16(True):
        y, mean, rstd = TG.gn_silu_fwd_reference(xb, scale, bias, 32, 1e-5)
    assert torch.equal(y, TG.groupnorm_silu_reference(xb, scale, bias, 32,
                                                      1e-5))
    ref_mean, ref_rstd = TG.group_stats_reference(xb, 32, 1e-5)
    assert torch.equal(mean, ref_mean) and torch.equal(rstd, ref_rstd)


def _bwd_inputs(shape, seed):
    x, scale, bias = _inputs(shape, seed=seed)
    dy = np.random.default_rng(seed + 100).standard_normal(shape).astype(
        np.float32)
    return x, scale, bias, dy


def _closed_form(x, scale, bias, dy, groups=32, eps=1e-5):
    tx = torch.from_numpy(x)
    mean, rstd = TG.group_stats_reference(tx, groups, eps)
    return TG.groupnorm_silu_backward_reference(
        torch.from_numpy(dy), tx, torch.from_numpy(scale),
        torch.from_numpy(bias), mean, rstd, groups)


BWD_SHAPES = [(2, 16, 320), (2, 100, 128), (1, 64, 960)]  # C/G 10, 4, 30


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_reference_matches_jax_vjp(shape):
    x, scale, bias, dy = _bwd_inputs(shape, seed=7)
    _, vjp = jax.vjp(
        lambda a, w, b: JG.groupnorm_silu_reference(a, w, b, 32, 1e-5),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = _closed_form(x, scale, bias, dy)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert np.abs(a.numpy() - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_reference_matches_torch_autograd(shape):
    x, scale, bias, dy = _bwd_inputs(shape, seed=8)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = TG.groupnorm_silu_reference(*leaves, 32, 1e-5)
    ref = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    got = _closed_form(x, scale, bias, dy)
    for a, r in zip(got, ref):
        assert (a - r).abs().max() <= 1e-5 * r.abs().max()


def _ulp(v: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each |v| (its least subnormal at 0)."""
    info = torch.finfo(dtype)
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    mag = v.abs().clamp(min=info.tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant).clamp(
        min=info.smallest_normal * 2.0 ** -mant)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_backward_reference_16bit_rounds_once(dtype):
    """16-bit x and dy: dx within one output ulp of the fp32 oracle on the
    same values (the closed form runs in fp32 and rounds once); dscale and
    dbias, in the fp32 parameters' dtype, equal to it."""
    x, scale, bias, dy = _bwd_inputs((2, 100, 128), seed=9)
    x16, dy16 = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    mean, rstd = TG.group_stats_reference(x16, 32, 1e-5)
    got = TG.groupnorm_silu_backward_reference(dy16, x16, w, b, mean, rstd,
                                               32)
    oracle = TG.groupnorm_silu_backward_reference(
        dy16.float(), x16.float(), w, b, mean, rstd, 32)
    assert got[0].dtype == dtype
    assert ((got[0].float() - oracle[0]).abs()
            <= _ulp(oracle[0], dtype)).all()
    assert torch.equal(got[1], oracle[1]) and torch.equal(got[2], oracle[2])
