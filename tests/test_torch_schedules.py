"""PyTorch port: Karras schedule, ZTSNR Euler sampler and the CFG denoiser
against the JAX package.

The sampler gets JAX's own initial noise (``noise=``), so the two walks
see the same numbers.  Pinned hazards: the ZTSNR first step calls the
model at sigma = +inf and the timestep lookup maps it to index 0 (JAX's
argmin over an all-inf vector); the CFG batch is [uncond; cond] with the
guidance combine in fp32.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.training import schedules as JS
from sdxl_training_improvements_tpu.training import validation as JVal
from sdxl_training_improvements_tpu_torch.training import schedules as TS
from sdxl_training_improvements_tpu_torch.training import validation as TVal

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("n,smin,smax,rho", [(1000, 0.002, 20000.0, 7.0),
                                             (28, 0.0292, 20000.0, 7.0),
                                             (10, 0.01, 80.0, 3.0)])
def test_karras_sigmas(n, smin, smax, rho):
    np.testing.assert_allclose(
        TS.karras_sigmas(n, smin, smax, rho).numpy(),
        np.asarray(JS.karras_sigmas(n, smin, smax, rho)), rtol=RTOL)


@pytest.mark.parametrize("sigma", [0.002, 0.5, 1.0, 14.6, 20000.0])
def test_karras_scalings(sigma):
    ref = JS.karras_scalings(jnp.float32(sigma))
    np.testing.assert_allclose(TS.karras_scalings(sigma),
                               [float(r) for r in ref], rtol=RTOL)


@pytest.mark.parametrize("ztsnr", [True, False])
def test_schedule_table(ztsnr):
    kw = dict(use_ztsnr=ztsnr, sigma_max=80.0)
    ours, theirs = TS.NoiseSchedule.create(**kw), JS.NoiseSchedule.create(**kw)
    np.testing.assert_allclose(ours.sigmas.numpy(),
                               np.asarray(theirs.sigmas), rtol=RTOL)
    assert ours.sigmas.dtype == torch.float32


def _analytic(xp):
    """A smooth stand-in network F(x, sigma) defined at sigma = inf."""
    def fn(x, sigma):
        return 0.3 * x + 0.1 * xp.tanh(x) + 0.01 / (1.0 + sigma)
    return fn


@pytest.mark.parametrize("prediction,ztsnr,steps", [
    ("v_prediction", True, 6), ("v_prediction", True, 2),
    ("epsilon", False, 5)])
def test_sample_ztsnr_matches_jax(prediction, ztsnr, steps):
    sched_kw = dict(prediction_type=prediction, use_ztsnr=ztsnr,
                    sigma_max=80.0)
    key, shape = jax.random.key(3), (2, 4, 8, 8)
    ref = JS.sample_ztsnr(_analytic(jnp), key, shape,
                          JS.NoiseSchedule.create(**sched_kw),
                          num_steps=steps)
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, shape, jnp.float32)))
    seen = []

    def fn(x, sigma):
        seen.append(sigma)
        return _analytic(torch)(x, sigma)

    out = TS.sample_ztsnr(fn, shape, TS.NoiseSchedule.create(**sched_kw),
                          num_steps=steps, noise=noise)
    assert len(seen) == steps
    assert (seen[0] == float("inf")) == (prediction == "v_prediction")
    atol = ATOL
    if steps == 2 and ztsnr:
        # one Euler step from sigma_max = 20000 cancels states of size
        # 20000*|n| down to O(1): agreement is bounded by a few fp32 ulps
        # of that largest state, whatever the implementation
        atol = 4 * float(np.spacing(np.float32(
            20000.0 * noise.abs().max().item())))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=atol)


def test_noise_from_generator_when_absent():
    sched = TS.NoiseSchedule.create()
    draws = [TS.sample_ztsnr(lambda x, s: 0 * x, (1, 4, 4, 4), sched,
                             num_steps=2,
                             generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise shape"):
        TS.sample_ztsnr(lambda x, s: x, (1, 4, 4, 4), sched, num_steps=2,
                        noise=torch.zeros(1, 4, 4, 5))


def _samplers():
    model = SimpleNamespace(unet_config=SimpleNamespace(num_time_ids=6))
    js = JVal.ValidationSampler(model, None, JS.NoiseSchedule.create(),
                                guidance_scale=5.0)
    ts = TVal.ValidationSampler(model, None, TS.NoiseSchedule.create(),
                                guidance_scale=5.0)
    return model, js, ts


@pytest.mark.parametrize("sigma", [float("inf"), 20000.0, 14.6, 1.0,
                                   0.0292, 0.002, 1e-9])
def test_timestep_index_matches_jax_argmin(sigma):
    _, js, ts = _samplers()
    sigmas = js.schedule.sigmas
    ref = int(jnp.argmin(jnp.abs(
        jnp.log(jnp.maximum(sigmas, 1e-8))
        - jnp.log(jnp.maximum(jnp.float32(sigma), 1e-8)))))
    assert ts.timestep_index(sigma) == ref
    if sigma == float("inf"):
        assert ref == 0


def test_cfg_conditioning_and_denoiser_match_jax():
    """[cond; neg]-ordered encoder rows become [uncond; cond], and the
    guidance combine runs in fp32 on the split prediction."""
    model, js, ts = _samplers()
    rng = np.random.default_rng(11)
    n = 2
    enc = {"prompt_embeds": rng.standard_normal((2 * n, 77, 8)).astype(
               np.float32),
           "pooled_prompt_embeds": rng.standard_normal((2 * n, 6)).astype(
               np.float32)}
    jpe, jpooled, jids = js._conditioning(
        {k: jnp.asarray(v) for k, v in enc.items()}, n, 64, 48, 6.0, 2.5)
    tpe, tpooled, tids = ts._conditioning(
        {k: torch.from_numpy(v) for k, v in enc.items()}, n, 64, 48)
    for a, b in ((tpe, jpe), (tpooled, jpooled), (tids, jids)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tpe[:n].numpy(), enc["prompt_embeds"][n:])

    def fake_unet(*args):  # same arithmetic on jax arrays and tensors
        x2, t, pe, pooled, ids = args[-5:]
        w = pe.mean(axis=(1, 2)) + pooled.sum(axis=1) + ids[:, 0] + t
        return x2 * 0.5 + 1e-3 * w[:, None, None, None]

    model.unet_apply = fake_unet
    x = rng.standard_normal((n, 4, 8, 6)).astype(np.float32)
    for sigma in (float("inf"), 3.0):
        ref = js._denoiser(None, jpe, jpooled, jids)(jnp.asarray(x), sigma)
        out = ts._denoiser(tpe, tpooled, tids)(torch.from_numpy(x), sigma)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
