"""PyTorch port: the samplers against the JAX package.

``sample_ztsnr`` (text-to-image, img2img, the denoising_end/start
handoff, the aux-threading form), ``sample_dpmpp_2m`` (the same) and
``sample_flow`` (text-to-image, img2img) walk the same analytic model in
both frameworks, and two of them the tiny UNet, for v-prediction and
epsilon.  The port gets JAX's draw through ``noise=``.  The JAX walks
keep sigma in fp32; the port's in Python floats, so the two differ by
fp32 rounding of the step coefficients: the bar is rtol 2e-4 / atol 2e-5
of the latents' largest magnitude.  Pinned: the img2img entry index
round((1 - strength) * n) and flow's round(strength * n) steps, the DPM++
first step and its last step to sigma = 0, and the handoff seam (the
split walk equals the whole one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.training import schedules as JS
from sdxl_training_improvements_tpu_torch.models.unet import (
    SDXLUNet, UNetConfig)
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.training import schedules as TS

RTOL, ATOL = 2e-4, 2e-5
SHAPE = (2, 4, 8, 8)
STEPS = 6
SCHEDULES = {
    "v_prediction": dict(),
    "epsilon": dict(use_ztsnr=False, sigma_max=80.0,
                    prediction_type="epsilon"),
}


def _schedules(pred):
    return (JS.NoiseSchedule.create(**SCHEDULES[pred]),
            TS.NoiseSchedule.create(**SCHEDULES[pred]))


def _jnoise(seed, shape=SHAPE):
    key = jax.random.key(seed)
    return key, torch.from_numpy(np.array(jax.random.normal(
        key, shape, jnp.float32)))


def _init(seed=7):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


def _close(port, ref):
    ref = np.asarray(ref)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(ref).max()))


# an analytic stand-in for the network: smooth in x, bounded in sigma (the
# v walk calls it at sigma = inf first)
def _jax_fn(x, sigma):
    return 0.5 * x + 0.2 * jnp.tanh(x) / (1.0 + jnp.minimum(sigma, 100.0))


def _port_fn(x, sigma):
    return 0.5 * x + 0.2 * torch.tanh(x) / (1.0 + min(sigma, 100.0))


SAMPLERS = {"euler": (JS.sample_ztsnr, TS.sample_ztsnr),
            "dpmpp_2m": (JS.sample_dpmpp_2m, TS.sample_dpmpp_2m)}
MODES = {"text2img": {}, "img2img": dict(strength=0.35),
         "img2img_weak": dict(strength=0.1),
         "denoising_end": dict(denoising_end=0.5),
         "denoising_start": dict(denoising_start=0.5)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pred", sorted(SCHEDULES))
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_sigma_samplers_match_jax(sampler, pred, mode):
    jsample, tsample = SAMPLERS[sampler]
    jsched, tsched = _schedules(pred)
    key, noise = _jnoise(1)
    kw = dict(MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    if "strength" in kw or "denoising_start" in kw:
        jkw["init"] = jnp.asarray(_init())
        tkw["init"] = torch.from_numpy(_init())
    ref = jsample(_jax_fn, key, SHAPE, jsched, num_steps=STEPS, **jkw)
    out = tsample(_port_fn, SHAPE, tsched, num_steps=STEPS, noise=noise,
                  **tkw)
    _close(out, ref)


@pytest.mark.parametrize("pred", sorted(SCHEDULES))
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_aux_state_threads_like_jax(sampler, pred):
    """The aux form: the state goes through every call in order (a
    per-step counter here, DeepCache's (step, deep) in the pipelines)."""
    jsample, tsample = SAMPLERS[sampler]
    jsched, tsched = _schedules(pred)
    key, noise = _jnoise(2)

    def jfn(x, sigma, step):
        return _jax_fn(x, sigma) + 0.01 * step, step + 1

    calls = []

    def tfn(x, sigma, step):
        calls.append(step)
        return _port_fn(x, sigma) + 0.01 * step, step + 1

    ref = jsample(jfn, key, SHAPE, jsched, num_steps=STEPS,
                  aux0=jnp.asarray(0, jnp.int32))
    out = tsample(tfn, SHAPE, tsched, num_steps=STEPS, noise=noise, aux0=0)
    _close(out, ref)
    assert calls == list(range(len(calls)))
    # text-to-image makes exactly num_steps model calls
    assert len(calls) == STEPS


@pytest.mark.parametrize("pred", sorted(SCHEDULES))
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_handoff_seam_equals_whole_walk(sampler, pred):
    _, tsample = SAMPLERS[sampler]
    _, tsched = _schedules(pred)
    noise = torch.from_numpy(_init(3))
    whole = tsample(_port_fn, SHAPE, tsched, num_steps=8, noise=noise)
    noisy = tsample(_port_fn, SHAPE, tsched, num_steps=8, noise=noise,
                    denoising_end=0.5)
    rest = tsample(_port_fn, SHAPE, tsched, num_steps=8, noise=noise,
                   init=noisy, denoising_start=0.5)
    if sampler == "euler":  # DPM++ restarts its multistep history
        torch.testing.assert_close(rest, whole, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(rest).all()


def _jax_flow(x, t):
    return -x * (1.0 + t) + 0.1 * jnp.sin(x)


def _port_flow(x, t):
    return -x * (1.0 + t) + 0.1 * torch.sin(x)


@pytest.mark.parametrize("strength", [1.0, 0.45, 0.05])
def test_flow_matches_jax(strength):
    key, noise = _jnoise(4)
    calls = []

    def counted(x, t):
        calls.append(float(t))
        return _port_flow(x, t)

    init = None if strength == 1.0 else _init()
    ref = JS.sample_flow(_jax_flow, key, SHAPE, num_steps=STEPS,
                         init=None if init is None else jnp.asarray(init),
                         strength=strength)
    out = TS.sample_flow(counted, SHAPE, num_steps=STEPS, noise=noise,
                         init=None if init is None
                         else torch.from_numpy(init), strength=strength)
    _close(out, ref)
    assert len(calls) == (STEPS if strength == 1.0
                          else max(1, round(strength * STEPS)))
    assert calls[0] == pytest.approx(1.0 - strength, abs=1e-7)


def test_refusals():
    _, tsched = _schedules("v_prediction")
    init = torch.zeros(SHAPE)
    for kw, match in ((dict(strength=0.0), "strength"),
                      (dict(strength=1.5), "strength"),
                      (dict(denoising_start=0.5), "requires init"),
                      (dict(init=init, denoising_start=1.0),
                       "denoising_start"),
                      (dict(denoising_end=0.0), "denoising_end")):
        for sample in (TS.sample_ztsnr, TS.sample_dpmpp_2m):
            with pytest.raises(ValueError, match=match):
                sample(_port_fn, SHAPE, tsched, num_steps=4, **kw)
    with pytest.raises(ValueError, match="strength"):
        TS.sample_flow(_port_flow, SHAPE, strength=0.0)
    with pytest.raises(ValueError, match="noise shape"):
        TS.sample_ztsnr(_port_fn, SHAPE, tsched, noise=torch.zeros(1, 4))


# ---------------------------------------------------------- tiny UNet
@pytest.fixture(scope="module")
def unets():
    jmodel = JModel.create(tiny=True, dtype=jnp.float32,
                           init_rng=jax.random.key(5),
                           init_components=("unet",))
    unet = SDXLUNet(UNetConfig.tiny()).eval()
    unet.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, jmodel.params["unet"])), strict=True)
    rng = np.random.default_rng(6)
    ucfg = jmodel.unet_config
    cond = (rng.standard_normal((2, 77, ucfg.cross_attention_dim)),
            rng.standard_normal((2, ucfg.pooled_embed_dim)),
            np.tile([[16.0, 16, 0, 0, 16, 16]], (2, 1)))
    cond = [c.astype(np.float32) for c in cond]
    return jmodel, unet, cond


@pytest.mark.parametrize("sampler,pred,mode", [
    ("dpmpp_2m", "epsilon", "text2img"),
    ("euler", "v_prediction", "img2img"),
])
def test_tiny_unet_walk_matches_jax(unets, sampler, pred, mode):
    """A sampler over the tiny UNet (the raw network at the nearest
    trained timestep, as the pipelines call it) in both frameworks."""
    jmodel, unet, cond = unets
    jsample, tsample = SAMPLERS[sampler]
    jsched, tsched = _schedules(pred)
    log_sig = np.log(np.maximum(tsched.sigmas.numpy(), 1e-8))
    jcond = [jnp.asarray(c) for c in cond]
    tcond = [torch.from_numpy(c) for c in cond]

    def jfn(x, sigma):
        t = jnp.argmin(jnp.abs(jnp.log(jnp.maximum(jsched.sigmas, 1e-8))
                               - jnp.log(jnp.maximum(sigma, 1e-8))))
        return jmodel.unet_apply(jmodel.params["unet"], x,
                                 jnp.full((2,), t, jnp.int32), *jcond)

    def tfn(x, sigma):
        t = 0 if np.isinf(sigma) else int(np.argmin(np.abs(
            log_sig - np.log(max(np.float32(sigma), 1e-8)))))
        return unet(x, torch.full((2,), t), *tcond).float()

    key, noise = _jnoise(8)
    jkw, tkw = {}, {}
    if mode == "img2img":
        jkw = dict(init=jnp.asarray(_init()), strength=0.5)
        tkw = dict(init=torch.from_numpy(_init()), strength=0.5)
    ref = jsample(jfn, key, SHAPE, jsched, num_steps=4, **jkw)
    with torch.no_grad():
        out = tsample(tfn, SHAPE, tsched, num_steps=4, noise=noise, **tkw)
    _close(out, ref)
