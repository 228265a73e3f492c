"""PyTorch port: the training slice against the JAX package.

* The training half of the noise schedule at the golden values of
  ``tests/test_schedules.py`` and against the JAX functions.
* ``ddpm_loss`` and ``flow_matching_loss`` on the fp32 tiny UNet holding the
  flax module's parameters, with replayed noise and timesteps (the batch's
  ``noise`` / ``timesteps``), per-sample tag weights, and one sample whose
  latents overflow the squared error: loss and every gradient at rtol 2e-4 /
  atol 2e-5 (``tests/test_weight_parity.py``); the overflowed elements add
  a zero gradient, not NaN.
* One ``make_train_step`` step of each framework at accumulation 1 and at
  accumulation 2, with the global-norm clip active, from the same
  parameters and the same carried-over optimizer state (one JAX step in,
  mapped with ``from_jax_opt_state``); all leaves of the fp32 model take
  the exact fp32 AdamW path.  Loss and grad norm agree at rtol 2e-4; the
  first and second moments, which carry the accumulated, clipped
  gradients, at rtol 2e-4 and an atol of 1e-6 of the largest moment (some
  leaves' true gradient is 0: a conv bias followed by a one-channel-per-
  group GroupNorm, so both frameworks hold rounding noise there); each
  parameter within rtol 1e-6 plus one Adam step of this learning rate (an
  element whose gradient is at the rounding level may step either way:
  Adam divides it by its own scale).
* ``tpu.micro_batch_size`` re-tiling is exact (``tests/test_trainer.py::
  test_micro_batch_retile_is_exact``), and the config's defaults are JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu import config as JC
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.training import methods as JM
from sdxl_training_improvements_tpu.training import schedules as JS
from sdxl_training_improvements_tpu.training import trainer as JT
from sdxl_training_improvements_tpu.training.optimizers import (
    make_optimizer as jax_make_optimizer)
from sdxl_training_improvements_tpu_torch import config as TC
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params)
from sdxl_training_improvements_tpu_torch.training import methods as TM
from sdxl_training_improvements_tpu_torch.training import schedules as TS
from sdxl_training_improvements_tpu_torch.training import trainer as TT
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    make_optimizer)

RTOL, ATOL = 2e-4, 2e-5


# ------------------------------------------------------------ schedules

@pytest.fixture
def scheds():
    kw = dict(num_timesteps=100, sigma_min=0.002, sigma_max=20000.0,
              use_ztsnr=True)
    return TS.NoiseSchedule.create(**kw), JS.NoiseSchedule.create(**kw)


def test_add_noise_velocity_snr_match_jax(scheds):
    ours, theirs = scheds
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    eps = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = np.asarray([0, 50, 99])
    for name in ("add_noise", "get_velocity"):
        out = getattr(ours, name)(*map(torch.from_numpy, (x, eps, t)))
        ref = getattr(theirs, name)(*map(jnp.asarray, (x, eps, t)))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    for name in ("get_snr", "min_snr_weight"):
        np.testing.assert_allclose(
            getattr(ours, name)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(theirs, name)(jnp.asarray(t))), rtol=1e-6)


def test_schedule_golden_values(scheds):
    sched = scheds[0]
    sig = sched.sigmas.numpy()
    noisy = sched.add_noise(torch.full((2, 4, 8, 8), 0.5),
                            torch.ones(2, 4, 8, 8), torch.tensor([50, 99]))
    expect = np.clip(0.5 + sig[[50, 99]], -20000, 20000)[:, None, None, None]
    np.testing.assert_allclose(noisy.numpy(),
                               np.broadcast_to(expect, noisy.shape),
                               rtol=1e-5)
    clamped = sched.add_noise(torch.zeros(1, 4, 2, 2),
                              torch.full((1, 4, 2, 2), 3.0),
                              torch.tensor([0]))
    assert clamped.max().item() == 20000.0
    v = sched.get_velocity(torch.full((1, 4, 2, 2), 2.0),
                           torch.full((1, 4, 2, 2), 5.0), torch.tensor([70]))
    np.testing.assert_allclose(v.numpy(), 3.0 / sig[70], rtol=1e-5)
    w = sched.min_snr_weight(torch.arange(100)).numpy()
    np.testing.assert_allclose(w, np.minimum((1.0 / sig) ** 2, 5.0),
                               rtol=1e-5)
    off = TS.NoiseSchedule.create(num_timesteps=10, min_snr_gamma=None)
    np.testing.assert_array_equal(off.min_snr_weight(torch.arange(10)), 1.0)


def test_timestep_sampling_and_bias(scheds):
    sched = scheds[0]
    t = sched.sample_timesteps(torch.Generator().manual_seed(0), 512)
    assert t.shape == (512,) and 0 <= int(t.min()) and int(t.max()) < 100
    w = TS.generate_timestep_weights(100, "later", bias_portion=0.25,
                                     bias_multiplier=100.0)
    t = sched.sample_timesteps(torch.Generator().manual_seed(1), 2000,
                               weights=w)
    assert (t >= 75).float().mean().item() > 0.9


@pytest.mark.parametrize("kw", [
    dict(bias_strategy="none"),
    dict(bias_strategy="later", bias_portion=0.25, bias_multiplier=2.0),
    dict(bias_strategy="earlier", bias_portion=0.25, bias_multiplier=2.0),
    dict(bias_strategy="range", bias_begin=10, bias_end=20,
         bias_multiplier=3.0),
])
def test_timestep_weights_match_jax(kw):
    np.testing.assert_allclose(
        TS.generate_timestep_weights(100, **kw).numpy(),
        np.asarray(JS.generate_timestep_weights(100, **kw)), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(bias_strategy="bogus"),
                                dict(bias_strategy="later",
                                     bias_multiplier=0.0),
                                dict(bias_strategy="range")])
def test_timestep_weights_refuse_bad_settings(kw):
    with pytest.raises(ValueError):
        TS.generate_timestep_weights(10, **kw)


def test_flow_matching_numerics():
    t = TS.sample_logit_normal(torch.Generator().manual_seed(0), (4096,))
    assert (t > 0).all() and (t < 1).all() and abs(t.mean() - 0.5) < 0.02
    shifted = TS.sample_logit_normal(torch.Generator().manual_seed(0),
                                     (4096,), mean=2.0)
    assert shifted.mean() > 0.7
    x0, x1 = torch.zeros(1, 1, 2, 2), torch.full((1, 1, 2, 2), 4.0)
    torch.testing.assert_close(
        TS.optimal_transport_path(x0, x1, torch.tensor([0.25])),
        torch.ones(1, 1, 2, 2))
    torch.testing.assert_close(TS.flow_matching_target(x0, x1), x1)
    ids = TS.get_add_time_ids([(1024, 768)], [(0, 32)], [(1024, 1024)])
    np.testing.assert_array_equal(ids.numpy(),
                                  [[1024, 768, 0, 32, 1024, 1024]])


# ------------------------------------------------- losses on the tiny UNet

@pytest.fixture(scope="module")
def models():
    """The flax tiny UNet (fp32) and the port's holding its parameters."""
    jmodel = JModel.create(tiny=True, dtype=jnp.float32,
                           init_rng=jax.random.key(0))
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    _load(model, jmodel.params["unet"])
    return jmodel, model


def _load(model, jax_params):
    model.unet.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params)), strict=True)


def _batch(b, seed, overflow=False):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
    if overflow:  # (eps - x) / sigma squared overflows fp32 for sample 0
        lat[0] *= np.float32(1e30)
    return {
        "vae_latents": lat,
        "prompt_embeds": rng.standard_normal((b, 77, 64)).astype(np.float32),
        "pooled_prompt_embeds": rng.standard_normal((b, 32)).astype(
            np.float32),
        "time_ids": np.tile(np.asarray([[128., 128, 0, 0, 128, 128]],
                                       np.float32), (b, 1)),
        "noise": rng.standard_normal((b, 4, 16, 16)).astype(np.float32),
        "timesteps": np.asarray([300, 700, 500, 900][:b]),
        "tag_weights": np.asarray([0.5, 2.0, 1.0, 1.5][:b], np.float32),
    }


def _port_loss_grads(model, method, batch):
    model.unet.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if method == "flow_matching":  # t in (0, 1) for flow matching
        tb["timesteps"] = tb["timesteps"].float() / 1000.0
    cfg = TC.Config()
    loss, _ = TM.get_method(method)(model.unet_apply, tb, None,
                                    TS.NoiseSchedule.from_config(cfg),
                                    cfg.model)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in
                         model.unet.named_parameters()}


@pytest.mark.parametrize("method", ["ddpm", "flow_matching"])
def test_losses_and_gradients_match_jax(models, method):
    jmodel, model = models
    cfg = JC.Config()
    sched = JS.NoiseSchedule.from_config(cfg)
    fn = JM.get_method(method)

    def loss(params, batch):
        return fn(jmodel.unet_apply, params, batch, jax.random.key(1),
                  sched, cfg.model)[0]
    value_and_grad = jax.jit(jax.value_and_grad(loss))
    cases = [False, True] if method == "ddpm" else [False]
    for overflow in cases:
        batch = _batch(2, 7, overflow)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if method == "flow_matching":
            jb["timesteps"] = jb["timesteps"].astype(jnp.float32) / 1000.0
        ref_loss, ref_grads = value_and_grad(jmodel.params["unet"], jb)
        ref_grads = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_grads))
        got_loss, got_grads = _port_loss_grads(model, method, batch)
        np.testing.assert_allclose(got_loss, float(ref_loss), rtol=RTOL)
        assert set(got_grads) == set(ref_grads)
        for name, g in got_grads.items():
            assert torch.isfinite(g).all(), name
            np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_finite_guard_and_tag_weight_contracts():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    loss = TM._finite_guard((x * torch.tensor([float("inf"), 1.0])).sum())
    assert loss.item() == TM.LOSS_CLAMP
    big = TM._finite_guard(x.sum() * 1e4)
    big.backward()
    assert big.item() == TM.LOSS_CLAMP and (x.grad == 0).all()
    tw = {"tag_weights": torch.tensor([2.0, 4.0])}
    assert TM._apply_tag_weights(torch.tensor(10.0), tw).item() == 30.0
    torch.testing.assert_close(
        TM._apply_tag_weights(torch.ones(2), tw), torch.tensor([2.0, 4.0]))
    with pytest.raises(ValueError, match="Unknown training method"):
        TM.get_method("bogus")


# ------------------------------------------------------------ train step

def _jax_config(accum, batch_size):
    cfg = JC.Config()
    cfg.training.gradient_accumulation_steps = accum
    cfg.training.batch_size = batch_size
    cfg.optimizer.learning_rate = 1e-3
    return cfg


def _port_config(jcfg):
    return TC.Config.from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(models, accum):
    """Step 2 of each framework from JAX's state after step 1: Adam's
    update is no longer sign-like there, so the parameters carry the
    gradients' agreement."""
    jmodel, model = models
    global_b = 4
    jcfg = _jax_config(accum, global_b // accum)
    sched = JS.NoiseSchedule.from_config(jcfg)
    jopt = jax_make_optimizer(jcfg)
    jstep = JT.make_train_step(jmodel.unet_apply, sched, jopt, jcfg,
                               donate=False)
    state = JT.create_train_state(jmodel.trainable_params(), jopt)
    state, _ = jstep(state, {k: jnp.asarray(v) for k, v in
                             _batch(global_b, 11).items()})
    batch = _batch(global_b, 12)
    ref_state, ref_metrics = jstep(state, {k: jnp.asarray(v)
                                           for k, v in batch.items()})

    _load(model, state.params)
    cfg = _port_config(jcfg)
    opt = make_optimizer(cfg)
    step = TT.make_train_step(model.unet_apply, TS.NoiseSchedule.from_config(
        cfg), opt, cfg)
    tstate = TT.create_train_state(model.trainable_params(), opt)
    tstate.opt_state = from_jax_opt_state(
        jax.tree_util.tree_map(np.asarray,
                               state.opt_state._replace(key=None)),
        like=tstate.params)
    tstate, metrics = step(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})

    assert metrics["grad_norm"].item() > cfg.training.clip_grad_norm
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]),
                                   rtol=RTOL)
    ref_opt = ref_state.opt_state
    for ours, theirs in ((tstate.opt_state.exp_avg, ref_opt.exp_avg),
                         (tstate.opt_state.exp_avg_sq, ref_opt.exp_avg_sq)):
        theirs = from_jax_params(jax.tree_util.tree_map(np.asarray, theirs))
        atol = 1e-6 * max(t.abs().max().item() for t in theirs.values())
        for name, m in ours.items():
            np.testing.assert_allclose(m.numpy(), theirs[name].numpy(),
                                       rtol=RTOL, atol=atol, err_msg=name)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                 ref_state.params))
    adam_step = 4 * opt.lr_eff(2)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=adam_step, err_msg=name)
    assert tstate.step == 1 and tstate.opt_state.step == 2


def test_micro_batch_retile_is_exact(models):
    """Every tiling of the same global batch (4x1, 2x2, 1x4 micro-batches)
    draws the same per-sample noise and timesteps and computes the same
    mean over the same per-sample terms: equal up to fp32 summation order
    (port of ``tests/test_trainer.py::test_micro_batch_retile_is_exact``,
    with the randomness drawn by the trainer, not replayed)."""
    _, model = models
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, 13).items()
             if k not in ("noise", "timesteps")}
    start = {n: p.detach().clone() for n, p in model.unet.named_parameters()}
    outs = []
    for batch_size, accum, micro in [(4, 1, None), (2, 2, None), (4, 1, 1),
                                     (1, 4, None)]:
        cfg = TC.Config()
        cfg.training.batch_size = batch_size
        cfg.training.gradient_accumulation_steps = accum
        cfg.tpu.micro_batch_size = micro
        with torch.no_grad():
            for n, p in model.unet.named_parameters():
                p.copy_(start[n])
        opt = make_optimizer(cfg)
        step = TT.make_train_step(model.unet_apply,
                                  TS.NoiseSchedule.from_config(cfg), opt, cfg)
        state, m = step(TT.create_train_state(model.trainable_params(), opt),
                        batch)
        outs.append((m["loss"].item(), {n: p.detach().clone()
                                        for n, p in state.params.items()}))
    ref_loss, ref_params = outs[0]
    for loss, params in outs[1:]:
        assert loss == pytest.approx(ref_loss, rel=1e-5)
        for n, p in params.items():
            torch.testing.assert_close(p, ref_params[n], rtol=1e-4, atol=1e-6)


def test_micro_batch_must_divide_global():
    cfg = TC.Config()
    cfg.tpu.micro_batch_size = 3
    with pytest.raises(ValueError, match="must divide the global"):
        TT.make_train_step(None, None, None, cfg)


def test_config_defaults_and_validation_match_jax():
    ours, theirs = TC.Config(), JC.Config()
    for section in ("model", "optimizer", "training", "tpu"):
        a, b = dataclasses.asdict(getattr(ours, section)), \
            dataclasses.asdict(getattr(theirs, section))
        assert a == {k: b[k] for k in a}, section
    cfg = TC.Config.from_dict({"training": {"batch_size": 2},
                               "tpu": {"use_pallas_attention": False},
                               "data": {"image_size": 512}})
    assert cfg.training.batch_size == 2 and cfg.tpu.attention_impl == "xla"
    with pytest.raises(ValueError, match="grad_accum_dtype"):
        TC.Config.from_dict({"tpu": {"grad_accum_dtype": "fp8"}})
    with pytest.raises(ValueError, match="must be a mapping"):
        TC.Config.from_dict({"training": 3})
