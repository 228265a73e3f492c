"""PyTorch port: plain ``adamw`` against ``optax.adamw``, and the
optimizers' refusals of leaves they do not take.

``optimizer_type: "adamw"`` is JAX's ``optax.adamw(lr, b1, b2, eps,
weight_decay)`` (``training/optimizers/__init__.py``); the port writes it
as a plain per-leaf update.  Three steps with weight decay from the same
parameters and gradients (numpy, seeded), on:

* fp32 leaves with fp32 gradients: parameters at rtol 1e-6 and atol 4e-8
  (an ulp at |p| < 0.5), moments at rtol 1e-6 and atol 1e-6 of the
  largest moment (XLA contracts the moment updates into FMAs, the port
  rounds each product, and gradients of opposite signs cancel in the
  first moment);
* fp16 leaves with fp32 gradients, what the trainer hands an fp16 UNet
  (its accumulator is fp32): the moments turn fp32 at the first step, as
  optax's do; parameters within one fp16 ulp (rtol 2**-10), moments as
  for fp32;
* fp16 leaves with fp16 gradients: all arithmetic in fp16, where XLA and
  torch round their intermediates at other places; parameters within
  atol lr / 4 per step (3 steps: 7.5e-4) plus one fp16 ulp, moments
  within 2 fp16 ulps of their own or of the largest moment.

The moments keep the dtype optax keeps for each leaf in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_training_improvements_tpu.training.optimizers.adamw_bf16 import (
    adamw_bf16 as jax_adamw_bf16)
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    AdamW, AdamWBF16, make_optimizer)

LR, WD, STEPS = 1e-3, 1e-2, 3


def _run(p_dtype, g_dtype, seed=0):
    """(port params, port state, optax params, optax state) after STEPS
    steps on two leaves of different shapes."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 33), "b": (33,)}
    p0 = {k: (0.1 * rng.standard_normal(s)).astype(p_dtype)
          for k, s in shapes.items()}
    grads = []
    for _ in range(STEPS):
        # magnitudes from 0.05 to 1: no fp16 moment underflows
        g = {k: (rng.choice([-1.0, 1.0], s)
                 * rng.uniform(0.05, 1.0, s)).astype(g_dtype)
             for k, s in shapes.items()}
        grads.append(g)
    opt = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    update = jax.jit(opt.update)
    port = AdamW(LR, (0.9, 0.999), 1e-8, WD)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = port.init(tp)
    for g in grads:
        u, jstate = update({k: jnp.asarray(v) for k, v in g.items()},
                           jstate, jp)
        jp = optax.apply_updates(jp, u)
        deltas, tstate = port.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        for k, p in tp.items():
            p.add_(deltas[k])
    return tp, tstate, jp, jstate[0]


def _np(x):
    return np.asarray(x).astype(np.float64)


@pytest.mark.parametrize("p_dtype,g_dtype", [(np.float32, np.float32),
                                             (np.float16, np.float32),
                                             (np.float16, np.float16)])
def test_adamw_matches_optax(p_dtype, g_dtype):
    tp, tstate, jp, jadam = _run(p_dtype, g_dtype)
    assert tstate.step == STEPS
    for k in tp:
        ours, theirs = tp[k].numpy(), np.asarray(jp[k])
        assert ours.dtype == theirs.dtype == p_dtype
        for mine, ref in ((tstate.mu[k], jadam.mu[k]),
                          (tstate.nu[k], jadam.nu[k])):
            assert str(mine.dtype).split(".")[-1] == str(ref.dtype)
            tol = 2 * 2 ** -10 if ref.dtype == np.float16 else 1e-6
            np.testing.assert_allclose(
                _np(mine.numpy()), _np(ref), rtol=tol,
                atol=tol * np.abs(_np(ref)).max())
        if p_dtype == np.float32:
            np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=4e-8)
        elif g_dtype == np.float32:
            np.testing.assert_allclose(_np(ours), _np(theirs),
                                       rtol=2 ** -10, atol=0)
        else:
            np.testing.assert_allclose(_np(ours), _np(theirs),
                                       rtol=2 ** -10,
                                       atol=STEPS * LR / 4)


def test_make_optimizer_builds_plain_adamw():
    """``optimizer_type: adamw`` builds the plain update from the
    optimizer section; as in JAX, the adamw_bf16-only settings (layout,
    int8 moments, noise, host-streamed state) do not apply to it, while
    EMA stays unported."""
    cfg = Config.from_dict({"optimizer": {
        "optimizer_type": "adamw", "learning_rate": 1e-5, "beta1": 0.8,
        "beta2": 0.99, "epsilon": 1e-6, "weight_decay": 0.05,
        "moments_8bit": True, "shift_host": True},
        "tpu": {"sr_noise": "rbg", "flat_optimizer": "on"}})
    opt = make_optimizer(cfg)
    assert isinstance(opt, AdamW)
    assert (opt.lr, opt.beta1, opt.beta2, opt.eps, opt.weight_decay) == (
        1e-5, 0.8, 0.99, 1e-6, 0.05)
    cfg.training.ema_decay = 0.999
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(cfg)


def test_adamw_bf16_refuses_fp16_leaves_as_jax_does():
    """An fp16 leaf is refused by name, with JAX's ValueError, at init and
    at update (before any leaf is touched), not by the kernel wrapper's
    TypeError deep in the step."""
    p16 = np.zeros((4, 4), np.float16)
    with pytest.raises(ValueError, match="adamw_bf16 requires bfloat16"):
        jax_adamw_bf16(lr=1e-4).init({"w": jnp.asarray(p16)})
    opt = AdamWBF16(lr=1e-4)
    params = {"w": torch.zeros(4, 4, dtype=torch.float16)}
    with pytest.raises(ValueError, match="adamw_bf16 requires bfloat16"):
        opt.init(params)
    good = {"w": torch.zeros(4, 4, dtype=torch.bfloat16)}
    state = opt.init(good)
    with pytest.raises(ValueError, match="adamw_bf16 requires bfloat16"):
        opt.update({"w": torch.zeros(4, 4)}, state, params)
    assert state.step == 0
