"""PyTorch port: stochastic rounding and the bf16-SR AdamW against JAX.

Integer-defined maths is held bit for bit: ``counter_noise``, the three
stochastic-rounding functions, and the whole bf16 AdamW chain of the JAX
optimizer's default path (``adamw_bf16(noise="hash")``, per-leaf), with
JAX's own per-leaf seeds injected and both optimizers starting from the
same state (``from_jax_opt_state``).  The zero-noise chain is held bit for
bit against the Pallas kernel in interpret mode, where its random bits are
stubbed to zero.  fp32 leaves (exact AdamW) agree to rtol 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdxl_training_improvements_tpu.ops import fused_adamw as JF
from sdxl_training_improvements_tpu.ops import stochastic as JS
from sdxl_training_improvements_tpu.training.optimizers import (
    adamw_bf16 as jax_adamw_bf16)
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state)
from sdxl_training_improvements_tpu_torch.ops import fused_adamw as TF
from sdxl_training_improvements_tpu_torch.ops import stochastic as TS
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    AdamWBF16, make_optimizer)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jnp_bits(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)).view(np.uint32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 0x9E3779B9, 0xFFFFFFFF])
def test_counter_noise_bit_exact(seed):
    n = 5000
    ref = np.asarray(JS.counter_noise(jnp.uint32(seed), n))
    out = TS.counter_noise(seed, n).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))


def _sr_inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 3, n)
         ).astype(np.float32)
    acc = rng.standard_normal(n).astype(np.float32) * 1e-2
    other = rng.standard_normal(n).astype(np.float32) * 1e-4
    denom = (rng.random(n).astype(np.float32) + 0.5) * 1e-2
    noise = np.asarray(JS.counter_noise(jnp.uint32(seed + 3), n))
    return x, acc, other, denom, noise


def test_stochastic_round_functions_bit_exact():
    """Against the JAX functions jitted, as the optimizer runs them: XLA
    fuses ``alpha * other + acc`` into one FMA."""
    x, acc, other, denom, noise = _sr_inputs()
    jacc = jnp.asarray(acc).astype(jnp.bfloat16)
    tacc = _bf16(np.asarray(jacc, np.float32))
    tn = torch.from_numpy(noise.astype(np.int64))
    pairs = [
        (JS.stochastic_round_bits(jnp.asarray(x), jnp.asarray(noise)),
         TS.stochastic_round_bits(torch.from_numpy(x), tn)),
        (jax.jit(functools.partial(JS.add_stochastic_bits, alpha=0.1))(
            jacc, jnp.asarray(other), jnp.asarray(noise)),
         TS.add_stochastic_bits(tacc, torch.from_numpy(other), tn,
                                alpha=0.1)),
        (jax.jit(functools.partial(JS.addcdiv_stochastic_bits,
                                   value=-3e-4))(
            jacc, jnp.asarray(other), jnp.asarray(denom), jnp.asarray(noise)),
         TS.addcdiv_stochastic_bits(tacc, torch.from_numpy(other),
                                    torch.from_numpy(denom), tn,
                                    value=float(np.float32(-3e-4)))),
    ]
    for ref, out in pairs:
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(out), _jnp_bits(ref))


def _leaves(seed=0):
    """Flat bf16 and fp32 leaves (sorted names: JAX's leaf order)."""
    rng = np.random.default_rng(seed)
    shapes = {"a_bf16": (3001,), "b_bf16": (64, 48), "c_f32": (96,)}
    params, grads = {}, {}
    for name, shape in shapes.items():
        p = 0.05 * rng.standard_normal(shape).astype(np.float32)
        g = 0.01 * rng.standard_normal(shape).astype(np.float32)
        if name.endswith("bf16"):
            p = np.asarray(jnp.asarray(p).astype(jnp.bfloat16), np.float32)
        params[name], grads[name] = p, g
    return params, grads


def _jax_tree(arrays):
    """{name: {"bias": leaf}}: the key mapping leaves "bias" leaves
    untransposed, so the port's name is "<name>.bias"."""
    return {k: {"bias": jnp.asarray(v).astype(jnp.bfloat16)
                if k.endswith("bf16") else jnp.asarray(v)}
            for k, v in arrays.items()}


def _jax_seeds(state, n_leaves):
    """The two uint32 seeds JAX's per-leaf "hash" update draws per leaf."""
    _, step_key = jax.random.split(state.key)
    keys = jax.random.split(step_key, n_leaves)
    return torch.tensor(np.stack([np.asarray(jax.random.bits(
        k, (2,), jnp.uint32)) for k in keys]).astype(np.int64))


def test_adamw_chain_bit_exact_vs_jax_hash():
    """Three steps of JAX ``adamw_bf16(noise="hash")`` and the port's
    optimizer from the same state, with JAX's per-leaf seeds and a weight
    decay large enough that the batched decay fires: bf16 p (after the
    delta round trip), m, v and shift equal bit for bit."""
    kw = dict(lr=1e-3, weight_decay=2.0)
    jopt = jax_adamw_bf16(**kw, noise="hash")
    params_np, grads_np = _leaves()
    jparams = _jax_tree(params_np)
    jstate = jopt.init(jparams)
    port = AdamWBF16(lr=kw["lr"], weight_decay=kw["weight_decay"])
    tstate = from_jax_opt_state(jax.tree_util.tree_map(
        np.asarray, jstate._replace(key=None)))
    tparams = {f"{k}.bias": _bf16(v) if k.endswith("bf16")
               else torch.from_numpy(v) for k, v in params_np.items()}
    fired = 0
    update = jax.jit(jopt.update)
    for step in range(3):
        scale = 1.0 + step
        jgrads = {k: {"bias": jnp.asarray(v * scale)}
                  for k, v in grads_np.items()}
        tgrads = {f"{k}.bias": torch.from_numpy(v * scale)
                  for k, v in grads_np.items()}
        seeds = _jax_seeds(jstate, len(jparams))
        before = {k: float(v) for k, v in tstate.accumulated_decay.items()}
        updates, jstate = update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(tgrads, tstate, tparams, seeds=seeds)
        with torch.no_grad():
            for k, p in tparams.items():
                p.add_(deltas[k])
        fired += sum(float(tstate.accumulated_decay[k]) == 0.0 < before[k]
                     for k in before)
        for name in params_np:
            k, jp = f"{name}.bias", jparams[name]["bias"]
            if name.endswith("f32"):
                np.testing.assert_allclose(_np(tparams[k]), np.asarray(jp),
                                           rtol=1e-6, atol=0)
                continue
            for got, ref in ((tparams[k], jp),
                             (tstate.exp_avg[k], jstate.exp_avg[name]["bias"]),
                             (tstate.exp_avg_sq[k],
                              jstate.exp_avg_sq[name]["bias"]),
                             (tstate.shift[k], jstate.shift[name]["bias"])):
                np.testing.assert_array_equal(_bits(got), _jnp_bits(ref))
            assert float(tstate.accumulated_decay[k]) == float(
                jstate.accumulated_decay[name]["bias"])
    assert fired > 0  # the decay branch ran


def test_lr_eff_equals_jax():
    """lr * sqrt(1 - beta2**t) in fp32: the one scalar XLA's pow could
    round differently."""
    port = AdamWBF16(lr=1e-6)
    for step in (1, 2, 3, 10, 100, 1000):
        ref = np.float32(1e-6) * jnp.sqrt(
            1.0 - 0.999 ** jnp.asarray(step, jnp.float32))
        assert port.lr_eff(step) == float(ref)


def _pallas(p, g, m, v, s, lr_eff, decay):
    with pltpu.force_tpu_interpret_mode():
        return JF.fused_adamw_update(p, g, m, v, s, lr_eff=jnp.float32(lr_eff),
                                     decay_amt=jnp.float32(decay),
                                     seed=jnp.int32(3))


def _fused_inputs(shape, seed):
    k = jax.random.split(jax.random.key(seed), 5)
    return ((0.05 * jax.random.normal(k[0], shape)).astype(jnp.bfloat16),
            (0.01 * jax.random.normal(k[1], shape)).astype(jnp.bfloat16),
            (0.01 * jax.random.normal(k[2], shape)).astype(jnp.bfloat16),
            (1e-4 * jax.random.uniform(k[3], shape)).astype(jnp.bfloat16),
            (1e-3 * jax.random.normal(k[4], shape)).astype(jnp.bfloat16))


@pytest.mark.parametrize("shape,lr_eff,decay", [
    ((2048,), 1e-3, 0.0),          # the zero-noise chain
    ((2048,), 1e-3, 0.007),        # decay fires
    ((3, 5, 7, 11), 1e-3, 0.0),    # not a multiple of the 1024-lane rows
])
def test_zero_plane_chain_bit_exact_vs_pallas(shape, lr_eff, decay):
    """The Pallas kernel in interpret mode draws zero noise; the port's
    chain on zero planes and bf16-representable grads matches it bit for
    bit in all four outputs."""
    p, g, m, v, s = _fused_inputs(shape, 0 if decay == 0.0 else 3)
    pf, mf, vf, sf = _pallas(p, g, m, v, s, lr_eff, decay)
    t = [_bf16(np.asarray(x, np.float32)) for x in (p, g, m, v, s)]
    zero = torch.zeros(shape, dtype=torch.int64)
    delta, mt, vt, st = TF.adamw_bf16_chain(
        t[0], t[1].float(), *t[2:], float(np.float32(lr_eff)),
        float(np.float32(decay)), [zero] * 4)
    ref_delta = (jnp.asarray(pf, jnp.float32)
                 - jnp.asarray(p, jnp.float32)).astype(jnp.bfloat16)
    for got, ref in ((delta, ref_delta), (mt, mf), (vt, vf), (st, sf)):
        np.testing.assert_array_equal(_bits(got), _jnp_bits(ref))


def test_exactly_representable_sums_round_deterministically():
    """SR(x) == x for bf16-representable x whatever the noise."""
    n = 512
    z = torch.zeros(n, dtype=torch.bfloat16)
    v = torch.full((n,), 1e-2, dtype=torch.bfloat16)
    shift = torch.full((n,), 0.5, dtype=torch.bfloat16)
    for seed in range(8):
        delta, _, _, _ = TF.fused_adamw_reference(z, z.float(), z, v, shift,
                                                  0.0, 0.0, seed, seed + 1)
        assert (delta.float() == 0.5).all()


def test_fp32_leaf_matches_f32_delta():
    rng = np.random.default_rng(4)
    p, g = (rng.standard_normal(257).astype(np.float32) for _ in range(2))
    m, v = 0.1 * g, 0.001 * g * g
    port = AdamWBF16(lr=1e-3, weight_decay=0.01)
    delta, m2, v2 = port._f32_leaf(*map(torch.from_numpy, (p, g, m, v)),
                                   port.lr_eff(3))
    b1, b2, lr, wd, eps = 0.9, 0.999, 1e-3, 0.01, 1e-8
    mr = m * np.float32(b1) + np.float32(1 - b1) * g
    vr = v * np.float32(b2) + np.float32(1 - b2) * g * g
    dc = np.sqrt(np.float32(1) - np.float32(b2) ** 3)
    ref = (-np.float32(lr) * dc) * mr / (np.sqrt(vr) + np.float32(eps)) \
        - np.float32(wd * lr) * p
    np.testing.assert_allclose(delta.numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(m2.numpy(), mr, rtol=1e-6)
    np.testing.assert_allclose(v2.numpy(), vr, rtol=1e-6)


def test_channels_last_leaf_noise_follows_memory_order():
    """A channels-last leaf gets the noise of its memory position, so the
    plain chain on it equals the chain on its memory-order flat view."""
    gen = torch.Generator().manual_seed(2)
    shape = (8, 4, 3, 3)
    p, g, m = (0.05 * torch.randn(shape, generator=gen) for _ in range(3))
    p = p.bfloat16().contiguous(memory_format=torch.channels_last)
    g = g.contiguous(memory_format=torch.channels_last)
    m = m.bfloat16().contiguous(memory_format=torch.channels_last)
    v = (m.float() ** 2).bfloat16()
    s = torch.zeros_like(p)
    out = TF.fused_adamw_reference(p, g, m, v, s, 1e-3, 0.0, 5, 6)
    flat = TF.fused_adamw_reference(
        *(TF.memory_order(x) for x in (p, g, m, v, s)), 1e-3, 0.0, 5, 6)
    for a, b in zip(out, flat):
        assert a.stride() == p.stride()
        assert torch.equal(TF.memory_order(a), b)


@pytest.mark.parametrize("section,key,value", [
    ("optimizer", "optimizer_type", "soap"),
    ("optimizer", "moments_8bit", True),
    ("optimizer", "shift_host", True),
    ("training", "ema_decay", 0.999),
    ("tpu", "sr_noise", "rbg"),
    ("tpu", "flat_optimizer", "on"),
])
def test_make_optimizer_refuses_what_is_not_ported(section, key, value):
    cfg = Config()
    setattr(getattr(cfg, section), key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(cfg)


def test_make_optimizer_defaults():
    opt = make_optimizer(Config())
    assert (opt.lr, opt.beta1, opt.beta2, opt.eps, opt.weight_decay) == (
        1e-6, 0.9, 0.999, 1e-8, 0.01)
    with pytest.raises(ValueError, match="Unsupported"):
        cfg = Config()
        cfg.optimizer.optimizer_type = "sgd"
        make_optimizer(cfg)
