"""PyTorch port: int8 moments, weight EMA, schedule-free AdamW and SOAP
against the JAX package.

* ``ops/quantize.py``: codes and scales against JAX's jitted functions on
  arrays spanning 10 decades with zeros, +-inf and NaN.  XLA's CPU ``exp``
  and ``log`` are not torch's; a code or a bf16 value that moves because
  of it is counted and may differ by one step (none does on these
  arrays).  The half-step error bounds (3.69% unsigned, 7.58% signed) and
  the confinement of non-finite elements.
* ``adamw_bf16(moments="int8", noise="hash")``: 5 steps from the same
  state with JAX's seeds: parameters, codes, scales and shift, with the
  same count of moved codes.
* schedule-free: 5 steps, warmup 3, Kahan on and off, ``correct_bias`` on
  and off, fp32 and bf16 leaves: fp32 state at rtol 1e-6 / atol 1e-7, bf16
  parameters within one bf16 ulp, the eval parameters likewise.
* EMA over ``adamw_bf16`` (hash) and ``adamw``: 5 steps, the shadow at
  rtol 1e-6, the warmup ramp, ``ema_eval_params``.
* SOAP: eigenvectors are unique only up to sign (and rotation inside a
  degenerate eigenspace), and LAPACK in JAX and in torch may pick
  differently, so: GG at rtol 1e-6 every step; after the install step Q
  orthonormal and Q^T GG Q diagonal, eigenvalues descending; each Adam
  step, QR refreshes included, from a carried-across JAX state (Q too):
  exp_avg and exp_avg_sq at rtol 1e-5 / atol 1e-6, the delta at rtol 1e-5
  and 1e-3 of its max (a projected entry formed by cancellation has a
  large relative rounding error, and m_proj / sqrt(v) weights it O(1));
  a 4-step run on leaves whose step-1 GG has
  full rank, on what does not depend on the signs (delta, exp_avg, the
  sorted exp_avg_sq) at rtol 1e-4 of each element and of the array's
  max (each side's basis carries its own LAPACK rounding, amplified by
  the eigen-gaps).  GG's sums run in another order in XLA's dot: rtol
  1e-6 of each element and of the matrix's max.  The [4, 8] leaf's step-1 GG over its
  8-axis has rank 4, so its eigenvectors are not unique: it gets the
  invariant checks only.
* every new state round-trips through the train-state checkpoint.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_training_improvements_tpu.ops import quantize as JQ
from sdxl_training_improvements_tpu.training.optimizers import (
    adamw_bf16 as jax_adamw_bf16, adamw_schedule_free_kahan as jax_sf,
    schedule_free_eval_params as jax_sf_eval, soap as jax_soap,
    with_ema as jax_with_ema, ema_eval_params as jax_ema_eval)
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state)
from sdxl_training_improvements_tpu_torch.ops import quantize as TQ
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    SOAP, AdamW, AdamWBF16, AdamWScheduleFreeKahan, EMAState,
    ema_eval_params, schedule_free_eval_params, with_ema)
from sdxl_training_improvements_tpu_torch.training.optimizers.ema import (
    ema_factor)
from sdxl_training_improvements_tpu_torch.training.trainer import TrainState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: with six
    xdist workers each spinning a pool the size of the host, the tiny
    model's steps ran ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x) -> np.ndarray:
    return _np(x).view(np.uint32)


def _bf16_ulps(a, b) -> int:
    """Largest distance in bf16 steps between two bf16 arrays."""
    ia = (_np(a).view(np.int32) >> 16).astype(np.int64)
    ib = (_np(b).view(np.int32) >> 16).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


# ------------------------------------------------------------- quantize
def _decades(n=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-10, 0, n)
         ).astype(np.float32)
    x[:6] = [0.0, np.inf, -np.inf, np.nan, -0.0, 0.0]
    x[6:64] = 0.0
    return x


@pytest.mark.parametrize("signed", [True, False])
def test_quantize_codes_and_scales_match_jax(signed):
    x = _decades()
    if not signed:
        x = np.abs(x)
    ref = jax.jit(lambda a: JQ.quantize_8bit(a, signed=signed))(
        jnp.asarray(x))
    got = TQ.quantize_8bit(torch.from_numpy(x), signed=signed)
    assert got["q"].dtype == torch.uint8 and got["s"].shape == ()
    assert float(got["s"]) == float(ref["s"])
    steps = np.abs(got["q"].numpy().astype(int)
                   - np.asarray(ref["q"]).astype(int))
    moved = int((steps != 0).sum())
    assert steps.max() <= 1 and moved <= x.size // 10000, moved
    # decode: every code of the table, scaled, to bf16
    codes = np.arange(256, dtype=np.uint8)
    qs = {"q": codes, "s": np.float32(ref["s"])}
    ref_d = jax.jit(lambda q: JQ.dequantize_8bit(q, signed=signed))(
        {"q": jnp.asarray(codes), "s": jnp.asarray(qs["s"])})
    got_d = TQ.dequantize_8bit({"q": torch.from_numpy(codes),
                                "s": torch.tensor(qs["s"])}, signed=signed)
    assert got_d.dtype == torch.bfloat16
    assert _bf16_ulps(got_d, ref_d) <= 1


# half a log step: 8 decades over 254 unsigned steps (3.69%), 126 negative
# steps (7.58%; the positive side's 127 give 7.52%)
@pytest.mark.parametrize("signed,half_step", [
    (False, 10 ** (8 / 254 / 2) - 1), (True, 10 ** (8 / 126 / 2) - 1)])
def test_quantize_error_bound(signed, half_step):
    x = _decades(seed=1)[64:]
    if not signed:
        x = np.abs(x)
    qs = TQ.quantize_8bit(torch.from_numpy(x), signed=signed)
    back = TQ.dequantize_8bit(qs, signed=signed, dtype=torch.float32).numpy()
    scale = float(qs["s"])
    inside = np.abs(x) >= scale * 1e-8  # the code's 8 decades
    rel = np.abs(back[inside] - x[inside]) / np.abs(x[inside])
    assert rel.max() <= half_step
    assert (np.sign(back[inside]) == np.sign(x[inside])).all()
    # below the range: the zero code
    assert (back[np.abs(x) < scale * 0.5e-8] == 0).all()


def test_quantize_non_finite_confined():
    x = np.linspace(-2.0, 3.0, 101).astype(np.float32)
    x[[5, 50, 90]] = [np.inf, np.nan, -np.inf]
    for signed in (True, False):
        xs = x if signed else np.abs(x)
        qs = TQ.quantize_8bit(torch.from_numpy(xs), signed=signed)
        finite = np.isfinite(xs)
        assert float(qs["s"]) == np.abs(xs[finite]).max()
        back = TQ.dequantize_8bit(qs, signed=signed,
                                  dtype=torch.float32).numpy()
        assert np.isfinite(back).all()
        # the top code of its sign: +-absmax, up to the fp32 rounding of
        # the code's exponent (JAX's decode gives the same value)
        top, s = 255, float(qs["s"])
        assert np.abs(back).max() <= s
        assert qs["q"][50] == top and back[50] == pytest.approx(s, rel=1e-6)
        if signed:
            assert qs["q"][5] == top and qs["q"][90] == 0
            assert back[90] == pytest.approx(-s, rel=1e-6)
    z = TQ.quantized_zeros(torch.empty(3, 4), signed=True)
    assert (TQ.dequantize_8bit(z) == 0).all() and float(z["s"]) == 1.0
    zq = TQ.quantize_8bit(torch.zeros(7), signed=False)
    assert float(zq["s"]) == 1.0 and (zq["q"] == 0).all()


def test_code_table_is_the_decoder():
    for signed in (True, False):
        got = TQ.dequantize_8bit({"q": torch.arange(256).to(torch.uint8),
                                  "s": torch.tensor(1.0)}, signed=signed,
                                 dtype=torch.float32).numpy()
        # the fp32 exp of arguments up to |18| (8 decades): a few ulps
        np.testing.assert_allclose(got, JQ._code_np(signed), rtol=5e-6)


# ------------------------------------------------------- shared leaves
def _leaves(seed=0, shapes=None):
    """Flat bf16 and fp32 leaves (sorted names: JAX's leaf order)."""
    rng = np.random.default_rng(seed)
    shapes = shapes or {"a_bf16": (3001,), "b_bf16": (64, 48),
                        "c_f32": (96,)}
    params, grads = {}, {}
    for name, shape in shapes.items():
        p = 0.05 * rng.standard_normal(shape).astype(np.float32)
        g = 0.01 * rng.standard_normal(shape).astype(np.float32)
        if name.endswith("bf16"):
            p = np.asarray(jnp.asarray(p).astype(jnp.bfloat16), np.float32)
        params[name], grads[name] = p, g
    return params, grads


def _jax_tree(arrays, scale=None):
    """{name: {"bias": leaf}}: "bias" leaves map untransposed, so the
    port's name is "<name>.bias".  Parameters (``scale`` None) are bf16
    where the name says; gradients (``scale`` given) stay fp32."""
    if scale is not None:
        return {k: {"bias": jnp.asarray(v * scale)}
                for k, v in arrays.items()}
    return {k: {"bias": jnp.asarray(v).astype(jnp.bfloat16)
                if k.endswith("bf16") else jnp.asarray(v)}
            for k, v in arrays.items()}


def _port_tree(arrays, scale=1.0, grads=False):
    return {f"{k}.bias": torch.from_numpy(v * scale).bfloat16()
            if k.endswith("bf16") and not grads
            else torch.from_numpy(v * scale) for k, v in arrays.items()}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_seeds(key, n_leaves):
    """The two uint32 seeds JAX's per-leaf "hash" update draws per leaf."""
    _, step_key = jax.random.split(key)
    keys = jax.random.split(step_key, n_leaves)
    return torch.tensor(np.stack([np.asarray(jax.random.bits(
        k, (2,), jnp.uint32)) for k in keys]).astype(np.int64))


def _apply(tparams, deltas):
    with torch.no_grad():
        for k, p in tparams.items():
            p.add_(deltas[k])


# ----------------------------------------------------------- int8 AdamW
def test_int8_moments_adamw_bf16_matches_jax_hash():
    kw = dict(lr=1e-3, weight_decay=2.0)
    jopt = jax_adamw_bf16(**kw, noise="hash", moments="int8")
    params_np, grads_np = _leaves()
    jparams = _jax_tree(params_np)
    jstate = jopt.init(jparams)
    port = AdamWBF16(lr=kw["lr"], weight_decay=kw["weight_decay"],
                     moments="int8", noise="hash")
    tparams = _port_tree(params_np)
    tstate = from_jax_opt_state(_host(jstate._replace(key=None)))
    fresh = port.init(tparams)
    for k, m in fresh.exp_avg.items():  # the port's own init is JAX's
        ref = tstate.exp_avg[k]
        if isinstance(m, dict):
            assert torch.equal(m["q"], ref["q"]) and float(m["s"]) == 1.0
    update = jax.jit(jopt.update)
    moved = 0
    for step in range(5):
        scale = 1.0 + step
        seeds = _jax_seeds(jstate.key, len(jparams))
        updates, jstate = update(_jax_tree(grads_np, scale), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(_port_tree(grads_np, scale, True),
                                     tstate, tparams, seeds=seeds)
        _apply(tparams, deltas)
        for name in params_np:
            k, jp = f"{name}.bias", jparams[name]["bias"]
            if name.endswith("f32"):
                np.testing.assert_allclose(_np(tparams[k]), np.asarray(jp),
                                           rtol=1e-6, atol=0)
                continue
            np.testing.assert_array_equal(_bits(tparams[k]), _bits(jp))
            np.testing.assert_array_equal(_bits(tstate.shift[k]),
                                          _bits(jstate.shift[name]["bias"]))
            for got, ref in ((tstate.exp_avg[k], jstate.exp_avg[name]["bias"]),
                             (tstate.exp_avg_sq[k],
                              jstate.exp_avg_sq[name]["bias"])):
                assert float(got["s"]) == float(ref["s"])
                d = np.abs(got["q"].numpy().astype(int)
                           - np.asarray(ref["q"]).astype(int))
                assert d.max() <= 1
                moved += int((d != 0).sum())
    assert moved == 0, f"{moved} codes moved by one step"


def test_int8_state_is_4_bytes_a_bf16_parameter():
    p = {"w": torch.zeros(64, 48, dtype=torch.bfloat16),
         "n": torch.zeros(8, dtype=torch.float32)}
    st = AdamWBF16(moments="int8").init(p)
    nbytes = sum(t.numel() * t.element_size()
                 for d in (st.exp_avg["w"], st.exp_avg_sq["w"])
                 for t in d.values()) + st.shift["w"].numel() * 2
    assert nbytes == 4 * p["w"].numel() + 8  # + the two fp32 scales
    assert st.exp_avg["n"].dtype == torch.float32  # fp32 leaves exact
    with pytest.raises(ValueError, match="moments"):
        AdamWBF16(moments="fp8")


# -------------------------------------------------------- schedule-free
@pytest.mark.parametrize("kahan", [True, False])
@pytest.mark.parametrize("correct_bias", [True, False])
def test_schedule_free_matches_jax(kahan, correct_bias):
    """Each of 5 steps from JAX's state and parameters (carried across):
    a bf16 delta rounds an fp32 value that XLA's fused arithmetic and
    torch's may leave a few ulps apart, so a bf16 parameter may land one
    step away, and the next step would start apart."""
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1,
              warmup_steps=3, kahan_sum=kahan, correct_bias=correct_bias)
    jopt = jax_sf(**kw)
    port = AdamWScheduleFreeKahan(**kw)
    params_np, grads_np = _leaves(seed=2)
    jparams = _jax_tree(params_np)
    jstate = jopt.init(jparams)
    fresh = port.init(_port_tree(params_np))
    update = jax.jit(jopt.update)
    for step in range(5):
        scale = 1.0 + step
        tparams = {f"{k}.bias": torch.tensor(np.asarray(
            v["bias"], np.float32)).to(_port_tree(params_np)[f"{k}.bias"]
                                       .dtype)
            for k, v in jparams.items()}
        tstate = fresh if step == 0 else from_jax_opt_state(_host(jstate))
        updates, jstate = update(_jax_tree(grads_np, scale), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(_port_tree(grads_np, scale, True),
                                     tstate, tparams)
        _apply(tparams, deltas)
        assert tstate.step == int(jstate.step) == step + 1
        for name in params_np:
            k = f"{name}.bias"
            for got, ref in ((tstate.z[k], jstate.z[name]["bias"]),
                             (tstate.exp_avg_sq[k],
                              jstate.exp_avg_sq[name]["bias"])):
                np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6,
                                           atol=1e-7)
            # the compensation holds the write's rounding error, a
            # difference of near-equal fp32 values: held to a few ulps of
            # the parameter, and where the bf16 parameter landed one step
            # away it differs by that step
            pj = _np(jparams[name]["bias"])
            moved = (_np(tparams[k]) - pj) if kahan else 0.0
            err = np.abs(_np(tstate.kahan_comp[k]) + moved
                         - _np(jstate.kahan_comp[name]["bias"]))
            assert (err <= 1e-7 + 4 * np.spacing(np.abs(pj))).all()
            jp = jparams[name]["bias"]
            if name.endswith("bf16"):
                assert tparams[k].dtype == torch.bfloat16
                assert _bf16_ulps(tparams[k], jp) <= 1
            else:
                np.testing.assert_allclose(_np(tparams[k]), _np(jp),
                                           rtol=1e-6, atol=1e-7)
        got = schedule_free_eval_params(tstate, tparams)
        ref = jax_sf_eval(jstate, jparams)
        for name in params_np:
            k, r = f"{name}.bias", ref[name]["bias"]
            if name.endswith("bf16"):
                assert _bf16_ulps(got[k], r) <= 1
            else:
                np.testing.assert_allclose(_np(got[k]), _np(r), rtol=1e-6,
                                           atol=1e-7)


# ------------------------------------------------------------------ EMA
@pytest.mark.parametrize("inner", ["adamw_bf16", "adamw"])
def test_ema_matches_jax(inner):
    decay = 0.99
    params_np, grads_np = _leaves(seed=3)
    if inner == "adamw_bf16":
        jinner = jax_adamw_bf16(lr=1e-3, weight_decay=0.5, noise="hash")
        tinner = AdamWBF16(lr=1e-3, weight_decay=0.5, noise="hash")
    else:
        params_np = {k.replace("bf16", "f32x"): v
                     for k, v in params_np.items()}
        grads_np = {k.replace("bf16", "f32x"): v
                    for k, v in grads_np.items()}
        jinner = optax.adamw(learning_rate=1e-3, weight_decay=0.5)
        tinner = AdamW(lr=1e-3, weight_decay=0.5)
    jopt, port = jax_with_ema(jinner, decay=decay), with_ema(tinner, decay)
    jparams = _jax_tree(params_np)
    jstate = jopt.init(jparams)
    tparams = _port_tree(params_np)
    tstate = port.init(tparams)
    if inner == "adamw_bf16":
        tstate.inner = from_jax_opt_state(_host(jstate.inner._replace(
            key=None)))
    for k, e in tstate.ema.items():  # a copy, never the parameter
        assert e.dtype == torch.float32
        assert e.data_ptr() != tparams[k].data_ptr()
    update = jax.jit(jopt.update)
    for step in range(5):
        scale = 1.0 + step
        kw = {}
        if inner == "adamw_bf16":
            kw["seeds"] = _jax_seeds(jstate.inner.key, len(jparams))
        updates, jstate = update(_jax_tree(grads_np, scale), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(_port_tree(grads_np, scale, True),
                                     tstate, tparams, **kw)
        _apply(tparams, deltas)
        assert tstate.count == int(jstate.count) == step + 1
        for name in params_np:
            k = f"{name}.bias"
            # atol: a few fp32 ulps of elements near zero
            np.testing.assert_allclose(_np(tstate.ema[k]),
                                       _np(jstate.ema[name]["bias"]),
                                       rtol=1e-6, atol=1e-9)
    got = ema_eval_params(tstate, tparams)
    ref = jax_ema_eval(jstate, jparams)
    for name in params_np:
        k = f"{name}.bias"
        assert got[k].dtype == tparams[k].dtype
        np.testing.assert_allclose(_np(got[k]), _np(ref[name]["bias"]),
                                   rtol=1e-6, atol=1e-9)
    assert ema_eval_params(tstate.inner, tparams) is tparams


def test_ema_warmup_ramp_is_jax():
    for count in (1, 2, 5, 9, 100, 10 ** 5):
        ref = jnp.minimum(0.9999, (1.0 + jnp.int32(count))
                          / (10.0 + jnp.int32(count))).astype(jnp.float32)
        assert ema_factor(0.9999, count) == float(ref)
    assert ema_factor(0.9999, 3, warmup=False) == float(np.float32(0.9999))


# ----------------------------------------------------------------- SOAP
SOAP_KW = dict(lr=3e-3, betas=(0.95, 0.95), shampoo_beta=-1, eps=1e-8,
               weight_decay=0.01, precondition_frequency=2,
               max_precond_dim=32, merge_dims=True, precondition_1d=False,
               normalize_grads=False, correct_bias=True)
# flax kernels (JAX layout) and a bias, each GG of full rank from step 1:
# [16, 16]; [40, 8] with its 40-axis skipped; a conv [2, 2, 4, 16]
# merged to (16, 16)
SOAP_LEAVES = {"full": (16, 16), "skip": (40, 8), "conv": (2, 2, 4, 16),
               "bias": (24,)}
# rank 4 on its 8-axis: that basis is not unique (invariants only)
RANK_DEFICIENT = {"rankdef": (4, 8)}


def _soap_trees(leaves, seed, n_steps):
    rng = np.random.default_rng(seed)
    params = {k: 0.1 * rng.standard_normal(s).astype(np.float32)
              for k, s in leaves.items()}
    grads = [{k: 0.01 * rng.standard_normal(s).astype(np.float32)
              for k, s in leaves.items()} for _ in range(n_steps)]
    return params, grads


def _jax_kernel_tree(arrays):
    return {k: {"bias" if v.ndim == 1 else "kernel": jnp.asarray(v)}
            for k, v in arrays.items()}


def _port_weights(arrays):
    out = {}
    for k, v in arrays.items():
        if v.ndim == 1:
            out[f"{k}.bias"] = torch.from_numpy(v.copy())
        elif v.ndim == 2:
            out[f"{k}.weight"] = torch.from_numpy(v.T.copy())
        else:
            out[f"{k}.weight"] = torch.from_numpy(
                v.transpose(3, 2, 0, 1).copy())
    return out


def _jleaf(tree, name):
    (v,) = tree[name].values()
    return v


def _port_name(name, arr):
    return f"{name}.{'bias' if np.ndim(arr) == 1 else 'weight'}"


def _check_invariants(q, gg):
    for qm, g in zip(q, gg):
        if qm.shape[0] == 0:
            continue
        eye = torch.eye(qm.shape[0])
        torch.testing.assert_close(qm.T @ qm, eye, rtol=0, atol=2e-5)
        d = qm.T @ g @ qm
        off = d - torch.diag(torch.diagonal(d))
        assert off.abs().max() <= 1e-4 * d.abs().max()
        ev = torch.diagonal(d)
        assert (ev[:-1] >= ev[1:] - 1e-6 * ev.abs().max()).all()


def test_soap_install_and_adam_steps_from_carried_state():
    leaves = dict(SOAP_LEAVES, **RANK_DEFICIENT)
    params, grads = _soap_trees(leaves, seed=5, n_steps=5)
    jopt, port = jax_soap(**SOAP_KW), SOAP(**SOAP_KW)
    jparams = _jax_kernel_tree(params)
    jstate = jopt.init(jparams)
    tparams = _port_weights(params)
    tstate = port.init(tparams)
    for n, arr in params.items():  # shapes, placeholders: JAX's
        k = _port_name(n, arr)
        assert tuple(tstate.exp_avg_sq[k].shape) == \
            _jleaf(jstate.exp_avg_sq, n).shape
        assert [tuple(m.shape) for m in tstate.gg[k]] == \
            [m.shape for m in _jleaf(jstate.gg, n)]
    update = jax.jit(jopt.update)
    for step, g in enumerate(grads):
        if step > 0:  # carry JAX's state across, Q included
            tstate = from_jax_opt_state(_host(jstate))
        updates, jnext = update(_jax_kernel_tree(g), jstate, jparams)
        deltas, tstate = port.update(_port_weights(g), tstate, tparams)
        for n, arr in params.items():
            k = _port_name(n, arr)
            for a, b in zip(tstate.gg[k], _jleaf(jnext.gg, n)):
                # XLA's dot and torch's sum in another order: a few ulps,
                # held at 1e-6 of each element and of the matrix's max
                np.testing.assert_allclose(
                    _np(a), _np(b), rtol=1e-6,
                    atol=1e-6 * float(np.abs(_np(b)).max(initial=0)))
            if step == 0:
                assert not deltas[k].any()
                _check_invariants(tstate.q[k], tstate.gg[k])
                continue
            if n in RANK_DEFICIENT:
                continue
            ref = _np(_port_weights({n: np.asarray(_jleaf(updates, n))})[k])
            # a projected entry formed by cancellation carries a large
            # relative rounding error and m_proj / sqrt(v) gives it an O(1)
            # weight in the step: the delta is held at rtol 1e-5 and 1e-3
            # of its max (the moments at rtol 1e-5 / atol 1e-6)
            np.testing.assert_allclose(
                _np(deltas[k]), ref, rtol=1e-5,
                atol=max(1e-6, 1e-3 * float(np.abs(ref).max())))
            for a, b in ((tstate.exp_avg[k], _jleaf(jnext.exp_avg, n)),
                         (tstate.exp_avg_sq[k],
                          _jleaf(jnext.exp_avg_sq, n))):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                           atol=1e-6)
            if (step + 1) % SOAP_KW["precondition_frequency"] == 0:
                # the QR refresh from the same Q: the same basis
                for a, b in zip(tstate.q[k], _jleaf(jnext.q, n)):
                    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4,
                                               atol=1e-5)
        jparams = optax.apply_updates(jparams, updates)
        jstate = jnext


def test_soap_four_steps_agree_up_to_eigenvector_signs():
    params, grads = _soap_trees(SOAP_LEAVES, seed=6, n_steps=4)
    jopt, port = jax_soap(**SOAP_KW), SOAP(**SOAP_KW)
    jparams = _jax_kernel_tree(params)
    jstate = jopt.init(jparams)
    tparams = _port_weights(params)
    tstate = port.init(tparams)
    update = jax.jit(jopt.update)
    for g in grads:
        updates, jstate = update(_jax_kernel_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(_port_weights(g), tstate, tparams)
        _apply(tparams, deltas)
        for n, arr in params.items():
            k = _port_name(n, arr)
            # each basis is LAPACK's own, so rounding moves with the
            # eigen-gaps: 1e-4 of each element and of the array's max
            for got, ref in (
                    (_np(deltas[k]),
                     _np(_port_weights({n: np.asarray(
                         _jleaf(updates, n))})[k])),
                    (_np(tstate.exp_avg[k]), _np(_jleaf(jstate.exp_avg, n))),
                    (np.sort(_np(tstate.exp_avg_sq[k]).ravel()),
                     np.sort(_np(_jleaf(jstate.exp_avg_sq, n)).ravel()))):
                np.testing.assert_allclose(
                    got, ref, rtol=1e-4,
                    atol=1e-4 * float(np.abs(ref).max(initial=0)))
    assert tstate.step == 4


def test_soap_eigh_retries_in_fp64(monkeypatch):
    """An fp32 eigh that does not converge is solved again in fp64 (the
    reference's retry); the basis is still orthonormal and descending."""
    eigh = torch.linalg.eigh

    def fp32_fails(m, *a, **kw):
        if m.dtype == torch.float32:
            raise torch.linalg.LinAlgError("did not converge")
        return eigh(m, *a, **kw)

    monkeypatch.setattr(torch.linalg, "eigh", fp32_fails)
    params, grads = _soap_trees({"full": (16, 16)}, seed=8, n_steps=1)
    port = SOAP(**SOAP_KW)
    tparams = _port_weights(params)
    state = port.init(tparams)
    _, state = port.update(_port_weights(grads[0]), state, tparams)
    assert port.eigh_retries == 2
    for q in state.q["full.weight"]:
        assert q.dtype == torch.float32
    _check_invariants(state.q["full.weight"], state.gg["full.weight"])


# ---------------------------------------------------- checkpoint round trip
def _states():
    """(label, optimizer, params) for every new optimizer state."""
    bf = {"a.weight": torch.randn(6, 5).bfloat16(),
          "b.weight": torch.randn(4, 3, 3, 3).bfloat16().contiguous(
              memory_format=torch.channels_last),
          "n.bias": torch.randn(7)}
    f32 = {k: v.float() for k, v in bf.items()}
    big = dict(f32, **{"w.weight": torch.randn(40, 3)})
    return [("ema_int8", with_ema(AdamWBF16(moments="int8"), 0.99), bf),
            ("schedule_free", AdamWScheduleFreeKahan(lr=1e-2), bf),
            ("soap", SOAP(max_precond_dim=32, merge_dims=True,
                          precondition_frequency=2), big),
            ("ema_soap", with_ema(SOAP(max_precond_dim=32), 0.9), f32)]


@pytest.mark.parametrize("label", ["ema_int8", "schedule_free", "soap",
                                   "ema_soap"])
def test_new_states_round_trip_through_the_checkpoint(label, tmp_path):
    (_, opt, params), = [s for s in _states() if s[0] == label]
    gen = torch.Generator().manual_seed(0)
    state = TrainState(step=0, params=params, opt_state=opt.init(params),
                       generator=gen)
    for _ in range(3):
        grads = {k: torch.randn(v.shape) for k, v in params.items()}
        deltas, state.opt_state = opt.update(grads, state.opt_state,
                                             state.params)
        _apply(state.params, deltas)
        state.step += 1
    C.save_train_state(tmp_path, state)
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    template = TrainState(step=0, params=fresh, opt_state=opt.init(fresh),
                          generator=torch.Generator())
    got = C.restore_train_state(tmp_path, template)
    ref_t, ref_m = C.flatten_train_state(state)
    got_t, got_m = C.flatten_train_state(got)
    assert got_m == ref_m and set(got_t) == set(ref_t)
    for k in ref_t:
        assert got_t[k].dtype == ref_t[k].dtype
        assert torch.equal(got_t[k], ref_t[k]), k
    if label == "soap":  # a (0, 0) placeholder survived the writer
        assert got.opt_state.gg["w.weight"][1].shape == (0, 0) or \
            got.opt_state.gg["w.weight"][0].shape == (0, 0)
    if label.startswith("ema"):
        assert isinstance(got.opt_state, EMAState)
        assert got.opt_state.count == 3
