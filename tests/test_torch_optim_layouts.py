"""PyTorch port: the bf16 AdamW's flat, hybrid and stacked layouts and its
"rbg" noise against the JAX package's.

Three steps of JAX ``adamw_bf16(layout=...)`` and the port's from the same
state (``from_jax_opt_state``), with JAX's own seeds (hash) or planes
(rbg) handed in and a weight decay large enough that every unit's batched
decay fires: bf16 parameters (after the delta round trip), every state
buffer and every accumulated decay equal bit for bit; fp32 leaves (exact
AdamW) to rtol 1e-6.  The leaves are untransposed ``bias`` leaves, whose
memory order is JAX's row-major order, so the groups' buffers compare
directly.  Then the partitions follow the JAX tree's flatten order on the
tiny UNet (``flax_path`` inverts the key mapping), a state resumes
bit-equal under each layout and refuses another layout's checkpoint, and
``make_optimizer`` keeps JAX's refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu.training.optimizers import (
    adamw_bf16 as jax_adamw_bf16)
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models import weights as W
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state)
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    AdamWBF16, make_optimizer)
from sdxl_training_improvements_tpu_torch.training.optimizers.adamw_bf16 \
    import flax_order
from sdxl_training_improvements_tpu_torch.training.trainer import TrainState

# name -> shape; bf16 unless it ends in f32.  Repeated shapes feed the
# stacked layout, sizes on both sides of HYBRID feed the hybrid one.
SHAPES = {"a": (300,), "b": (64, 48), "c": (300,), "d": (8, 9, 10),
          "e": (1500,), "f": (64, 48), "g": (300,), "h": (97,),
          "i_f32": (96,), "j": (1500,), "k_f32": (31,)}
HYBRID = 600
CASES = {"flat": dict(layout="flat", flat_groups=3),
         "flat_rbg": dict(layout="flat", flat_groups=3, noise="rbg"),
         "hybrid": dict(layout="hybrid", hybrid_threshold=HYBRID),
         "stacked": dict(layout="stacked"),
         "per_leaf_rbg": dict(layout="per_leaf", noise="rbg")}
KW = dict(lr=1e-3, weight_decay=2.0)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    params, grads = {}, {}
    for name, shape in SHAPES.items():
        p = 0.05 * rng.standard_normal(shape).astype(np.float32)
        if not name.endswith("f32"):
            p = np.asarray(jnp.asarray(p).astype(jnp.bfloat16), np.float32)
        params[name] = p
        grads[name] = 0.01 * rng.standard_normal(shape).astype(np.float32)
    return params, grads


def _bf16(name):
    return not name.endswith("f32")


def _jax_tree(arrays):
    return {k: {"bias": jnp.asarray(v).astype(jnp.bfloat16) if _bf16(k)
                else jnp.asarray(v)} for k, v in arrays.items()}


def _port_tree(arrays):
    return {f"{k}.bias": torch.from_numpy(v).bfloat16() if _bf16(k)
            else torch.from_numpy(v) for k, v in arrays.items()}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.uint32)
    return np.asarray(jnp.asarray(x, jnp.float32)).view(np.uint32)


def _draws(jstate, opt: AdamWBF16, tparams, case):
    """JAX's per-unit draws of the next step, in the port's unit order:
    (seeds [units, 2] or None, planes per unit or None)."""
    _, step_key = jax.random.split(jstate.key)
    if opt.layout == "per_leaf":
        keys = jax.random.split(step_key, len(tparams))
        shapes = [(name, SHAPES[name]) for name in sorted(SHAPES)]
    else:
        units, f32 = opt._units(tparams)
        n_keys = len(units) + (len(f32) if opt.layout == "flat" else 0)
        keys = jax.random.split(step_key, max(n_keys, 1))
        shapes = [(u.key, (sum(tparams[n].numel() for n in u.names),))
                  for u in units]
    if opt.noise == "hash":
        return torch.tensor(np.stack([np.asarray(jax.random.bits(
            keys[i], (2,), jnp.uint32)) for i in range(len(shapes))]
        ).astype(np.int64)), None
    planes = []
    for i, (name, shape) in enumerate(shapes):
        if name.endswith("f32"):
            planes.append(None)
            continue
        raw = np.asarray(jax.random.bits(keys[i], (2,) + tuple(shape),
                                         jnp.uint32))
        planes.append(torch.from_numpy(raw.reshape(2, -1).astype(np.int64)))
    return None, planes


def _state_key(opt, tparams, name):
    """The JAX state tree's key of a port state key."""
    if "." in name:
        if opt.layout == "per_leaf":
            return name.split(".")[0], "bias"
        return f"leaf_{flax_order(tparams).index(name)}", None
    return name, None


def _jax_state_value(tree, key):
    k, sub = key
    return tree[k][sub] if sub else tree[k]


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_bit_exact_vs_jax(case):
    kw = CASES[case]
    jopt = jax_adamw_bf16(**KW, **kw)
    port = AdamWBF16(**KW, **kw)
    params_np, grads_np = _arrays()
    jparams = _jax_tree(params_np)
    jstate = jopt.init(jparams)
    tparams = _port_tree(params_np)
    tstate = from_jax_opt_state(_host(jstate._replace(key=None)),
                                like=tparams, optimizer=port)
    fresh = port.init(tparams)
    assert set(fresh.exp_avg) == set(tstate.exp_avg)
    assert fresh.layout == tstate.layout == kw["layout"]
    for k, t in fresh.shift.items():
        assert t.shape == tstate.shift[k].shape, k
    update = jax.jit(jopt.update)
    fired = set()
    for step in range(3):
        scale = 1.0 + step
        jgrads = {k: {"bias": jnp.asarray(v * scale)}
                  for k, v in grads_np.items()}
        tgrads = {f"{k}.bias": torch.from_numpy(v * scale)
                  for k, v in grads_np.items()}
        seeds, planes = _draws(jstate, port, tparams, case)
        before = {k: v.clone() for k, v in tstate.accumulated_decay.items()}
        updates, jstate = update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(tgrads, tstate, tparams, seeds=seeds,
                                     planes=planes)
        with torch.no_grad():
            for k, p in tparams.items():
                p.add_(deltas[k])
        for k, acc in tstate.accumulated_decay.items():
            if bool(((acc == 0) & (before[k] > 0)).any()):
                fired.add(k)
        for name in params_np:
            got, ref = tparams[f"{name}.bias"], jparams[name]["bias"]
            if not _bf16(name):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(_bits(got), _bits(ref))
        for key, t in tstate.shift.items():
            jkey = _state_key(port, tparams, key)
            if t.dtype != torch.bfloat16:
                continue  # an fp32 leaf's unused shift
            for tree, jtree in ((tstate.exp_avg, jstate.exp_avg),
                                (tstate.exp_avg_sq, jstate.exp_avg_sq),
                                (tstate.shift, jstate.shift)):
                np.testing.assert_array_equal(
                    _bits(tree[key].reshape(-1)),
                    _bits(_jax_state_value(jtree, jkey)).reshape(-1),
                    err_msg=f"{case} step {step} {key}")
        for key, acc in tstate.accumulated_decay.items():
            ref = np.asarray(_jax_state_value(
                jstate.accumulated_decay, _state_key(port, tparams, key)))
            np.testing.assert_array_equal(acc.numpy().reshape(-1),
                                          ref.reshape(-1))
    bf16_units = {k for k, t in tstate.shift.items()
                  if t.dtype == torch.bfloat16}
    assert bf16_units <= fired, bf16_units - fired  # every decay fired


def test_partitions_follow_the_jax_flatten_order():
    """``flax_path`` inverts the key mapping on the tiny UNet's 330
    parameters, and sorting by it is JAX's leaf order; the flat layout
    then cuts the same groups as JAX's ``_partition_flat``."""
    cfg = JU.UNetConfig.tiny()
    jm = JU.SDXLUNet(config=cfg, dtype=jnp.bfloat16,
                     param_dtype=jnp.bfloat16)
    args = (jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
            jnp.zeros((1, 77, cfg.cross_attention_dim)),
            jnp.zeros((1, cfg.pooled_embed_dim)), jnp.zeros((1, 6)))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *args)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    port = {}
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        name, _ = W._leaf(keys, np.zeros((1,) * len(leaf.shape), np.float32))
        assert ("params",) + W.flax_path(name, len(leaf.shape)) == keys
        assert W.jax_shape(name, W._leaf(keys, np.zeros(
            leaf.shape, np.float32))[1].shape) == tuple(leaf.shape)
        dtype = torch.float32 if leaf.dtype == jnp.float32 else \
            torch.bfloat16
        port[name] = torch.zeros(W._leaf(keys, np.zeros(
            leaf.shape, np.float32))[1].shape, dtype=dtype)
    names = list(port)
    rng = np.random.default_rng(0)
    shuffled = {n: port[n] for n in rng.permutation(names)}
    assert flax_order(shuffled) == names
    from sdxl_training_improvements_tpu.training.optimizers.adamw_bf16 \
        import _partition_flat as jax_partition
    _, jgroups = jax_partition(jax.tree_util.tree_leaves(shapes), 8)
    groups = AdamWBF16(layout="flat").groups(shuffled)
    assert [list(g) for g in groups.values()] == [
        [names[i] for i in grp] for grp in jgroups]


def _train_state(opt, params):
    return TrainState(step=0, params=params, opt_state=opt.init(params),
                      generator=torch.Generator().manual_seed(1))


def _steps(opt, state, grads_np, n, seed_base=0):
    for s in range(n):
        grads = {f"{k}.bias": torch.from_numpy(v * (1 + s + seed_base))
                 for k, v in grads_np.items()}
        deltas, state.opt_state = opt.update(grads, state.opt_state,
                                             state.params)
        with torch.no_grad():
            for k, p in state.params.items():
                p.add_(deltas[k])
        state.step += 1
    return state


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_layout_resumes_bit_equal(tmp_path, case):
    """Two steps, a checkpoint, a step: the resumed run's third step
    equals the uninterrupted one's in every tensor (the generators, the
    rbg noise generator included, are part of the state)."""
    opt = AdamWBF16(**KW, **CASES[case])
    params_np, grads_np = _arrays(1)
    run = _steps(opt, _train_state(opt, _port_tree(params_np)), grads_np,
                 2)
    C.save_train_state(tmp_path, run)
    _steps(opt, run, grads_np, 1, seed_base=2)
    resumed = _train_state(opt, _port_tree(params_np))
    C.restore_train_state(tmp_path, resumed)
    assert resumed.step == 2
    _steps(opt, resumed, grads_np, 1, seed_base=2)
    ref, _ = C.flatten_train_state(run)
    got, _ = C.flatten_train_state(resumed)
    assert set(ref) == set(got)
    for k in ref:
        assert torch.equal(ref[k], got[k]), k


@pytest.mark.parametrize("saved,resumed", [("flat", "per_leaf"),
                                           ("per_leaf", "stacked"),
                                           ("hybrid", "flat")])
def test_resume_under_another_layout_raises(tmp_path, saved, resumed):
    params_np, _ = _arrays(2)
    a = AdamWBF16(**KW, layout=saved, noise="hash")
    C.save_train_state(tmp_path, _train_state(a, _port_tree(params_np)))
    b = AdamWBF16(**KW, layout=resumed, noise="hash")
    with pytest.raises(ValueError, match=rf"{saved!r}.*{resumed!r}"):
        C.restore_train_state(tmp_path, _train_state(
            b, _port_tree(params_np)))


@pytest.mark.parametrize("setting,match", [
    ({"tpu": {"flat_optimizer": "on", "shard_params": True}},
     "flat_optimizer=on cannot be combined"),
    ({"tpu": {"flat_optimizer": "on", "mesh_shape": [1, 1, 2]}},
     "flat_optimizer=on cannot be combined"),
    ({"tpu": {"shard_params": True}, "optimizer": {"shift_host": True}},
     "shift_host/moments_host cannot be combined"),
    ({"tpu": {"flat_optimizer": "on"}, "optimizer": {"moments_8bit": True}},
     "moments='int8' requires layout='per_leaf'"),
    ({"tpu": {"flat_optimizer": "on"}, "optimizer": {"moments_host": True}},
     "moments_host requires layout='per_leaf'"),
])
def test_make_optimizer_keeps_jax_refusals(setting, match):
    cfg = Config()
    for section, values in setting.items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    with pytest.raises(ValueError, match=match):
        make_optimizer(cfg)


def test_make_optimizer_noise_and_layout_defaults():
    """A bare ``OptimizerConfig`` (no ``tpu``): JAX's per-leaf "rbg";
    ``flat_optimizer`` auto/off: per-leaf; on: flat with "hash"."""
    cfg = Config()
    bare = make_optimizer(cfg.optimizer)
    assert (bare.layout, bare.noise) == ("per_leaf", "rbg")
    for choice, layout in (("auto", "per_leaf"), ("off", "per_leaf"),
                           ("on", "flat")):
        cfg.tpu.flat_optimizer = choice
        opt = make_optimizer(cfg)
        assert (opt.layout, opt.noise) == (layout, "hash")
    for bad in (dict(layout="columns"), dict(noise="philox")):
        with pytest.raises(ValueError):
            AdamWBF16(**bad)
    assert AdamWBF16(flat_state=True).layout == "flat"
