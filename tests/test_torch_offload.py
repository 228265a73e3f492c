"""PyTorch port: host-streamed optimizer state (``optimizer.shift_host`` /
``moments_host``) and ``core/offload.py``.

The streamed update is the resident one in another schedule: for the same
seeds, every parameter, moment (int8 codes and scales included) and shift
equals the resident run's bit for bit over three steps, with groups small
enough that the update runs as several (``stream_group_params``).  It is
also held against JAX's streamed update (the optimization-barrier chain)
with JAX's seeds.  The state it streams is in host memory between steps
(on the card, pinned), a streamed state resumes bit-equal from a
checkpoint, and ``offload_to_host`` / ``fetch_to_device`` /
``tree_bytes`` behave as JAX's over the same trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_training_improvements_tpu.core import offload as JO
from sdxl_training_improvements_tpu.training.optimizers import (
    adamw_bf16 as jax_adamw_bf16)
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.core import offload as TO
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state)
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    AdamWBF16, make_optimizer)
from sdxl_training_improvements_tpu_torch.training.trainer import TrainState

SHAPES = {"a": (3001,), "b": (64, 48), "c_f32": (96,), "d": (5, 7, 9),
          "e": (2048,), "f_f32": (33,)}
KW = dict(lr=1e-3, weight_decay=2.0, noise="hash")
GROUP = 3000  # stream_group_params: the leaves above make 3 groups
HOSTS = {"shift": dict(shift_host=True),
         "moments": dict(moments_host=True),
         "both": dict(shift_host=True, moments_host=True)}


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


def _port_tree(arrays):
    return {f"{k}.bias": torch.from_numpy(v).bfloat16()
            if not k.endswith("f32") else torch.from_numpy(v)
            for k, v in arrays.items()}


def _seeds(step):
    return torch.randint(0, 2 ** 32, (len(SHAPES), 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(step))


def _flat(state):
    out = {}
    for field in ("exp_avg", "exp_avg_sq", "shift", "accumulated_decay"):
        for k, v in getattr(state, field).items():
            if isinstance(v, dict):
                out.update({f"{field}.{k}.{kk}": x for kk, x in v.items()})
            else:
                out[f"{field}.{k}"] = v
    return out


def _run(opt, params_np, grads_np, steps=3):
    params = _port_tree(params_np)
    state = opt.init(params)
    for step in range(steps):
        grads = {f"{k}.bias": torch.from_numpy(v * (1 + step))
                 for k, v in grads_np.items()}
        deltas, state = opt.update(grads, state, params, seeds=_seeds(step))
        with torch.no_grad():
            for k, p in params.items():
                p.add_(deltas[k])
    return params, state


@pytest.mark.parametrize("moments", ["bf16", "int8"])
@pytest.mark.parametrize("host", sorted(HOSTS))
def test_streamed_state_equals_resident(monkeypatch, moments, host):
    groups = []
    stream = TO.stream_groups

    def counting(g, *a, **kw):
        groups.append(len(g))
        return stream(g, *a, **kw)
    monkeypatch.setattr(TO, "stream_groups", counting)
    params_np, grads_np = _arrays()
    ref_p, ref = _run(AdamWBF16(**KW, moments=moments), params_np, grads_np)
    assert not groups
    got_p, got = _run(AdamWBF16(**KW, moments=moments,
                                stream_group_params=GROUP, **HOSTS[host]),
                      params_np, grads_np)
    assert groups == [3, 3, 3]
    for k, p in ref_p.items():
        assert torch.equal(got_p[k], p), k
    ref_t, got_t = _flat(ref), _flat(got)
    assert set(ref_t) == set(got_t)
    for k, t in ref_t.items():
        assert torch.equal(got_t[k], t), k
    # what is streamed lives on the host between steps (pinned on a card)
    streamed = {"shift": ("shift",), "moments": ("exp_avg", "exp_avg_sq"),
                "both": ("shift", "exp_avg", "exp_avg_sq")}[host]
    for k, t in _flat(got).items():
        if k.split(".")[0] in streamed:
            assert t.device.type == "cpu"
            assert t.is_pinned() == torch.cuda.is_available()


def test_streamed_int8_matches_jax_streamed():
    """JAX's streamed int8 update (both host flags, its barrier chain;
    on a CPU backend the arrays stay where they are) and the port's, from
    the same state with JAX's seeds: parameters, codes, scales and shift
    bit for bit."""
    kw = dict(lr=1e-3, weight_decay=2.0)
    jopt = jax_adamw_bf16(**kw, noise="hash", moments="int8",
                          shift_host=True, moments_host=True,
                          stream_group_params=GROUP)
    port = AdamWBF16(**KW, moments="int8", shift_host=True,
                     moments_host=True, stream_group_params=GROUP)
    params_np, grads_np = _arrays(3)
    jparams = {k: {"bias": jnp.asarray(v).astype(jnp.bfloat16)
                   if not k.endswith("f32") else jnp.asarray(v)}
               for k, v in params_np.items()}
    jstate = jopt.init(jparams)
    tparams = _port_tree(params_np)
    tstate = from_jax_opt_state(jax.tree_util.tree_map(
        np.asarray, jstate._replace(key=None)), optimizer=port)
    update = jax.jit(jopt.update)
    for step in range(3):
        jgrads = {k: {"bias": jnp.asarray(v * (1 + step))}
                  for k, v in grads_np.items()}
        tgrads = {f"{k}.bias": torch.from_numpy(v * (1 + step))
                  for k, v in grads_np.items()}
        _, step_key = jax.random.split(jstate.key)
        keys = jax.random.split(step_key, len(SHAPES))
        seeds = torch.tensor(np.stack([np.asarray(jax.random.bits(
            k, (2,), jnp.uint32)) for k in keys]).astype(np.int64))
        updates, jstate = update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, tstate = port.update(tgrads, tstate, tparams, seeds=seeds)
        with torch.no_grad():
            for k, p in tparams.items():
                p.add_(deltas[k])
        for name in params_np:
            got, ref = tparams[f"{name}.bias"], jparams[name]["bias"]
            if name.endswith("f32"):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=0)
                continue
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(ref, np.float32))
            k = f"{name}.bias"
            for mine, theirs in ((tstate.exp_avg[k], jstate.exp_avg[name]),
                                 (tstate.exp_avg_sq[k],
                                  jstate.exp_avg_sq[name])):
                np.testing.assert_array_equal(
                    mine["q"].numpy(), np.asarray(theirs["bias"]["q"]))
                assert float(mine["s"]) == float(theirs["bias"]["s"])
            np.testing.assert_array_equal(
                tstate.shift[k].float().numpy(),
                np.asarray(jstate.shift[name]["bias"], np.float32))


def test_streamed_state_resumes_bit_equal(tmp_path):
    opt = AdamWBF16(**KW, moments="int8", shift_host=True,
                    moments_host=True, stream_group_params=GROUP)
    params_np, grads_np = _arrays(4)

    def state_of(params):
        return TrainState(step=0, params=params, opt_state=opt.init(params),
                          generator=torch.Generator().manual_seed(0))

    def step(state, s):
        grads = {f"{k}.bias": torch.from_numpy(v * (1 + s))
                 for k, v in grads_np.items()}
        deltas, state.opt_state = opt.update(grads, state.opt_state,
                                             state.params)
        with torch.no_grad():
            for k, p in state.params.items():
                p.add_(deltas[k])
        state.step += 1

    run = state_of(_port_tree(params_np))
    step(run, 0)
    C.save_train_state(tmp_path, run)
    step(run, 1)
    resumed = state_of(_port_tree(params_np))
    C.restore_train_state(tmp_path, resumed)
    step(resumed, 1)
    ref, _ = C.flatten_train_state(run)
    got, _ = C.flatten_train_state(resumed)
    for k in ref:
        assert torch.equal(ref[k], got[k]), k


def test_make_optimizer_builds_the_single_chip_plan():
    """``configs/v5e16_single_chip.yaml``'s optimizer: int8 moments and
    both host flags build one per-leaf AdamWBF16 that streams."""
    cfg = Config()
    cfg.optimizer.moments_8bit = True
    cfg.optimizer.shift_host = cfg.optimizer.moments_host = True
    opt = make_optimizer(cfg)
    assert (opt.moments, opt.shift_host, opt.moments_host, opt.layout) == (
        "int8", True, True, "per_leaf")
    assert opt.stream_group_params == 1 << 25


def test_offload_helpers_match_jax():
    rng = np.random.default_rng(5)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "codes": {"q": rng.integers(0, 255, (8,), dtype=np.uint8),
                        "s": np.float32(2.5)}}
    jtree = jax.tree_util.tree_map(jnp.asarray, arrays)
    ttree = {"w": torch.from_numpy(arrays["w"]).contiguous(
        memory_format=torch.contiguous_format),
        "codes": {"q": torch.from_numpy(arrays["codes"]["q"]),
                  "s": torch.tensor(2.5)}}
    assert TO.tree_bytes(ttree) == JO.tree_bytes(jtree)
    host = TO.offload_to_host(ttree)
    assert host["w"] is not ttree["w"] and torch.equal(host["w"],
                                                       ttree["w"])
    assert host["codes"]["q"].dtype == torch.uint8
    back = TO.fetch_to_device(host, "cpu")
    for a, b in ((back["w"], ttree["w"]),
                 (back["codes"]["s"], ttree["codes"]["s"])):
        assert torch.equal(a, b)
    cl = torch.randn(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    assert TO.to_host(cl).stride() == cl.stride()
    jhost = JO.offload_to_host(jtree)
    np.testing.assert_array_equal(np.asarray(jhost["w"]),
                                  host["w"].numpy())
