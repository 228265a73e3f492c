"""PyTorch port: the mesh's sharding rules and the ZeRO chunk updates.

* ``parallel/mesh.py``'s rules (``_fsdp_dim_for``, ``_fsdp_spec_for``,
  ``_tp_dim_for``, ``spec_for_param``) agree with JAX's on the shapes of
  ``tests/test_trainer.py:340-353`` and on every leaf of the tiny UNet:
  the set of leaves that shard over fsdp equals the set where JAX's
  ``param_shardings`` carries ``fsdp`` on meshes [1,2,1] and [2,4,1] of
  the 8 virtual devices, and every spec equals JAX's on [2,2,2].
  ``create_mesh`` raises JAX's errors.
* The counter-hash noise with an element base is the slice of JAX's.
* Every optimizer updates ZeRO chunks exactly as the whole leaf: ranks
  simulated by threads (``parallel/zero.py`` ``Zero`` with its two
  collectives, the gather and the MAX, done over a thread barrier), two
  steps each; the chunks' parameters, deltas and gathered state are
  ``torch.equal`` to the one-process run's.  The same holds for
  megatron slices over a tensor axis (a column, a row and a GEGLU leaf,
  alone and chunked over fsdp): the slices' update is the whole leaf's.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.ops import stochastic as JStoch
from sdxl_training_improvements_tpu.parallel import mesh as JM
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.weights import flax_path
from sdxl_training_improvements_tpu_torch.ops.stochastic import (
    counter_noise)
from sdxl_training_improvements_tpu_torch.parallel import mesh as M
from sdxl_training_improvements_tpu_torch.parallel.zero import Zero
from sdxl_training_improvements_tpu_torch.training import optimizers as O
from sdxl_training_improvements_tpu_torch.training.checkpoints import (
    flatten_train_state)
from sdxl_training_improvements_tpu_torch.training.trainer import TrainState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the simulated ranks run as Python threads, and
    each rank of a real world is a process with its own pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the rules

SHAPES = [(128,), (10240,), (320, 64), (1280, 10240), (3, 3, 320, 640),
          (640, 2560), (3, 3, 4, 320), (77, 2048), (2048, 1280, 1)]


def _trim(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_fsdp_and_tp_rules_match_jax():
    for shape in SHAPES:
        for size in (1, 2, 4, 8, 3):
            assert M._fsdp_spec_for(shape, size) == tuple(
                JM._fsdp_spec_for(shape, size)), (shape, size)
            for exclude in (None, 0, len(shape) - 1):
                assert M._fsdp_dim_for(shape, size, exclude) == \
                    JM._fsdp_dim_for(shape, size, exclude)
    # JAX's own golden cases (tests/test_trainer.py:340-353)
    assert M._fsdp_spec_for((128,), 2) == ()
    assert M._fsdp_spec_for((320, 64), 2) == ()
    assert M._fsdp_spec_for((3, 3, 320, 640), 2) == (None, None, None,
                                                     "fsdp")
    paths = ["a/attn1/to_q/kernel", "a/attn2/to_out_0/kernel",
             "b/ff/net_0/proj/kernel", "b/ff/net_0/proj/bias",
             "b/ff/net_2/kernel", "c/conv1/kernel", "a/attn1/to_k/bias"]
    mesh = JM.create_mesh([2, 2, 2], devices=jax.devices()[:8])
    for path in paths:
        for shape in ((320, 640), (640,), (1280, 10240), (10240, 1280)):
            for t in (1, 2, 3):
                assert M._tp_dim_for(path, shape, t) == JM._tp_dim_for(
                    path, shape, t)
            for shard in (False, True):
                assert M.spec_for_param(path, shape, dict(mesh.shape),
                                        shard) == tuple(JM.spec_for_param(
                                            path, shape, mesh, shard))


@pytest.fixture(scope="module")
def tiny_leaves():
    """(the port's tiny UNet parameters, the flax template's leaves as
    {"/"-joined path: shape-carrying leaf})."""
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    jmodel = JModel.create(tiny=True, remat=False, dtype=jnp.float32)
    c = jmodel.unet.config
    template = jax.eval_shape(
        jmodel.unet.init, jax.random.key(0),
        jnp.zeros((1, c.in_channels, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 77, c.cross_attention_dim)),
        jnp.zeros((1, c.pooled_embed_dim)), jnp.zeros((1, c.num_time_ids)))
    return model.trainable_params(), template


@pytest.mark.parametrize("shape", [[1, 2, 1], [2, 4, 1], [2, 2, 2]])
def test_sharded_leaves_match_jax_param_shardings(tiny_leaves, shape):
    params, template = tiny_leaves
    n = int(np.prod(shape))
    mesh = JM.create_mesh(shape, devices=jax.devices()[:n])
    shardings = JM.param_shardings(mesh, template, shard_params=True)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    jax_specs = {}
    for path, sh in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        jax_specs["/".join(k for k in keys if k != "params")] = _trim(
            sh.spec)
    sizes = dict(zip(M.AXIS_NAMES, shape))
    port_specs = {"/".join(flax_path(n, p.dim())): _trim(M.port_spec(
        n, p, sizes, shard_params=True)) for n, p in params.items()}
    assert set(port_specs) == set(jax_specs)
    assert port_specs == jax_specs
    sharded = {k for k, s in port_specs.items() if "fsdp" in s}
    assert sharded == {k for k, s in jax_specs.items() if "fsdp" in s}
    assert sharded  # the tiny UNet has leaves large enough to shard


def test_create_mesh_errors_match_jax():
    for shape, names in (([3, 1, 1], M.AXIS_NAMES),
                         ([8, 1, 1], ("dp", "fsdp", "tensor"))):
        with pytest.raises(ValueError) as ours:
            M.create_mesh(shape, names, world=8)
        with pytest.raises(ValueError) as theirs:
            JM.create_mesh(shape, names, devices=jax.devices()[:8])
        assert str(ours.value) == str(theirs.value)


def test_counter_noise_with_base_is_the_slice_of_jax():
    n = 1 << 12
    for seed in (0, 12345, 0xFFFFFFFF):
        ref = np.asarray(JStoch.counter_noise(
            jnp.asarray(seed, jnp.uint32), n)).astype(np.int64)
        for base, size in ((0, n), (n // 2, n // 2), (1000, 77)):
            got = counter_noise(seed, size, base=base).numpy()
            np.testing.assert_array_equal(got, ref[base:base + size])


# ------------------------------------------------- chunks in one process

class _Hub:
    def __init__(self, n):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)


class ThreadZero(Zero):
    """``Zero`` for rank ``rank`` of ``f`` simulated fsdp ranks (and, with
    ``t`` > 1, tensor coordinate ``tp_rank`` of ``t``, ``tp`` its plan):
    the collectives of an optimizer update (the gathers and the MAX)
    exchange through ``hub`` (the fsdp group's) and ``tp_hub`` (the
    tensor group's) over thread barriers."""

    def __init__(self, params, rank, f, hub, t=1, tp_rank=0, tp_hub=None,
                 tp=None):
        self.data, self.fsdp, self.world, self.tensor = 1, f, f, t
        self.rank, self.hub = rank, hub
        self.tp_rank, self.tp_hub = tp_rank, tp_hub
        self.tp = dict(tp or {})
        self._plan(params, {"data": 1, "fsdp": f, "tensor": t}, rank, True)

    @staticmethod
    def _exchange_on(hub, rank, x):
        hub.slots[rank] = x.clone()  # the ranks write on
        hub.barrier.wait()
        out = list(hub.slots)
        hub.barrier.wait()
        return out

    def _exchange(self, x):
        return self._exchange_on(self.hub, self.rank, x)

    def _gather_flat(self, name, chunk):
        return torch.cat(self._exchange(chunk))

    def _gather_tensor_rows(self, flat):
        return torch.stack(self._exchange_on(self.tp_hub, self.tp_rank,
                                             flat))

    def max_over_shards(self, x, name):
        if name in self.chunks:
            x.copy_(torch.stack(self._exchange(x)).max())
        if name in self.tp:
            x.copy_(torch.stack(self._exchange_on(
                self.tp_hub, self.tp_rank, x)).max())
        return x


BIG_CONV = "down_blocks.0.resnets.0.conv1.weight"
BIG_LINEAR = ("down_blocks.1.attentions.0.transformer_blocks.0.attn1."
              "to_q.weight")


def _leaves(dtype):
    g = torch.Generator().manual_seed(0)
    params = {
        BIG_CONV: (torch.randn(128, 64, 3, 3, generator=g) * 0.05).to(
            dtype).contiguous(memory_format=torch.channels_last),
        BIG_LINEAR: (torch.randn(256, 320, generator=g) * 0.05).to(dtype),
        "down_blocks.0.resnets.0.conv1.bias": torch.randn(
            128, generator=g).to(dtype),
        "down_blocks.0.resnets.0.norm1.weight": torch.ones(128),
    }
    grads = [{n: torch.randn(p.shape, generator=g).float()
              .to(memory_format=torch.channels_last if p.dim() == 4
                  else torch.contiguous_format)
              for n, p in params.items()} for _ in range(2)]
    return params, grads


OPTIMIZERS = {
    "adamw": (lambda: O.AdamW(lr=1e-3, weight_decay=1e-2), torch.float32),
    "adamw_bf16_hash": (lambda: O.AdamWBF16(lr=1e-3, weight_decay=0.5,
                                            noise="hash"), torch.bfloat16),
    "adamw_bf16_rbg": (lambda: O.AdamWBF16(lr=1e-3, weight_decay=0.5,
                                           noise="rbg"), torch.bfloat16),
    "adamw_bf16_int8": (lambda: O.AdamWBF16(lr=1e-3, noise="hash",
                                            moments="int8"),
                        torch.bfloat16),
    "ema": (lambda: O.with_ema(O.AdamW(lr=1e-3), decay=0.9),
            torch.float32),
    "schedule_free": (lambda: O.AdamWScheduleFreeKahan(lr=1e-3,
                                                       warmup_steps=1),
                      torch.float32),
    "soap": (lambda: O.SOAP(lr=1e-3, precondition_frequency=2),
             torch.float32),
}


def _flat_state(opt_state, params):
    return flatten_train_state(TrainState(
        step=0, params=params, opt_state=opt_state,
        generator=torch.Generator()))[0]


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_chunk_updates_equal_the_whole_leaf(kind, f):
    make, dtype = OPTIMIZERS[kind]
    start, grads = _leaves(dtype)
    opt = make()
    params = {n: p.clone() for n, p in start.items()}
    state = opt.init(params)
    deltas = []
    for g in grads:
        d, state = opt.update(g, state, params)
        deltas.append(d)
        for n in params:
            params[n].add_(d[n])
    whole = _flat_state(state, params)

    hub, results, errors = _Hub(f), [None] * f, []

    def rank(r):
        try:
            ropt = make()
            p = {n: t.clone() for n, t in start.items()}
            zero = ThreadZero(p, r, f, hub)
            assert set(zero.chunks) == {BIG_CONV, BIG_LINEAR}
            st = ropt.init(p)
            zero.shard_state(st)
            got = []
            for g in grads:
                d, st = ropt.update(zero.views(g), st, zero.views(p),
                                    zero=zero)
                got.append(d)
                for n in p:
                    zero.view(n, p[n]).add_(d[n])
                for n in zero.chunks:  # the step's all-gather
                    p[n].copy_(zero.gather(n, zero.view(n, p[n])))
            flat = _flat_state(st, p)
            for key, n, how, _, _ in zero.state_fields(st):
                flat[key] = zero.gather(n, flat[key], how)
            results[r] = (got, p, flat, zero)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(f)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    for got, p, flat, zero in results:
        for step, d in enumerate(deltas):
            for n in d:  # SOAP's whole delta is a view of its JAX layout
                ref = (zero.chunk_of(n, d[n]) if n in zero.chunks
                       else d[n])
                assert torch.equal(got[step][n], ref), (kind, step, n)
        for n in params:
            assert torch.equal(p[n], params[n]), (kind, n)
        assert set(flat) == set(whole)
        for k in whole:
            assert torch.equal(flat[k], whole[k]), (kind, k)


@pytest.mark.parametrize("case", ["hybrid", "stacked", "flat", "host",
                                  "tensor"])
def test_refusals_under_model_sharding(case):
    """JAX's refusals under model sharding, word for word where JAX has
    them (``optimizers/__init__.py:54-58``, ``:80-86``); over a tensor
    axis the per-leaf layout updates the slices and the packed layouts
    refuse, saying that no config selects them."""
    from sdxl_training_improvements_tpu_torch.config import Config
    params, grads = _leaves(torch.bfloat16)
    if case in ("hybrid", "stacked"):
        opt = O.AdamWBF16(layout=case)
        zero = ThreadZero(params, 0, 2, _Hub(1))
        state = opt.init(params)
        with pytest.raises(ValueError, match="per-leaf layout"):
            opt.update(zero.views(grads[0]), state, zero.views(params),
                       zero=zero)
        return
    cfg = Config()
    cfg.tpu.shard_params = True
    if case == "flat":
        cfg.tpu.flat_optimizer = "on"
        match = "cannot be combined with model sharding"
    elif case == "host":
        cfg.optimizer.shift_host = True
        match = "cannot be combined with tpu.shard_params"
    else:
        # a tensor axis trains (test_tp_updates_equal_the_whole_leaf):
        # per leaf on one rank of two here; the packed layouts refuse it
        tp, _ = _tp_leaves(torch.bfloat16)
        plan = M.tp_plan(tp, {"data": 1, "fsdp": 1, "tensor": 2},
                         TP_HEADS, rank=0)
        local = {n: plan[n].cut(p) if n in plan else p
                 for n, p in tp.items()}
        zero = ThreadZero(local, 0, 1, _Hub(1), t=2, tp=plan)
        assert set(zero.tp) == {TP_COLUMN, TP_ROW, TP_GEGLU, TP_GEGLU_BIAS}
        for layout in ("per_leaf", "hybrid"):
            opt = O.AdamWBF16(layout=layout, noise="hash")
            state = opt.init(local)
            if layout == "per_leaf":
                deltas, _ = opt.update({n: torch.zeros_like(p).float()
                                        for n, p in local.items()},
                                       state, local, zero=zero)
                assert all(deltas[n].shape == local[n].shape
                           for n in local)
                continue
            with pytest.raises(ValueError,
                               match="no config selects the hybrid"):
                opt.update({n: torch.zeros_like(p).float()
                            for n, p in local.items()}, state, local,
                           zero=zero)
        return
    with pytest.raises(ValueError, match=match):
        O.make_optimizer(cfg)


# ------------------------------------------- megatron slices in one process

TP_PREFIX = "down_blocks.1.attentions.0.transformer_blocks.0."
TP_COLUMN = TP_PREFIX + "attn1.to_q.weight"
TP_ROW = TP_PREFIX + "attn1.to_out.0.weight"
TP_GEGLU = TP_PREFIX + "ff.net.0.proj.weight"
TP_GEGLU_BIAS = TP_PREFIX + "ff.net.0.proj.bias"
TP_HEADS = {TP_PREFIX + "attn1": 4}


def _tp_leaves(dtype):
    """A column, a row and a GEGLU leaf (one in the JAX layout), the
    GEGLU's bias, a replicated bias and a norm; two steps' gradients."""
    g = torch.Generator().manual_seed(1)
    params = {
        TP_COLUMN: (torch.randn(256, 320, generator=g) * 0.05).to(dtype),
        TP_ROW: (torch.randn(256, 320, generator=g) * 0.05).t().to(dtype),
        TP_GEGLU: (torch.randn(1024, 256, generator=g) * 0.05).to(dtype),
        TP_GEGLU_BIAS: torch.randn(1024, generator=g).to(dtype) * 0.05,
        TP_PREFIX + "attn1.to_out.0.bias": torch.randn(
            320, generator=g).to(dtype),
        TP_PREFIX + "norm1.weight": torch.ones(320),
    }
    grads = [{n: torch.empty_strided(p.shape, p.stride()).copy_(
        torch.randn(p.shape, generator=g)) for n, p in params.items()}
        for _ in range(2)]  # each gradient laid out as its parameter
    return params, grads


@pytest.mark.parametrize("f,t", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_tp_updates_equal_the_whole_leaf(kind, f, t):
    make, dtype = OPTIMIZERS[kind]
    start, grads = _tp_leaves(dtype)
    opt = make()
    params = {n: p.clone() for n, p in start.items()}
    state = opt.init(params)
    deltas = []
    for g in grads:
        d, state = opt.update(g, state, params)
        deltas.append(d)
        for n in params:
            params[n].add_(d[n])
    whole = _flat_state(state, params)

    n_ranks = f * t
    f_hubs = [_Hub(f) for _ in range(t)]
    t_hubs = [_Hub(t) for _ in range(f)]
    results, errors = [None] * n_ranks, []

    def rank(r):
        fi, ti = divmod(r, t)
        try:
            ropt = make()
            plan = M.tp_plan(start, {"data": 1, "fsdp": f, "tensor": t},
                             TP_HEADS, rank=ti)
            p = {n: (plan[n].cut(x) if n in plan else x.clone())
                 for n, x in start.items()}
            zero = ThreadZero(p, fi, f, f_hubs[ti], t, ti, t_hubs[fi],
                              plan)
            # the one-card state of a fresh init, cut as a restore is
            st = ropt.init({n: x.clone() for n, x in start.items()})
            zero.shard_state(st)
            got = []
            for g in grads:
                gl = {n: (plan[n].cut(x) if n in plan else x)
                      for n, x in g.items()}
                d, st = ropt.update(zero.views(gl), st, zero.views(p),
                                    zero=zero)
                got.append(d)
                for n in p:
                    zero.view(n, p[n]).add_(d[n])
                for n in zero.chunks:  # the step's all-gather over fsdp
                    p[n].copy_(zero.gather(n, zero.view(n, p[n]),
                                           whole=False))
            flat = _flat_state(st, p)
            for key, n, how, _, _ in zero.state_fields(st):
                flat[key] = zero.gather(n, flat[key], how)
            flat.update({f"params.{n}": x for n, x in
                         zero.whole_params(p).items()})
            results[r] = (got, flat, zero)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            for h in f_hubs + t_hubs:
                h.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(n_ranks)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    if errors:
        raise errors[0]
    for got, flat, zero in results:
        assert set(zero.tp) == {TP_COLUMN, TP_ROW, TP_GEGLU, TP_GEGLU_BIAS}
        for step, d in enumerate(deltas):
            for n in d:
                assert torch.equal(got[step][n],
                                   zero.chunk_of(n, d[n])
                                   if n in zero.chunks or n in zero.tp
                                   else d[n]), (kind, step, n)
        assert set(flat) == set(whole)
        for k in whole:
            assert torch.equal(flat[k], whole[k]), (kind, k)
