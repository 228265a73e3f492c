"""PyTorch port: parameters stored as fsdp chunks under ``tpu.shard_params``.

Gloo worlds on the CPU (this file run as a script, one process a rank,
as ``tests/test_torch_multiprocess.py`` starts them; both start together
and JAX's mesh steps run in this process meanwhile), on the tiny UNet
from one seeded state dict and one batch (its noise and timesteps
replayed), each state placed with ``shard_train_state(..., shard_params=
True, unet=)``, so that each rank stores only its chunk of every large
leaf and the UNet gathers each unit's chunks to run it:

* ``fsdp2`` (2 ranks, mesh [1,2,1]) and ``fsdp4`` (4 ranks, [2,2,1] and
  [1,2,2]): one step of the fp32 model (adamw_bf16 with hash noise; on
  [1,2,1] also plain adamw and schedule-free) against JAX's
  ``make_train_step`` on ``shard_train_state(..., shard_params=True)``
  over the virtual devices: the loss and the grad norm at rtol 2e-4, the
  gathered gradient the optimizer received and the gathered parameters
  at ``tests/test_torch_multiprocess.py``'s bars;
* storage: each stored chunk's ``numel`` is its ``Zero.chunks`` size, and
  the bytes of ``state.params`` and of the step's gradient accumulator on
  a rank are the sums the chunk plan predicts;
* the remat modes ("full", the selective "dots_small_conv", none) give
  ``torch.equal`` gradients on [1,2,1], and no gathered weight outlives
  its unit: none is alive when the forward returns or after the step,
  and at most one unit's (plus one leaf gathered again in the backward)
  is alive at a time;
* checkpoints (bf16, adamw_bf16 with hash noise, no clipping): the mesh
  [1,2,1] step is ``torch.equal`` to the one-process step that takes a
  rank's rows as micro-batches (``tpu.micro_batch_size`` 2), so a state
  saved on [1,2,1] and resumed in one process, and one saved by one
  process and resumed on [1,2,1], each take their second step
  ``torch.equal`` to the one-process run of two steps.
"""
import json
import os
import sys
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_multiprocess as MP  # noqa: E402  (the worlds' helpers)

REMAT_MODES = ("full", "dots_small_conv", None)
JAX_CASES = (("fsdp2", (1, 2, 1), "adamw_bf16"),
             ("fsdp2", (1, 2, 1), "adamw"),
             ("fsdp2", (1, 2, 1), "adamw_schedule_free_kahan"),
             ("fsdp4", (2, 2, 1), "adamw_bf16"),
             ("fsdp4", (1, 2, 2), "adamw_bf16"))


class World(MP.World):
    """``tests/test_torch_multiprocess.py``'s world, running this file."""

    def __init__(self, scenario: str, ranks: int, work: Path):
        import subprocess
        import time
        self.scenario, self.ranks, self.work = scenario, ranks, work
        port = MP._free_port()
        self.procs = []
        for r in range(ranks):
            env = dict(os.environ, PYTHONPATH=str(MP.REPO),
                       COORDINATOR_ADDRESS=f"localhost:{port}",
                       SDXL_NUM_PROCESSES=str(ranks),
                       SDXL_PROCESS_ID=str(r), OMP_NUM_THREADS="1")
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                      "MASTER_PORT"):
                env.pop(k, None)
            log = open(work / f"rank{r}.log", "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, scenario, str(work)], env=env,
                stdout=log, stderr=subprocess.STDOUT, cwd=MP.REPO))
        self.start = time.perf_counter()


def _config(optimizer: str, shape=None, micro=None, clip=True):
    from sdxl_training_improvements_tpu_torch.config import Config
    cfg = Config()
    cfg.training.batch_size = 4
    cfg.optimizer.optimizer_type = optimizer
    cfg.tpu.sr_noise = "hash"
    cfg.tpu.shard_params = shape is not None
    cfg.tpu.mesh_shape = None if shape is None else list(shape)
    cfg.tpu.micro_batch_size = micro
    if not clip:
        cfg.training.clip_grad_norm = None
    return cfg


def _model(dtype, sd, remat="unset"):
    """The tiny UNet from ``sd``; ``remat``: a policy name, or None for
    none, with the bf16 norm interior on in every mode (so that the
    modes compute alike)."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    if remat == "unset":
        return MP._tiny(dtype, sd)
    kw = dict(norm_bf16_arith=True, remat=remat is not None)
    if remat is not None:
        kw["remat_policy"] = remat
    model = SDXLModel.create(tiny=True, dtype=dtype, device="cpu",
                             unet_config=UNetConfig.tiny(**kw))
    model.unet.load_state_dict(sd)
    return model


def _one_process_run(sd, batch, work: Path):
    """The unsharded run of the checkpoint case: one process, a rank's
    rows as micro-batches; the state after step 1 saved to ``ckpt_one``;
    returns the flattened states after steps 1 and 2 and the config."""
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    cfg = _config("adamw_bf16", micro=2, clip=False)
    model = _model(torch.bfloat16, sd)
    opt = make_optimizer(cfg)
    step = T.make_train_step(model.unet_apply, NoiseSchedule.from_config(
        cfg), opt, cfg)
    state = T.create_train_state(model.trainable_params(), opt)
    state, _ = step(state, batch)
    C.save_train_state(work / "ckpt_one", state)
    first, _ = C.flatten_train_state(state)
    first = {k: v.clone() for k, v in first.items()}
    state, _ = step(state, batch)
    second, _ = C.flatten_train_state(state)
    return first, {k: v.clone() for k, v in second.items()}, cfg


def _jax_mesh_step(sd, batch, shape, optimizer):
    """JAX's metrics, the gradient its optimizer received and the
    parameters after one ``shard_params`` step on mesh ``shape`` of
    virtual devices, on the port's fp32 weights."""
    import jax
    import jax.numpy as jnp
    import optax

    from sdxl_training_improvements_tpu import config as JC
    from sdxl_training_improvements_tpu.models import weights as JW
    from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JM
    from sdxl_training_improvements_tpu.parallel import mesh as JMesh
    from sdxl_training_improvements_tpu.training import schedules as JS
    from sdxl_training_improvements_tpu.training import trainer as JT
    from sdxl_training_improvements_tpu.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.models.weights import (
        from_jax_params)
    jmodel = JM.create(tiny=True, remat=False, dtype=jnp.float32)
    c = jmodel.unet.config
    template = jax.eval_shape(
        jmodel.unet.init, jax.random.key(0),
        jnp.zeros((1, c.in_channels, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 77, c.cross_attention_dim)),
        jnp.zeros((1, c.pooled_embed_dim)), jnp.zeros((1, c.num_time_ids)))
    jmodel.params["unet"] = JW.hf_to_flax_params(
        template, {k: v.numpy() for k, v in sd.items()}, strict=True)
    cfg = JC.Config()
    cfg.training.batch_size = 4
    cfg.optimizer.optimizer_type = optimizer
    cfg.tpu.sr_noise = "hash"
    cfg.tpu.shard_params = True
    mesh = JMesh.create_mesh(list(shape), devices=jax.devices()[:int(
        np.prod(shape))])
    inner = make_optimizer(cfg)

    def update(grads, st, params=None):  # keeps the gradient it received
        updates, st0 = inner.update(grads, st[0], params)
        return updates, (st0, grads)
    opt = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    step = JT.make_train_step(jmodel.unet_apply,
                              JS.NoiseSchedule.from_config(cfg), opt, cfg,
                              mesh=mesh, donate=False)
    state = JT.shard_train_state(
        JT.create_train_state(jmodel.trainable_params(), opt), mesh,
        shard_params=True)
    state, metrics = step(state, JT.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    host = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t))
    return ({k: float(metrics[k]) for k in ("loss", "grad_norm")},
            host(state.opt_state[1]), host(state.params))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Write the worlds' inputs (the one-process run's first checkpoint
    among them) and start them; JAX's steps and the rest of the
    one-process run go on meanwhile."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("fsdp")
    two, four = root / "fsdp2", root / "fsdp4"
    for d in (two, four):
        d.mkdir()
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.unet.state_dict().items()}
    batch = MP._batch(4, 12)
    for d in (two, four):
        torch.save(sd, d / "unet.pt")
        np.savez(d / "batch.npz", **batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    first, second, one_cfg = _one_process_run(sd, tbatch, two)
    running = {"fsdp2": World("fsdp2", 2, two),
               "fsdp4": World("fsdp4", 4, four)}
    pool = ThreadPoolExecutor(4)
    jax_runs = {(shape, opt): pool.submit(_jax_mesh_step, sd, batch, shape,
                                          opt)
                for _, shape, opt in JAX_CASES}
    yield {"worlds": running, "sd": sd, "batch": batch, "two": two,
           "four": four, "jax": jax_runs, "first": first,
           "second": second, "one_cfg": one_cfg}
    pool.shutdown(cancel_futures=True)
    for w in running.values():
        for p in w.procs:
            if p.poll() is None:
                p.kill()
    torch.set_num_threads(n)


def _results(worlds, name):
    return worlds["worlds"][name].results()


@pytest.mark.parametrize("world,shape,optimizer", JAX_CASES)
def test_stored_chunks_step_matches_jax(worlds, world, shape, optimizer):
    jax_metrics, jax_grads, jax_params = worlds["jax"][
        (shape, optimizer)].result()
    res = _results(worlds, world)
    tag = f"{''.join(map(str, shape))}_{optimizer}"
    out = worlds["two" if world == "fsdp2" else "four"]
    got = torch.load(out / f"{tag}_grads.pt")
    params = torch.load(out / f"{tag}_params.pt")
    for r in res:
        case = r["cases"][tag]
        assert case["stored"] and case["chunked"] > 0
        assert case["params_equal_across_ranks"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(case[k], jax_metrics[k],
                                       rtol=MP.RTOL, err_msg=f"{tag} {k}")
    MP._close_grads(got, jax_grads, tag)
    total = sum(p.numel() for p in params.values())
    assert MP._close_params(params, jax_params, jax_grads, tag) \
        >= 0.99 * total


def _storage_ok(case):
    return (case["chunk_numel_ok"] and case["param_bytes"]
            == case["planned_param_bytes"] and case["grad_bytes"]
            == case["planned_grad_bytes"]
            and case["param_bytes"] < case["whole_param_bytes"])


@pytest.mark.parametrize("tag", ["121_adamw_bf16", "221_adamw_bf16",
                                 "122_adamw_bf16"])
def test_stored_bytes_are_the_chunk_plan(worlds, tag):
    """Every stored parameter is its chunk, and the parameters' and the
    accumulator's bytes on each rank are the plan's."""
    world = "fsdp2" if tag.startswith("121") else "fsdp4"
    for r in _results(worlds, world):
        case = r["cases"][tag]
        assert _storage_ok(case), case


def test_remat_modes_give_equal_gradients_and_drop_gathered_weights(
        worlds):
    res = _results(worlds, "fsdp2")
    for r in res:
        modes = r["remat"]
        assert set(modes) == {str(m) for m in REMAT_MODES}
        for name, m in modes.items():
            assert m["live_after_forward"] == 0, name
            assert m["live_after_step"] == 0, name
            assert 0 < m["peak_live_bytes"] <= m["unit_bound_bytes"], (
                name, m)
            assert m["gathers"] > 0 and m["scatters"] > 0, name
        assert all(m["grads_equal_full"] for m in modes.values())


def test_checkpoints_resume_across_meshes_bit_for_bit(worlds):
    """On [1,2,1] the step is the one-process micro-batched step bit for
    bit; a save on either side resumes on the other ``torch.equal`` to
    the one-process run of two steps."""
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    _results(worlds, "fsdp2")
    two, first, second = worlds["two"], worlds["first"], worlds["second"]
    cfg, sd = worlds["one_cfg"], worlds["sd"]

    def read(path):
        fresh = MP._tiny(torch.bfloat16, sd)
        return C.restore_train_state(path, T.create_train_state(
            fresh.trainable_params(), make_optimizer(cfg))), fresh

    def equal(state, ref, what):
        flat, _ = C.flatten_train_state(state)
        assert set(flat) == set(ref), what
        for k in ref:
            assert torch.equal(flat[k], ref[k]), f"{what}: {k}"

    # the ranks' step 1, saved on [1,2,1], is the one-process step 1
    state, _ = read(two / "ckpt_mesh1")
    equal(state, first, "[1,2,1] step 1")
    # ... and resumes in one process for a step 2 equal to the run's
    state, fresh = read(two / "ckpt_mesh1")
    step = T.make_train_step(fresh.unet_apply,
                             NoiseSchedule.from_config(cfg),
                             make_optimizer(cfg), cfg)
    batch = {k: torch.from_numpy(v) for k, v in worlds["batch"].items()}
    state, _ = step(state, batch)
    equal(state, second, "saved on [1,2,1], step 2 in one process")
    # one process's step 1, resumed on [1,2,1] for step 2
    state, _ = read(two / "ckpt_back2")
    equal(state, second, "saved by one process, step 2 on [1,2,1]")


# ------------------------------------------------------------ the ranks

class _Live:
    """The gathered weights alive, through weak references: the count,
    their bytes, and the most bytes alive at once."""

    def __init__(self):
        self.refs, self.peak = [], 0

    def add(self, tensors):
        for t in tensors:
            self.refs.append(weakref.ref(t))
        self.peak = max(self.peak, self.bytes())

    def alive(self):
        return [t for t in (r() for r in self.refs) if t is not None]

    def bytes(self):
        return sum(t.numel() * t.element_size() for t in self.alive())


def _watch_gathers(live: _Live):
    """Record every tensor the fsdp gathers return in ``live``."""
    from sdxl_training_improvements_tpu_torch.parallel import tensor as PT
    from sdxl_training_improvements_tpu_torch.parallel import zero as PZ
    inner = PT.gather_chunks

    def gather(*a, **kw):
        out = inner(*a, **kw)
        live.add(out)
        return out
    PT.gather_chunks = PZ.gather_chunks = gather
    return lambda: setattr(PT, "gather_chunks", inner) or setattr(
        PZ, "gather_chunks", inner)


def _placed_step(cfg, model, shape):
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    mesh = M.create_mesh(list(shape), device_type="cpu")
    opt = make_optimizer(cfg)
    update, seen = opt.update, {}

    def recording(grads, opt_state, params, zero=None):
        seen.update({n: g.clone() for n, g in grads.items()})
        return update(grads, opt_state, params, zero=zero)
    opt.update = recording
    step = T.make_train_step(model.unet_apply,
                             NoiseSchedule.from_config(cfg), opt, cfg,
                             mesh=mesh)
    state = T.shard_train_state(
        T.create_train_state(model.trainable_params(), opt), mesh, True,
        unet=model.unet)
    return step, state, seen


def _storage(state, whole_bytes) -> dict:
    zero = state.zero
    params = state.params
    planned = sum((zero.chunks[n].size if n in zero.chunks else p.numel())
                  * p.element_size() for n, p in params.items())
    elements = sum(zero.chunks[n].size if n in zero.chunks else p.numel()
                   for n, p in params.items())
    return dict(
        stored=zero.stored, chunked=len(zero.chunks),
        chunk_numel_ok=all(params[n].numel() == c.size and params[n].dim()
                           == 1 for n, c in zero.chunks.items()),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in params.values()),
        planned_param_bytes=planned, whole_param_bytes=whole_bytes,
        planned_grad_bytes=elements * 4)


def _jax_cases(work: Path, world: str, out: dict) -> None:
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    rank = M.process_index()
    sd = torch.load(work / "unet.pt")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(work / "batch.npz").items()}
    for w, shape, optimizer in JAX_CASES:
        if w != world:
            continue
        tag = f"{''.join(map(str, shape))}_{optimizer}"
        model = _model(torch.float32, sd)
        whole = sum(p.numel() * p.element_size()
                    for p in model.trainable_params().values())
        step, state, seen = _placed_step(_config(optimizer, shape), model,
                                         shape)
        case = _storage(state, whole)
        state, metrics = step(state, batch)
        case["grad_bytes"] = state.zero.grad_bytes
        zero = state.zero
        grads = zero.gather_tensors(seen)
        params = {n: p.detach().clone()
                  for n, p in zero.whole_params(state.params).items()}
        everyone = [None] * M.process_count()
        torch.distributed.all_gather_object(everyone, params)
        case.update(loss=metrics["loss"].item(),
                    grad_norm=metrics["grad_norm"].item(),
                    params_equal_across_ranks=all(
                        torch.equal(e[n], params[n]) for e in everyone
                        for n in params))
        out["cases"][tag] = case
        if rank == 0:
            torch.save(params, work / f"{tag}_params.pt")
            torch.save(grads, work / f"{tag}_grads.pt")


def _remat_modes(work: Path, out: dict) -> None:
    """One bf16 step in each remat mode, the gathered weights watched."""
    from sdxl_training_improvements_tpu_torch.training import methods
    sd = torch.load(work / "unet.pt")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(work / "batch.npz").items()}
    grads = {}
    for mode in REMAT_MODES:
        model = _model(torch.bfloat16, sd, remat=mode)
        cfg = _config("adamw_bf16", (1, 2, 1))
        live = _Live()
        after_forward = []
        fn = methods.LOSS_REGISTRY[cfg.training.method]

        def watched(*a, **kw):  # the step's loss, right after its forward
            loss = fn(*a, **kw)
            after_forward.append(len(live.alive()))
            return loss
        methods.LOSS_REGISTRY[cfg.training.method] = watched
        try:
            step, state, seen = _placed_step(cfg, model, (1, 2, 1))
        finally:
            methods.LOSS_REGISTRY[cfg.training.method] = fn
        zero = state.zero
        unit_bytes = max(sum(sum(b.sizes) * b.likes[0].element_size()
                             * zero.fsdp for b in bs)
                         for bs in zero.units.values())
        leaf_bytes = max(c.numel * zero.like[n].element_size()
                         for n, c in zero.chunks.items())
        restore = _watch_gathers(live)
        try:
            g0, s0 = zero.gathers, zero.scatters
            state, _ = step(state, batch)
        finally:
            restore()
        grads[str(mode)] = {n: g.clone() for n, g in seen.items()}
        out["remat"][str(mode)] = dict(
            live_after_forward=max(after_forward),
            live_after_step=len(live.alive()), peak_live_bytes=live.peak,
            unit_bound_bytes=unit_bytes + leaf_bytes,
            gathers=zero.gathers - g0, scatters=zero.scatters - s0)
    for mode, g in grads.items():
        out["remat"][mode]["grads_equal_full"] = set(g) == set(
            grads["full"]) and all(torch.equal(g[n], grads["full"][n])
                                   for n in g)


def _checkpoints(work: Path) -> None:
    """[1,2,1], bf16, no clipping: step 1 saved (``ckpt_mesh1``); the
    one-process step-1 state restored, placed and stepped once more,
    saved (``ckpt_back2``)."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    sd = torch.load(work / "unet.pt")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(work / "batch.npz").items()}
    cfg = _config("adamw_bf16", (1, 2, 1), clip=False)
    model = _model(torch.bfloat16, sd)
    step, state, _ = _placed_step(cfg, model, (1, 2, 1))
    state, _ = step(state, batch)
    C.save_train_state(work / "ckpt_mesh1", state)
    M.barrier("saved step 1")
    model = _model(torch.bfloat16, sd)
    mesh = M.create_mesh([1, 2, 1], device_type="cpu")
    opt = make_optimizer(cfg)
    template = T.create_train_state(model.trainable_params(), opt)
    C.restore_train_state(work / "ckpt_one", template)
    state = T.shard_train_state(template, mesh, True, unet=model.unet)
    step = T.make_train_step(model.unet_apply,
                             NoiseSchedule.from_config(cfg), opt, cfg,
                             mesh=mesh)
    state, _ = step(state, batch)
    C.save_train_state(work / "ckpt_back2", state)
    M.barrier("saved step 2")


def _world_fsdp2(work: Path) -> dict:
    out = {"cases": {}, "remat": {}}
    _jax_cases(work, "fsdp2", out)
    _remat_modes(work, out)
    _checkpoints(work)
    return out


def _world_fsdp4(work: Path) -> dict:
    out = {"cases": {}}
    _jax_cases(work, "fsdp4", out)
    return out


WORLDS = {"fsdp2": _world_fsdp2, "fsdp4": _world_fsdp4}


def _rank_main(scenario: str, work: str) -> None:
    torch.set_num_threads(1)
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    M.initialize_multihost("cpu")
    work = Path(work)
    out = WORLDS[scenario](work)
    (work / f"result{M.process_index()}.json").write_text(json.dumps(out))
    M.barrier("done")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3])
