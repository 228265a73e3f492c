"""PyTorch port: training over several ranks, gloo worlds on the CPU.

Each world is this file run as a script, one process per rank, joined
through JAX's env triple (``COORDINATOR_ADDRESS``, ``SDXL_NUM_PROCESSES``,
``SDXL_PROCESS_ID``, as ``tests/mp_worker.py`` sets it) on the gloo
backend; the ranks write their results into the world's directory, and
the tests hold them against the JAX package and the one-process port.
The three worlds start together (one torch thread per rank); a rank that
has not finished after ``WORKER_TIMEOUT`` seconds fails its test.

* ``steps`` (2 ranks), on the tiny UNet from one seeded state dict and
  one batch (its noise and timesteps replayed):
  (a) mesh [2,1,1], plain adamw, fp32, the default learning rate 1e-6:
  against JAX's ``make_train_step(mesh=create_mesh([2,1,1],
  jax.devices()[:2]))`` on the same weights and batch and against the
  one-process port step, the loss and the grad norm at JAX's loss bar
  (rtol 2e-4, ``tests/test_trainer.py:268-274``), the reduced, clipped
  gradient each optimizer received at rtol 2e-4 / atol 2e-5, and every
  parameter whose reference gradient is not zero to rounding at atol
  lr/4 (Adam's first step moves it by about lr, which is checked too);
  (b) mesh [1,2,1] with ``shard_params``, adamw_bf16 (hash noise) with
  int8 moments, bf16: its gathered gradient and its parameters
  ``torch.equal`` to [2,1,1]'s with the same optimizer, its loss and grad
  norm at rtol 2e-4; the gradient the optimizer received, gathered, drives a
  one-process optimizer from the same start, and its state and
  parameters are ``torch.equal`` to the ranks' (read back from the state
  the two ranks saved, restored in one process: (e)'s first half);
  (e) a state saved by one process restores on the two ranks, is cut to
  their chunks and saved back by them ``torch.equal``.
* ``dryrun`` (4 ranks): ``parallel/dryrun.dryrun_multichip(4)`` (mesh
  [2,2,1] with micro-batch re-tiling, dp-only, fsdp-only with int8
  moments, flow matching with EMA, tp-only on [1,1,4], [2,1,2] with rbg
  noise, the dp/fsdp and dp/tp trajectory agreements).
* ``trainer`` (2 ranks): ``SDXLTrainer`` on [1,2,1] with
  ``shard_params`` and the partitioned cache (``tests/mp_worker.py``'s
  scenarios): each rank's cache under ``host-NNN`` holding its half;
  1 epoch + ``resume_from: auto`` ``torch.equal`` to 2 uninterrupted
  epochs in every parameter and optimizer-state chunk; the validation
  loss agreed (a failure on one rank: None on both; else the mean); a
  cache entry dropped on rank 1 makes the integrity gate raise on both.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 300
RTOL = 2e-4  # JAX's loss bar (tests/test_trainer.py:268-274)
GRAD_ATOL = 2e-5  # tests/test_torch_trainer.py's gradient bars
# Adam's first step moves every element by about the learning rate (the
# default, 1e-6) in the direction of its gradient's sign, so the
# parameters are held well below it: a missing, doubled or reversed
# update fails.  Where the reference gradient is zero to rounding (within
# 2^-16, 128 fp32 ulps, of the largest gradient) its sign, and so the
# element's direction, is not fixed, and the parameter is held to the
# gradient check alone
LR = 1e-6
PARAM_ATOL = LR / 4
ROUNDING = 2.0 ** -16


# ------------------------------------------------------------ the worlds

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """The processes of one world, started together."""

    def __init__(self, scenario: str, ranks: int, work: Path):
        self.scenario, self.ranks, self.work = scenario, ranks, work
        port = _free_port()
        self.procs = []
        for r in range(ranks):
            env = dict(os.environ, PYTHONPATH=str(REPO),
                       COORDINATOR_ADDRESS=f"localhost:{port}",
                       SDXL_NUM_PROCESSES=str(ranks),
                       SDXL_PROCESS_ID=str(r), OMP_NUM_THREADS="1")
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                      "MASTER_PORT"):
                env.pop(k, None)
            log = open(work / f"rank{r}.log", "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, scenario, str(work)], env=env,
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
        self.start = time.perf_counter()

    def results(self) -> list:
        """Every rank's result, once all have exited 0."""
        for p in self.procs:
            left = WORKER_TIMEOUT - (time.perf_counter() - self.start)
            try:
                p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                pytest.fail(f"world {self.scenario}: a rank hung past "
                            f"{WORKER_TIMEOUT} s")
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                tail = (self.work / f"rank{r}.log").read_text()[-3000:]
                pytest.fail(f"world {self.scenario} rank {r} exited "
                            f"{p.returncode}:\n{tail}")
        return [json.loads((self.work / f"result{r}.json").read_text())
                for r in range(self.ranks)]


def _batch(b: int, seed: int) -> dict:
    """A batch of the tiny UNet's shapes (``tests/test_torch_trainer.py``),
    its noise and timesteps replayed so that both packages draw alike."""
    rng = np.random.default_rng(seed)
    return {
        "vae_latents": rng.standard_normal((b, 4, 16, 16)).astype(
            np.float32),
        "prompt_embeds": rng.standard_normal((b, 77, 64)).astype(
            np.float32),
        "pooled_prompt_embeds": rng.standard_normal((b, 32)).astype(
            np.float32),
        "time_ids": np.tile(np.asarray([[128., 128, 0, 0, 128, 128]],
                                       np.float32), (b, 1)),
        "noise": rng.standard_normal((b, 4, 16, 16)).astype(np.float32),
        "timesteps": np.asarray([300, 700, 500, 900][:b]),
        "tag_weights": np.asarray([0.5, 2.0, 1.0, 1.5][:b], np.float32),
    }


def _port_config(optimizer: str, shard: bool = False, shape=None):
    from sdxl_training_improvements_tpu_torch.config import Config
    cfg = Config()
    cfg.training.batch_size = 4
    cfg.optimizer.optimizer_type = optimizer
    cfg.optimizer.moments_8bit = optimizer == "adamw_bf16"
    cfg.tpu.sr_noise = "hash"
    cfg.tpu.shard_params = shard
    cfg.tpu.mesh_shape = shape
    return cfg


def _tiny(dtype, state_dict):
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    model = SDXLModel.create(tiny=True, dtype=dtype, device="cpu")
    model.unet.load_state_dict(state_dict)
    return model


def _one_process_step(model, cfg, batch, seen=None):
    """(state, metrics) of one meshless port step; ``seen`` receives the
    gradient its optimizer got."""
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    opt = make_optimizer(cfg)
    if seen is not None:
        update = opt.update

        def recording(grads, opt_state, params):
            seen.update({n: g.clone() for n, g in grads.items()})
            return update(grads, opt_state, params)
        opt.update = recording
    step = T.make_train_step(model.unet_apply,
                             NoiseSchedule.from_config(cfg), opt, cfg)
    state = T.create_train_state(model.trainable_params(), opt)
    return step(state, batch)


def _images(root: Path, n: int = 4) -> Path:
    from sdxl_training_improvements_tpu_torch.png import write_png
    rng = np.random.default_rng(1)
    d = root / "imgs"
    d.mkdir()
    for i in range(n):
        write_png(d / f"i{i}.png",
                  rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        (d / f"i{i}.txt").write_text(f"masterpiece, tag{i % 2}, cat")
    return d


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the three worlds (after writing their inputs); the JAX step
    runs in this process while they do."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("mp")
    steps, dry, trainer = (root / "steps", root / "dryrun",
                           root / "trainer")
    for d in (steps, dry, trainer):
        d.mkdir()
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.unet.state_dict().items()}
    torch.save(sd, steps / "unet.pt")
    batch = _batch(4, 12)
    np.savez(steps / "batch.npz", **batch)
    # (e): a one-process state of (b)'s settings, saved by one process
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, _ = _one_process_step(_tiny(torch.bfloat16, sd),
                                 _port_config("adamw_bf16"), tbatch)
    C.save_train_state(steps / "ckpt_one", state)
    _images(trainer)
    running = {"steps": World("steps", 2, steps),
               "dryrun": World("dryrun", 4, dry),
               "trainer": World("trainer", 2, trainer)}
    yield {"worlds": running, "sd": sd, "batch": batch, "steps": steps,
           "trainer": trainer}
    for w in running.values():
        for p in w.procs:
            if p.poll() is None:
                p.kill()
    torch.set_num_threads(n)


def _jax_mesh_step(sd, batch):
    """JAX's metrics, the gradient its optimizer received and the
    parameters after one step on mesh [2,1,1] of two virtual devices, on
    the port's weights."""
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
    cfg.optimizer.optimizer_type = "adamw"
    assert cfg.optimizer.learning_rate == LR
    mesh = JMesh.create_mesh([2, 1, 1], devices=jax.devices()[:2])
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
        JT.create_train_state(jmodel.trainable_params(), opt), mesh)
    state, metrics = step(state, JT.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    host = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t))
    return ({k: float(metrics[k]) for k in ("loss", "grad_norm")},
            host(state.opt_state[1]), host(state.params))


def _close_grads(got, ref, what):
    assert set(got) == set(ref), what
    for n, r in ref.items():
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what} {n}")


def _close_params(got, ref, ref_grads, what):
    """Every parameter within ``PARAM_ATOL`` of ``ref`` where the
    reference gradient is not zero to rounding; returns how many
    elements that held."""
    floor = ROUNDING * max(g.abs().max().item() for g in ref_grads.values())
    held = 0
    for n, r in ref.items():
        g = ref_grads[n].numpy()
        fixed = np.abs(g) > floor
        np.testing.assert_allclose(got[n].numpy()[fixed], r.numpy()[fixed],
                                   rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {n}")
        held += int(fixed.sum())
    return held


def test_data_parallel_step_matches_jax_and_one_process(worlds):
    sd, batch = worlds["sd"], worlds["batch"]
    jax_metrics, jax_grads, jax_params = _jax_mesh_step(sd, batch)
    model = _tiny(torch.float32, sd)
    grads = {}
    state, metrics = _one_process_step(
        model, _port_config("adamw"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, grads)
    res = worlds["worlds"]["steps"].results()
    out = worlds["steps"]
    ranks = torch.load(out / "a_params.pt")
    got = torch.load(out / "a_grads.pt")
    assert res[0]["a"] == res[1]["a"]  # the metrics agree on every rank
    one = {n: p.detach() for n, p in state.params.items()}
    total = sum(p.numel() for p in one.values())
    for what, ref_metrics, ref_grads, ref_params in (
            ("JAX mesh step", jax_metrics, jax_grads, jax_params),
            ("one-process step", {k: v.item() for k, v in metrics.items()},
             grads, one)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[0]["a"][k], ref_metrics[k],
                                       rtol=RTOL, err_msg=f"{what} {k}")
        _close_grads(got, ref_grads, what)
        # nearly every element has a gradient above the rounding
        assert _close_params(ranks, ref_params, ref_grads, what) \
            >= 0.99 * total
    # the step moved every such element by about LR
    moved = _close_params(
        {n: (p - sd[n]).abs() for n, p in ranks.items()},
        {n: torch.full_like(p, LR) for n, p in ranks.items()}, grads,
        "the update's size")
    assert moved >= 0.99 * total
    assert res[0]["a"]["params_equal_across_ranks"]


def test_zero_step_matches_data_parallel_and_one_process_state(worlds):
    from sdxl_training_improvements_tpu_torch.models import weights as W
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    res = worlds["worlds"]["steps"].results()
    out = worlds["steps"]
    dp, zero = res[0]["b_dp"], res[0]["b_fsdp"]
    assert zero["sharded_leaves"] > 0 and dp["sharded_leaves"] == 0
    assert all(r["b_fsdp"]["params_equal_across_ranks"] for r in res)
    # two ranks' halves sum alike in a reduce-scatter and an all-reduce,
    # so the gradient, its norm and the update are bit for bit [2,1,1]'s
    grads = torch.load(out / "b_fsdp_grads.pt")
    g_dp = torch.load(out / "b_dp_grads.pt")
    assert set(grads) == set(g_dp)
    for n, g in g_dp.items():
        assert torch.equal(grads[n], g), n
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(zero[k], dp[k], rtol=RTOL, err_msg=k)
    p_dp = torch.load(out / "b_dp_params.pt")
    p_zero = torch.load(out / "b_fsdp_params.pt")
    for n, p in p_dp.items():
        assert torch.equal(p_zero[n], p), f"[1,2,1] against [2,1,1] {n}"
    # the one-process optimizer on the gradient the ranks' optimizer got
    cfg = _port_config("adamw_bf16", shard=True)
    model = _tiny(torch.bfloat16, worlds["sd"])
    opt = make_optimizer(cfg)
    state = T.create_train_state(model.trainable_params(), opt)
    deltas, state.opt_state = opt.update(grads, state.opt_state,
                                         state.params)
    with torch.no_grad():
        for n, p in state.params.items():
            p.add_(deltas[n])
            assert torch.equal(p, p_zero[n]), n
    state.step = 1
    # (e) the state the two ranks saved, restored in one process
    template = T.create_train_state(
        _tiny(torch.bfloat16, worlds["sd"]).trainable_params(),
        make_optimizer(cfg))
    restored = C.restore_train_state(out / "ckpt_two", template)
    ours, _ = C.flatten_train_state(state)
    theirs, _ = C.flatten_train_state(restored)
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    # (e) a one-process state through the two ranks and back
    one = W.read_safetensors(out / "ckpt_one" / "state" / C.STATE_TENSORS)
    back = W.read_safetensors(out / "ckpt_back" / "state" / C.STATE_TENSORS)
    assert set(one) == set(back)
    for k in one:
        assert torch.equal(one[k], back[k]), k
    assert json.loads((out / "ckpt_one" / "state" / C.STATE_META
                       ).read_text()) == json.loads(
        (out / "ckpt_back" / "state" / C.STATE_META).read_text())


def test_dryrun_multichip_over_four_ranks(worlds):
    res = worlds["worlds"]["dryrun"].results()
    assert res[0] == res[1] == res[2] == res[3]
    losses = res[0]
    assert set(losses) == {"ddpm_dp_fsdp_retile", "ddpm_dp_only",
                           "ddpm_fsdp_only_int8_moments", "ddpm_fsdp_only",
                           "flow_matching_ema", "ddpm_tp_only",
                           "ddpm_dp_tp"}
    for other in ("ddpm_fsdp_only", "ddpm_tp_only"):
        for a, b in zip(losses["ddpm_dp_only"], losses[other]):
            assert abs(a - b) <= 5e-3 * abs(b), other


def test_trainer_over_two_ranks_with_partitioned_cache(worlds):
    res = worlds["worlds"]["trainer"].results()
    for r, out in enumerate(res):
        assert out["cache_dir"].endswith(f"host-{r:03d}")
        assert out["host_dirs"] == ["host-000", "host-001"]
        assert out["local_images"] == out["local_cached"] == 2
        assert out["step"] == 4 and out["resumed_step"] == 2
        assert out["resume_equal"], out
        assert out["val_first_is_none"]
        assert out["val_second"] == pytest.approx(0.55)
        assert out["integrity_raised"]
        assert "missing from the latent cache" in out["integrity_message"]
    assert res[0]["loss"] == res[1]["loss"]
    assert res[0]["sharded_leaves"] > 0


# ------------------------------------------------------------ the ranks

def _world_steps(work: Path) -> dict:
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    rank = M.process_index()
    sd = torch.load(work / "unet.pt")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(work / "batch.npz").items()}
    out = {}

    def run(tag, dtype, optimizer, shape, shard):
        cfg = _port_config(optimizer, shard, shape)
        model = _tiny(dtype, sd)
        mesh = M.create_mesh(shape, device_type="cpu")
        opt = make_optimizer(cfg)
        update, seen = opt.update, {}

        def recording(grads, opt_state, params, zero=None):
            seen.update(zero.gather_tensors(
                {n: g.clone() for n, g in grads.items()}))
            return update(grads, opt_state, params, zero=zero)
        opt.update = recording
        step = T.make_train_step(model.unet_apply,
                                 NoiseSchedule.from_config(cfg), opt, cfg,
                                 mesh=mesh)
        state = T.shard_train_state(
            T.create_train_state(model.trainable_params(), opt), mesh,
            shard)
        state, metrics = step(state, batch)
        params = {n: p.detach().clone() for n, p in state.params.items()}
        both = [None, None]
        torch.distributed.all_gather_object(both, params)
        out[tag] = {"loss": metrics["loss"].item(),
                    "grad_norm": metrics["grad_norm"].item(),
                    "sharded_leaves": len(state.zero.chunks),
                    "params_equal_across_ranks": all(
                        torch.equal(both[0][n], both[1][n])
                        for n in params)}
        if rank == 0:
            torch.save(params, work / f"{tag}_params.pt")
            torch.save(seen, work / f"{tag}_grads.pt")
        return state, opt, mesh

    run("a", torch.float32, "adamw", [2, 1, 1], False)
    run("b_dp", torch.bfloat16, "adamw_bf16", [2, 1, 1], False)
    state, opt, mesh = run("b_fsdp", torch.bfloat16, "adamw_bf16",
                           [1, 2, 1], True)
    C.save_train_state(work / "ckpt_two", state)
    M.barrier("saved")
    # a one-process state: restored whole, cut, saved back by the ranks
    cfg = _port_config("adamw_bf16", True, [1, 2, 1])
    opt = make_optimizer(cfg)
    template = T.create_train_state(
        _tiny(torch.bfloat16, sd).trainable_params(), opt)
    C.restore_train_state(work / "ckpt_one", template)
    state = T.shard_train_state(template, mesh, True)
    C.save_train_state(work / "ckpt_back", state)
    M.barrier("saved back")
    return out


def _world_dryrun(work: Path) -> dict:
    from sdxl_training_improvements_tpu_torch.parallel import dryrun
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    return dryrun.dryrun_multichip(M.process_count(), "cpu",
                                   log=lambda *a: None)


def _trainer_config(work: Path, epochs: int, resume=None):
    from sdxl_training_improvements_tpu_torch.config import Config
    cfg = Config.from_dict({
        "model": {"model_type": "sdxl_tiny",
                  "pretrained_model_name": str(work / "none")},
        "optimizer": {"optimizer_type": "adamw", "learning_rate": 1e-4},
        "training": {"batch_size": 2, "mixed_precision": "no",
                     "num_epochs": epochs, "save_every": 0,
                     "save_best": False, "save_final_model": True,
                     "seed": 0, "resume_from": resume},
        "data": {"train_data_dir": [str(work / "imgs")], "image_size": 64},
        "tpu": {"mesh_shape": [1, 2, 1], "shard_params": True},
        "global_config": {
            "cache": {"cache_dir": str(work / "cache"),
                      "partitioned": True},
            "image": {"min_size": [32, 32], "max_size": [96, 96],
                      "bucket_step": 16},
            "logging": {"log_dir": str(work / "logs"), "log_every": 1}}})
    return cfg


def _world_trainer(work: Path) -> dict:
    from sdxl_training_improvements_tpu_torch.core.logging import (
        cleanup_logging)
    from sdxl_training_improvements_tpu_torch.training import validation as V
    from sdxl_training_improvements_tpu_torch.training.checkpoints import (
        flatten_train_state)
    from sdxl_training_improvements_tpu_torch.training.loop import (
        SDXLTrainer)
    rank = int(os.environ["SDXL_PROCESS_ID"])

    def trainer(name, epochs, resume=None):
        cleanup_logging()
        t = SDXLTrainer(_trainer_config(work, epochs, resume),
                        output_dir=str(work / name), device="cpu")
        t.prepare_data()
        return t

    a = trainer("out_a", 2)
    metrics = a.train()
    ds = a.dataset
    out = {"loss": metrics["loss"], "step": a.state.step,
           "sharded_leaves": len(a.state.zero.chunks),
           "cache_dir": str(ds.cache.cache_dir),
           "host_dirs": sorted(os.listdir(work / "cache")),
           "local_images": sum(len(v) for v in ds.bucket_indices.values()),
           "local_cached": sum(1 for idxs in ds.bucket_indices.values()
                               for i in idxs
                               if ds.cache.is_cached(ds.image_paths[i]))}
    trainer("out_b", 1).train()
    b = trainer("out_b", 2, resume="auto")
    out["resumed_step"] = b.state.step
    b.train()
    ta, _ = flatten_train_state(a.state)
    tb, _ = flatten_train_state(b.state)
    out["resume_equal"] = set(ta) == set(tb) and all(
        torch.equal(ta[k], tb[k]) for k in ta) and (
        a.state.generator.get_state().equal(b.state.generator.get_state()))
    # the validation loss, agreed over the ranks (tests/mp_worker.py)
    calls = {"n": 0}

    def fake_loss(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1 and rank == 1:
            raise RuntimeError("injected per-host validation failure")
        return 0.5 + 0.1 * rank

    V.validation_loss = fake_loss
    out["val_first_is_none"] = a.run_validation_loss(object()) is None
    out["val_second"] = a.run_validation_loss(object())
    # one cache entry lost on rank 1: the gate raises on both ranks
    if rank == 1:
        i = next(iter(ds.bucket_indices.values()))[0]
        ds.cache.index.pop(ds.cache.get_cache_key(ds.image_paths[i]))
    try:
        a.train()
        out["integrity_raised"] = False
    except RuntimeError as e:
        out["integrity_raised"] = True
        out["integrity_message"] = str(e)[:200]
    return out


WORLDS = {"steps": _world_steps, "dryrun": _world_dryrun,
          "trainer": _world_trainer}


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
