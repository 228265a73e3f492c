"""PyTorch port: the tensor axis (megatron splitting) and mesh serving.

* The TP plan (``parallel/mesh.py`` ``tp_plan``) over every leaf of the
  tiny UNet: where the port and JAX's ``spec_for_param`` both split a
  leaf, on the same dim; where the port keeps one whole that JAX splits,
  the attention's head count does not divide by the tensor size.
* Kernel #7's plain version through a slice's index map: a rank's slice
  of a column, row or GEGLU split, at T = 2 and 4, hash and rbg noise,
  in both memory layouts of a Linear weight, is bit-equal to the same
  elements of the whole leaf's update.
* Gloo worlds on the CPU (this file run as a script, one process a rank,
  as ``tests/test_torch_multiprocess.py`` starts them; both start
  together and JAX's mesh programs run in this process meanwhile):
  ``tp2`` (2 ranks) trains one step on mesh [1,1,2], saves and restores
  a state across meshes, runs ``SDXLTrainer`` there with a bit-equal
  resume, serves on [1,1,2] and [2,1,1] and runs
  ``generate.main(["--mesh", "1,1,2", ...])``; ``tp4`` (4 ranks) trains
  one step on [2,1,2].  JAX's four programs run in threads meanwhile.  The steps are held to JAX's ``make_train_step``
  on ``create_mesh`` of the same shape over the virtual devices and to
  the one-process port step at ``tests/test_torch_multiprocess.py``'s
  bars; the served images to JAX's ``SDXLPipeline(mesh=...)`` and to the
  meshless port at ``tests/test_torch_pipeline.py``'s (1e-3 of the
  largest magnitude; JAX's latents decoded by the port's VAE, the same
  weights).
"""
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch.ops import fused_adamw as F
from sdxl_training_improvements_tpu_torch.parallel import mesh as M

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_multiprocess as MP  # noqa: E402  (the step's helpers)

WORKER_TIMEOUT = 300
PROMPTS = ["a photo of a cat", "an oil painting of a lighthouse"]
COMPONENTS = ("unet", "vae", "clip_l", "clip_g")
SIZE, STEPS, SEED = 32, 2, 0
IMAGE_RTOL = 1e-3  # tests/test_torch_pipeline.py


# ------------------------------------------------------------ the plan

def _jax_specs(params, shape):
    """JAX's spec of each port leaf on mesh ``shape`` of virtual devices."""
    import jax

    from sdxl_training_improvements_tpu.parallel import mesh as JM
    from sdxl_training_improvements_tpu_torch.models.weights import (
        flax_path, jax_shape)
    n = int(np.prod(shape))
    mesh = JM.create_mesh(shape, devices=jax.devices()[:n])
    return {name: tuple(JM.spec_for_param(
        "/".join(flax_path(name, p.dim())), jax_shape(name, p.shape), mesh))
        for name, p in params.items()}


@pytest.mark.parametrize("head_dim,t", [(16, 2), (16, 4), (32, 4)])
def test_tp_plan_matches_jax_where_heads_divide(head_dim, t):
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import (
        UNetConfig, attention_heads)
    model = SDXLModel.create(
        tiny=True, dtype=torch.float32, device="cpu",
        unet_config=UNetConfig.tiny(attention_head_dim=head_dim))
    params = model.trainable_params()
    heads = attention_heads(model.unet)
    plan = M.tp_plan(params, {"data": 1, "fsdp": 1, "tensor": t}, heads,
                     rank=0)
    jax_specs = _jax_specs(params, [1, 1, t])
    kept = 0
    for name, p in params.items():
        jspec = jax_specs[name]
        jdim = jspec.index("tensor") if "tensor" in jspec else None
        if name in plan:
            assert plan[name].jax_dim == jdim, name
            want = M._torch_dim(name, p.dim(), jdim)
            assert plan[name].dim == want, name
            local = plan[name].local_shape()
            assert local[want] * t == p.shape[want], name
            continue
        if jdim is None:
            continue
        # JAX splits it and the port keeps it whole: an attention whose
        # heads do not divide by the tensor size
        attn = M._ATTN.match(name)
        assert attn is not None, name
        assert heads[attn.group(1)] % t, name
        kept += 1
    assert plan
    assert (kept > 0) == (head_dim == 32)  # 64 channels: 2 heads of 32
    glu = [n for n, s in plan.items() if s.glu]
    assert glu and all("ff.net.0.proj" in n for n in glu)


# ------------------------------------------------- #7 through the map

def _leaf(shape, transposed, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    if transposed:  # the JAX layout: [in, out] in memory
        x = x.t().contiguous().t()
    return x.to(dtype)


@pytest.mark.parametrize("noise", ["hash", "rbg"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("kind", ["column", "row", "geglu"])
@pytest.mark.parametrize("transposed", [False, True])
def test_strided_slice_updates_equal_the_whole_leaf(kind, t, noise,
                                                    transposed):
    shape = {"column": (128, 48), "row": (48, 128), "geglu": (256, 48)}[kind]
    p = _leaf(shape, transposed, 0) * 0.05
    like = torch.empty_strided(p.shape, p.stride(), device="meta")
    tensors = [p, _leaf(shape, transposed, 1, torch.float32) * 0.01,
               _leaf(shape, transposed, 2) * 0.01,
               (_leaf(shape, transposed, 3) * 1e-3).abs(),
               _leaf(shape, transposed, 4) * 1e-3]
    seeds = (0x9E3779B9, 12345)
    planes = F.draw_planes(p.numel(), torch.Generator().manual_seed(5))
    hp = dict(lr_eff=1e-3, decay_amt=0.007, seed0=seeds[0], seed1=seeds[1])
    whole = F.fused_adamw_reference(
        *tensors, **hp, planes=planes if noise == "rbg" else None)
    dim = 0 if kind in ("column", "geglu") else 1
    for r in range(t):
        split = M.TPSplit(dim=dim, jax_dim=1 - dim, size=t, rank=r,
                          glu=kind == "geglu", like=like)
        imap = split.index_map()
        # contiguous where the split dim is outermost in memory, and
        # never for the GEGLU's two halves
        assert imap.contiguous == (kind != "geglu"
                                   and transposed == (kind == "row"))
        local = [split.cut(x) for x in tensors]
        n = local[0].numel()
        mine = None
        if noise == "rbg":  # the whole leaf's planes through the map
            mine = planes[:, imap.indices(0, n)]
        got = F.fused_adamw_reference(*local, **hp, planes=mine, imap=imap)
        for out, ref in zip(got, whole):
            assert torch.equal(out, split.cut(ref)), (kind, t, r)
        # a chunk of the slice from an element base on
        half = n // 2
        flat = [F.memory_order(x)[half:] for x in local]
        chunk = F.fused_adamw_reference(
            *flat, **hp, base=half, imap=imap,
            planes=None if mine is None else mine[:, half:].contiguous())
        for out, ref in zip(chunk, got):
            assert torch.equal(out, F.memory_order(ref)[half:])


# ------------------------------------------------------------ the worlds

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World(MP.World):
    """``tests/test_torch_multiprocess.py``'s world, running this file."""

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


def _jax_model():
    import jax
    import jax.numpy as jnp

    from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JM
    return JM.create(tiny=True, dtype=jnp.float32,
                     init_rng=jax.random.key(0),
                     init_components=COMPONENTS)


def _port_serving_model(sd):
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    for c in COMPONENTS:
        getattr(model, c).load_state_dict(sd[c], strict=True)
    return model


def _noise():
    import jax
    import jax.numpy as jnp
    return np.array(jax.random.normal(
        jax.random.key(SEED), (len(PROMPTS), 4, SIZE // 2, SIZE // 2),
        jnp.float32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Write the worlds' inputs and start them, then JAX's programs; yield
    what the tests read."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tp")
    two, four = root / "tp2", root / "tp4"
    for d in (two, four):
        d.mkdir()
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.unet.state_dict().items()}
    batch = MP._batch(4, 12)
    for d in (two, four):
        torch.save(sd, d / "unet.pt")
        np.savez(d / "batch.npz", **batch)
    # a one-process bf16 state, for the ranks to cut and save back
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, _ = MP._one_process_step(MP._tiny(torch.bfloat16, sd),
                                    MP._port_config("adamw_bf16"), tbatch)
    C.save_train_state(two / "ckpt_one", state)
    MP._images(two)  # the trainer's PNGs
    running = {"tp2": World("tp2", 2, two), "tp4": World("tp4", 4, four)}
    # JAX's programs compile and run in threads (XLA releases the GIL)
    # while the worlds run; the serving weights come from JAX's tiny model,
    # so the worlds' serving waits for them (``_serving_inputs``)
    pool = ThreadPoolExecutor(4)
    jax_runs = {("step", 1, 1, 2): pool.submit(_jax_mesh_step, sd, batch,
                                               [1, 1, 2]),
                ("step", 2, 1, 2): pool.submit(_jax_mesh_step, sd, batch,
                                               [2, 1, 2])}
    inputs = pool.submit(_serving_inputs, two)
    for shape in ([1, 1, 2], [2, 1, 1]):
        jax_runs[("serve", *shape)] = pool.submit(
            lambda shape=shape: _jax_latents(inputs.result()[0], shape))
    yield {"worlds": running, "sd": sd, "batch": batch, "two": two,
           "four": four, "serving": inputs, "jax": jax_runs}
    pool.shutdown(cancel_futures=True)
    for w in running.values():
        for p in w.procs:
            if p.poll() is None:
                p.kill()
    torch.set_num_threads(n)


def _serving_inputs(two: Path):
    """(JAX's tiny model, its weights in the port's keys), the weights,
    the noise and a checkpoint for ``generate`` written into ``two``,
    each renamed into place when complete."""
    import jax

    from sdxl_training_improvements_tpu_torch.models.weights import (
        from_jax_params)
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    jmodel = _jax_model()
    serve = {c: from_jax_params(jax.tree_util.tree_map(
        np.asarray, jmodel.params[c]), clip=c.startswith("clip"))
        for c in COMPONENTS}
    smodel = _port_serving_model(serve)
    C.export_diffusers(two / "export.tmp", C.components(smodel),
                       unet_config=smodel.unet_config)
    os.replace(two / "export.tmp", two / "export")
    np.save(two / "noise.tmp.npy", _noise())
    os.replace(two / "noise.tmp.npy", two / "noise.npy")
    torch.save(serve, two / "serve.tmp")
    os.replace(two / "serve.tmp", two / "serve.pt")
    return jmodel, serve


def _wait_for(path: Path) -> Path:
    """``path`` once the parent has renamed it into place."""
    start = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - start > WORKER_TIMEOUT:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)
    return path


def _jax_latents(jmodel, shape):
    """JAX's pipeline on mesh ``shape`` of virtual devices: the latents."""
    import jax

    from sdxl_training_improvements_tpu.parallel import mesh as JMesh
    from sdxl_training_improvements_tpu.pipelines import SDXLPipeline as JP
    jmesh = JMesh.create_mesh(shape, devices=jax.devices()[:2])
    return np.array(JP.from_model(jmodel, mesh=jmesh)(
        PROMPTS, return_latents=True, height=SIZE, width=SIZE,
        num_inference_steps=STEPS, guidance_scale=5.0, seed=SEED))


def _jax_mesh_step(sd, batch, shape):
    """JAX's metrics, the gradient its optimizer received and the
    parameters after one step on mesh ``shape`` of virtual devices."""
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
    mesh = JMesh.create_mesh(shape, devices=jax.devices()[:int(
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
        JT.create_train_state(jmodel.trainable_params(), opt), mesh)
    state, metrics = step(state, JT.shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    host = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t))
    return ({k: float(metrics[k]) for k in ("loss", "grad_norm")},
            host(state.opt_state[1]), host(state.params))


@pytest.mark.parametrize("shape", [[1, 1, 2], [2, 1, 2]])
def test_tensor_parallel_step_matches_jax_and_one_process(worlds, shape):
    sd, batch = worlds["sd"], worlds["batch"]
    jax_metrics, jax_grads, jax_params = worlds["jax"][
        ("step", *shape)].result()
    grads = {}
    state, metrics = MP._one_process_step(
        MP._tiny(torch.float32, sd), MP._port_config("adamw"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, grads)
    name = "tp2" if shape == [1, 1, 2] else "tp4"
    res = worlds["worlds"][name].results()
    out = worlds["two" if name == "tp2" else "four"]
    ranks = torch.load(out / "a_params.pt")
    got = torch.load(out / "a_grads.pt")
    assert all(r["a"] == res[0]["a"] for r in res)  # every rank agrees
    assert res[0]["a"]["split_leaves"] > 0
    assert all(r["a"]["params_equal_across_ranks"] for r in res)
    one = {n: p.detach() for n, p in state.params.items()}
    total = sum(p.numel() for p in one.values())
    for what, ref_metrics, ref_grads, ref_params in (
            ("JAX mesh step", jax_metrics, jax_grads, jax_params),
            ("one-process step", {k: v.item() for k, v in metrics.items()},
             grads, one)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[0]["a"][k], ref_metrics[k],
                                       rtol=MP.RTOL, err_msg=f"{what} {k}")
        MP._close_grads(got, ref_grads, what)
        assert MP._close_params(ranks, ref_params, ref_grads, what) \
            >= 0.99 * total


def test_checkpoint_across_meshes(worlds):
    """A state the two ranks saved at [1,1,2] restores in one process and
    cuts back to each rank's pieces ``torch.equal``; a one-process state
    restored on the ranks and saved back is ``torch.equal`` to itself."""
    from sdxl_training_improvements_tpu_torch.models import weights as W
    from sdxl_training_improvements_tpu_torch.models.unet import (
        attention_heads)
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    res = worlds["worlds"]["tp2"].results()
    two = worlds["two"]
    cfg = MP._port_config("adamw_bf16")
    model = MP._tiny(torch.bfloat16, worlds["sd"])
    template = T.create_train_state(model.trainable_params(),
                                    make_optimizer(cfg))
    restored = C.restore_train_state(two / "ckpt_two", template)
    assert restored.step == 1
    flat, _ = C.flatten_train_state(restored)
    sizes = {"data": 1, "fsdp": 1, "tensor": 2}
    heads = attention_heads(model.unet)
    for r in range(2):
        plan = M.tp_plan(model.trainable_params(), sizes, heads, rank=r)
        assert plan and res[r]["b"]["split_leaves"] == len(plan)
        local = torch.load(two / f"b_local{r}.pt")
        assert set(local) == set(flat)
        for key, t in flat.items():
            name = key.split(".", 1)[1]
            if key.startswith("opt."):  # opt.<field>.<name>[.q|.s]
                name = name.split(".", 1)[1]
                if name.endswith((".q", ".s")):
                    name = name[:-2]
            ref = plan[name].cut(t) if name in plan and t.dim() else t
            assert torch.equal(local[key], ref), (r, key)
    one = W.read_safetensors(two / "ckpt_one" / "state" / C.STATE_TENSORS)
    back = W.read_safetensors(two / "ckpt_back" / "state" / C.STATE_TENSORS)
    assert set(one) == set(back)
    for k in one:
        assert torch.equal(one[k], back[k]), k
    assert json.loads((two / "ckpt_one" / "state" / C.STATE_META
                       ).read_text()) == json.loads(
        (two / "ckpt_back" / "state" / C.STATE_META).read_text())


@pytest.mark.parametrize("shape", [[1, 1, 2], [2, 1, 1]])
def test_mesh_serving_matches_jax_and_meshless(worlds, shape):
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    kw = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
              guidance_scale=5.0, seed=SEED)
    j_lat = worlds["jax"][("serve", *shape)].result()
    pipe = SDXLPipeline.from_model(
        _port_serving_model(worlds["serving"].result()[1]))
    with torch.inference_mode():  # JAX's latents through the same decoder
        jax_img = pipe.model.decode_latents(
            torch.from_numpy(np.array(j_lat))).numpy()
    lat = pipe(PROMPTS, noise=torch.from_numpy(_noise()),
               return_latents=True, **kw)
    with torch.inference_mode():
        meshless = pipe.model.decode_latents(lat).numpy()
    worlds["worlds"]["tp2"].results()
    tag = "".join(map(str, shape))
    mesh_lat = torch.load(worlds["two"] / f"serve_{tag}.pt")
    with torch.inference_mode():
        got = pipe.model.decode_latents(mesh_lat).numpy()
    assert got.shape == jax_img.shape == (2, 3, SIZE, SIZE)
    for ref in (jax_img, meshless):
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= IMAGE_RTOL, err


def test_trainer_over_a_tensor_axis(worlds):
    """``SDXLTrainer`` on mesh [1,1,2]: a resume ``torch.equal`` to the
    uninterrupted run on each rank, the exported UNet the one-card
    weights, the validation images sampled on both ranks and written by
    rank 0 alone."""
    res = worlds["worlds"]["tp2"].results()
    for out in (r["trainer"] for r in res):
        assert out["step"] == 4 and out["split_leaves"] > 0
        assert out["resume_equal"] and out["export_is_whole"]
        assert out["images"] == ["out_a/validation-000004/00.png"]
    assert res[0]["trainer"]["loss"] == res[1]["trainer"]["loss"]


def test_generate_main_over_a_mesh(worlds, tmp_path):
    from sdxl_training_improvements_tpu_torch import generate, png
    res = worlds["worlds"]["tp2"].results()
    assert res[0]["generate_rc"] == res[1]["generate_rc"] == 0
    out = worlds["two"] / "samples"
    assert sorted(p.name for p in out.iterdir()) == ["000.png"]
    assert not (worlds["two"] / "samples_rank1").exists()
    common = ["--model", str(worlds["two"] / "export"), "--prompt",
              PROMPTS[0], "--height", str(SIZE), "--width", str(SIZE),
              "--steps", str(STEPS), "--device", "cpu", "--tiny", "--out",
              str(tmp_path)]
    assert generate.main(common) == 0
    ours = png.read_png(out / "000.png").astype(int)
    ref = png.read_png(tmp_path / "000.png").astype(int)
    assert ours.shape == ref.shape == (SIZE, SIZE, 3)
    # the CLI's tiny UNet is bf16: the megatron sums round otherwise than
    # the one-card products, and 2 Euler steps from sigma = 20000 amplify
    # that (tests/test_torch_pipeline.py), so the images agree as a whole
    # (the fp32 comparison above holds the values)
    assert np.corrcoef(ours.ravel(), ref.ravel())[0, 1] >= 0.99
    # a mesh that names more ranks than the process has
    with pytest.raises(SystemExit, match="torchrun"):
        generate.main(common + ["--mesh", "1,1,2"])


# ------------------------------------------------------------ the ranks

def _world_steps(work: Path, shape) -> dict:
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    rank = M.process_index()
    sd = torch.load(work / "unet.pt")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(work / "batch.npz").items()}
    cfg = MP._port_config("adamw", False, shape)
    model = MP._tiny(torch.float32, sd)
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
        unet=model.unet)
    state, metrics = step(state, batch)
    params = state.zero.whole_params(state.params)
    every = [None] * M.process_count()
    torch.distributed.all_gather_object(every, params)
    out = {"loss": metrics["loss"].item(),
           "grad_norm": metrics["grad_norm"].item(),
           "split_leaves": len(state.zero.tp),
           "params_equal_across_ranks": all(
               torch.equal(e[n], params[n]) for e in every for n in params)}
    if rank == 0:
        torch.save({n: p.detach() for n, p in params.items()},
                   work / "a_params.pt")
        torch.save(seen, work / "a_grads.pt")
    return out


def _world_checkpoints(work: Path) -> dict:
    """(b): a bf16 step at [1,1,2] saved; each rank's pieces kept; a
    one-process state cut and saved back."""
    from sdxl_training_improvements_tpu_torch.training import checkpoints as C
    from sdxl_training_improvements_tpu_torch.training import trainer as T
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    shape = [1, 1, 2]
    sd = torch.load(work / "unet.pt")
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(work / "batch.npz").items()}
    cfg = MP._port_config("adamw_bf16", False, shape)
    model = MP._tiny(torch.bfloat16, sd)
    mesh = M.create_mesh(shape, device_type="cpu")
    opt = make_optimizer(cfg)
    step = T.make_train_step(model.unet_apply,
                             NoiseSchedule.from_config(cfg), opt, cfg,
                             mesh=mesh)
    state = T.shard_train_state(
        T.create_train_state(model.trainable_params(), opt), mesh,
        unet=model.unet)
    state, _ = step(state, batch)
    C.save_train_state(work / "ckpt_two", state)
    local, _ = C.flatten_train_state(state)
    torch.save({k: v.detach().clone() for k, v in local.items()},
               work / f"b_local{M.process_index()}.pt")
    M.barrier("saved")
    model = MP._tiny(torch.bfloat16, sd)
    template = T.create_train_state(model.trainable_params(),
                                    make_optimizer(cfg))
    C.restore_train_state(work / "ckpt_one", template)
    back = T.shard_train_state(template, mesh, unet=model.unet)
    C.save_train_state(work / "ckpt_back", back)
    M.barrier("saved back")
    return {"split_leaves": len(state.zero.tp)}


def _world_serving(work: Path, shape) -> None:
    from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
    mesh = M.create_mesh(shape, device_type="cpu")
    pipe = SDXLPipeline.from_model(
        _port_serving_model(torch.load(_wait_for(work / "serve.pt"))),
        mesh=mesh)
    lat = pipe(PROMPTS, noise=torch.from_numpy(np.load(work / "noise.npy")),
               height=SIZE, width=SIZE, num_inference_steps=STEPS,
               guidance_scale=5.0, seed=SEED, return_latents=True)
    if M.process_index() == 0:
        torch.save(lat, work / f"serve_{''.join(map(str, shape))}.pt")


def _world_trainer(work: Path) -> dict:
    """``SDXLTrainer`` on [1,1,2] (``tests/test_torch_multiprocess.py``'s
    recipe): run A 2 epochs, a checkpoint and the validation images after
    the second; run B 1 epoch with the final checkpoint, then
    ``resume_from: auto`` to 2 epochs, ``torch.equal`` to run A."""
    from sdxl_training_improvements_tpu_torch.core.logging import (
        cleanup_logging)
    from sdxl_training_improvements_tpu_torch.models import weights as W
    from sdxl_training_improvements_tpu_torch.training.checkpoints import (
        UNET_FILE, flatten_train_state)
    from sdxl_training_improvements_tpu_torch.training.loop import (
        SDXLTrainer)

    def trainer(name, epochs, resume=None, **training):
        cleanup_logging()
        cfg = MP._trainer_config(work, epochs, resume)
        cfg.tpu.mesh_shape = [1, 1, 2]
        for k, v in training.items():
            setattr(cfg.training, k, v)
        if training.get("save_every"):
            cfg.data.validation_prompts = ["a cat"]
        t = SDXLTrainer(cfg, output_dir=str(work / name), device="cpu")
        t.prepare_data()
        return t

    a = trainer("out_a", 2, save_every=2, num_inference_steps=2)
    metrics = a.train()
    trainer("out_b", 1).train()
    b = trainer("out_b", 2, resume="auto")
    b.train()
    ta, _ = flatten_train_state(a.state)
    tb, _ = flatten_train_state(b.state)
    export = W.read_safetensors(work / "out_a" / "checkpoint-0001"
                                / UNET_FILE)
    whole = a.state.zero.whole_params(a.state.params)
    return {"loss": metrics["loss"], "step": a.state.step,
            "split_leaves": len(a.state.zero.tp),
            "resume_equal": set(ta) == set(tb) and all(
                torch.equal(ta[k], tb[k]) for k in ta),
            "export_is_whole": all(torch.equal(export[n], p.detach())
                                   for n, p in whole.items()),
            "images": sorted(str(q.relative_to(work)) for q in
                             (work / "out_a").glob("validation-*/*.png"))}


def _world_tp2(work: Path) -> dict:
    from sdxl_training_improvements_tpu_torch import generate
    out = {"a": _world_steps(work, [1, 1, 2]),
           "b": _world_checkpoints(work),
           "trainer": _world_trainer(work)}
    for shape in ([1, 1, 2], [2, 1, 1]):
        _world_serving(work, shape)
    rank = M.process_index()
    _wait_for(work / "export")
    out["generate_rc"] = generate.main([
        "--model", str(work / "export"), "--prompt", PROMPTS[0],
        "--height", str(SIZE), "--width", str(SIZE), "--steps", str(STEPS),
        "--device", "cpu", "--tiny", "--mesh", "1,1,2",
        "--out", str(work / ("samples" if rank == 0 else "samples_rank1"))])
    return out


def _world_tp4(work: Path) -> dict:
    return {"a": _world_steps(work, [2, 1, 2])}


WORLDS = {"tp2": _world_tp2, "tp4": _world_tp4}


if __name__ == "__main__":
    torch.set_num_threads(1)
    M.initialize_multihost("cpu")
    work = Path(sys.argv[2])
    result = WORLDS[sys.argv[1]](work)
    (work / f"result{M.process_index()}.json").write_text(json.dumps(result))
    M.barrier("done")
    torch.distributed.destroy_process_group()
