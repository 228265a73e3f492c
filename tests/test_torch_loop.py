"""PyTorch port: the training entry point on the CPU, against the JAX package.

* ``validation_loss`` matches the JAX package's on the tiny fp32 model
  holding the flax module's parameters, over one cache read by both
  packages, with the same replayed noise and timesteps (the batch's
  ``noise`` / ``timesteps``): rtol 2e-4 / atol 2e-5
  (``tests/test_weight_parity.py``).
* ``main.main([... "--device", "cpu"])`` on a tiny config over seeded
  PNGs: the loss is finite and the parameters change; ``checkpoint-*``,
  ``best_checkpoint``, ``final_checkpoint/state``, ``trainer_state.json``,
  validation images and a diffusers export that
  ``SDXLPipeline.from_pretrained`` loads all exist; the held-out loss is
  logged.
* Resume: a run of one epoch continued with ``--resume`` to two is
  ``torch.equal`` to the uninterrupted run in every parameter and
  optimizer-state tensor, its step and its generators; completed epochs
  are not replayed (JAX ``tests/test_loop.py::test_resume_continues``);
  an explicit ``--resume`` path without ``state/`` raises.
* A refiner checkpoint fine-tunes and re-exports its layout; the
  refusals raise: an inpainting checkpoint, a mesh of more ranks than
  the process has, ``--device cuda`` without a card; LoRA, refused
  before it was ported, builds.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.data import cache as JCa
from sdxl_training_improvements_tpu.data import dataset as JD
from sdxl_training_improvements_tpu.main import build_parser as jax_parser
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.training import schedules as JS
from sdxl_training_improvements_tpu.training import validation as JV
from sdxl_training_improvements_tpu_torch import _yaml
from sdxl_training_improvements_tpu_torch import main as entry
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.data import cache as TCa
from sdxl_training_improvements_tpu_torch.data import dataset as TD
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training import loop
from sdxl_training_improvements_tpu_torch.training import schedules as TS
from sdxl_training_improvements_tpu_torch.training import validation as TV

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-4, 2e-5
IMAGE = {"min_size": [32, 32], "max_size": [96, 96], "bucket_step": 16}
REFINER = dict(num_time_ids=5, cross_attention_dim=32,
               projection_class_embeddings_input_dim=32 + 5 * 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: with six
    xdist workers each spinning a pool the size of the host, the tiny
    model's steps ran ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ validation loss
def _replayed(ds):
    """``ds.get_batch`` with noise and timesteps drawn from the batch's
    indices, the same in both packages."""
    get = ds.get_batch

    def get_batch(indices, **kw):
        batch = get(indices, **kw)
        rng = np.random.default_rng(sum(indices))
        batch["noise"] = rng.standard_normal(
            batch["vae_latents"].shape).astype(np.float32)
        batch["timesteps"] = rng.integers(0, 1000, len(indices))
        return batch

    ds.get_batch = get_batch
    return ds


def test_validation_loss_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths = [str(tmp_path / f"v{i}.png") for i in range(6)]
    cm = JCa.CacheManager(tmp_path / "cache")
    for i, p in enumerate(paths):
        hw = (16, 16)
        cm.save_latents(
            cm.get_cache_key(p),
            vae_latents=rng.standard_normal((4, *hw)).astype(np.float32),
            time_ids=np.asarray([128, 128, 0, 0, 128, 128], np.float32),
            prompt_embeds=rng.standard_normal((77, 64)).astype(np.float32),
            pooled_prompt_embeds=rng.standard_normal(32).astype(np.float32),
            metadata={"original_size": [hw[0] * 8, hw[1] * 8]})
    cm.flush()
    raw = {"training": {"batch_size": 2, "seed": 5},
           "global_config": {"image": {"min_size": [64, 64],
                                       "max_size": [256, 256]}}}
    jcfg, tcfg = JConfig.from_dict(raw), Config.from_dict(raw)
    captions = [""] * len(paths)
    jds = _replayed(JD.AspectBucketDataset(
        jcfg, paths, captions, JCa.CacheManager(tmp_path / "cache")))
    tds = _replayed(TD.AspectBucketDataset(
        tcfg, paths, captions, TCa.CacheManager(tmp_path / "cache")))
    assert len(tds.bucket_indices) == 1

    jmodel = JModel.create(tiny=True, dtype=jnp.float32,
                           init_rng=jax.random.key(3),
                           init_components=("unet",))
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    model.unet.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, jmodel.params["unet"])), strict=True)
    ref = JV.validation_loss(jmodel.unet_apply, jmodel.params["unet"], jds,
                             JS.NoiseSchedule.from_config(jcfg), jcfg,
                             key=jax.random.key(1))
    ours = TV.validation_loss(model.unet_apply, tds,
                              TS.NoiseSchedule.from_config(tcfg), tcfg,
                              seed=1, device="cpu")
    assert ref is not None and np.isfinite(ours)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- entry point
def _images(root, n=4):
    rng = np.random.default_rng(1)
    d = root / "imgs"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(d / f"i{i}.png")
        (d / f"i{i}.txt").write_text(f"masterpiece, tag{i % 2}, cat")
    return d


def _config(root, name, img, **training):
    raw = {"model": {"model_type": "sdxl_tiny",
                     "pretrained_model_name": str(root / "none")},
           "optimizer": {"optimizer_type": "adamw", "learning_rate": 1e-4},
           "training": {"batch_size": 2, "mixed_precision": "no",
                        "num_inference_steps": 2, **training},
           "data": {"train_data_dir": [str(img)], "image_size": 64},
           "global_config": {
               "cache": {"cache_dir": str(root / "cache")},
               "image": IMAGE,
               "logging": {"log_dir": str(root / "logs"), "log_every": 1}},
           "tag_weighting": {"enable_tag_weighting": True}}
    path = root / f"{name}.yaml"
    path.write_text(_yaml.dump(raw))
    return str(path)


def _run(argv):
    """``main.main(argv)``; returns the trainer it built."""
    trainers = []
    init = loop.SDXLTrainer.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    loop.SDXLTrainer.__init__ = recording_init
    try:
        assert entry.main(argv) == 0
    finally:
        loop.SDXLTrainer.__init__ = init
    return trainers[0]


def _snapshot(state):
    tensors, meta = C.flatten_train_state(state)
    return {k: v.detach().clone() for k, v in tensors.items()}, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A: 2 epochs uninterrupted, with a checkpoint every epoch.  Run
    B: 1 epoch with the final checkpoint, then ``--resume`` to 2 epochs."""
    root = tmp_path_factory.mktemp("entry")
    img = _images(root)
    seeded = SDXLModel.from_config(Config.from_yaml(
        _config(root, "seed", img)), device="cpu",
        generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone()
            for k, v in seeded.trainable_params().items()}
    a = _run(["--config", _config(root, "a", img, num_epochs=2,
                                  save_every=1),
              "--output-dir", str(root / "a"), "--device", "cpu"])
    ref = _snapshot(a.state)
    b1 = _config(root, "b1", img, num_epochs=1, save_every=0,
                 save_best=False)
    _run(["--config", b1, "--output-dir", str(root / "b"), "--device",
          "cpu"])
    b2 = _config(root, "b2", img, num_epochs=2, save_every=0,
                 save_best=False, save_final_model=False)
    b = _run(["--config", b2, "--output-dir", str(root / "b"), "--device",
              "cpu", "--resume"])
    return dict(root=root, img=img, init=init, a=a, ref=ref,
                got=_snapshot(b.state), b1=b1)


def test_entry_point_trains_and_checkpoints(runs):
    root, a = runs["root"], runs["a"]
    assert a.state.step == 4
    changed = [k for k, v in runs["init"].items()
               if not torch.equal(v, a.state.params[k].detach())]
    assert len(changed) > len(runs["init"]) // 2
    out = root / "a"
    names = sorted(p.name for p in out.iterdir())
    assert names == ["best_checkpoint", "checkpoint-0000", "checkpoint-0001",
                     "final_checkpoint"]
    final = out / "final_checkpoint"
    assert (final / "state" / C.STATE_TENSORS).exists()
    meta = json.loads((final / "trainer_state.json").read_text())
    assert meta["step"] == 4 and np.isfinite(meta["best_loss"])
    assert Config.from_dict(json.loads((final / "config.json").read_text())
                            ).training.num_epochs == 2
    pipe = SDXLPipeline.from_pretrained(final, tiny=True, device="cpu",
                                        dtype=torch.float32)
    for k, v in pipe.model.unet.state_dict().items():
        assert torch.equal(v, a.model.unet.state_dict()[k]), k
    lines = (root / "logs" / "training.log").read_text().splitlines()
    losses = [json.loads(ln.split("metrics step=", 1)[1].split(" ", 1)[1])
              ["loss"] for ln in lines if "metrics step=" in ln
              and '"loss"' in ln]
    assert len(losses) >= 4 and np.isfinite(losses).all()


def test_validation_loss_and_images_in_the_loop(tmp_path):
    img = _images(tmp_path)
    cfg = Config.from_yaml(_config(tmp_path, "v", img, num_epochs=1,
                                   save_every=1, save_final_model=False))
    cfg.data.validation_data_dir = str(img)
    cfg.data.validation_prompts = ["a cat"]
    trainer = loop.SDXLTrainer(cfg, output_dir=str(tmp_path / "out"),
                               device="cpu")
    trainer.prepare_data()
    trainer.train()
    assert (tmp_path / "cache" / "validation").exists()
    shot = tmp_path / "out" / "validation-000002" / "00.png"
    assert shot.exists()
    assert np.asarray(Image.open(shot)).shape == (64, 64, 3)
    vals = trainer.logger.metrics.get_average("val/loss")
    assert vals is not None and np.isfinite(vals)


def test_resume_is_bit_equal_to_the_uninterrupted_run(runs):
    (ref, ref_meta), (got, meta) = runs["ref"], runs["got"]
    assert meta == ref_meta and meta["step"] == 4
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_completed_epochs_are_not_replayed(runs):
    root = runs["root"]
    cfg = Config.from_yaml(runs["b1"])
    cfg.training.resume_from = "auto"
    trainer = loop.SDXLTrainer(cfg, output_dir=str(root / "b"), device="cpu")
    assert trainer.state.step == 2  # run B's final checkpoint
    trainer.train(num_epochs=1)
    assert trainer.state.step == 2
    trainer.train(num_epochs=2)
    assert trainer.state.step == 4


def test_explicit_resume_without_state_raises(runs, tmp_path):
    with pytest.raises(FileNotFoundError, match="no 'state'"):
        entry.main(["--config", runs["b1"], "--output-dir",
                    str(tmp_path / "x"), "--device", "cpu", "--resume",
                    str(tmp_path)])


def test_deterministic_convolutions_are_scoped(monkeypatch):
    """cuDNN's flags are set for a card's body and restored after it,
    also when the body raises; the CPU leaves them alone."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    with loop.deterministic_convolutions(torch.device("cpu")):
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    with pytest.raises(RuntimeError, match="body"):
        with loop.deterministic_convolutions(torch.device("cuda")):
            assert (cudnn.deterministic, cudnn.benchmark) == (True, False)
            raise RuntimeError("body")
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)


def test_parser_is_jax_plus_device():
    ours, theirs = entry.build_parser(), jax_parser()
    a = vars(ours.parse_args(["--resume"]))
    assert a.pop("device") == "cuda"
    assert a == vars(theirs.parse_args(["--resume"]))
    assert ours.parse_args([]).resume is None


def _export(root, ucfg, refiner):
    from sdxl_training_improvements_tpu_torch.training.checkpoints import (
        components, export_diffusers)
    m = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                         unet_config=ucfg, refiner=refiner,
                         generator=torch.Generator().manual_seed(5))
    ckpt = root / ("refiner" if refiner else "inpaint")
    export_diffusers(ckpt, components(m), Config(), unet_config=ucfg)
    return ckpt


def test_refiner_checkpoint_finetunes(tmp_path):
    img = _images(tmp_path)
    cfg = Config.from_yaml(_config(tmp_path, "r", img, num_epochs=1,
                                   save_every=0, save_best=False))
    cfg.model.pretrained_model_name = str(_export(
        tmp_path, UNetConfig.tiny(**REFINER), refiner=True))
    trainer = loop.SDXLTrainer(cfg, output_dir=str(tmp_path / "out"),
                               device="cpu")
    assert trainer.model.clip_l is None
    assert trainer.model.imported == {"unet", "vae", "clip_g"}
    assert trainer.model.unet_config.num_time_ids == 5
    trainer.prepare_data()
    metrics = trainer.train()
    assert np.isfinite(metrics["loss"])
    final = tmp_path / "out" / "final_checkpoint"
    assert (final / "text_encoder_2").exists()
    assert not (final / "text_encoder").exists()
    raw = json.loads((final / "unet" / "config.json").read_text())
    assert raw["projection_class_embeddings_input_dim"] == 32 + 5 * 8


@pytest.mark.parametrize("case", ["inpainting", "lora", "mesh", "cuda"])
def test_refusals(tmp_path, case, monkeypatch):
    cfg = Config.from_dict({"model": {"model_type": "sdxl_tiny",
                                      "pretrained_model_name": "none"},
                            "global_config": {"logging": {
                                "log_dir": str(tmp_path / "logs")}}})
    device, error, match = "cpu", NotImplementedError, None
    if case == "inpainting":
        cfg.model.pretrained_model_name = str(_export(
            tmp_path, UNetConfig.tiny(in_channels=9), refiner=False))
        error, match = ValueError, "inpainting"
    elif case == "lora":
        # refused until LoRA was ported: now the trainer builds, with the
        # pairs as the trainable tree and the UNet frozen
        cfg.training.lora.enabled = True
        trainer = loop.SDXLTrainer(cfg, output_dir=str(tmp_path / "o"),
                                   device=device)
        assert set(trainer.state.params) == {
            f"{n}.{half}" for n in trainer.lora_apply.adapter.modules
            for half in ("down", "up")}
        assert not any(p.requires_grad
                       for p in trainer.model.unet.parameters())
        return
    elif case == "mesh":
        # every mesh axis trains now (tests/test_torch_multiprocess.py,
        # tests/test_torch_tensor_parallel.py); a shape of two ranks in
        # one process does not cover the world: JAX's error
        cfg.tpu.mesh_shape = [1, 1, 2]
        error, match = ValueError, "does not cover 1 devices"
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        device, error, match = "cuda", RuntimeError, "is_available"
    with pytest.raises(error, match=match):
        loop.SDXLTrainer(cfg, output_dir=str(tmp_path / "o"), device=device)


def test_entry_point_imports_no_jax_yaml_or_pil(tmp_path):
    """``main.main`` trains and checkpoints in a process that never
    imports jax, yaml, PIL or the JAX package (the card's machine has
    none of them)."""
    img = _images(tmp_path)
    cfg = _config(tmp_path, "c", img, num_epochs=1, save_every=0)
    script = textwrap.dedent(f"""
        import sys
        from sdxl_training_improvements_tpu_torch import main
        assert main.main(["--config", {cfg!r}, "--output-dir",
                          {str(tmp_path / "out")!r}, "--device", "cpu"]) == 0
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "yaml", "PIL",
                      "sdxl_training_improvements_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert (tmp_path / "out" / "final_checkpoint" / "state").exists()
