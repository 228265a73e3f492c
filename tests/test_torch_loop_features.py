"""PyTorch port: the trainer with LoRA, EMA, schedule-free, SOAP and int8
moments, on the CPU.

* LoRA + EMA against the JAX ``SDXLTrainer``: both train the same seeded
  tiny fp32 UNet (the flax module holds the port's weights) from the same
  LoRA tree (``from_jax_lora``) over one cache read by both packages, the
  batches replaying the same noise and timesteps: every step's loss at
  rtol 2e-4 (the bar of ``tests/test_torch_loop.py``; the losses are
  ~1e-6, so no atol), the trained pairs and the EMA shadow at rtol 2e-4 /
  atol 2e-5 (``tests/test_weight_parity.py``).  Schedule-free, SOAP and
  int8 moments against JAX's trainer: ``tests/test_torch_loop_optimizers.py``.
* ``main.main --device cpu`` with each of LoRA + EMA, schedule-free, SOAP
  and int8 moments (a bf16 UNet): 2 epochs uninterrupted against 1 epoch
  with the final checkpoint, then ``--resume``: every tensor (EMA's inner
  state and count, z and the compensation, SOAP's matrices with their
  (0, 0) placeholders, the int8 codes and scales), the step and the
  generators ``torch.equal``; the weights evaluated and exported are the
  EMA shadow, schedule-free's x, the merged LoRA.
* ``example_method`` (the extension template) trains for 2 steps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.data import cache as JCa
from sdxl_training_improvements_tpu.data import dataset as JD
from sdxl_training_improvements_tpu.models import weights as JW
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.training import loop as JLoop
from sdxl_training_improvements_tpu_torch import _yaml
from sdxl_training_improvements_tpu_torch import main as entry
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.data import cache as TCa
from sdxl_training_improvements_tpu_torch.data import dataset as TD
from sdxl_training_improvements_tpu_torch.models import lora as TL
from sdxl_training_improvements_tpu_torch.models import weights as W
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.weights import from_jax_lora
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training import loop
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    EMAState, ScheduleFreeKahanState, SOAPState,
    schedule_free_eval_params)

RTOL, ATOL = 2e-4, 2e-5
IMAGE = {"min_size": [32, 32], "max_size": [96, 96], "bucket_step": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: with six
    xdist workers each spinning a pool the size of the host, the tiny
    model's steps ran ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------- LoRA + EMA against JAX's trainer
def _replayed(ds):
    """``ds.get_batch`` with noise and timesteps drawn from the batch's
    indices, the same in both packages."""
    get = ds.get_batch

    def get_batch(indices, **kw):
        batch = get(indices, **kw)
        rng = np.random.default_rng(sum(indices) + 7)
        batch["noise"] = rng.standard_normal(
            batch["vae_latents"].shape).astype(np.float32)
        batch["timesteps"] = rng.integers(0, 1000, len(indices))
        return batch

    ds.get_batch = get_batch
    return ds


def _recording(trainer, losses):
    step = trainer.train_step

    def recorded(*a, **kw):
        state, metrics = step(*a, **kw)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = recorded


def _trainers(tmp_path, optimizer, training, precision="no"):
    """The JAX and the port ``SDXLTrainer`` on one cache of 4 entries read
    by both, the flax module holding the port's seeded tiny UNet weights;
    2 epochs of 2 steps."""
    rng = np.random.default_rng(0)
    paths = [str(tmp_path / f"t{i}.png") for i in range(4)]
    cm = JCa.CacheManager(tmp_path / "cache")
    for p in paths:
        cm.save_latents(
            cm.get_cache_key(p),
            vae_latents=rng.standard_normal((4, 16, 16)).astype(np.float32),
            time_ids=np.asarray([128, 128, 0, 0, 128, 128], np.float32),
            prompt_embeds=rng.standard_normal((77, 64)).astype(np.float32),
            pooled_prompt_embeds=rng.standard_normal(32).astype(np.float32),
            metadata={"original_size": [128, 128]})
    cm.flush()
    raw = {"model": {"model_type": "sdxl_tiny"},
           "optimizer": {"learning_rate": 1e-3, **optimizer},
           "training": {"batch_size": 2, "mixed_precision": precision,
                        "num_epochs": 2, "save_every": 0,
                        "save_best": False, "save_final_model": False,
                        "seed": 3, **training},
           "tpu": {"sr_noise": "hash", "remat": False},
           "global_config": {"image": {"min_size": [64, 64],
                                       "max_size": [256, 256]},
                             "logging": {"log_dir": str(tmp_path / "logs")}}}
    jcfg, tcfg = JConfig.from_dict(raw), Config.from_dict(raw)
    captions = [""] * len(paths)
    jds = _replayed(JD.AspectBucketDataset(
        jcfg, paths, captions, JCa.CacheManager(tmp_path / "cache")))
    tds = _replayed(TD.AspectBucketDataset(
        tcfg, paths, captions, TCa.CacheManager(tmp_path / "cache")))
    model = SDXLModel.from_config(
        tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    jmodel = JModel.create(tiny=True, remat=False, dtype=(
        jnp.bfloat16 if precision == "bf16" else jnp.float32))
    jmodel.params["unet"] = _flax_params(jmodel, model)
    jt = JLoop.SDXLTrainer(jcfg, model=jmodel, dataset=jds,
                           output_dir=str(tmp_path / "jax"), use_mesh=False)
    tt = loop.SDXLTrainer(tcfg, model=model, dataset=tds,
                          output_dir=str(tmp_path / "port"), device="cpu")
    return jt, tt


def _flax_params(jmodel, model):
    """The port's seeded UNet weights as the flax module's tree, in its
    dtypes (a template from ``eval_shape``: no init to compile)."""
    c = jmodel.unet.config
    template = jax.eval_shape(
        jmodel.unet.init, jax.random.key(0),
        jnp.zeros((1, c.in_channels, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 77, c.cross_attention_dim)),
        jnp.zeros((1, c.pooled_embed_dim)), jnp.zeros((1, c.num_time_ids)))
    state = {k: v.detach().float().numpy()
             for k, v in model.unet.state_dict().items()}
    return JW.hf_to_flax_params(template, state, strict=True)


def test_lora_ema_trainer_matches_jax(tmp_path):
    jt, tt = _trainers(tmp_path, {"optimizer_type": "adamw_bf16"},
                       {"ema_decay": 0.9, "lora": {"enabled": True}})
    # the same pairs and optimizer state to start from (the packages draw
    # their LoRA inits from different generators)
    jtree = jax.tree_util.tree_map(np.asarray, jt.state.params)
    with torch.no_grad():
        for k, v in from_jax_lora(jtree).items():
            tt.state.params[k].copy_(v)
    tt.state.opt_state = tt.optimizer.init(tt.state.params)
    jlosses, tlosses = [], []
    _recording(jt, jlosses)
    _recording(tt, tlosses)
    jt.train()
    tt.train()
    assert len(tlosses) == len(jlosses) == 4
    # the losses are ~1e-6 (MinSNR-weighted): held at rtol alone
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL, atol=0)
    assert isinstance(tt.state.opt_state, EMAState)
    for got, ref in ((tt.state.params, jt.state.params),
                     (tt.eval_params(), jt.eval_params())):
        ref = from_jax_lora(jax.tree_util.tree_map(np.asarray, ref))
        assert set(ref) == set(got)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL)


# ------------------------------------------- main.main with each feature
def _images(root, n=2):
    rng = np.random.default_rng(1)
    d = root / "imgs"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(d / f"i{i}.png")
        (d / f"i{i}.txt").write_text(f"masterpiece, tag{i}, cat")
    return d


FEATURES = {
    "lora_ema": ({}, {"lora": {"enabled": True}, "ema_decay": 0.99}, "no"),
    "schedule_free": ({"optimizer_type": "adamw_schedule_free_kahan",
                       "warmup_steps": 1}, {}, "no"),
    "soap": ({"optimizer_type": "soap", "precondition_frequency": 2,
              "max_precond_dim": 64}, {}, "no"),
    "int8": ({"optimizer_type": "adamw_bf16", "moments_8bit": True}, {},
             "bf16"),
}


def _config(root, name, img, feature, **training):
    optimizer, extra, precision = FEATURES[feature]
    raw = {"model": {"model_type": "sdxl_tiny",
                     "pretrained_model_name": str(root / "none")},
           "optimizer": {"optimizer_type": "adamw", "learning_rate": 1e-4,
                         **optimizer},
           "training": {"batch_size": 2, "mixed_precision": precision,
                        "num_inference_steps": 2, "save_every": 0,
                        "save_best": False, **extra, **training},
           "tpu": {"sr_noise": "hash", "remat": False},
           "data": {"train_data_dir": [str(img)], "image_size": 64},
           "global_config": {
               "cache": {"cache_dir": str(root / "cache")},
               "image": IMAGE,
               "logging": {"log_dir": str(root / "logs"), "log_every": 1}}}
    path = root / f"{name}.yaml"
    path.write_text(_yaml.dump(raw))
    return str(path)


def _run(argv):
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


@pytest.fixture(scope="module", params=sorted(FEATURES))
def feature_runs(request, tmp_path_factory):
    """Run A: 2 epochs (one step each).  Run B: 1 epoch with the final
    checkpoint, then ``--resume`` to 2."""
    feature = request.param
    root = tmp_path_factory.mktemp(feature)
    img = _images(root)
    a = _run(["--config", _config(root, "a", img, feature, num_epochs=2),
              "--output-dir", str(root / "a"), "--device", "cpu"])
    b1 = _run(["--config", _config(root, "b1", img, feature, num_epochs=1),
               "--output-dir", str(root / "b"), "--device", "cpu"])
    b = _run(["--config", _config(root, "b2", img, feature, num_epochs=2,
                                  save_final_model=False),
              "--output-dir", str(root / "b"), "--device", "cpu",
              "--resume"])
    return dict(feature=feature, root=root, a=a, b1=b1,
                ref=_snapshot(a.state), got=_snapshot(b.state))


def test_feature_resume_is_bit_equal(feature_runs):
    (ref, ref_meta), (got, meta) = feature_runs["ref"], feature_runs["got"]
    assert meta == ref_meta and meta["step"] == 2
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    state = feature_runs["a"].state
    kind = {"lora_ema": EMAState, "schedule_free": ScheduleFreeKahanState,
            "soap": SOAPState}.get(feature_runs["feature"])
    if kind is not None:
        assert isinstance(state.opt_state, kind)
    if feature_runs["feature"] == "soap":  # a skipped axis's placeholder
        assert any(m.shape == (0, 0) for ms in state.opt_state.gg.values()
                   for m in ms)
    if feature_runs["feature"] == "int8":  # codes and a scale a bf16 leaf
        codes = [m for k, m in state.opt_state.exp_avg_sq.items()
                 if state.params[k].dtype == torch.bfloat16]
        assert codes and all(m["q"].dtype == torch.uint8 and m["s"].dim() == 0
                             for m in codes)
        assert any(k.startswith("opt.exp_avg_sq.") and k.endswith(".q")
                   for k in ref)  # the codes went through the checkpoint


def test_feature_exports_the_evaluated_weights(feature_runs):
    """The final checkpoint's UNet is ``eval_params`` (LoRA: merged into
    the base; schedule-free: x), and a LoRA run ships its adapter."""
    trainer, feature = feature_runs["b1"], feature_runs["feature"]
    final = feature_runs["root"] / "b" / "final_checkpoint"
    saved = W.read_safetensors(final / C.UNET_FILE)
    params = trainer.eval_params()
    if feature == "lora_ema":
        assert json.loads((final / "lora_config.json").read_text())["r"] == 4
        tree = C.import_lora(final / C.LORA_FILE, trainer.model.unet)
        for k, v in tree.items():
            assert torch.equal(v, params[k].detach())
        params = TL.lora_merge(trainer.model.trainable_params(), params)
        assert set(tree) == set(trainer.state.params)
    elif feature == "schedule_free":
        x = schedule_free_eval_params(trainer.state.opt_state,
                                      trainer.state.params)
        assert any(not torch.equal(x[k], v)
                   for k, v in trainer.state.params.items())
    for k, v in params.items():
        assert torch.equal(saved[k], v.detach()), k


def test_lora_validation_images_use_the_merged_weights(tmp_path,
                                                       monkeypatch):
    img = _images(tmp_path)
    cfg = Config.from_yaml(_config(tmp_path, "v", img, "lora_ema",
                                   num_epochs=1, save_every=1,
                                   save_final_model=False))
    cfg.data.validation_prompts = ["a cat"]
    trainer = loop.SDXLTrainer(cfg, output_dir=str(tmp_path / "out"),
                               device="cpu")
    seen = []
    forward = trainer.lora_apply.adapter.modules[
        next(iter(trainer.lora_apply.adapter.modules))].forward

    def spy(x):
        seen.append(trainer.lora_apply.adapter.tree)
        return forward(x)

    name = next(iter(trainer.lora_apply.adapter.modules))
    monkeypatch.setattr(trainer.lora_apply.adapter.modules[name], "forward",
                        spy)
    trainer.prepare_data()
    trainer.train()
    assert (tmp_path / "out" / "validation-000001" / "00.png").exists()
    # the sampler ran on the evaluated (EMA) pairs, the step on the
    # trained ones
    assert any(t is not trainer.state.params for t in seen)
    assert any(t is trainer.state.params for t in seen)


def test_example_method_trains(tmp_path):
    img = _images(tmp_path)
    path = _config(tmp_path, "ex", img, "schedule_free", num_epochs=2,
                   save_final_model=False)
    trainer = _run(["--config", path, "--output-dir", str(tmp_path / "o"),
                    "--device", "cpu", "--method", "example_method"])
    assert trainer.config.training.method == "example_method"
    assert trainer.state.step == 2
    scale = trainer.logger.metrics.get_average("pred_scale")
    assert scale is not None and np.isfinite(scale) and scale > 0
