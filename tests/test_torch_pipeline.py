"""PyTorch port: the whole text-to-image slice against the JAX package.

The JAX ``SDXLPipeline.from_model`` and the port's, holding the same tiny
weights, turn the same prompts into images in 2 ZTSNR Euler steps with
guidance 5 on a 16x16 latent.  The port gets JAX's initial noise through
``noise=``.  The decoded float images must agree within 1e-3 of their max
magnitude.  Observed on the CPU: 4.7e-4 at 2 steps, 8.2e-6 at 4 steps.
At 2 steps the one Euler step from sigma = 20000 cancels fp32 states of
size ~7e4 down to O(1) latents, so the two frameworks' roundings differ by
~2e-3 in the latents; with more steps the walk is well conditioned.
"""
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

from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.pipelines import SDXLPipeline as JPipe
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["a photo of a cat", "an oil painting of a lighthouse"]
COMPONENTS = ("unet", "vae", "clip_l", "clip_g")
SIZE, STEPS, SEED = 32, 2, 0


@pytest.fixture(scope="module")
def pipelines():
    jmodel = JModel.create(tiny=True, dtype=jnp.float32,
                           init_rng=jax.random.key(0),
                           init_components=COMPONENTS)
    model = SDXLModel.create(tiny=True, dtype=torch.float32,
                             device="cpu")
    for c in COMPONENTS:
        tree = jax.tree_util.tree_map(np.asarray, jmodel.params[c])
        getattr(model, c).load_state_dict(
            from_jax_params(tree, clip=c.startswith("clip")), strict=True)
    return JPipe.from_model(jmodel), SDXLPipeline.from_model(model)


def test_slice_matches_jax(pipelines):
    jpipe, pipe = pipelines
    kw = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
              guidance_scale=5.0, seed=SEED)
    j_lat = jpipe(PROMPTS, return_latents=True, **kw)
    ref = np.asarray(jpipe.model.decode_latents(j_lat))
    f = pipe.model.vae.config.downscale_factor
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(SEED), (len(PROMPTS), 4, SIZE // f, SIZE // f),
        jnp.float32)))
    lat = pipe(PROMPTS, noise=noise, return_latents=True, **kw)
    with torch.inference_mode():
        out = pipe.model.decode_latents(lat).numpy()
    assert out.shape == ref.shape == (2, 3, SIZE, SIZE)
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 1e-3, err

    images = pipe(PROMPTS, noise=noise, **kw)
    assert [im.shape for im in images] == [(SIZE, SIZE, 3)] * 2
    assert all(im.dtype == np.uint8 for im in images)


def test_seeded_noise_is_reproducible(pipelines):
    _, pipe = pipelines
    kw = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
              return_latents=True)
    a, b = pipe(PROMPTS[:1], seed=3, **kw), pipe(PROMPTS[:1], seed=3, **kw)
    c = pipe(PROMPTS[:1], seed=4, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_port_imports_no_jax():
    """The port runs the tiny serving slice and one step of the tiny
    training slice on the CPU, with every module of both and of the
    ``tools`` subpackage imported, without importing jax, yaml, PIL or
    the JAX package."""
    script = textwrap.dedent("""
        import sys, torch
        from sdxl_training_improvements_tpu_torch.config import Config
        from sdxl_training_improvements_tpu_torch.models.sdxl import (
            SDXLModel)
        from sdxl_training_improvements_tpu_torch.models.weights import (
            from_jax_opt_state)
        from sdxl_training_improvements_tpu_torch.ops import (
            fused_adamw, probe)
        from sdxl_training_improvements_tpu_torch.pipelines import (
            SDXLPipeline)
        from sdxl_training_improvements_tpu_torch.training.optimizers import (
            make_optimizer)
        from sdxl_training_improvements_tpu_torch.training.schedules import (
            NoiseSchedule)
        from sdxl_training_improvements_tpu_torch.training.trainer import (
            create_train_state, make_train_step)
        model = SDXLModel.create(tiny=True, dtype=torch.float32,
                                 device="cpu")
        images = SDXLPipeline.from_model(model)(
            ["a cat"], height=32, width=32, num_inference_steps=2)
        assert images[0].shape == (32, 32, 3), images[0].shape
        import tempfile
        from sdxl_training_improvements_tpu_torch import aot, serve
        with tempfile.TemporaryDirectory() as art:
            pipe = SDXLPipeline.from_model(model)
            aot.export_text2img(pipe, art, height=32, width=32,
                                num_inference_steps=2)
            runner = aot.AOTPipeline.load(art, model, pipe.tokenizers,
                                          device="cpu")
            assert runner(["a cat"])[0].shape == (32, 32, 3)
            server = serve.build_server(runner, port=0)
            server.server_close()
        cfg = Config()
        cfg.training.batch_size = 1
        opt = make_optimizer(cfg)
        step = make_train_step(model.unet_apply,
                               NoiseSchedule.from_config(cfg), opt, cfg)
        u = model.unet_config
        state, metrics = step(create_train_state(model.trainable_params(),
                                                 opt), {
            "vae_latents": torch.randn(1, 4, 8, 8),
            "prompt_embeds": torch.randn(1, 77, u.cross_attention_dim),
            "pooled_prompt_embeds": torch.randn(1, u.pooled_embed_dim),
            "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]])})
        assert torch.isfinite(metrics["loss"]), metrics
        assert state.opt_state.step == 1
        z = torch.zeros(8, dtype=torch.bfloat16)  # the bf16 leaves' chain
        delta = fused_adamw.fused_adamw_update(z, z.float(), z, z, z, 1e-3,
                                               0.0, 1, 2)[0]
        assert delta.dtype == torch.bfloat16
        import importlib
        import pkgutil
        from sdxl_training_improvements_tpu_torch import tools
        for info in pkgutil.iter_modules(tools.__path__):
            importlib.import_module(f"{tools.__name__}.{info.name}")
        assert {"parity_check", "finetune_demo", "study_int8_moments",
                "bench_precompute", "verify_checkpoint",
                "profile_step"} <= {i.name for i in
                                    pkgutil.iter_modules(tools.__path__)}
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "yaml", "PIL",
                      "sdxl_training_improvements_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
