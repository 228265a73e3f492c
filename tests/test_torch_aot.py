"""PyTorch port: the serving artifact (``aot.py``) against the JAX package.

* ``param_shape_digest`` of weights carried from JAX equals JAX's
  ``aot._shape_digest`` of the originals, base and refiner topologies;
  the meta's keys and schedule summary equal what JAX's
  ``export_text2img`` writes (its ``jax.export`` stubbed out: the export
  itself is JAX's slow test, ``tests/test_aot.py``).
* ``AOTPipeline`` on the CPU (no capture) with JAX's noise matches JAX's
  live ``SDXLPipeline`` latents, decoded within 1e-3 of their max
  magnitude at 4 steps (``tests/test_torch_pipeline.py``'s bar), for
  Euler, DPM++ 2M with DeepCache 2, flow matching and the refiner
  topology; it is ``torch.equal`` to the port's own eager ``SDXLPipeline``
  at the same seed, and guidance stays a runtime input.
* JAX's refusals (format version, refiner against base, the digest, the
  static batch, the negatives' count, missing components, a platform the
  artifact was not exported for), and ``generate.main`` with
  ``--export-aot`` then ``--aot``: the explicit default-valued conflict
  and the mode refusals.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu import aot as jax_aot
from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.pipelines import SDXLPipeline as JPipe
from sdxl_training_improvements_tpu_torch import generate, png
from sdxl_training_improvements_tpu_torch.aot import (
    AOTPipeline, export_text2img, param_shape_digest)
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
from sdxl_training_improvements_tpu_torch.training.checkpoints import (
    components, export_diffusers)

SIZE, STEPS = 16, 4  # pixels (the tiny VAE halves them), sampler steps
PROMPTS = ["a photo of a cat", "an oil painting of a lighthouse"]


def _refiner_cfg(config_cls):
    # cross and pooled widths of the tiny CLIP-G (hidden 32, projection 32)
    return config_cls.tiny(num_time_ids=5, cross_attention_dim=32,
                           projection_class_embeddings_input_dim=32 + 5 * 8)


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model) with the same tiny weights."""
    out = {}
    for seed, (name, ucfg, jcfg, refiner) in enumerate((
            ("base", UNetConfig.tiny(), JU.UNetConfig.tiny(), False),
            ("refiner", _refiner_cfg(UNetConfig),
             _refiner_cfg(JU.UNetConfig), True))):
        comps = ("unet", "vae", "clip_g") + (() if refiner else ("clip_l",))
        jmodel = JModel.create(tiny=True, dtype=jnp.float32,
                               unet_config=jcfg, refiner=refiner,
                               init_rng=jax.random.key(seed),
                               init_components=comps)
        model = SDXLModel.create(tiny=True, dtype=torch.float32,
                                 device="cpu", unet_config=ucfg,
                                 refiner=refiner)
        for c in comps:
            tree = jax.tree_util.tree_map(np.asarray, jmodel.params[c])
            getattr(model, c).load_state_dict(
                from_jax_params(tree, clip=c.startswith("clip")),
                strict=True)
        out[name] = (jmodel, model)
    return out


def _load(pipe, path, batch=2, **kw):
    art = export_text2img(pipe, path, batch=batch, height=SIZE, width=SIZE,
                          num_inference_steps=STEPS, **kw)
    return AOTPipeline.load(art, pipe.model, pipe.tokenizers, device="cpu")


def _noise(seed, n=2):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.key(seed), (n, 4, SIZE // 2, SIZE // 2), jnp.float32)))


# ------------------------------------------------------------ the meta
@pytest.mark.parametrize("name", ["base", "refiner"])
def test_digest_and_meta_match_jax(models, name, tmp_path, monkeypatch):
    jmodel, model = models[name]
    assert param_shape_digest(model) == jax_aot._shape_digest(jmodel.params)

    class Stub:  # jax.export's result, serialized as nothing
        def serialize(self):
            return b""

    monkeypatch.setattr(jax_aot.jax_export, "export",
                        lambda *a, **kw: lambda *specs: Stub())
    kw = dict(batch=2, height=SIZE, width=SIZE, num_inference_steps=STEPS,
              guidance_scale=4.0, platforms=("cpu",))
    jax_aot.export_text2img(JPipe.from_model(jmodel, sampler="dpmpp_2m",
                                             deep_cache=2),
                            tmp_path / "jax", **kw)
    export_text2img(SDXLPipeline.from_model(model, sampler="dpmpp_2m",
                                            deep_cache=2),
                    tmp_path / "port", **kw)
    want = json.loads((tmp_path / "jax" / "meta.json").read_text())
    got = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert set(got) == set(want) - {"jax_version"} | {"torch_version"}
    assert got["torch_version"] == torch.__version__
    for k in set(want) - {"jax_version"}:
        assert got[k] == want[k], k


# ---------------------------------------------- against JAX's pipeline
CASES = {  # name -> (model, pipeline options, seed)
    "euler": ("base", {}, 3),
    "dpmpp_2m deep-cache 2": ("base", dict(sampler="dpmpp_2m",
                                           deep_cache=2), 4),
    "flow": ("base", dict(method="flow_matching"), 5),
    "refiner": ("refiner", {}, 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_pipeline(models, case, tmp_path):
    name, kw, seed = CASES[case]
    jmodel, model = models[name]
    run = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
               guidance_scale=5.0, seed=seed, return_latents=True)
    jpipe = JPipe.from_model(jmodel, **kw)
    jlat = np.asarray(jpipe(PROMPTS, **run))
    pipe = SDXLPipeline.from_model(model, **kw)
    aot = _load(pipe, tmp_path / "art")
    lat = aot.generate_latents(PROMPTS, seed=seed, guidance_scale=5.0,
                               noise=_noise(seed))
    ref = np.asarray(jmodel.decode_latents(jnp.asarray(jlat)))
    with torch.inference_mode():
        out = model.decode_latents(lat).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 1e-3, err
    # the port's own eager pipeline, the same seed: bit for bit
    eager = pipe(PROMPTS, **run)
    assert torch.equal(aot.generate_latents(PROMPTS, seed=seed,
                                            guidance_scale=5.0), eager)
    images = aot(PROMPTS, seed=seed, guidance_scale=5.0)
    want = pipe(PROMPTS, **dict(run, return_latents=False))
    assert all(np.array_equal(a, b) for a, b in zip(images, want))
    assert images[0].shape == (SIZE, SIZE, 3) and images[0].dtype == np.uint8
    assert not aot.graphs and aot.kernel_launches() == {}


def test_guidance_is_a_runtime_input(models, tmp_path):
    _, model = models["base"]
    aot = _load(SDXLPipeline.from_model(model), tmp_path / "art",
                guidance_scale=5.0)
    a = aot.generate_latents(PROMPTS, seed=0, guidance_scale=5.0)
    b = aot.generate_latents(PROMPTS, seed=0, guidance_scale=1.0)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert not torch.equal(a, b)
    # the recorded default applies when the caller passes none
    assert torch.equal(aot.generate_latents(PROMPTS, seed=0), a)
    # and another seed draws other noise
    assert not torch.equal(aot.generate_latents(PROMPTS, seed=1), a)


# ------------------------------------------------------------ refusals
def test_refusals(models, tmp_path):
    _, model = models["base"]
    _, refiner = models["refiner"]
    pipe = SDXLPipeline.from_model(model)
    aot = _load(pipe, tmp_path / "art")
    with pytest.raises(ValueError, match="batch is static"):
        aot.generate_latents(PROMPTS[:1])
    with pytest.raises(ValueError, match="negative_prompts"):
        aot.generate_latents(PROMPTS, negative_prompts=["x"])
    art = tmp_path / "art"
    with pytest.raises(ValueError, match="refiner topology|base"):
        AOTPipeline.load(art, refiner, pipe.tokenizers, device="cpu")
    other = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                             unet_config=UNetConfig.tiny(in_channels=9))
    with pytest.raises(ValueError, match="shape digest"):
        AOTPipeline.load(art, other, pipe.tokenizers, device="cpu")
    # the card unless told otherwise: this model is on the CPU
    with pytest.raises(ValueError, match="load it on cuda"):
        AOTPipeline.load(art, model, pipe.tokenizers)
    cuda_only = export_text2img(pipe, tmp_path / "cuda", batch=1,
                                height=SIZE, width=SIZE, platforms=("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        AOTPipeline.load(cuda_only, model, pipe.tokenizers, device="cpu")
    meta = json.loads((art / "meta.json").read_text())
    (art / "meta.json").write_text(json.dumps(dict(meta,
                                                   format_version=2)))
    with pytest.raises(ValueError, match="format_version"):
        AOTPipeline.load(art, model, pipe.tokenizers, device="cpu")
    for missing in ("vae", "clip_g"):
        broken = SDXLPipeline.from_model(
            dataclasses.replace(model, **{missing: None}),
            tokenizers=pipe.tokenizers)
        with pytest.raises(ValueError, match="missing components"):
            export_text2img(broken, tmp_path / "x")


# ------------------------------------------------------------- the CLI
def test_generate_export_then_aot(models, tmp_path, capsys):
    _, model = models["base"]
    ckpt, art = tmp_path / "ckpt", tmp_path / "art"
    export_diffusers(ckpt, components(model), Config(),
                     unet_config=model.unet_config)
    common = ["--model", str(ckpt), "--prompt", PROMPTS[0], "--tiny",
              "--device", "cpu", "--seed", "2"]
    size = ["--height", str(SIZE), "--width", str(SIZE), "--steps", "3"]
    assert generate.main(common + size + ["--export-aot", str(art)]) == 0
    assert "AOT artifact written" in capsys.readouterr().out
    meta = json.loads((art / "meta.json").read_text())
    assert (meta["batch"], meta["height"], meta["num_inference_steps"]) == (
        1, SIZE, 3)
    assert meta["platforms"] == ["cuda", "cpu"]
    # the artifact's images, through the CLI and the API, and the eager
    # CLI's at the same flags
    assert generate.main(common + ["--aot", str(art), "--out",
                                   str(tmp_path / "aot")]) == 0
    assert generate.main(common + size + ["--out",
                                          str(tmp_path / "eager")]) == 0
    served = png.read_png(tmp_path / "aot" / "000.png")
    want = AOTPipeline.from_pretrained(art, ckpt, tiny=True, device="cpu")(
        PROMPTS[:1], seed=2)[0]
    np.testing.assert_array_equal(served, want)
    np.testing.assert_array_equal(
        served, png.read_png(tmp_path / "eager" / "000.png"))
    # a static flag passed explicitly: matching passes, any other value
    # exits, the parser's default (28) included
    assert generate.main(common + ["--aot", str(art), "--steps", "3",
                                   "--out", str(tmp_path / "x")]) == 0
    for flag in (["--steps", "28"], ["--height", "32"],
                 ["--sampler", "dpmpp_2m"], ["--deep-cache", "2"]):
        with pytest.raises(SystemExit, match="conflicts with the AOT"):
            generate.main(common + ["--aot", str(art)] + flag)
    for flag in (["--init", "a.png"], ["--init", "a.png", "--mask", "m.png"],
                 ["--refiner", str(ckpt)], ["--mesh", "1,1,2"]):
        with pytest.raises(SystemExit, match="text2img program only"):
            generate.main(common + ["--aot", str(art)] + flag)
