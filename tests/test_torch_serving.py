"""PyTorch port: the rest of serving against the JAX package.

* The UNet's DeepCache split (``return_deep``, ``deep_cache``) and the
  9-channel inpainting and refiner tiny UNets against JAX's, rtol 2e-4 /
  atol 2e-5 (``tests/test_weight_parity.py:107``).  The deep feature is
  NCHW here and NHWC in JAX: the tests transpose.
* Both pipelines, holding the same tiny weights, through DPM++ 2M with
  DeepCache on an img2img call, the flow sampler, inpainting, and the
  base -> refiner handoff.  The port gets JAX's draws (the sampler's, the
  VAE encode's) by JAX's key splits.  Decoded images must agree within
  1e-3 of their max magnitude at 4-5 steps, where the walk is well
  conditioned (``tests/test_torch_pipeline.py``).
* The refusals, the tokenizer layout rules (the port refuses a present
  tokenizer directory: its BPE tokenizer is not ported), and
  ``generate.main`` on a tiny checkpoint, its PNG read by Pillow, and a
  Pillow PNG read by the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.models.tokenizer import (
    load_tokenizers as jax_load_tokenizers)
from sdxl_training_improvements_tpu.pipelines import SDXLPipeline as JPipe
from sdxl_training_improvements_tpu_torch import generate
from sdxl_training_improvements_tpu_torch import png
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.tokenizer import (
    load_tokenizers)
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
from sdxl_training_improvements_tpu_torch.training import schedules as TS
from sdxl_training_improvements_tpu_torch.training.checkpoints import (
    components, export_diffusers)
from sdxl_training_improvements_tpu_torch.training.validation import (
    ValidationSampler)

RTOL, ATOL = 2e-4, 2e-5
SIZE = 16  # pixels; the tiny VAE halves it
PROMPTS = ["a photo of a cat", "an oil painting of a lighthouse"]


def _refiner_cfg(config_cls):
    # cross and pooled widths of the tiny CLIP-G (hidden 32, projection 32)
    return config_cls.tiny(num_time_ids=5, cross_attention_dim=32,
                           projection_class_embeddings_input_dim=32 + 5 * 8)


VARIANTS = {  # name -> (port config, JAX config, refiner, components)
    "base": (UNetConfig.tiny(), JU.UNetConfig.tiny(), False,
             ("unet", "vae", "clip_l", "clip_g")),
    "inpaint": (UNetConfig.tiny(in_channels=9),
                JU.UNetConfig.tiny(in_channels=9), False,
                ("unet", "vae", "clip_l", "clip_g")),
    "refiner": (_refiner_cfg(UNetConfig), _refiner_cfg(JU.UNetConfig), True,
                ("unet", "vae", "clip_g")),
}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model) with the same tiny weights."""
    out = {}
    for seed, (name, (ucfg, jcfg, refiner, comps)) in enumerate(
            VARIANTS.items()):
        # each variant its own UNet; the VAE and CLIPs of the base model
        jmodel = JModel.create(tiny=True, dtype=jnp.float32,
                               unet_config=jcfg, refiner=refiner,
                               init_rng=jax.random.key(seed),
                               init_components=comps if seed == 0
                               else ("unet",))
        if seed:
            jmodel.params.update({c: out["base"][0].params[c]
                                  for c in comps if c != "unet"})
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


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                       jnp.float32)))


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(n)]


def _masks(n):
    masks = []
    for i in range(n):
        m = np.zeros((SIZE, SIZE), np.uint8)
        m[2 + i:10 + i, 4:12] = 255
        masks.append(m)
    return masks


def _decoded_close(pipe, lat, jpipe, jlat):
    ref = np.asarray(jpipe.model.decode_latents(jnp.asarray(jlat)))
    with torch.inference_mode():
        out = pipe.model.decode_latents(lat).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= 1e-3, err


# ------------------------------------------------------------------ UNet
def _unet_inputs(ucfg, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((2, ucfg.in_channels, 8, 8)).astype(f32),
            np.asarray([10, 900], np.int32),
            rng.standard_normal((2, 77, ucfg.cross_attention_dim)).astype(
                f32),
            rng.standard_normal((2, ucfg.pooled_embed_dim)).astype(f32),
            np.tile(np.asarray([[32.0, 32, 0, 0, 32, 32][:ucfg.num_time_ids]],
                               f32), (2, 1)))


def _close_nchw(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_unet_variants_match_jax(models, name):
    jmodel, model = models[name]
    args = _unet_inputs(model.unet_config)
    ref = jax.jit(jmodel.unet.apply)(jmodel.params["unet"],
                                     *map(jnp.asarray, args))
    with torch.no_grad():
        out = model.unet(*map(torch.from_numpy, args))
    _close_nchw(out, ref)


def test_deep_cache_split_matches_jax(models):
    jmodel, model = models["base"]
    args = _unet_inputs(model.unet_config, seed=1)
    jargs = [jnp.asarray(a) for a in args]
    params = jmodel.params["unet"]
    ref, ref_deep = jax.jit(lambda p, *a: jmodel.unet.apply(
        p, *a, return_deep=True))(params, *jargs)
    # a shallow call around another deep feature (a cached one)
    other = np.asarray(ref_deep) * 0.5 + 0.1
    ref_shallow = jax.jit(lambda p, d, *a: jmodel.unet.apply(
        p, *a, deep_cache=d))(params, jnp.asarray(other), *jargs)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        out, deep = model.unet(*targs, return_deep=True)
        shallow = model.unet(*targs, deep_cache=torch.from_numpy(
            other).permute(0, 3, 1, 2))
        exact = model.unet(*targs, deep_cache=deep)
        full = model.unet(*targs)
    ch = model.unet_config.block_out_channels[1]
    assert deep.shape == (2, ch, 8, 8)
    assert deep.is_contiguous(memory_format=torch.channels_last)
    _close_nchw(out, ref)
    _close_nchw(deep.permute(0, 2, 3, 1), ref_deep)
    _close_nchw(shallow, ref_shallow)
    # the true deep feature gives the full forward back
    torch.testing.assert_close(exact, full, rtol=0, atol=0)
    assert torch.equal(out, full)
    with pytest.raises(ValueError, match="excludes return_deep"):
        model.unet(*targs, deep_cache=deep, return_deep=True)


def test_vae_encode_matches_jax(models):
    """``encode``: (mean + exp(0.5 logvar) n) * scaling_factor with JAX's
    draw of n, and the mean alone without ``sample``."""
    jmodel, model = models["base"]
    pixels = np.random.default_rng(2).uniform(
        -1, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
    key = jax.random.key(9)
    params = jmodel.params["vae"]
    ref = jmodel.vae.apply(params, jnp.asarray(pixels), key,
                           method=jmodel.vae.encode)
    ref_mean = jmodel.vae.apply(params, jnp.asarray(pixels), key, False,
                                method=jmodel.vae.encode)
    with torch.no_grad():
        out = model.encode_images(torch.from_numpy(pixels), noise=_normal(
            key, (2, 4, SIZE // 2, SIZE // 2)))
        mean = model.vae.encode(torch.from_numpy(pixels), sample=False)
    _close_nchw(out, ref)
    _close_nchw(mean, ref_mean)
    with pytest.raises(ValueError, match="noise shape"):
        model.vae.encode(torch.from_numpy(pixels), noise=torch.zeros(1))


# ------------------------------------------------------------- pipelines
def test_dpmpp_deep_cache_img2img_matches_jax(models):
    jmodel, model = models["base"]
    kw = dict(num_inference_steps=5, guidance_scale=5.0, seed=3,
              strength=0.6)
    jpipe = JPipe.from_model(jmodel, sampler="dpmpp_2m", deep_cache=2)
    pipe = SDXLPipeline.from_model(model, sampler="dpmpp_2m", deep_cache=2)
    images = _images(2)
    jlat = jpipe.img2img(PROMPTS, images=images, return_latents=True, **kw)
    key, ekey = jax.random.split(jax.random.key(3))
    shape = (2, 4, SIZE // 2, SIZE // 2)
    lat = pipe.img2img(PROMPTS, images=images, return_latents=True,
                       noise=_normal(key, shape),
                       encode_noise=_normal(ekey, shape), **kw)
    _decoded_close(pipe, lat, jpipe, jlat)


def test_flow_matches_jax(models):
    jmodel, model = models["base"]
    kw = dict(height=SIZE, width=SIZE, num_inference_steps=4, seed=4,
              return_latents=True)
    jlat = JPipe.from_model(jmodel, method="flow_matching")(PROMPTS, **kw)
    pipe = SDXLPipeline.from_model(model, method="flow_matching")
    lat = pipe(PROMPTS, noise=_normal(jax.random.key(4),
                                      (2, 4, SIZE // 2, SIZE // 2)), **kw)
    _decoded_close(pipe, lat, JPipe.from_model(jmodel), jlat)


def test_inpaint_matches_jax(models):
    jmodel, model = models["inpaint"]
    kw = dict(num_inference_steps=4, seed=5, strength=0.7)
    jpipe, pipe = JPipe.from_model(jmodel), SDXLPipeline.from_model(model)
    images, masks = _images(2, seed=1), _masks(2)
    jlat = _jax_inpaint_latents(jpipe, images, masks, **kw)
    key, k_img, k_masked = jax.random.split(jax.random.key(5), 3)
    shape = (2, 4, SIZE // 2, SIZE // 2)
    lat = pipe.inpaint(PROMPTS, images, masks, return_latents=True,
                       noise=_normal(key, shape),
                       masked_noise=_normal(k_masked, shape),
                       image_noise=_normal(k_img, shape), **kw)
    _decoded_close(pipe, lat, jpipe, jlat)


def _jax_inpaint_latents(jpipe, images, masks, **kw):
    """JAX's ``inpaint`` returns images only: capture its latents at the
    decode."""
    seen = []
    decode = jpipe.model.decode_latents
    jpipe.model.decode_latents = lambda lat: seen.append(lat) or decode(lat)
    try:
        jpipe.inpaint(PROMPTS, images, masks, **kw)
    finally:
        del jpipe.model.decode_latents
    return seen[0]


def test_base_to_refiner_handoff_matches_jax(models):
    jbase, base = models["base"]
    jref, ref = models["refiner"]
    kw = dict(num_inference_steps=5, guidance_scale=5.0)
    shape = (2, 4, SIZE // 2, SIZE // 2)
    jnoisy = JPipe.from_model(jbase)(PROMPTS, height=SIZE, width=SIZE,
                                     seed=6, denoising_end=0.5, **kw)
    noisy = SDXLPipeline.from_model(base)(
        PROMPTS, height=SIZE, width=SIZE, seed=6, denoising_end=0.5,
        noise=_normal(jax.random.key(6), shape), **kw)
    np.testing.assert_allclose(noisy.numpy(), np.asarray(jnoisy),
                               rtol=RTOL, atol=ATOL * np.abs(
                                   np.asarray(jnoisy)).max())
    # both refiners take JAX's noisy latents
    jpipe = JPipe.from_model(jref)
    seen = []
    decode = jref.decode_latents
    jref.decode_latents = lambda lat: seen.append(lat) or decode(lat)
    try:
        jpipe.refine(PROMPTS, jnoisy, denoising_start=0.5, seed=7, **kw)
    finally:
        del jref.decode_latents
    pipe = SDXLPipeline.from_model(ref)
    lat = pipe.refine(PROMPTS, torch.from_numpy(np.array(jnoisy)),
                      denoising_start=0.5, seed=7, return_latents=True,
                      noise=_normal(jax.random.key(7), shape), **kw)
    _decoded_close(pipe, lat, jpipe, seen[0])


def test_refiner_conditioning_rows(models):
    _, ref = models["refiner"]
    sampler = ValidationSampler(ref, None, TS.NoiseSchedule.create())
    enc = {"prompt_embeds": torch.zeros(4, 77, 32),
           "pooled_prompt_embeds": torch.zeros(4, 32)}
    _, pooled, time_ids = sampler._conditioning(enc, 2, 64, 48, 7.0, 1.5)
    assert pooled.shape == (4, 32)
    assert time_ids.tolist() == [[64, 48, 0, 0, 1.5]] * 2 \
        + [[64, 48, 0, 0, 7.0]] * 2


def test_deep_cache_first_call_is_exact(models):
    """An epsilon walk of one step makes one model call, step 0, which
    the cached path always runs in full: bit-equal to the uncached walk."""
    _, model = models["base"]
    eps = TS.NoiseSchedule.create(num_timesteps=50, use_ztsnr=False,
                                  sigma_max=80.0, prediction_type="epsilon")
    outs = [SDXLPipeline.from_model(model, schedule=eps, deep_cache=k)(
        ["x"], height=SIZE, width=SIZE, num_inference_steps=1,
        return_latents=True) for k in (1, 3)]
    assert torch.equal(outs[0], outs[1])
    off = SDXLPipeline.from_model(model)(["x"], height=SIZE, width=SIZE,
                                         num_inference_steps=4,
                                         return_latents=True)
    on = SDXLPipeline.from_model(model, deep_cache=2)(
        ["x"], height=SIZE, width=SIZE, num_inference_steps=4,
        return_latents=True)
    assert torch.isfinite(on).all() and not torch.equal(on, off)


def test_refusals(models, tmp_path):
    _, model = models["base"]
    sched = TS.NoiseSchedule.create()
    for kw, match in ((dict(method="flow_matching", sampler="dpmpp_2m"),
                       "sigma-space"),
                      (dict(method="flow_matching", deep_cache_interval=2),
                       "deep_cache"),
                      (dict(method="rectified"), "methods"),
                      (dict(sampler="heun"), "sampler"),
                      (dict(deep_cache_interval=0), "deep_cache_interval")):
        with pytest.raises(ValueError, match=match):
            ValidationSampler(model, None, sched, **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        ValidationSampler(model, None, sched, mesh=object())
    flow = SDXLPipeline.from_model(model, method="flow_matching")
    with pytest.raises(ValueError, match="denoising_start/denoising_end"):
        flow(["x"], height=SIZE, width=SIZE, num_inference_steps=2,
             denoising_end=0.5)
    pipe = SDXLPipeline.from_model(model)
    with pytest.raises(ValueError, match="inpainting UNet"):
        pipe.inpaint(["x"], _images(1), _masks(1), num_inference_steps=2)
    with pytest.raises(ValueError, match="exactly one"):
        pipe.img2img(["x"], num_inference_steps=2)
    # a flow-trained checkpoint refuses to be sampled as ddpm
    cfg = Config()
    cfg.training.method = "flow_matching"
    export_diffusers(tmp_path, {"unet": model.unet}, cfg,
                     unet_config=model.unet_config)
    assert SDXLPipeline.detect_method(tmp_path) == "flow_matching"
    with pytest.raises(ValueError, match="refusing to sample"):
        SDXLPipeline.from_pretrained(tmp_path, tiny=True, method="ddpm",
                                     device="cpu")
    with pytest.raises(FileNotFoundError, match="missing components"):
        SDXLPipeline.from_pretrained(tmp_path, tiny=True, device="cpu")
    (tmp_path / "config.json").write_text("{not json")
    with pytest.raises(ValueError, match="corrupt checkpoint config"):
        SDXLPipeline.declared_method(tmp_path)


def test_declared_schedule_and_variants_load(models, tmp_path):
    _, model = models["refiner"]
    cfg = Config()
    cfg.model.use_ztsnr, cfg.model.sigma_max = False, 80.0
    cfg.training.prediction_type = "epsilon"
    export_diffusers(tmp_path, components(model), cfg,
                     unet_config=model.unet_config)
    pipe = SDXLPipeline.from_pretrained(tmp_path, tiny=True,
                                        dtype=torch.float32, device="cpu")
    assert pipe.model.clip_l is None and pipe.method == "ddpm"
    assert pipe.model.unet_config.num_time_ids == 5
    assert pipe.schedule.prediction_type == "epsilon"
    assert not pipe.schedule.use_ztsnr
    for k, v in model.unet.state_dict().items():
        assert torch.equal(pipe.model.unet.state_dict()[k], v), k


# ------------------------------------------------------------ tokenizers
@pytest.mark.parametrize("layout,single,want", [
    ((), False, "fallback"),
    ((), True, "fallback"),
    (("tokenizer",), False, FileNotFoundError),
    (("tokenizer_2",), False, FileNotFoundError),
    (("tokenizer",), True, FileNotFoundError),
    (("tokenizer", "tokenizer_2"), False, NotImplementedError),
    (("tokenizer_2",), True, NotImplementedError),
])
def test_tokenizer_layout_rules(tmp_path, layout, single, want):
    for d in layout:
        (tmp_path / d).mkdir()
    if want == "fallback":
        pair = load_tokenizers(tmp_path, single_encoder=single,
                               fallback_vocab_size=1000)
        jpair = jax_load_tokenizers(tmp_path, single_encoder=single,
                                    fallback_vocab_size=1000)
        for a, b in zip(pair(PROMPTS), jpair(PROMPTS)):
            np.testing.assert_array_equal(a, b)
        return
    with pytest.raises(want):
        load_tokenizers(tmp_path, single_encoder=single)
    if want is FileNotFoundError:  # the same layout faults as JAX
        with pytest.raises(FileNotFoundError):
            jax_load_tokenizers(tmp_path, single_encoder=single)


# -------------------------------------------------------------- generate
def test_generate_main_and_png(models, tmp_path, capsys):
    _, model = models["base"]
    ckpt, out = tmp_path / "ckpt", tmp_path / "out"
    export_diffusers(ckpt, components(model), Config(),
                     unet_config=model.unet_config)
    common = ["--model", str(ckpt), "--prompt", PROMPTS[0], "--height",
              str(SIZE), "--width", str(SIZE), "--steps", "3", "--tiny",
              "--device", "cpu", "--out", str(out)]
    assert generate.main(common + ["--sampler", "dpmpp_2m",
                                   "--deep-cache", "2"]) == 0
    assert "dpmpp_2m, deep-cache 2" in capsys.readouterr().out
    ours = png.read_png(out / "000.png")
    pil = np.asarray(Image.open(out / "000.png"))
    assert ours.shape == (SIZE, SIZE, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, pil)
    # the same checkpoint in bf16 (generate.py's dtype), through the API
    want = SDXLPipeline.from_pretrained(
        ckpt, tiny=True, sampler="dpmpp_2m", deep_cache=2, device="cpu")(
        PROMPTS[:1], height=SIZE, width=SIZE, num_inference_steps=3)[0]
    np.testing.assert_array_equal(ours, want)

    # img2img from that PNG, and from an .npy
    np.save(tmp_path / "init.npy", ours)
    for init in (out / "000.png", tmp_path / "init.npy"):
        assert generate.main(common + ["--init", str(init),
                                       "--strength", "0.5"]) == 0
    with pytest.raises(SystemExit, match="resizing is not ported"):
        generate.main([a if a != str(SIZE) else "32" for a in common]
                      + ["--init", str(out / "000.png")])
    for flag in (["--mesh", "1,1,2"], ["--aot", "x"], ["--export-aot", "x"]):
        with pytest.raises(SystemExit, match="ROADMAP"):
            generate.main(common + flag)
    with pytest.raises(SystemExit, match="--mask requires --init"):
        generate.main(common + ["--mask", "m.png"])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_reader_takes_pillow_files(tmp_path, mode):
    rng = np.random.default_rng(0)
    # smooth and noisy rows, so Pillow's adaptive filter picks every type
    base = np.cumsum(rng.integers(0, 9, (24, 40, 4)), axis=1) % 256
    base[::3] = rng.integers(0, 256, (8, 40, 4))
    channels = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    arr = base[..., :channels].astype(np.uint8)
    if channels == 1:
        arr = arr[..., 0]
    Image.fromarray(arr, mode).save(tmp_path / "x.png", optimize=True)
    got = png.read_png(tmp_path / "x.png")
    np.testing.assert_array_equal(got, np.asarray(Image.open(
        tmp_path / "x.png")))
    img = Image.open(tmp_path / "x.png")
    np.testing.assert_array_equal(png.to_rgb(got),
                                  np.asarray(img.convert("RGB")))
    np.testing.assert_array_equal(png.to_gray(got),
                                  np.asarray(img.convert("L")))


def test_png_writer_read_by_pillow(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((5, 7, 3), (6, 3)):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        png.write_png(tmp_path / "y.png", arr)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "y.png")), arr)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(tmp_path / "z.png", np.zeros((4, 4, 3), np.float32))
