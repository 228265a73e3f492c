"""PyTorch port: ``tools/finetune_demo`` against JAX's
``tools/finetune_demo.py``.

* The drawing: the port's numpy rasterizer against Pillow's
  ``ImageDraw`` on every draw of the demo's datasets (seeds 0, 1, 5 at
  64^2 and 2 at 1024^2), on ellipses of every radius from 2 to 160 and
  on the demo's triangle (apex up, base level) at every radius: 0
  pixels may differ, the ellipse's boundary included (the rasterizer is
  Pillow's quarter iteration, not an analytic disc).
* ``make_dataset`` writes PNGs whose pixels are Pillow's drawing and
  JAX's captions; ``concept_score`` equals JAX's on the same PNGs.
* ``vae_loss`` (JAX's ``pretrain_vae`` closure, written here for JAX
  with the sample's noise injected) on the tiny VAE with JAX's weights:
  loss and every gradient at rtol 2e-4 / atol 2e-5 (fp32 activations).
* ``demo_config`` and ``full_scale_config`` field for field against
  JAX's (only the work directories differ); the gate is JAX's rule.
* Slow lane: the fast demo (``stage_pretrain`` + ``stage_lora`` with
  ``fast=True``) raises the concept score, as JAX's
  ``TestFinetuneDemoSmoke`` checks.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from sdxl_training_improvements_tpu.models import vae as JV
from sdxl_training_improvements_tpu_torch.models import vae as TV
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.tools import finetune_demo as FD

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import finetune_demo as JD  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pil(color, shape, rng, size=64):
    return np.asarray(JD._draw(color, shape, rng, size))


@pytest.mark.parametrize("seed,size,concepts,n_per", [
    (0, 64, JD.BASE_CONCEPTS, 64), (1, 64, [JD.NEW_CONCEPT], 64),
    (5, 64, JD.BASE_CONCEPTS + [JD.NEW_CONCEPT], 48),
    (2, 1024, JD.BASE_CONCEPTS + [JD.NEW_CONCEPT], 4)])
def test_drawing_is_pillows(seed, size, concepts, n_per):
    """Every image of the demo's datasets, pixel for pixel."""
    ours, theirs = (np.random.default_rng(seed) for _ in range(2))
    for color, shape in concepts:
        for _ in range(n_per):
            a = FD._draw(color, shape, ours, size)
            b = _pil(color, shape, theirs, size)
            assert a.dtype == np.uint8 and a.shape == (size, size, 3)
            assert int((a != b).any(-1).sum()) == 0, (color, shape)


def test_ellipse_and_polygon_every_radius():
    for r in range(2, 161):
        s = 2 * r + 9
        for box in ([3, 4, 3 + 2 * r, 4 + 2 * r], [3, 4, 4 + 2 * r, 4 + r]):
            img = Image.new("RGB", (s, s), (0, 0, 0))
            ImageDraw.Draw(img).ellipse(box, fill=(255, 255, 255))
            ours = np.zeros((s, s, 3), np.uint8)
            FD._ellipse(ours, *box, (255, 255, 255))
            assert np.array_equal(ours, np.asarray(img)), (r, box)
        for cx, cy in ((r + 3, r + 3), (r + 4, r + 4)):  # the demo's form
            pts = [(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)]
            img = Image.new("RGB", (s, s), (0, 0, 0))
            ImageDraw.Draw(img).polygon(pts, fill=(255, 255, 255))
            ours = np.zeros((s, s, 3), np.uint8)
            FD._polygon(ours, pts, (255, 255, 255))
            assert np.array_equal(ours, np.asarray(img)), (r, cx)


def test_dataset_files_and_concept_score(tmp_path):
    n = FD.make_dataset(tmp_path, [("red", "circle"), ("green", "triangle")],
                        n_per=3, seed=4)
    assert n == 6
    rng = np.random.default_rng(4)
    for color, shape in [("red", "circle"), ("green", "triangle")]:
        for i in range(3):
            stem = tmp_path / f"{color}_{shape}_{i:03d}"
            got = np.asarray(Image.open(stem.with_suffix(".png"))
                             .convert("RGB"))
            assert np.array_equal(got, _pil(color, shape, rng))
            assert stem.with_suffix(".txt").read_text() == \
                f"a {color} {shape}"
            for c in JD.COLORS:
                assert FD.concept_score(stem.with_suffix(".png"), c) == \
                    JD.concept_score(stem.with_suffix(".png"), c)
    # a noisy image: the RGB ball's boundary
    noisy = tmp_path / "noisy.png"
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (40, 48, 3), dtype=np.uint8)).save(noisy)
    for c in JD.COLORS:
        assert FD.concept_score(noisy, c) == JD.concept_score(noisy, c)


def _jax_vae_loss(vae, p, px, noise):
    """JAX's ``pretrain_vae`` loss with the sample's noise injected."""
    mean, logvar = vae.apply(p, px, method=vae.moments)
    z = mean + jnp.exp(0.5 * logvar) * noise
    recon = vae.apply(p, z * vae.config.scaling_factor, method=vae.decode)
    mse = jnp.mean(jnp.square(recon - px))
    kl = 0.5 * jnp.mean(jnp.square(mean) + jnp.exp(logvar) - 1 - logvar)
    scale_pen = jnp.square(jnp.std(mean * vae.config.scaling_factor) - 1.0)
    return mse + 1e-4 * kl + 0.1 * scale_pen, mse


def test_vae_loss_and_grads_match_jax():
    rng = np.random.default_rng(3)
    px = rng.uniform(-1, 1, (3, 3, 32, 32)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    jm = JV.AutoencoderKL(JV.VAEConfig.tiny())
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(px),
                              jax.random.key(1))
    (jloss, jmse), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_vae_loss(jm, p, jnp.asarray(px), jnp.asarray(noise)),
        has_aux=True))(params)
    vae = TV.AutoencoderKL(TV.VAEConfig.tiny())
    vae.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    loss, mse = FD.vae_loss(vae, torch.from_numpy(px),
                            torch.from_numpy(noise))
    names = [n for n, _ in vae.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in vae.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(mse.detach()), float(jmse), rtol=RTOL)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(ref) == sorted(names)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_pretrain_vae_runs_and_recon_check(tmp_path):
    FD.make_dataset(tmp_path, [FD.NEW_CONCEPT], n_per=4, seed=0)
    logs = []
    vae, curve = FD.pretrain_vae(tmp_path, steps=3, batch=2, lr=2e-3,
                                 seed=0, log=logs.append, device="cpu")
    assert [c["step"] for c in curve] == [0, 2]
    assert all(np.isfinite(c["mse"]) for c in curve)
    out = FD.vae_recon_check(vae, FD.NEW_CONCEPT, logs.append)
    assert out["concept"] == "a green triangle"
    assert np.isfinite(out["recon_mse"]) and 0 < out["source_color_fraction"]


def _fields(cfg):
    """The config as a flat dict of dotted names."""
    out = {}

    def walk(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(f"{prefix}{f.name}.", v)
            else:
                out[prefix + f.name] = v
    walk("", cfg)
    return out


WORK_FIELDS = ("global_config.cache.cache_dir",
               "global_config.logging.log_dir")


def _same_config(ours, theirs):
    a, b = _fields(ours), _fields(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        if k in WORK_FIELDS:
            assert Path(a[k]).parent == FD.WORK, k
            assert Path(a[k]).name == Path(b[k]).name, k
            assert Path(b[k]).parent == JD.WORK, k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(batch=16, epochs=400, lr=4e-4, out_label="base"),
    dict(batch=16, epochs=900, lr=1e-3, out_label="lora", seed=3),
    dict(batch=4, epochs=2, lr=1e-3, out_label="x", image_size=32,
         empty_prompts=0.0)])
def test_demo_config_is_jax(tmp_path, kw):
    _same_config(FD.demo_config(tmp_path, **kw),
                 JD.demo_config(tmp_path, **kw))


def test_full_scale_config_is_jax(tmp_path, monkeypatch):
    """JAX builds its config inside ``stage_full_scale``: run it up to the
    trainer and take the config it hands over."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_trainer(cfg, out_dir, log, model=None):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(JD, "run_trainer", fake_trainer)
    monkeypatch.setattr(JD, "make_dataset", lambda *a, **k: 16)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    with pytest.raises(Stop):
        JD.stage_full_scale(lambda m: None, steps=300, image_size=1024)
    _same_config(FD.full_scale_config(JD.WORK / "data_full", 300, 1024),
                 seen["cfg"])


@pytest.mark.parametrize("before,after", [
    (0.0, 0.0), (0.0, 0.03), (0.0, 0.031), (0.01, 0.035), (0.01, 0.041),
    (0.04, 0.075), (0.04, 0.081), (0.059, 0.119), (0.2, 0.5)])
def test_gate_is_jax_rule(before, after):
    margin = 0.03
    jax_rule = (after > max(before + margin, margin)
                and after > 2.0 * before)
    assert FD.gate(before, after) == jax_rule


@pytest.mark.slow
def test_fast_demo_raises_the_concept_score(tmp_path, monkeypatch):
    monkeypatch.setattr(FD, "WORK", tmp_path / "work")
    monkeypatch.setattr(FD, "ART", tmp_path / "art")
    FD.stage_pretrain(print, fast=True, device="cpu")
    out = FD.stage_lora(print, fast=True, enforce=False, device="cpu")
    assert out["concept_score_after"] > out["concept_score_before"]
    saved = json.loads((tmp_path / "art" / "lora.json").read_text())
    assert saved["card"] is None and saved["device"] == "cpu"
