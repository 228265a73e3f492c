"""PyTorch port: CLIP text encoders and the VAE against the flax modules.

Same weights (``from_jax_params``) and numpy inputs, fp32, rtol 2e-4 /
atol 2e-5.  Pinned hazards: CLIP-G's exact-erf GELU against CLIP-L's
quick-GELU, the -1e9 (not -inf) logit mask, EOS pooling at the first
argmax, the VAE's nearest upsampling and its asymmetric (0,1)x(0,1)
downsampling pad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.models import clip as JC
from sdxl_training_improvements_tpu.models import vae as JV
from sdxl_training_improvements_tpu_torch.models import clip as TC
from sdxl_training_improvements_tpu_torch.models import vae as TV
from sdxl_training_improvements_tpu_torch.models.tokenizer import (
    HashTokenizer)
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)

RTOL, ATOL = 2e-4, 2e-5
CAPTIONS = ["a photo of a cat", "", "an oil painting of a lighthouse at dusk"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clip_pair(jcfg, tcfg, seed):
    ids = HashTokenizer(jcfg.vocab_size)(CAPTIONS)
    jm = JC.CLIPTextModel(jcfg)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(ids))
    tm = TC.CLIPTextModel(tcfg)
    tm.load_state_dict(from_jax_params(_np(params), clip=True), strict=True)
    return jm, params, tm.eval(), ids


@pytest.mark.parametrize("act,projection", [("gelu", True),
                                            ("quick_gelu", False)])
def test_clip_text_model(act, projection):
    kw = dict(vocab_size=1000, hidden_size=32, num_layers=3, num_heads=4,
              hidden_act=act, projection_dim=32 if projection else None)
    jm, params, tm, ids = _clip_pair(JC.CLIPTextConfig(**kw),
                                     TC.CLIPTextConfig(**kw), seed=0)
    ref = jax.jit(jm.apply)(params, jnp.asarray(ids))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long())
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == 4
    for a, b in zip(out["hidden_states"], ref["hidden_states"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for k in ("last_hidden_state", "pooled_output"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_activations_differ_by_name():
    x = torch.linspace(-4, 4, 101)
    assert (TC._act("gelu", x) - TC._act("quick_gelu", x)).abs().max() > 1e-2
    np.testing.assert_allclose(
        TC._act("gelu", x).numpy(),
        np.asarray(JC._act("gelu")(jnp.asarray(x.numpy()))), atol=1e-6)
    np.testing.assert_allclose(
        TC._act("quick_gelu", x).numpy(),
        np.asarray(JC._act("quick_gelu")(jnp.asarray(x.numpy()))),
        atol=1e-6)


def test_eos_pooling_takes_first_eos():
    """Padding repeats the EOS id; pooling takes the first one (the true
    EOS), as JAX's and transformers' argmax does."""
    cfg = TC.CLIPTextConfig.tiny()
    tm = TC.CLIPTextModel(cfg).eval()
    ids = torch.from_numpy(HashTokenizer(cfg.vocab_size)(CAPTIONS)).long()
    with torch.no_grad():
        out = tm(ids)
    first_eos = [list(r).index(cfg.vocab_size - 1) for r in ids.tolist()]
    assert first_eos == [6, 1, 9]
    for b, p in enumerate(first_eos):
        torch.testing.assert_close(out["pooled_output"][b],
                                   out["last_hidden_state"][b, p])


def test_attention_mask_is_minus_1e9():
    """A fully masked row averages the values (softmax of equal -1e9
    logits) instead of producing NaN, in both frameworks."""
    x = np.random.default_rng(1).standard_normal((1, 5, 32)).astype(
        np.float32)
    mask = np.tril(np.ones((5, 5), bool))
    mask[2] = False
    jm = JC.CLIPAttention(num_heads=4)
    params = jm.init(jax.random.key(2), jnp.asarray(x),
                     jnp.asarray(mask)[None, None])
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(mask)[None, None])
    tm = TC.CLIPAttention(32, 4)
    tm.load_state_dict(from_jax_params(_np(params)), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_encode_dual_and_encode_g():
    jl, pl, tl, ids_l = _clip_pair(JC.CLIPTextConfig.tiny(),
                                   TC.CLIPTextConfig.tiny(), seed=3)
    jg, pg, tg, ids_g = _clip_pair(JC.CLIPTextConfig.tiny(projection=True),
                                   TC.CLIPTextConfig.tiny(projection=True),
                                   seed=4)
    ref = JC.encode_dual(jl, pl, jg, pg, jnp.asarray(ids_l),
                         jnp.asarray(ids_g))
    with torch.no_grad():
        out = TC.encode_dual(tl, tg, torch.from_numpy(ids_l).long(),
                             torch.from_numpy(ids_g).long())
    assert out["prompt_embeds"].shape == (3, 77, 64)
    ref_g = JC.encode_g(jg, pg, jnp.asarray(ids_g))
    with torch.no_grad():
        out_g = TC.encode_g(tg, torch.from_numpy(ids_g).long())
    assert out_g["prompt_embeds"].shape == (3, 77, 32)
    for ours, theirs in ((out, ref), (out_g, ref_g)):
        for k in ("prompt_embeds", "pooled_prompt_embeds"):
            np.testing.assert_allclose(ours[k].numpy(),
                                       np.asarray(theirs[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def vaes():
    jm = JV.AutoencoderKL(JV.VAEConfig.tiny())
    pixels = np.random.default_rng(5).uniform(-1, 1, (2, 3, 16, 16)).astype(
        np.float32)
    params = jax.jit(jm.init)(jax.random.key(5), jnp.asarray(pixels),
                              jax.random.key(6))
    tm = TV.AutoencoderKL(TV.VAEConfig.tiny())
    tm.load_state_dict(from_jax_params(_np(params)), strict=True)
    return jm, params, tm.eval(), pixels


def test_vae_decode(vaes):
    jm, params, tm, _ = vaes
    latents = np.random.default_rng(7).standard_normal((2, 4, 8, 8)).astype(
        np.float32) * 0.2
    ref = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(
        params, jnp.asarray(latents))
    with torch.no_grad():
        out = tm.decode(torch.from_numpy(latents))
    assert out.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_vae_encoder_asymmetric_downsample_pad(vaes):
    """The encoder's stride-2 convs pad (0,1)x(0,1), not (1,1)x(1,1)."""
    jm, params, tm, pixels = vaes
    ref = jax.jit(lambda p, x: jm.apply(p, x, method=jm.moments))(
        params, jnp.asarray(pixels))
    with torch.no_grad():
        out = tm.moments(torch.from_numpy(pixels))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    assert tm.encoder.down_blocks[0].downsamplers[0].conv.padding == (0, 0)
