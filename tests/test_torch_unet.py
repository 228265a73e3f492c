"""PyTorch port: UNet layers and the tiny SDXL UNet against the flax modules.

Each module gets the flax module's own initial parameters (through
``from_jax_params``) and the same numpy inputs, fp32, rtol 2e-4 / atol
2e-5 (``tests/test_weight_parity.py``).  The parity hazards are pinned by
name: exact-erf GEGLU, GroupNorm eps 1e-6 in Transformer2D against 1e-5 in
the resnets, flip_sin_to_cos sinusoids, nearest upsampling, and the fp32
concat of pooled embeds with the time-id embedding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sdxl_training_improvements_tpu.models import layers as JL
from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu_torch.models import layers as TL
from sdxl_training_improvements_tpu_torch.models import unet as TU
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)

RTOL, ATOL = 2e-4, 2e-5
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _port(module, jax_params):
    module.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params)), strict=True)
    return module.eval()


def _jax(module, seed, *args):
    """(params, output) of a flax module, jitted (eager flax dispatches
    op by op and is slow on the CPU)."""
    args = [None if a is None else jnp.asarray(a) for a in args]
    params = jax.jit(module.init)(jax.random.key(seed), *args)
    return params, jax.jit(module.apply)(params, *args)


def _close(port_nchw, jax_nhwc):
    np.testing.assert_allclose(port_nchw.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_nhwc), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding_flip_sin_to_cos(dim):
    t = np.asarray([0, 1, 250, 999, 1024], np.float32)
    ref = JL.timestep_embedding(jnp.asarray(t), dim)
    out = TL.timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # flip_sin_to_cos: the cosine half comes first
    np.testing.assert_allclose(out[0, :dim // 2].numpy(), 1.0)


@pytest.mark.parametrize("cin,cout,emb,eps,groups", [
    (64, 64, 32, 1e-5, 32),   # UNet resnet with time embedding
    (32, 64, 32, 1e-5, 32),   # channel change -> conv_shortcut
    (16, 32, None, 1e-6, 8),  # VAE resnet: no embedding, eps 1e-6
])
def test_resnet_block(cin, cout, emb, eps, groups):
    x = _rand((2, 8, 8, cin), 0)
    e = None if emb is None else _rand((2, emb), 1)
    jm = JL.ResnetBlock2D(out_channels=cout, emb_dim=emb, num_groups=groups,
                          eps=eps, **F32)
    params, ref = _jax(jm, 0, x, e)
    tm = _port(TL.ResnetBlock2D(cin, cout, emb, groups, eps), params)
    with torch.no_grad():
        out = tm(_nchw(x), None if e is None else torch.from_numpy(e))
    _close(out, ref)


def test_transformer2d_groupnorm_eps_is_1e6():
    """Transformer2D normalizes with eps 1e-6 (the resnets use 1e-5); an
    input of variance ~1e-5 makes the difference visible."""
    x = 3e-3 * _rand((2, 4, 4, 64), 2)
    ctx = _rand((2, 77, 48), 3)
    jm = JL.Transformer2DModel(num_heads=4, head_dim=16, depth=2,
                               attn_impl="xla", **F32)
    params, ref = _jax(jm, 1, x, ctx)
    tm = _port(TL.Transformer2DModel(64, 48, 4, 16, 2), params)
    assert tm.norm.eps == 1e-6
    with torch.no_grad():
        out = tm(_nchw(x), torch.from_numpy(ctx))
        tm.norm.eps = 1e-5
        wrong = tm(_nchw(x), torch.from_numpy(ctx))
    _close(out, ref)
    assert (wrong - out).abs().max().item() > 100 * ATOL


def test_geglu_is_exact_erf():
    x = _rand((2, 10, 32), 4)
    jm = JL.GEGLU(inner_dim=64, **F32)
    params, ref = _jax(jm, 2, x)
    ref = np.asarray(ref)
    tm = _port(TL.GEGLU(32, 64), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
        h, gate = tm.proj(torch.from_numpy(x)).chunk(2, dim=-1)
        tanh_form = h * F.gelu(gate, approximate="tanh")
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert np.abs(tanh_form.numpy() - ref).max() > 10 * ATOL


@pytest.mark.parametrize("cls,jcls", [(TL.Upsample2D, JL.Upsample2D),
                                      (TL.Downsample2D, JL.Downsample2D)])
def test_resamplers(cls, jcls):
    """Upsampling is nearest-neighbour, then conv3x3."""
    x = _rand((1, 5, 6, 16), 5)
    jm = jcls(channels=16, **F32)
    params, ref = _jax(jm, 3, x)
    tm = _port(cls(16), params)
    with torch.no_grad():
        out = tm(_nchw(x))
    _close(out, ref)


@pytest.fixture(scope="module")
def tiny_unets():
    cfg = JU.UNetConfig.tiny()
    jm = JU.SDXLUNet(config=cfg, dtype=jnp.float32,
                     param_dtype=jnp.float32)
    args = (_rand((2, 4, 16, 16), 6), np.asarray([10, 900], np.int32),
            _rand((2, 77, cfg.cross_attention_dim), 7),
            _rand((2, cfg.pooled_embed_dim), 8),
            np.asarray([[64, 64, 0, 0, 64, 64], [32, 48, 4, 2, 32, 48]],
                       np.float32))
    params = jax.jit(jm.init)(jax.random.key(4), *map(jnp.asarray, args))
    tm = _port(TU.SDXLUNet(TU.UNetConfig.tiny()), params)
    return jm, params, tm, args


def test_tiny_unet_forward(tiny_unets):
    jm, params, tm, args = tiny_unets
    ref = jax.jit(jm.apply)(params, *map(jnp.asarray, args))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, args))
    assert out.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_tiny_unet_time_ids_enter_in_fp32(tiny_unets):
    """The pooled embeds and the time-id sinusoids are concatenated in fp32
    before the add-embedding; real SDXL ids (1024, 1536, crops) agree."""
    jm, params, tm, args = tiny_unets
    args = args[:4] + (np.asarray([[1024, 1024, 0, 0, 1024, 1024],
                                   [1536, 640, 8, 16, 1536, 640]],
                                  np.float32),)
    ref = jax.jit(jm.apply)(params, *map(jnp.asarray, args))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_config_matches_jax_topology():
    for name in ("sdxl", "tiny"):
        j, t = getattr(JU.UNetConfig, name)(), getattr(TU.UNetConfig, name)()
        for f in TU.UNetConfig.__dataclass_fields__:
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert (t.time_embed_dim, t.pooled_embed_dim, t.mid_depth) == \
            (j.time_embed_dim, j.pooled_embed_dim, j.mid_depth)
