"""PyTorch port: gradients flow through the kernel paths.

The kernels' outputs are fresh tensors written through ctypes or Triton;
without a ``torch.autograd.Function`` around them the graph is cut and
``backward`` leaves the attention projections and every GroupNorm+SiLU
weight without a gradient, silently.  Here the two Functions run on CPU
tensors with the plain versions in the kernels' places (monkeypatched in
the test; the package has no switch) and their gradients are held against
autograd through the plain path in fp32: rtol 2e-4 / atol 2e-5.  Then every
UNet parameter of the tiny model gets a finite gradient through one
``ddpm_loss`` backward, with and without remat, and with the UNet's
attention and GroupNorm+SiLU sites routed through the two Functions as on
the card; remat changes no gradient.  Last, the bf16 norm interior
(``norm_arith_bf16``) against the JAX package's, at bf16 precision.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.models import layers as JL
from sdxl_training_improvements_tpu.ops import groupnorm as JG
from sdxl_training_improvements_tpu_torch.models import layers as TL
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF
from sdxl_training_improvements_tpu_torch.ops import groupnorm as TG
from sdxl_training_improvements_tpu_torch.ops.attention import (
    dot_product_attention_reference)
from sdxl_training_improvements_tpu_torch.training.methods import ddpm_loss
from sdxl_training_improvements_tpu_torch.training.schedules import (
    NoiseSchedule)

RTOL, ATOL = 2e-4, 2e-5


def _leaves(*shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).requires_grad_() for s in shapes]


def _grads(fn, leaves, cot):
    (fn(*leaves) * cot).sum().backward()
    out = [x.grad.clone() for x in leaves]
    for x in leaves:
        x.grad = None
    return out


@pytest.mark.parametrize("s,t", [(64, 64), (50, 77)])
def test_flash_function_gradients_match_plain_autograd(monkeypatch, s, t):
    monkeypatch.setattr(TF, "flash_attention_fwd_cuda",
                        TF.flash_attention_fwd_reference)
    monkeypatch.setattr(TF, "flash_attention_bwd_cuda",
                        TF.flash_attention_bwd_reference)
    leaves = _leaves((2, s, 3, 16), (2, t, 3, 16), (2, t, 3, 16))
    cot = torch.randn(2, s, 3, 16, generator=torch.Generator().manual_seed(1))
    got = _grads(TF.flash_attention, leaves, cot)
    ref = _grads(dot_product_attention_reference, leaves, cot)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


def test_gn_silu_function_gradients_match_plain_autograd(monkeypatch):
    monkeypatch.setattr(TG, "groupnorm_silu_cuda",
                        TG.groupnorm_silu_reference)
    x, scale, bias = _leaves((2, 48, 64), (64,), (64,), seed=2)
    cot = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(3))
    got = _grads(lambda *a: TG.GroupNormSiLU.apply(*a, 32, 1e-5),
                 [x, scale, bias], cot)
    ref = _grads(lambda *a: TG.groupnorm_silu_reference(*a, 32, 1e-5),
                 [x, scale, bias], cot)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)


def _through_functions(monkeypatch):
    """Route the UNet's kernel sites through the autograd Functions, as a
    CUDA tensor is, with the plain versions in the kernels' places."""
    monkeypatch.setattr(TF, "flash_attention_fwd_cuda",
                        TF.flash_attention_fwd_reference)
    monkeypatch.setattr(TF, "flash_attention_bwd_cuda",
                        TF.flash_attention_bwd_reference)
    monkeypatch.setattr(TG, "groupnorm_silu_cuda",
                        TG.groupnorm_silu_reference)
    monkeypatch.setattr(TL, "dot_product_attention", TF.flash_attention)

    def gn_silu(x, scale, bias, groups, eps):
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])
        return TG.GroupNormSiLU.apply(x3, scale, bias, groups,
                                      eps).reshape(x.shape)
    monkeypatch.setattr(TL, "groupnorm_silu", gn_silu)


def _tiny_loss_grads(remat: bool):
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                             unet_config=UNetConfig.tiny(remat=remat))
    g = torch.Generator().manual_seed(4)
    cfg = model.unet_config
    batch = {"vae_latents": torch.randn(2, 4, 16, 16, generator=g),
             "prompt_embeds": torch.randn(2, 77, cfg.cross_attention_dim,
                                          generator=g),
             "pooled_prompt_embeds": torch.randn(2, cfg.pooled_embed_dim,
                                                 generator=g),
             "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2),
             "timesteps": torch.tensor([300, 700])}
    loss, _ = ddpm_loss(model.unet_apply, batch, g, NoiseSchedule.create(),
                        None)
    loss.backward()
    return {n: p.grad for n, p in model.unet.named_parameters()}


@pytest.mark.parametrize("remat,functions", [(False, False), (True, False),
                                              (True, True)])
def test_every_unet_parameter_gets_a_finite_gradient(monkeypatch, remat,
                                                      functions):
    if functions:
        _through_functions(monkeypatch)
    grads = _tiny_loss_grads(remat)
    missing = [n for n, g in grads.items() if g is None]
    assert not missing, missing[:5]
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    assert not bad, bad[:5]
    # the norm -> conv branches and the projections carry signal
    for n in ("down_blocks.0.resnets.0.norm1.weight",
              "mid_block.attentions.0.transformer_blocks.0.attn1.to_q.weight",
              "conv_norm_out.bias"):
        assert grads[n].abs().max() > 0, n


def test_remat_changes_no_gradient():
    plain, remat = _tiny_loss_grads(False), _tiny_loss_grads(True)
    for n, g in plain.items():
        torch.testing.assert_close(remat[n], g, rtol=1e-5, atol=1e-7)


def _bf16(x: np.ndarray):
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).bfloat16())


@pytest.mark.parametrize("which", ["group_norm", "groupnorm_silu",
                                   "layer_norm"])
def test_bf16_norm_interior_matches_jax(which):
    """Under ``norm_arith_bf16`` a bf16 input normalizes in bf16 after
    fp32 single-pass statistics; both frameworks round each bf16 op, so
    they agree to a few bf16 ulps of outputs of size ~3 (3e-2)."""
    rng = np.random.default_rng(5)
    x = (1.5 * rng.standard_normal((2, 4, 4, 64)) + 1.0).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _bf16(x)
    if which == "layer_norm":
        jm = JL.LayerNormF32()
        params = {"params": {"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}}
        jfn = functools.partial(jm.apply, params)
        tm = TL.LayerNormF32(64)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(scale))
            tm.bias.copy_(torch.from_numpy(bias))
        tfn = tm
    else:
        jf = JL.group_norm if which == "group_norm" else \
            JG.groupnorm_silu_reference
        tf = TL.group_norm if which == "group_norm" else \
            TG.groupnorm_silu_reference
        jfn = lambda a: jf(a, jnp.asarray(scale), jnp.asarray(bias), 32,
                           1e-5)
        tfn = lambda a: tf(a, torch.from_numpy(scale),
                           torch.from_numpy(bias), 32, 1e-5)
    with JG.norm_arith_bf16(True):
        ref = np.asarray(jfn(jx), np.float32)
    with TG.norm_arith_bf16(True), torch.no_grad():
        out = tfn(tx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2, rtol=0)
    with torch.no_grad():  # off: the fp32 interior, a different rounding
        assert not torch.equal(tfn(tx), out)
