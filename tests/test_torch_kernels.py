"""PyTorch port: kernel dispatch and the hand-written kernels.

This file imports torch and the port only (no JAX), so the card's tests
run on a machine without JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

On the CPU the wrappers take the plain versions and launch nothing; the
``cuda`` tests skip.  On the card each kernel is held against its plain
version: GN+SiLU fp32 max abs 1e-4 and bf16 2e-2 against the fp32-interior
plain version; flash forward bf16 out 2e-2 and lse 1e-3 against the plain
fp32-softmax version; the tiny UNet through the kernels against the plain
path at relative L2 3e-2.
"""
import inspect
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch.models import layers
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.ops import attention as TA
from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF
from sdxl_training_improvements_tpu_torch.ops import groupnorm as TG
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the H100 (README)")


def _launches():
    return (TG.gn_silu_stats_cuda.launches, TG.gn_silu_apply_cuda.launches,
            TF.flash_attention_fwd_cuda.launches)


def _gn_inputs(shape, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g) * 1.5 + 1.0
    scale = 1.0 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    return x.to(device, dtype), scale.to(device), bias.to(device)


def _qkv(b, s, t, h, d, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((b, n, h, d), generator=g).to(device, dtype)
                 for n in (s, t, t))


def _plain_ops():
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        layers, "groupnorm_silu", TG.groupnorm_silu_reference))
    stack.enter_context(mock.patch.object(
        layers, "dot_product_attention", TA.dot_product_attention_reference))
    return stack


# ------------------------------------------------------------------ CPU


def test_cpu_tensors_take_plain_paths_without_launch():
    before = _launches()
    x, scale, bias = _gn_inputs((1, 4, 4, 64))
    assert torch.equal(TG.groupnorm_silu(x, scale, bias, 32, 1e-5),
                       TG.groupnorm_silu_reference(x, scale, bias, 32, 1e-5))
    q, k, v = _qkv(1, 16, 77, 2, 16)
    assert torch.equal(TA.dot_product_attention(q, k, v),
                       TA.dot_product_attention_reference(q, k, v))
    assert _launches() == before


@pytest.mark.parametrize("call", [
    lambda x: TG.groupnorm_silu(x, torch.ones(32), torch.zeros(32)),
    lambda x: TA.dot_product_attention(x, x, x),
])
def test_other_devices_raise(call):
    with pytest.raises(ValueError, match="no kernel"):
        call(torch.zeros((1, 4, 2, 32), device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_attention_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        TG.groupnorm_silu_cuda(torch.zeros(1, 8, 64), torch.ones(64),
                               torch.zeros(64))


def test_bf16_model_dtypes_and_cpu_run():
    """bf16 UNet and CLIP weights with fp32 norm parameters, an fp32 VAE
    (the card's configuration), run end to end on the CPU."""
    model = SDXLModel.create(tiny=True, dtype=torch.bfloat16, device="cpu")
    assert model.unet.conv_in.weight.dtype == torch.bfloat16
    assert model.unet.conv_in.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert model.unet.conv_norm_out.weight.dtype == torch.float32
    assert model.clip_g.text_model.final_layer_norm.weight.dtype == \
        torch.float32
    assert model.clip_l.text_model.embeddings.token_embedding.weight.dtype \
        == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.vae.parameters())
    lat = SDXLPipeline.from_model(model)(["a cat"], height=32, width=32,
                                         num_inference_steps=2,
                                         return_latents=True)
    assert lat.shape == (1, 4, 16, 16) and torch.isfinite(lat).all()


def test_seeded_create_is_reproducible():
    a, b, c = (SDXLModel.create(tiny=True, device="cpu",
                                 generator=torch.Generator().manual_seed(s))
               for s in (5, 5, 6))
    wa, wb, wc = (m.unet.conv_in.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


def test_create_defaults_to_the_card():
    """The entry point builds on CUDA unless the caller asks for the CPU:
    with no card it raises rather than building on the CPU."""
    assert inspect.signature(SDXLModel.create).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        assert SDXLModel.create(tiny=True).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            SDXLModel.create(tiny=True)


def test_create_turns_tf32_off():
    """fp32 products stay full fp32 on the card: cuDNN's TF32 default
    would otherwise put the fp32 VAE convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    SDXLModel.create(tiny=True, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# ------------------------------------------------------------------ card


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,eps,tol", [
    ((2, 1024, 320), torch.bfloat16, 1e-5, 2e-2),
    ((2, 256, 2560), torch.bfloat16, 1e-5, 2e-2),
    ((2, 100, 64), torch.bfloat16, 1e-5, 2e-2),
    ((1, 65536, 128), torch.float32, 1e-6, 1e-4),
    ((2, 77, 16), torch.float32, 1e-6, 1e-4),
])
def test_gn_kernels_match_plain(cuda, shape, dtype, eps, tol):
    x, scale, bias = _gn_inputs(shape, seed=5, device="cuda", dtype=dtype)
    groups = 8 if shape[-1] == 16 else 32
    before = _launches()
    out = TG.groupnorm_silu(x, scale, bias, groups, eps)
    ref = TG.groupnorm_silu_reference(x.float(), scale, bias, groups, eps)
    torch.cuda.synchronize()
    assert _launches()[:2] == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,d", [(2, 1024, 1024, 4, 64),
                                       (2, 4096, 77, 2, 64),
                                       (1, 100, 77, 3, 16),
                                       (1, 130, 200, 2, 32),
                                       (1, 130, 200, 2, 128)])
def test_flash_kernel_matches_plain(cuda, b, s, t, h, d):
    q, k, v = _qkv(b, s, t, h, d, seed=9, device="cuda",
                   dtype=torch.bfloat16)
    before = _launches()[2]
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v)
    torch.cuda.synchronize()
    assert _launches()[2] == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_kernel_reads_strided_projections(cuda):
    """q/k/v as views of [B, S, H*D] projections are read in place."""
    x = torch.randn(2, 300, 4 * 64, device="cuda").bfloat16()
    q = x.view(2, 300, 4, 64)
    kv = torch.randn(2, 77, 2 * 4 * 64, device="cuda").bfloat16()
    k, v = kv.view(2, 77, 2, 4, 64).unbind(2)
    out, _ = TF.flash_attention_fwd_cuda(q, k, v)
    ref, _ = TF.flash_attention_fwd_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,err", [(torch.float32, 64, TypeError),
                                         (torch.bfloat16, 48, ValueError)])
def test_flash_kernel_rejects_what_it_does_not_take(cuda, dtype, d, err):
    q = torch.zeros((1, 8, 1, d), device="cuda", dtype=dtype)
    with pytest.raises(err):
        TF.flash_attention_fwd_cuda(q, q, q)


@pytest.mark.cuda
def test_tiny_unet_kernel_path_matches_plain(cuda):
    model = SDXLModel.create(tiny=True, dtype=torch.bfloat16, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    cfg = model.unet_config
    args = (torch.randn(2, 4, 32, 32, device="cuda", generator=g),
            torch.tensor([10, 900], device="cuda"),
            torch.randn(2, 77, cfg.cross_attention_dim, device="cuda",
                        generator=g),
            torch.randn(2, cfg.pooled_embed_dim, device="cuda", generator=g),
            torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2, device="cuda"))
    before = _launches()
    with torch.inference_mode():
        out = model.unet_apply(*args).float()
        launched = [a - b for a, b in zip(_launches(), before)]
        with _plain_ops():
            ref = model.unet_apply(*args).float()
    assert all(n > 0 for n in launched), launched
    assert ((out - ref).norm() / ref.norm()).item() <= 3e-2


@pytest.mark.cuda
def test_tiny_pipeline_on_card(cuda):
    model = SDXLModel.create(tiny=True, dtype=torch.bfloat16, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    before = _launches()
    images = SDXLPipeline.from_model(model)(["a cat"], height=64, width=64,
                                            num_inference_steps=3)
    assert images[0].shape == (64, 64, 3) and images[0].dtype == np.uint8
    assert all(a > b for a, b in zip(_launches(), before))
