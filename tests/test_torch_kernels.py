"""PyTorch port: kernel dispatch and the hand-written kernels.

This file imports torch and the port only (no JAX), so the card's tests
run on a machine without JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

On the CPU the wrappers take the plain versions and launch nothing; the
``cuda`` tests skip.  On the card each kernel is held against its plain
version: the GN+SiLU forward fp32 max abs 1e-4, bf16 2e-2 and fp16 4e-3
(about half an output ulp at |y| < 8) against the fp32-interior plain
version, its mean and rstd within 1e-4 of the two-pass statistics (the
backward kernel: ``test_torch_train_kernels.py``); flash
forward out and lse against the plain fp32-softmax version, bf16 2e-2 and
1e-3, fp16 4e-3 and 1e-3 (the kernel rounds P to fp16 before its product,
the plain version after normalising), fp32 2e-5 and 2e-5 (the Pallas
kernels' own fp32 bar, ``tests/test_flash_attention.py``; with q scaled by
50, 1e-4 of max |out| and 4e-6 of max |lse|, as the kernel's split TF32
holds S to ~2^-21 of |S|); the tiny UNet
through the kernels against the plain path at relative L2 3e-2 (bf16),
1e-2 (fp16) and 1e-4 (fp32, the kernels' and cuDNN's summation order).
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


# flash forward (out, lse) bars by dtype
FWD_TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float16: (4e-3, 1e-3),
           torch.float32: (2e-5, 2e-5)}


# GN+SiLU max abs error against the fp32-interior plain version, by dtype
GN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
_BF16, _F16, _F32 = torch.bfloat16, torch.float16, torch.float32
# (shape, dtype, eps): chip_smoke.py's GN_SHAPES, its backward sites
# (GN_BWD_SHAPES), a ragged S at C = 64, C = 960 (not a multiple of 128),
# the VAE's C = 128 (C/G = 4, a vector over two groups) and the tiny
# VAE's C = 16 in 8 groups (C/G = 2)
GN_CASES = [
    ((2, 16384, 320), _BF16, 1e-5), ((2, 4096, 640), _BF16, 1e-5),
    ((2, 1024, 2560), _BF16, 1e-5), ((2, 4096, 640), _F16, 1e-5),
    ((2, 4096, 640), _F32, 1e-5), ((1, 65536, 512), _F32, 1e-6),
    ((1, 1048576, 128), _F32, 1e-6),
    ((4, 16384, 320), _BF16, 1e-5), ((4, 16384, 960), _BF16, 1e-5),
    ((4, 4096, 640), _BF16, 1e-5), ((4, 1024, 2560), _BF16, 1e-5),
    ((1, 4096, 640), _F16, 1e-5), ((1, 4096, 320), _F32, 1e-5),
    ((2, 100, 64), _BF16, 1e-5), ((2, 300, 960), _BF16, 1e-5),
    ((2, 300, 960), _F32, 1e-5), ((1, 4096, 128), _BF16, 1e-6),
    ((2, 77, 16), _F32, 1e-6),
]


def _launches():
    return (TG.gn_silu_fwd_cuda.launches, TG.gn_silu_bwd_cuda.launches,
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
    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        TG.gn_silu_fwd_cuda(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA"):
        TG.gn_silu_bwd_cuda(x, x, torch.ones(64), torch.zeros(64),
                            torch.zeros(1, 32), torch.ones(1, 32))


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
@pytest.mark.parametrize("shape,dtype,eps", GN_CASES)
def test_gn_kernels_match_plain(cuda, shape, dtype, eps):
    """The forward kernel: y within ``GN_TOL`` of the fp32-interior plain
    version, its mean and rstd within 1e-4 of the two-pass statistics; one
    launch a call, a second launch bit-equal."""
    x, scale, bias = _gn_inputs(shape, seed=5, device="cuda", dtype=dtype)
    groups = 8 if shape[-1] == 16 else 32
    before = _launches()
    got = TG.gn_silu_fwd_cuda(x, scale, bias, groups, eps)
    torch.cuda.synchronize()
    assert _launches()[:2] == (before[0] + 1, before[1])
    again = TG.gn_silu_fwd_cuda(x, scale, bias, groups, eps)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    y, mean, rstd = got
    ref = TG.groupnorm_silu_reference(x.float(), scale, bias, groups, eps)
    ref_mean, ref_rstd = TG.group_stats_reference(x, groups, eps)
    assert y.dtype == dtype and y.shape == x.shape
    assert (y.float() - ref).abs().max().item() <= GN_TOL[dtype]
    assert (mean - ref_mean).abs().max().item() <= 1e-4
    assert (rstd - ref_rstd).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_gn_kernels_refuse_what_they_do_not_take(cuda):
    """A non-contiguous x, C not a multiple of 32 groups, float64 and a dy
    of another shape raise before any launch."""
    one, zero = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    stats = (torch.zeros(1, 32, device="cuda"),
             torch.ones(1, 32, device="cuda"))
    x = torch.randn(1, 8, 64, device="cuda")
    before = _launches()
    strided = torch.randn(1, 64, 8, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TG.gn_silu_fwd_cuda(strided, one, zero)
    with pytest.raises(ValueError, match="contiguous"):
        TG.gn_silu_bwd_cuda(x, strided, one, zero, *stats)
    x48 = torch.randn(1, 8, 48, device="cuda")
    one48, zero48 = one[:48], zero[:48]
    with pytest.raises(ValueError, match="multiple"):
        TG.gn_silu_fwd_cuda(x48, one48, zero48)
    with pytest.raises(ValueError, match="multiple"):
        TG.gn_silu_bwd_cuda(x48, x48, one48, zero48, *stats)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        TG.gn_silu_fwd_cuda(x.double(), one, zero)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        TG.gn_silu_bwd_cuda(x.double(), x.double(), one, zero, *stats)
    with pytest.raises(ValueError, match="dy must match"):
        TG.gn_silu_bwd_cuda(x[:, :4], x, one, zero, *stats)
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,d", [(2, 1024, 1024, 4, 64),
                                       (2, 4096, 77, 2, 64),
                                       (1, 100, 77, 3, 16),
                                       (1, 130, 200, 2, 32),
                                       (1, 130, 200, 2, 128),
                                       (1, 127, 77, 2, 16),
                                       (1, 129, 129, 2, 16),
                                       (1, 300, 300, 2, 32),
                                       (1, 129, 77, 3, 32),
                                       (1, 127, 127, 2, 64),
                                       (2, 300, 129, 3, 64),
                                       (1, 129, 77, 2, 128),
                                       (1, 300, 300, 2, 128),
                                       (2, 4096, 4096, 10, 64)])
def test_flash_kernel_matches_plain(cuda, b, s, t, h, d):
    """Every head dim, q lengths on both sides of the 128-row tile, the
    77-token and 129-row kv edges, T = S, and the B2 H10 S=T=4096 site;
    one launch per call, and a second launch bit-equal to the first."""
    q, k, v = _qkv(b, s, t, h, d, seed=9, device="cuda",
                   dtype=torch.bfloat16)
    before = _launches()[2]
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert _launches()[2] == before + 1
    out2, lse2 = TF.flash_attention_fwd_cuda(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_kernel_reads_strided_projections(cuda):
    """q/k/v as views of [B, S, H*D] projections are read in place."""
    x = torch.randn(2, 300, 4 * 64, device="cuda").bfloat16()
    q = x.view(2, 300, 4, 64)
    kv = torch.randn(2, 77, 2 * 4 * 64, device="cuda").bfloat16()
    k, v = kv.view(2, 77, 2, 4, 64).unbind(2)
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,err", [(torch.float64, 64, TypeError),
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
    assert launched[0] > 0 and launched[2] > 0, launched  # no backward
    assert ((out - ref).norm() / ref.norm()).item() <= 3e-2


@pytest.mark.cuda
def test_tiny_pipeline_on_card(cuda):
    model = SDXLModel.create(tiny=True, dtype=torch.bfloat16, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    before = _launches()
    images = SDXLPipeline.from_model(model)(["a cat"], height=64, width=64,
                                            num_inference_steps=3)
    assert images[0].shape == (64, 64, 3) and images[0].dtype == np.uint8
    now = _launches()
    assert now[0] > before[0] and now[2] > before[2]  # GN forward, flash


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1024, 320), (2, 4096, 640),
                                   (2, 100, 64)])
def test_gn_kernels_match_plain_fp16(cuda, shape):
    """The forward kernel loads fp16, computes in fp32 and stores fp16,
    through the dispatcher: one launch, no backward."""
    x, scale, bias = _gn_inputs(shape, seed=6, device="cuda",
                                dtype=torch.float16)
    before = _launches()
    out = TG.groupnorm_silu(x, scale, bias, 32, 1e-5)
    ref = TG.groupnorm_silu_reference(x.float(), scale, bias, 32, 1e-5)
    torch.cuda.synchronize()
    assert _launches()[:2] == (before[0] + 1, before[1])
    assert out.dtype == torch.float16
    assert (out.float() - ref).abs().max().item() <= 4e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("b,s,t,h,d", [(1, 100, 77, 3, 16),
                                       (1, 129, 129, 2, 16),
                                       (1, 130, 200, 2, 32),
                                       (1, 127, 77, 2, 64),
                                       (2, 300, 129, 3, 64),
                                       (1, 129, 77, 2, 128),
                                       (1, 300, 300, 2, 128),
                                       (2, 4096, 4096, 10, 64),
                                       (1, 127, 63, 2, 16),
                                       (1, 128, 65, 2, 32),
                                       (1, 129, 64, 3, 64),
                                       (2, 257, 127, 2, 64),
                                       (1, 127, 31, 2, 128),
                                       (1, 129, 33, 2, 128)])
def test_flash_kernel_fp16_fp32_match_plain(cuda, dtype, b, s, t, h, d):
    """The fp16 instantiation of the Hopper forward and the fp32 kernel:
    every head dim, q and kv lengths on both sides of the kernels' tiles
    (128 q rows for both; kv tiles of 128 rows for the 16-bit kernel, 64
    at D = 128, and of 64 rows for the fp32 one, 32 at D = 128), the
    77-token edge and the B2 H10 S=T=4096 site; one launch of that dtype's
    kernel per call, out in the input's dtype, a second launch
    bit-equal."""
    q, k, v = _qkv(b, s, t, h, d, seed=10, device="cuda", dtype=dtype)
    launcher = TF.LAUNCHERS["fwd"][dtype]
    before = launcher.launches
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1 and out.dtype == dtype
    out2, lse2 = TF.flash_attention_fwd_cuda(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v)
    out_tol, lse_tol = FWD_TOL[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


# q scaled by 50 (logits to ~240), fp32: max abs error of out over max
# |plain out| and of lse over max |plain lse|; the kernel's split TF32
# holds S to ~2^-21 of |S| (tests/test_torch_flash_fwd.py)
FWD_LARGE_LOGIT_TOL = (1e-4, 4e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,d", [(1, 256, 256, 2, 64),
                                       (1, 1000, 77, 2, 64),
                                       (1, 300, 129, 2, 128)])
def test_flash_kernel_fp32_large_logits(cuda, b, s, t, h, d):
    """fp32 forward with q scaled by 50 against the plain forward, at
    ``FWD_LARGE_LOGIT_TOL``; a second launch bit-equal."""
    q, k, v = _qkv(b, s, t, h, d, seed=11, device="cuda",
                   dtype=torch.float32)
    q = 50 * q
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    out2, lse2 = TF.flash_attention_fwd_cuda(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v)
    out_rel, lse_rel = FWD_LARGE_LOGIT_TOL
    assert ((out - ref).abs().max() <= out_rel * ref.abs().max()).item()
    assert ((lse - ref_lse).abs().max()
            <= lse_rel * ref_lse.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_flash_kernel_fp16_fp32_read_strided_projections(cuda, dtype):
    """q/k/v as views of [B, S, H*D] projections, in each dtype."""
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(2, 300, 4 * 64, device="cuda", generator=g).to(dtype)
    q = x.view(2, 300, 4, 64)
    kv = torch.randn(2, 77, 2 * 4 * 64, device="cuda", generator=g).to(dtype)
    k, v = kv.view(2, 77, 2, 4, 64).unbind(2)
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v)
    out_tol, lse_tol = FWD_TOL[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float16, 1e-2)])
def test_tiny_unet_fp32_fp16_on_card(cuda, dtype, tol):
    """A UNet that is not bf16 runs on the card: the tiny fp32 and fp16
    UNets give a finite prediction through the flash and GN+SiLU kernels
    of their dtype, within ``tol`` relative L2 of the plain path."""
    model = SDXLModel.create(tiny=True, dtype=dtype, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    assert model.unet.conv_in.weight.dtype == dtype
    g = torch.Generator("cuda").manual_seed(1)
    cfg = model.unet_config
    args = (torch.randn(2, 4, 32, 32, device="cuda", generator=g),
            torch.tensor([10, 900], device="cuda"),
            torch.randn(2, 77, cfg.cross_attention_dim, device="cuda",
                        generator=g).to(dtype),
            torch.randn(2, cfg.pooled_embed_dim, device="cuda",
                        generator=g).to(dtype),
            torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2, device="cuda"))
    before = _launches()
    flash_before = TF.LAUNCHERS["fwd"][dtype].launches
    with torch.inference_mode():
        out = model.unet_apply(*args)
        launched = [a - b for a, b in zip(_launches(), before)]
        with _plain_ops():
            ref = model.unet_apply(*args)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert launched[0] > 0 and launched[2] > 0, launched  # no backward
    assert TF.LAUNCHERS["fwd"][dtype].launches > flash_before
    out, ref = out.float(), ref.float()
    assert ((out - ref).norm() / ref.norm()).item() <= tol
