"""PyTorch port: the rest of serving through the kernels, on the card.

Each new serving mode on the tiny fp32 model runs through the GN+SiLU and
flash-forward kernels and through their plain versions, with both kernels
launched: the latents within 1e-3 rel L2.  fp32, because the kernels and
the plain versions then differ by summation order and the split-TF32
products only, so the bar isolates the paths' wiring; in bf16 a random
tiny model amplifies the two paths' different rounding over a CFG-5 walk
(0.19 rel L2 at 4 DPM++ steps on an H100), and ``chip_smoke.py`` phase 10
holds the full-width bf16 paths.  The checkpoint round trip and
``generate.main`` (bf16) run on the card too.  No JAX: run them on the
card with
``python -m pytest tests/test_torch_serving_kernels.py -m cuda
--noconftest``; they skip without a card.
"""
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch import generate, png
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models import layers
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.ops import attention as TA
from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF
from sdxl_training_improvements_tpu_torch.ops import groupnorm as TG
from sdxl_training_improvements_tpu_torch.pipelines import SDXLPipeline
from sdxl_training_improvements_tpu_torch.training.checkpoints import (
    components, export_diffusers)

SIZE = 64
REL_L2 = 1e-3
REFINER = dict(num_time_ids=5, cross_attention_dim=32,
               projection_class_embeddings_input_dim=32 + 5 * 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the H100 (README)")


def _model(seed=0, dtype=torch.float32, **kw):
    return SDXLModel.create(
        tiny=True, dtype=dtype, device="cuda",
        generator=torch.Generator("cuda").manual_seed(seed), **kw)


def _plain_ops():
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        layers, "groupnorm_silu", TG.groupnorm_silu_reference))
    stack.enter_context(mock.patch.object(
        layers, "dot_product_attention", TA.dot_product_attention_reference))
    return stack


def _launches():
    return (TG.gn_silu_fwd_cuda.launches,
            TF.flash_attention_fwd_cuda.launches)


def _kernels_vs_plain(run):
    before = _launches()
    out = run()
    launched = [a - b for a, b in zip(_launches(), before)]
    with _plain_ops():
        ref = run()
    assert all(n > 0 for n in launched), launched
    assert torch.isfinite(out).all()
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel <= REL_L2, rel


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (SIZE, SIZE, 3),
                                                dtype=np.uint8)


RUN = dict(num_inference_steps=4, seed=0, return_latents=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,mode", [
    (dict(sampler="dpmpp_2m"), "text2img"),
    (dict(deep_cache=2), "text2img"),
    (dict(method="flow_matching"), "text2img"),
    (dict(sampler="dpmpp_2m", deep_cache=2), "img2img"),
])
def test_modes_kernel_path_matches_plain(cuda, kw, mode):
    pipe = SDXLPipeline.from_model(_model(), **kw)
    if mode == "img2img":
        _kernels_vs_plain(lambda: pipe.img2img(["a cat"], images=[_image()],
                                               strength=0.6, **RUN))
    else:
        _kernels_vs_plain(lambda: pipe(["a cat"], height=SIZE, width=SIZE,
                                       **RUN))


@pytest.mark.cuda
def test_inpaint_and_refiner_kernel_path_match_plain(cuda):
    inpaint = SDXLPipeline.from_model(
        _model(1, unet_config=UNetConfig.tiny(in_channels=9)))
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[16:48, 8:40] = 1
    _kernels_vs_plain(lambda: inpaint.inpaint(
        ["a cat"], [_image()], [mask], strength=0.8, **RUN))
    base = SDXLPipeline.from_model(_model())
    refiner = SDXLPipeline.from_model(_model(
        2, unet_config=UNetConfig.tiny(**REFINER), refiner=True))

    def handoff():
        noisy = base(["a cat"], height=SIZE, width=SIZE, denoising_end=0.5,
                     **RUN)
        return refiner.refine(["a cat"], noisy, denoising_start=0.5, **RUN)

    _kernels_vs_plain(handoff)


@pytest.mark.cuda
def test_deep_cache_first_call_is_exact_on_card(cuda):
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    model = _model(dtype=torch.bfloat16)
    eps = NoiseSchedule.create(use_ztsnr=False, sigma_max=80.0,
                               prediction_type="epsilon")
    outs = [SDXLPipeline.from_model(model, schedule=eps, deep_cache=k)(
        ["x"], height=SIZE, width=SIZE, num_inference_steps=1,
        return_latents=True) for k in (1, 3)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_round_trip_and_generate_on_card(cuda, tmp_path):
    model = _model(dtype=torch.bfloat16)
    export_diffusers(tmp_path / "ckpt", components(model), Config(),
                     unet_config=model.unet_config)
    pipe = SDXLPipeline.from_pretrained(tmp_path / "ckpt", tiny=True)
    for name, module in components(model).items():
        loaded = getattr(pipe.model, name).state_dict()
        for k, v in module.state_dict().items():
            assert v.dtype == loaded[k].dtype and torch.equal(v, loaded[k])
    args = ["--model", str(tmp_path / "ckpt"), "--prompt", "a cat",
            "--height", str(SIZE), "--width", str(SIZE), "--steps", "3",
            "--tiny", "--out", str(tmp_path / "out")]
    assert generate.main(args + ["--sampler", "dpmpp_2m",
                                 "--deep-cache", "2"]) == 0
    img = png.read_png(tmp_path / "out" / "000.png")
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8
    assert generate.main(args + ["--init", str(tmp_path / "out" / "000.png"),
                                 "--strength", "0.5"]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 3072), (2, 1024, 2304),
                                   (2, 4096, 1152), (2, 300, 1536)])
def test_gn_kernel_at_refiner_widths(cuda, shape):
    """Up to 96 channels a group (C = 3072 in 32 groups), bf16."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 1.5 + 1.0).to("cuda",
                                                         torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(shape[-1], generator=g)).cuda()
    bias = (0.1 * torch.randn(shape[-1], generator=g)).cuda()
    y, _, _ = TG.gn_silu_fwd_cuda(x, scale, bias, 32, 1e-5)
    ref = TG.groupnorm_silu_reference(x.float(), scale, bias, 32, 1e-5)
    assert (y.float() - ref).abs().max().item() <= 2e-2
