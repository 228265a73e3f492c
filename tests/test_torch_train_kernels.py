"""PyTorch port: the training slice's kernels on the card.

This file imports torch and the port only (no JAX), so it runs on a machine
without JAX:

    python -m pytest tests/test_torch_train_kernels.py -m cuda --noconftest

On the CPU every test here skips.  On the card: the flash backward kernels
(the TMA + wgmma dq and dk/dv) against the plain fp32 backward (bf16
outputs, max abs error within 2e-2 of gradients scaled to O(1)) at every
head dim, ragged S and T, strided projections and the split dk/dv path,
which also gives bit-equal gradients run to run; the fused AdamW kernel
``torch.equal`` to
the plain chain in all four outputs; the probe kernel equal to
``x * 2 + 1``; the GN+SiLU backward kernel against the closed-form plain
backward on the forward kernel's statistics (max abs error over max
|plain| of dx, dscale, dbias: fp32 1e-4, summation order only; fp16 5e-3
and bf16 2e-2, dx rounded once to its type), one launch a call and
bit-equal on a second; and the bf16 tiny model's train step through the kernels
against the same step through the plain versions.  The other precisions:
the fp16 instantiation of the backward kernels within 5e-3 (P and dS
rounded to fp16, 8 times finer than bf16), the exact-fp32 kernels at the
Pallas kernels' fp32 gradient bars (atol 5e-5, rtol 5e-4,
``tests/test_flash_attention.py``; with logits to ~214, 1e-4 of max
|plain|), the split dk/dv path of both, each bit-equal over two runs; and the
fp32 tiny model's step at the settings of ``configs/ddpm_512_smoke.yaml``
(plain ``adamw``) through the kernels against the plain versions.
"""
import pytest
import torch

from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF
from sdxl_training_improvements_tpu_torch.ops import fused_adamw as TO
from sdxl_training_improvements_tpu_torch.ops import groupnorm as TG
from sdxl_training_improvements_tpu_torch.ops import probe as TP

FLASH_BWD_TOL = 2e-2
FLASH_BWD_TOL_F16 = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the H100 (README)")


def _flash_inputs(b, s, t, h, d, seed, dtype=torch.bfloat16):
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device="cuda"
                           ).to(dtype) for n in (s, t, t))
    dout = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    return q, k, v, out, lse, dout


def _bwd_errors(q, k, v, out, lse, dout):
    got = TF.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    ref = TF.flash_attention_bwd_reference(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    return [((a.float() - r.float()).abs().max()
             / r.float().abs().max().clamp_min(1.0)).item()
            for a, r in zip(got, ref)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,d", [(2, 1024, 1024, 4, 64),
                                       (2, 4096, 77, 2, 64),
                                       (1, 100, 77, 3, 16),
                                       (1, 130, 200, 2, 16),
                                       (1, 130, 200, 2, 32),
                                       (1, 130, 200, 2, 64),
                                       (1, 130, 200, 2, 128),
                                       (1, 1000, 77, 2, 16),
                                       (1, 1000, 77, 2, 32),
                                       (1, 1000, 77, 2, 64),
                                       (1, 1000, 77, 2, 128),
                                       (2, 2048, 2048, 8, 64)])
def test_flash_bwd_kernels_match_plain(cuda, b, s, t, h, d):
    args = _flash_inputs(b, s, t, h, d, seed=3)
    before = (TF.flash_bwd_dq_cuda.launches, TF.flash_bwd_dkv_cuda.launches)
    errs = _bwd_errors(*args)
    assert (TF.flash_bwd_dq_cuda.launches,
            TF.flash_bwd_dkv_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert max(errs) <= FLASH_BWD_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("t,h", [(77, 4), (2048, 8)])
def test_flash_bwd_reads_strided_projections(cuda, t, h):
    """q/k/v as views of [B, S, H*D] projections are read in place, by the
    split (T = 77) and the unsplit (T = 2048) dk/dv path."""
    g = torch.Generator("cuda").manual_seed(4)
    x = torch.randn(2, 300, h * 64, device="cuda", generator=g).bfloat16()
    kv = torch.randn(2, t, 2 * h * 64, device="cuda", generator=g
                     ).bfloat16()
    q = x.view(2, 300, h, 64)
    k, v = kv.view(2, t, 2, h, 64).unbind(2)
    assert all(TF.tma_addressable(y) for y in (q, k, v))
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    dout = torch.randn(2, 300, h, 64, device="cuda", generator=g).bfloat16()
    assert max(_bwd_errors(q, k, v, out, lse, dout)) <= FLASH_BWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,d,dtype", [
    pytest.param(4, 1024, 77, 20, 64, torch.bfloat16, id="4-1024-77-20-64"),
    pytest.param(2, 1000, 77, 4, 128, torch.bfloat16, id="2-1000-77-4-128"),
    pytest.param(4, 1024, 77, 20, 64, torch.float32,
                 id="fp32-4-1024-77-20-64"),
    pytest.param(2, 1000, 77, 4, 128, torch.float32,
                 id="fp32-2-1000-77-4-128"),
    pytest.param(1, 256, 256, 20, 64, torch.float32,
                 id="fp32-1-256-256-20-64")])
def test_flash_dkv_split_matches_plain_and_repeats(cuda, b, s, t, h, d,
                                                   dtype):
    """The split dk/dv path (fp32 partials summed by the reduction kernel
    in split order, no atomics) against its plain version, and bit-equal
    over two runs: bf16 within 2e-2 of max |plain|, fp32 at the Pallas
    kernels' fp32 bars (atol 5e-5, rtol 5e-4)."""
    splits, per = TF.plan_dkv_splits(b, h, s, t, d, dtype=dtype)
    assert splits > 1
    q, k, v, out, lse, dout = _flash_inputs(b, s, t, h, d, seed=6,
                                            dtype=dtype)
    scale = d ** -0.5
    delta = TF.flash_attention_bwd_delta(out, dout)
    args = (q, k, v, dout, lse, delta, scale)
    first = TF.flash_bwd_dkv_cuda(*args)
    second = TF.flash_bwd_dkv_cuda(*args)
    ref = TF.flash_bwd_dkv_split_reference(*args, splits, per)
    torch.cuda.synchronize()
    for a, a2, r in zip(first, second, ref):
        assert torch.equal(a, a2)
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, atol=5e-5, rtol=5e-4)
            continue
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= FLASH_BWD_TOL


@pytest.mark.cuda
def test_flash_function_grads_match_plain_autograd(cuda):
    q, k, v, _, _, dout = _flash_inputs(1, 256, 77, 2, 64, seed=5)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    TF.flash_attention(*leaves).backward(dout)
    ref = [x.float().clone().requires_grad_() for x in (q, k, v)]
    out = TF.flash_attention_fwd_reference(*ref)[0]
    out.backward(dout.float())
    for a, r in zip(leaves, ref):
        err = (a.grad.float() - r.grad).abs().max() / r.grad.abs().max()
        assert err.item() <= FLASH_BWD_TOL


def _adamw_inputs(shape, seed, g_dtype=torch.float32, channels_last=False):
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(scale):
        x = scale * torch.randn(shape, generator=gen, device="cuda")
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    p = randn(0.05).bfloat16()
    g = randn(0.01).to(g_dtype)
    m = randn(0.01).bfloat16()
    v = (1e-4 * randn(1.0).abs()).bfloat16()
    shift = randn(1e-3).bfloat16()
    return p, g, m, v, shift


@pytest.mark.cuda
@pytest.mark.parametrize("shape,g_dtype,decay,channels_last", [
    ((1280, 1280), torch.float32, 0.0, False),
    ((640, 640, 3, 3), torch.float32, 7e-3, True),
    ((1000003,), torch.float32, 7e-3, False),
    ((320,), torch.bfloat16, 0.0, False),
    ((3, 5, 7, 11), torch.bfloat16, 5.1e-3, False),
])
def test_fused_adamw_kernel_equals_plain(cuda, shape, g_dtype, decay,
                                         channels_last):
    p, g, m, v, shift = _adamw_inputs(shape, 7, g_dtype, channels_last)
    kw = dict(lr_eff=1e-3 * (1 - 0.999 ** 3) ** 0.5, decay_amt=decay,
              seed0=0x9E3779B9, seed1=12345)
    ref = TO.fused_adamw_reference(p, g, m, v, shift, **kw)
    before = TO.fused_adamw_cuda.launches
    got = TO.fused_adamw_cuda(p, g, m.clone(), v.clone(), shift.clone(),
                              **kw)
    torch.cuda.synchronize()
    assert TO.fused_adamw_cuda.launches == before + 1
    for name, a, r in zip(("delta", "m", "v", "shift"), got, ref):
        assert a.stride() == r.stride(), name
        assert torch.equal(a, r), name


@pytest.mark.cuda
def test_fused_adamw_rejects_what_it_does_not_take(cuda):
    p, g, m, v, shift = _adamw_inputs((64,), 1)
    kw = dict(lr_eff=1e-3, decay_amt=0.0, seed0=1, seed1=2)
    with pytest.raises(TypeError):
        TO.fused_adamw_cuda(p.float(), g, m, v, shift, **kw)
    with pytest.raises(ValueError):
        TO.fused_adamw_cuda(p, g[:32], m, v, shift, **kw)


@pytest.mark.cuda
def test_probe_kernel(cuda):
    before = TP.probe_cuda.launches
    result = TP.run_probe()
    assert TP.probe_cuda.launches > before
    assert result["max_abs_err"] == 0.0
    assert result["gbps"] > 0 and result["plain_gbps"] > 0


# GN+SiLU backward bars (max abs error over max |plain|) by dtype
GN_BWD_TOL = {torch.float32: 1e-4, torch.float16: 5e-3,
              torch.bfloat16: 2e-2}
_BF16, _F16, _F32 = torch.bfloat16, torch.float16, torch.float32
# (shape, dtype, eps): chip_smoke.py's backward sites (GN_BWD_SHAPES),
# its forward GN_SHAPES, a ragged S at C = 64, C = 960 (not a multiple of
# 128), the VAE's C = 128 and the tiny VAE's C = 16 in 8 groups
GN_BWD_CASES = [
    ((4, 16384, 320), _BF16, 1e-5), ((4, 16384, 960), _BF16, 1e-5),
    ((4, 4096, 640), _BF16, 1e-5), ((4, 1024, 2560), _BF16, 1e-5),
    ((1, 4096, 640), _F16, 1e-5), ((1, 4096, 320), _F32, 1e-5),
    ((2, 16384, 320), _BF16, 1e-5), ((2, 4096, 640), _BF16, 1e-5),
    ((2, 1024, 2560), _BF16, 1e-5), ((2, 4096, 640), _F16, 1e-5),
    ((2, 4096, 640), _F32, 1e-5), ((1, 65536, 512), _F32, 1e-6),
    ((1, 1048576, 128), _F32, 1e-6),
    ((2, 100, 64), _BF16, 1e-5), ((2, 300, 960), _BF16, 1e-5),
    ((2, 300, 960), _F16, 1e-5), ((1, 4096, 128), _F32, 1e-6),
    ((2, 77, 16), _F32, 1e-6),
]


def _gn_bwd_inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g) * 1.5 + 1.0
    dy = torch.randn(shape, generator=g)
    scale = 1.0 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    return (x.to("cuda", dtype), dy.to("cuda", dtype), scale.cuda(),
            bias.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,eps", GN_BWD_CASES)
def test_gn_backward_kernel_matches_plain(cuda, shape, dtype, eps):
    """dx, dscale and dbias of the backward kernel against the closed-form
    plain backward, both on the forward kernel's mean and rstd; one launch
    a call, a second launch bit-equal."""
    x, dy, scale, bias = _gn_bwd_inputs(shape, dtype, seed=11)
    groups = 8 if shape[-1] == 16 else 32
    _, mean, rstd = TG.gn_silu_fwd_cuda(x, scale, bias, groups, eps)
    args = (dy, x, scale, bias, mean, rstd, groups)
    before = TG.gn_silu_bwd_cuda.launches
    got = TG.gn_silu_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert TG.gn_silu_bwd_cuda.launches == before + 1
    again = TG.gn_silu_bwd_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = TG.groupnorm_silu_backward_reference(*args)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        err = (a.float() - r.float()).abs().max().item()
        assert err <= GN_BWD_TOL[dtype] * r.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [_BF16, _F32])
def test_gn_function_grads_match_plain_autograd(cuda, dtype):
    """``groupnorm_silu`` on a channels-last activation, as the resblocks
    call it, backward through both kernels: one forward and one backward
    launch, and the gradients of autograd through the fp32 plain version
    (bars as above, dx in x's dtype)."""
    g = torch.Generator().manual_seed(12)
    x = (torch.randn(2, 640, 32, 32, generator=g) * 1.5 + 1.0).to(
        "cuda", dtype).contiguous(memory_format=torch.channels_last)
    cot = torch.randn(2, 32, 32, 640, generator=g).cuda()
    scale = (1.0 + 0.1 * torch.randn(640, generator=g)).cuda()
    bias = (0.1 * torch.randn(640, generator=g)).cuda()
    nhwc = x.permute(0, 2, 3, 1)
    leaves = [t.detach().requires_grad_() for t in (nhwc, scale, bias)]
    fwd, bwd = TG.gn_silu_fwd_cuda.launches, TG.gn_silu_bwd_cuda.launches
    got = torch.autograd.grad(
        (TG.groupnorm_silu(*leaves, 32, 1e-5).float() * cot).sum(), leaves)
    torch.cuda.synchronize()
    assert TG.gn_silu_fwd_cuda.launches == fwd + 1
    assert TG.gn_silu_bwd_cuda.launches == bwd + 1
    plain = [t.detach().float().requires_grad_() for t in leaves]
    ref = torch.autograd.grad(
        (TG.groupnorm_silu_reference(*plain, 32, 1e-5) * cot).sum(), plain)
    for a, r in zip(got, ref):
        err = (a.float() - r).abs().max().item()
        assert err <= GN_BWD_TOL[dtype] * r.abs().max().item()


def _tiny_train_step(plain: bool, mixed_precision: str = "bf16"):
    """One step (batch 2, lr 1e-3) of the tiny model with remat, from
    seeded weights and batch: the default config for bf16, the settings of
    ``configs/ddpm_512_smoke.yaml`` (ddpm, epsilon, plain ``adamw``) for
    "no"; ``plain`` puts the plain versions in every kernel's place, as
    ``chip_smoke.py`` does."""
    from contextlib import ExitStack
    from unittest import mock

    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models import layers
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
    from sdxl_training_improvements_tpu_torch.ops import attention
    from sdxl_training_improvements_tpu_torch.ops import groupnorm
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        adamw_bf16, make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)
    if mixed_precision == "bf16":
        cfg = Config()
    else:
        cfg = Config.from_dict({
            "model": {"prediction_type": "epsilon", "use_ztsnr": False,
                      "sigma_max": 80.0, "min_snr_gamma": None},
            "optimizer": {"optimizer_type": "adamw"},
            "training": {"method": "ddpm", "prediction_type": "epsilon",
                         "mixed_precision": mixed_precision}})
    cfg.training.batch_size = 2
    cfg.optimizer.learning_rate = 1e-3
    model = SDXLModel.create(
        tiny=True, dtype={"bf16": torch.bfloat16,
                          "no": torch.float32}[mixed_precision],
        device="cuda", generator=torch.Generator("cuda").manual_seed(0),
        unet_config=UNetConfig.tiny(remat=True))
    ucfg = model.unet_config
    g = torch.Generator("cuda").manual_seed(1)
    batch = {"vae_latents": torch.randn(2, 4, 16, 16, generator=g,
                                        device="cuda"),
             "prompt_embeds": torch.randn(2, 77, ucfg.cross_attention_dim,
                                          generator=g, device="cuda"),
             "pooled_prompt_embeds": torch.randn(2, ucfg.pooled_embed_dim,
                                                 generator=g, device="cuda"),
             "time_ids": torch.tensor([[128.0, 128, 0, 0, 128, 128]] * 2,
                                      device="cuda"),
             "timesteps": torch.tensor([300, 700], device="cuda")}
    start = {n: p.detach().clone() for n, p in model.unet.named_parameters()}
    opt = make_optimizer(cfg)
    step = make_train_step(model.unet_apply, NoiseSchedule.from_config(cfg),
                           opt, cfg)
    with ExitStack() as stack:
        if plain:
            for mod, name, fn in (
                    (layers, "groupnorm_silu",
                     groupnorm.groupnorm_silu_reference),
                    (layers, "dot_product_attention",
                     attention.dot_product_attention_reference),
                    (adamw_bf16, "fused_adamw_update",
                     TO.fused_adamw_reference)):
                stack.enter_context(mock.patch.object(mod, name, fn))
        state, metrics = step(create_train_state(model.trainable_params(),
                                                 opt), batch)
    torch.cuda.synchronize()
    updates = {n: p.detach().float() - start[n].float()
               for n, p in state.params.items()}
    return metrics, updates


@pytest.mark.cuda
def test_tiny_train_step_kernels_match_plain(cuda):
    """The kernel path against the plain path over one train step: loss
    and grad norm within bf16 forward/backward spread (2e-2, 5e-2), and
    the parameter updates agree to 0.25 relative L2.  Adam's first step is
    sign-like, so an element whose gradient is near 0 may step the other
    way: each such flip adds twice a full step (0.125 measured on an H100,
    about 0.4% of the elements)."""
    wrappers = (TF.flash_attention_fwd_cuda, TF.flash_bwd_dq_cuda,
                TF.flash_bwd_dkv_cuda, TO.fused_adamw_cuda)
    before = [w.launches for w in wrappers]
    metrics, updates = _tiny_train_step(plain=False)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    plain_metrics, plain_updates = _tiny_train_step(plain=True)
    loss, plain_loss = metrics["loss"].item(), plain_metrics["loss"].item()
    assert abs(loss - plain_loss) <= 2e-2 * abs(plain_loss)
    gn, plain_gn = (m["grad_norm"].item() for m in (metrics, plain_metrics))
    assert abs(gn - plain_gn) <= 5e-2 * plain_gn
    num = sum((updates[n] - plain_updates[n]).square().sum()
              for n in updates)
    den = sum(u.square().sum() for u in plain_updates.values())
    assert den > 0 and (num / den).sqrt().item() <= 0.25


_BWD_SHAPES = [(2, 1024, 1024, 4, 64), (1, 100, 77, 3, 16),
               (1, 130, 200, 2, 16), (1, 130, 200, 2, 32),
               (1, 130, 200, 2, 64), (1, 130, 200, 2, 128),
               (1, 1000, 77, 2, 64), (2, 2048, 2048, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,t,h,d,q_scale", [
    *((dt, *shape, 1.0) for dt in (torch.float16, torch.float32)
      for shape in _BWD_SHAPES),
    (torch.float32, 1, 256, 256, 2, 64, 50.0),
    (torch.float32, 1, 1000, 77, 2, 64, 50.0)])
def test_flash_bwd_fp16_fp32_match_plain_and_repeat(cuda, dtype, b, s, t,
                                                    h, d, q_scale):
    """dq and dk/dv of the fp16 instantiation (the split dk/dv path at
    T = 77) and of the fp32 kernels: every head dim, ragged S and T; the
    gradients in the input's dtype, from that dtype's launchers, and
    bit-equal over two runs.  The fp32 kernels multiply split TF32
    operands (2^-22 an operand against fp32's 2^-24): with q scaled by 50
    (logits to ~214) that contract misses atol / rtol on dk and dv, as its
    CPU emulation shows (``tests/test_torch_flash_bwd.py``), so those cases
    are held to ``chip_smoke.FLASH_BWD_TOL[fp32]``, 1e-4 of max |plain|."""
    q, k, v, out, lse, dout = _flash_inputs(b, s, t, h, d, seed=7,
                                            dtype=dtype)
    if q_scale != 1.0:
        q = q * q_scale
        out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    before = [TF.LAUNCHERS[kind][dtype].launches for kind in ("dq", "dkv")]
    got = TF.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    again = TF.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    ref = TF.flash_attention_bwd_reference(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert [TF.LAUNCHERS[kind][dtype].launches
            for kind in ("dq", "dkv")] == [n + 2 for n in before]
    for a, a2, r in zip(got, again, ref):
        assert a.dtype == dtype and torch.equal(a, a2)
        if q_scale != 1.0:
            assert (a - r).abs().max() <= 1e-4 * r.abs().max()
        elif dtype == torch.float32:
            torch.testing.assert_close(a, r, atol=5e-5, rtol=5e-4)
        else:
            err = (a.float() - r.float()).abs().max() / r.float().abs().max()
            assert err.item() <= FLASH_BWD_TOL_F16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_flash_bwd_fp16_fp32_read_strided_projections(cuda, dtype):
    """q/k/v as views of [B, S, H*D] projections, in each dtype."""
    g = torch.Generator("cuda").manual_seed(8)
    x = torch.randn(2, 300, 4 * 64, device="cuda", generator=g).to(dtype)
    kv = torch.randn(2, 77, 2 * 4 * 64, device="cuda", generator=g).to(dtype)
    q = x.view(2, 300, 4, 64)
    k, v = kv.view(2, 77, 2, 4, 64).unbind(2)
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    dout = torch.randn(2, 300, 4, 64, device="cuda", generator=g).to(dtype)
    got = TF.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    ref = TF.flash_attention_bwd_reference(q, k, v, out, lse, dout)
    for a, r in zip(got, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, atol=5e-5, rtol=5e-4)
        else:
            err = (a.float() - r.float()).abs().max() / r.float().abs().max()
            assert err.item() <= FLASH_BWD_TOL_F16


@pytest.mark.cuda
def test_tiny_fp32_train_step_kernels_match_plain(cuda):
    """The fp32 tiny model's step through the fp32 flash kernels and the
    GN+SiLU kernels against the plain versions: both are fp32 throughout
    and differ in summation order only, so the loss agrees to 1e-5, the
    grad norm to 1e-4 and the parameter updates to 1e-2 relative L2 (plain
    AdamW's first step is sign-like, so an element whose gradient is at
    the rounding level may step the other way)."""
    launchers = [TF.LAUNCHERS[kind][torch.float32]
                 for kind in ("fwd", "dq", "dkv")]
    before = [x.launches for x in launchers]
    metrics, updates = _tiny_train_step(plain=False, mixed_precision="no")
    assert all(x.launches > b for x, b in zip(launchers, before))
    plain_metrics, plain_updates = _tiny_train_step(plain=True,
                                                    mixed_precision="no")
    loss, plain_loss = metrics["loss"].item(), plain_metrics["loss"].item()
    assert abs(loss - plain_loss) <= 1e-5 * abs(plain_loss)
    gn, plain_gn = (m["grad_norm"].item() for m in (metrics, plain_metrics))
    assert abs(gn - plain_gn) <= 1e-4 * plain_gn
    num = sum((updates[n] - plain_updates[n]).square().sum()
              for n in updates)
    den = sum(u.square().sum() for u in plain_updates.values())
    assert den > 0 and (num / den).sqrt().item() <= 1e-2


@pytest.mark.cuda
def test_flash_bwd_fp16_small_dout_matches_plain(cuda):
    """With no loss scale the gradient reaching attention is small: at
    dO ~ 1e-4, dS = P (dP - Delta) * scale falls under fp16's least
    subnormal (6e-8), where the Pallas kernel keeps dS in fp32.  The fp16
    kernels scale dS by a power of two from max|dO| and unscale their fp32
    accumulators before the store, so the gradients keep the fp16 bar of
    the plain fp32 backward.  With q scaled by 16 the softmax is peaked
    and a few keys take most queries' weight: their dk sums over all the
    queries, which a scaled fp16 output would overflow."""
    q, k, v, out, lse, dout = _flash_inputs(2, 1024, 1024, 4, 64, seed=9,
                                            dtype=torch.float16)
    dout = (dout.float() * 1e-4).half()
    for q_scale in (1.0, 16.0):
        qs = (q.float() * q_scale).half()
        out, lse = TF.flash_attention_fwd_cuda(qs, k, v)
        _check_small_dout(qs, k, v, out, lse, dout)


def _check_small_dout(q, k, v, out, lse, dout):
    got = TF.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    ref = TF.flash_attention_bwd_reference(q, k, v, out, lse, dout)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float16 and torch.isfinite(a).all()
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= FLASH_BWD_TOL_F16
