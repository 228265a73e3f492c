"""PyTorch port: the training slice's kernels on the card.

This file imports torch and the port only (no JAX), so it runs on a machine
without JAX:

    python -m pytest tests/test_torch_train_kernels.py -m cuda --noconftest

On the CPU every test here skips.  On the card: the flash backward kernels
against the plain fp32 backward (bf16 outputs, max abs error within 2e-2
of gradients scaled to O(1)); the fused AdamW kernel ``torch.equal`` to
the plain chain in all four outputs; the probe kernel equal to
``x * 2 + 1``; and the bf16 tiny model's train step through the kernels
against the same step through the plain versions.
"""
import pytest
import torch

from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF
from sdxl_training_improvements_tpu_torch.ops import fused_adamw as TO
from sdxl_training_improvements_tpu_torch.ops import probe as TP

FLASH_BWD_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the H100 (README)")


def _flash_inputs(b, s, t, h, d, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device="cuda"
                           ).bfloat16() for n in (s, t, t))
    dout = torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
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
                                       (1, 130, 200, 2, 32),
                                       (1, 130, 200, 2, 128)])
def test_flash_bwd_kernels_match_plain(cuda, b, s, t, h, d):
    args = _flash_inputs(b, s, t, h, d, seed=3)
    before = (TF.flash_bwd_dq_cuda.launches, TF.flash_bwd_dkv_cuda.launches)
    errs = _bwd_errors(*args)
    assert (TF.flash_bwd_dq_cuda.launches,
            TF.flash_bwd_dkv_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert max(errs) <= FLASH_BWD_TOL, errs


@pytest.mark.cuda
def test_flash_bwd_reads_strided_projections(cuda):
    """q/k/v as views of [B, S, H*D] projections are read in place."""
    g = torch.Generator("cuda").manual_seed(4)
    x = torch.randn(2, 300, 4 * 64, device="cuda", generator=g).bfloat16()
    kv = torch.randn(2, 77, 2 * 4 * 64, device="cuda", generator=g
                     ).bfloat16()
    q = x.view(2, 300, 4, 64)
    k, v = kv.view(2, 77, 2, 4, 64).unbind(2)
    out, lse = TF.flash_attention_fwd_cuda(q, k, v)
    dout = torch.randn(2, 300, 4, 64, device="cuda", generator=g).bfloat16()
    assert max(_bwd_errors(q, k, v, out, lse, dout)) <= FLASH_BWD_TOL


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


def _tiny_train_step(plain: bool):
    """One default-config step (batch 2, lr 1e-3) of the bf16 tiny model
    with remat, from seeded weights and batch; ``plain`` puts the plain
    versions in every kernel's place, as ``chip_smoke.py`` does."""
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
    cfg = Config()
    cfg.training.batch_size = 2
    cfg.optimizer.learning_rate = 1e-3
    model = SDXLModel.create(
        tiny=True, dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator("cuda").manual_seed(0),
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
