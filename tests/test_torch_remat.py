"""PyTorch port: the selective remat policies against the JAX package's.

Each of JAX's ten selective policies runs on the tiny fp32 UNet in both
packages from the same weights and inputs: the loss and every gradient
agree to rtol 2e-4 / atol 2e-5 (``tests/test_weight_parity.py:107``), and
the port's gradients under each policy equal its own "full" bit for bit
(a policy only decides what the backward recomputes).  The table has JAX's
names and an unknown name raises as JAX's does.  With lowered thresholds
the outputs a policy keeps are exactly the operators its rule names: the
named GN+SiLU, resnet convolutions and self-attention cores under their
thresholds, never ``conv_shortcut`` or a cross-attention core, and a kept
operator is not run again in the backward.  The bf16 model keeps its
bf16 norm interior under a selective policy (its recomputation sets it
again): bit-equal to "full".
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu_torch.models import unet as TU
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)

RTOL, ATOL = 2e-4, 2e-5
SELECTIVE = ("dots", "dots_nobatch", "dots_small", "dots_small_attn",
             "dots_small_conv", "dots_small_conv_wide", "dots_small_conv_mid",
             "dots_small_conv_attnwide", "dots_small_conv10",
             "dots_small_conv10_128")
GN_OP = torch.ops.sdxl.gn_silu.default
CONV_OP = torch.ops.aten.convolution.default
FLASH_OP = torch.ops.sdxl.flash_attn.default


def _inputs():
    rng = np.random.default_rng(11)
    cfg = JU.UNetConfig.tiny()
    return (rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
            np.asarray([10, 900], np.int32),
            rng.standard_normal((2, 77, cfg.cross_attention_dim)
                                ).astype(np.float32),
            rng.standard_normal((2, cfg.pooled_embed_dim)
                                ).astype(np.float32),
            np.asarray([[64, 64, 0, 0, 64, 64], [32, 48, 4, 2, 32, 48]],
                       np.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = JU.UNetConfig.tiny(remat=True)
    jm = JU.SDXLUNet(config=cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    args = _inputs()
    params = jax.jit(jm.init)(jax.random.key(4), *map(jnp.asarray, args))
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return params, state, args


def _port_unet(state, policy: str, dtype=torch.float32):
    unet = TU.SDXLUNet(TU.UNetConfig.tiny(remat=True, remat_policy=policy))
    unet.load_state_dict(state, strict=True)
    return unet.to(dtype).to(memory_format=torch.channels_last)


def _port_grads(unet, args, dtype=torch.float32):
    tensors = [torch.from_numpy(a) for a in args]
    tensors[0] = tensors[0].to(dtype)
    out = unet(*tensors)
    loss = (out.float() ** 2).mean()
    names = [n for n, _ in unet.named_parameters()]
    grads = torch.autograd.grad(loss, list(unet.parameters()))
    return loss.detach(), dict(zip(names, grads))


def _jax_grads(params, args, policy: str):
    jm = JU.SDXLUNet(config=JU.UNetConfig.tiny(remat=True,
                                                remat_policy=policy),
                     dtype=jnp.float32, param_dtype=jnp.float32)

    def loss(p):
        return (jm.apply(p, *map(jnp.asarray, args)) ** 2).mean()

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), from_jax_params(jax.tree_util.tree_map(
        np.asarray, grads))


@pytest.fixture(scope="module")
def full_grads(setup):
    _, state, args = setup
    return _port_grads(_port_unet(state, "full"), args)


@pytest.mark.parametrize("policy", SELECTIVE)
def test_policy_gradients_match_jax_and_full(setup, full_grads, policy):
    params, state, args = setup
    loss, grads = _port_grads(_port_unet(state, policy), args)
    full_loss, full = full_grads
    assert torch.equal(loss, full_loss)
    for name, g in grads.items():
        assert torch.equal(g, full[name]), name
    ref_loss, ref = _jax_grads(params, args, policy)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=RTOL, atol=ATOL)
    assert set(ref) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_policy_table_is_jax_and_unknown_names_raise():
    jm = JU.SDXLUNet(config=JU.UNetConfig.tiny(remat=True,
                                                remat_policy="bogus"),
                     dtype=jnp.float32, param_dtype=jnp.float32)
    args = tuple(map(jnp.asarray, _inputs()))
    with pytest.raises(ValueError, match="Unknown remat_policy") as jerr:
        jax.eval_shape(jm.init, jax.random.key(0), *args)
    with pytest.raises(ValueError, match="Unknown remat_policy") as terr:
        TU.UNetConfig.tiny(remat=True, remat_policy="bogus")
    listed = re.search(r"one of (\[.*\])", str(terr.value)).group(1)
    assert listed == re.search(r"one of (\[.*\])",
                               str(jerr.value)).group(1)
    assert sorted(TU.remat_policy_table()) == sorted(SELECTIVE + ("full",))
    # without remat the policy is not read, as in JAX
    TU.UNetConfig.tiny(remat=False, remat_policy="bogus")


class _Count(TorchDispatchMode):
    """Counts the named producers dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.calls = {GN_OP: 0, CONV_OP: 0, FLASH_OP: 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.calls:
            self.calls[func] += 1
        return func(*args, **(kwargs or {}))


def _recorded(policy, record):
    def wrapped(op, args, name):
        keep = policy(op, args, name)
        if keep:
            record.append((op, name, TU.out_elements(op, args)))
        return keep
    return wrapped


def _inventory(unet, args):
    """Every named producer and product of one forward, with its name
    and output elements (a policy that keeps nothing, recording)."""
    seen = []

    def everything(op, args_, name):
        if (name is not None and op in TU.NAMED_OPS) or \
                op in TU.NOBATCH_DOTS:
            seen.append((op, name, TU.out_elements(op, args_)))
        return False
    unet.remat_policies = (everything, everything)
    tensors = [torch.from_numpy(a) for a in args]
    with torch.enable_grad():
        unet(*tensors)
    return seen


def _kept(unet, args, policy):
    """(what ``policy`` keeps in the forward, producers run again in the
    backward)."""
    record = []
    unet.remat_policies = (_recorded(policy, record),) * 2
    tensors = [torch.from_numpy(a) for a in args]
    out = unet(*tensors)
    kept = list(record)
    with _Count() as count:
        (out ** 2).mean().backward()
    return kept, count.calls


def test_named_values_are_the_rules_operators(setup):
    _, state, args = setup
    unet = _port_unet(state, "full")
    seen = _inventory(unet, args)
    named = [(op, n) for op, n, _ in seen if n is not None]
    cfg = unet.config
    resnets = sum(1 for m in unet.modules()
                  if type(m).__name__ == "ResnetBlock2D")
    layers = sum(1 for m in unet.modules()
                 if type(m).__name__ == "BasicTransformerBlock")
    assert named.count((GN_OP, "gn_silu")) == 2 * resnets
    # conv1 and conv2 of each resnet; conv_shortcut is not named
    assert named.count((CONV_OP, "res_conv")) == 2 * resnets
    assert sum(op is CONV_OP for op, _ in named) == 2 * resnets
    assert any(hasattr(m, "conv_shortcut") for m in unet.modules())
    assert named.count((FLASH_OP, "attn_core")) == layers
    assert named.count((FLASH_OP, "attn_core_cross")) == layers
    assert len(named) == 4 * resnets + 2 * layers
    assert cfg.remat


@pytest.mark.parametrize("which", ["small_saves", "small_dots"])
def test_lowered_thresholds_keep_exactly_what_the_rule_names(setup, which):
    _, state, args = setup
    unet = _port_unet(state, "full")
    seen = _inventory(unet, args)
    sizes = sorted({e for _, _, e in seen})
    cut = sizes[len(sizes) // 2]  # some of each kind fall on each side
    if which == "small_dots":
        policy = TU._small_dots_policy(max_out_elements=cut)
        want = [(op, n, e) for op, n, e in seen
                if op in TU.NOBATCH_DOTS and e <= cut]
    else:
        names = ("res_conv", "gn_silu", "attn_core")
        policy = TU._small_saves_policy(max_out_elements=cut // 4,
                                        small_names=names,
                                        names_max_out_elements=cut)
        want = [(op, n, e) for op, n, e in seen
                if (n in names and op in TU.NAMED_OPS and e <= cut)
                or (op in TU.NOBATCH_DOTS and e <= cut // 4)]
    kept, _ = _kept(unet, args, policy)
    assert kept == want and 0 < len(kept) < len(seen)
    assert not any(n == "attn_core_cross" for _, n, _ in kept)
    skipped = [x for x in seen if x not in want]
    assert any(op in TU.NAMED_OPS for op, _, _ in skipped)


def test_kept_operators_are_not_run_again(setup):
    _, state, args = setup
    unet = _port_unet(state, "full")
    _, full = _kept(unet, args, lambda op, a, n: False)
    keep_named = TU.save_only_these_names("gn_silu", "attn_core")
    _, sel = _kept(unet, args, keep_named)
    assert full[GN_OP] > 0 and sel[GN_OP] == 0
    # only the cross-attention cores run again
    assert sel[FLASH_OP] == full[FLASH_OP] // 2
    assert sel[CONV_OP] == full[CONV_OP]


@pytest.mark.parametrize("policy", ["dots_small_conv", "dots_small_attn"])
def test_bf16_norm_interior_under_selective_policies(setup, policy):
    """bf16 weights and inputs: the norm interior is bf16 under every
    remat policy (``norm_bf16``), the recomputation included, so a
    selective policy's gradients equal "full"'s bit for bit."""
    _, state, args = setup
    full = _port_unet(state, "full", torch.bfloat16)
    sel = _port_unet(state, policy, torch.bfloat16)
    assert full.config.norm_bf16 and sel.config.norm_bf16
    ref_loss, ref = _port_grads(full, args, torch.bfloat16)
    loss, grads = _port_grads(sel, args, torch.bfloat16)
    assert torch.equal(loss, ref_loss)
    for name, g in grads.items():
        assert torch.equal(g, ref[name]), name
