"""PyTorch port: the precision policy against the JAX package.

``training.mixed_precision`` picks the UNet's dtypes through
``core.types.Policy.from_mixed_precision`` in both packages.  Here, on the
CPU, with the same numpy inputs and the flax modules' own parameters:

* the policy and the per-component weight dtypes of all three settings
  (and the refusal of an unknown name), against JAX's;
* ``SDXLModel.create(policy=...)``: every parameter of the tiny UNet, VAE,
  CLIP-L and CLIP-G in the dtype JAX gives it (UNet and CLIP in the
  policy's dtype with fp32 norms, the VAE fp32); ``from_config`` builds
  what a ``Config`` asks for;
* the tiny UNet forward built from each policy: fp32 at rtol 2e-4 / atol
  2e-5 (``tests/test_weight_parity.py``); fp16 within 1e-2 relative L2 of
  JAX's fp16 output, where both round every layer's output to fp16 at
  other places (measured 2.2e-3), and within 5e-3 of the fp32 output
  (measured 1.9e-3 for the port, 2.1e-3 for JAX);
* one fp32 training step at the settings of ``configs/ddpm_512_smoke.yaml``
  (ddpm, epsilon, no ZTSNR, sigma_max 80, plain ``adamw``, batch 1) from
  JAX's state after its first step, with replayed noise and timestep:
  loss and grad norm at rtol 2e-4, the moments at rtol 2e-4 with an atol
  of 1e-6 of the largest moment, each parameter within rtol 1e-6 plus
  one Adam step of this learning rate (``tests/test_torch_trainer.py``);
* ``chip_smoke.DDPM_512_SMOKE``, the literal the card's run uses for want
  of pyyaml, holds the YAML's settings.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sdxl_training_improvements_tpu import config as JC
from sdxl_training_improvements_tpu.core import types as JT
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.training import schedules as JS
from sdxl_training_improvements_tpu.training import trainer as JTR
from sdxl_training_improvements_tpu.training.optimizers import (
    make_optimizer as jax_make_optimizer)
from sdxl_training_improvements_tpu_torch import config as TC
from sdxl_training_improvements_tpu_torch.core import types as TT
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)
from sdxl_training_improvements_tpu_torch.training import schedules as TS
from sdxl_training_improvements_tpu_torch.training import trainer as TTR
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    AdamW, AdamWState, make_optimizer)

RTOL, ATOL = 2e-4, 2e-5
SMOKE_YAML = Path(__file__).resolve().parent.parent / "configs" / \
    "ddpm_512_smoke.yaml"
PARTS = ("unet", "vae", "clip_l", "clip_g")


def _name(dtype) -> str:
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) \
        else jnp.dtype(dtype).name


@pytest.mark.parametrize("mp", ["bf16", "fp16", "no", "fp32", "half",
                                " BFloat16 "])
def test_policy_from_mixed_precision_matches_jax(mp):
    ours, theirs = (TT.Policy.from_mixed_precision(mp),
                    JT.Policy.from_mixed_precision(mp))
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert _name(getattr(ours, field)) == _name(getattr(theirs, field))
    expect = {"bf16": "bfloat16", "fp16": "float16", "half": "float16",
              " BFloat16 ": "bfloat16"}.get(mp, "float32")
    assert _name(ours.compute_dtype) == expect


def test_unknown_precision_raises_as_jax():
    for types in (TT, JT):
        with pytest.raises(ValueError, match="Unknown dtype name"):
            types.Policy.from_mixed_precision("fp8")


def test_model_weight_dtypes_match_jax():
    for ours, theirs in zip(TT.DataType, JT.DataType):
        assert ours.value == theirs.value
        a = TT.ModelWeightDtypes.from_single_dtype(ours)
        b = JT.ModelWeightDtypes.from_single_dtype(theirs)
        assert {f: getattr(a, f).value for f in a.__dataclass_fields__} == \
            {f: getattr(b, f).value for f in b.__dataclass_fields__}
        assert a.vae is TT.DataType.FLOAT_32
    assert TT.ModelWeightDtypes().text_encoder is TT.DataType.BFLOAT_16


def _jax_param_dtypes(jm) -> dict:
    """part -> {port name: dtype name} of JAX's tiny bundle, from the
    modules' init traced by ``jax.eval_shape`` (no weights drawn)."""
    ucfg = jm.unet.config
    key = jax.random.key(0)
    ids = jnp.zeros((1, 77), jnp.int32)
    shapes = {
        "unet": jax.eval_shape(
            jm.unet.init, key, jnp.zeros((1, ucfg.in_channels, 16, 16)),
            jnp.zeros((1,)), jnp.zeros((1, 77, ucfg.cross_attention_dim)),
            jnp.zeros((1, ucfg.pooled_embed_dim)),
            jnp.zeros((1, ucfg.num_time_ids))),
        "vae": jax.eval_shape(jm.vae.init, key,
                              jnp.zeros((1, 3, 128, 128)), key),
        "clip_l": jax.eval_shape(jm.clip_l.init, key, ids),
        "clip_g": jax.eval_shape(jm.clip_g.init, key, ids)}
    out = {}
    for part, tree in shapes.items():
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), tree)
        out[part] = {n: _name(t.dtype) for n, t in from_jax_params(
            zeros, clip=part.startswith("clip")).items()}
    return out


@pytest.mark.parametrize("mp", ["bf16", "fp16", "no"])
def test_create_policy_part_dtypes_match_jax(mp):
    jm = JModel.create(tiny=True, policy=JT.Policy.from_mixed_precision(mp))
    model = SDXLModel.create(tiny=True, device="cpu",
                             policy=TT.Policy.from_mixed_precision(mp))
    theirs = _jax_param_dtypes(jm)
    for part in PARTS:
        ours = {n: _name(p.dtype)
                for n, p in getattr(model, part).state_dict().items()}
        assert ours == theirs[part], part
    assert model.unet.conv_in.weight.dtype == \
        TT.Policy.from_mixed_precision(mp).compute_dtype
    assert next(model.vae.parameters()).dtype == torch.float32


def test_create_policy_rules():
    """A bare dtype keeps working; ``weight_dtypes`` sets the CLIPs apart
    from the UNet; a policy whose params and compute differ raises (the
    port's UNet computes in its weights' dtype)."""
    model = SDXLModel.create(tiny=True, dtype=torch.float16, device="cpu")
    assert model.unet.conv_in.weight.dtype == torch.float16
    assert model.clip_l.text_model.embeddings.token_embedding.weight.dtype \
        == torch.float16
    wd = TT.ModelWeightDtypes.from_single_dtype(TT.DataType.FLOAT_32)
    model = SDXLModel.create(tiny=True, device="cpu", weight_dtypes=wd,
                             policy=TT.Policy.from_mixed_precision("bf16"))
    assert model.unet.conv_in.weight.dtype == torch.bfloat16
    for clip in (model.clip_l, model.clip_g):
        assert all(p.dtype == torch.float32 for p in clip.parameters())
    with pytest.raises(ValueError, match="weights' dtype"):
        SDXLModel.create(tiny=True, device="cpu", policy=TT.Policy())


@pytest.mark.parametrize("mp,dtype", [("bf16", torch.bfloat16),
                                      ("fp16", torch.float16),
                                      ("no", torch.float32)])
def test_from_config_builds_the_policy_model(mp, dtype):
    cfg = TC.Config.from_dict({"model": {"model_type": "sdxl_tiny"},
                               "training": {"mixed_precision": mp},
                               "tpu": {"remat": False}})
    model = SDXLModel.from_config(cfg, device="cpu")
    assert model.unet.conv_in.weight.dtype == dtype
    assert model.unet_config.block_out_channels == (32, 64, 128)
    assert model.unet_config.remat is False
    assert next(model.vae.parameters()).dtype == torch.float32


def test_from_config_refusals(tmp_path):
    with pytest.raises(ValueError, match="Unknown model type"):
        SDXLModel.from_config(TC.Config.from_dict(
            {"model": {"model_type": "sd15"}}), device="cpu")
    with pytest.raises(ValueError, match="Unknown dtype name"):
        SDXLModel.from_config(TC.Config.from_dict(
            {"model": {"model_type": "tiny"},
             "training": {"mixed_precision": "fp8"}}), device="cpu")
    # a local checkpoint is imported now; an inpainting one is refused
    (tmp_path / "unet").mkdir()
    (tmp_path / "unet" / "config.json").write_text(json.dumps(
        UNetConfig.tiny(in_channels=9).to_diffusers_config()))
    with pytest.raises(ValueError, match="inpainting"):
        SDXLModel.from_config(TC.Config.from_dict(
            {"model": {"model_type": "sdxl_tiny",
                       "pretrained_model_name": str(tmp_path)}}),
            device="cpu")


def _unet_args(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
            np.asarray([10, 900], np.int32),
            rng.standard_normal((2, 77, 64)).astype(np.float32),
            rng.standard_normal((2, 32)).astype(np.float32),
            np.asarray([[64, 64, 0, 0, 64, 64], [32, 48, 4, 2, 32, 48]],
                       np.float32))


def _unet_outputs(mp, params32):
    """(port, JAX) tiny UNet outputs as fp32 numpy, built from the policy
    ``mp``, both holding ``params32`` cast leaf by leaf to the dtypes that
    policy gives JAX's parameters."""
    jm = JModel.create(tiny=True, policy=JT.Policy.from_mixed_precision(mp))
    ucfg = jm.unet.config
    layout = jax.eval_shape(
        jm.unet.init, jax.random.key(0),
        jnp.zeros((1, ucfg.in_channels, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 77, ucfg.cross_attention_dim)),
        jnp.zeros((1, ucfg.pooled_embed_dim)),
        jnp.zeros((1, ucfg.num_time_ids)))
    params = jax.tree_util.tree_map(lambda p, s: p.astype(s.dtype),
                                    params32, layout)
    model = SDXLModel.create(tiny=True, device="cpu",
                             policy=TT.Policy.from_mixed_precision(mp))
    model.unet.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    args = _unet_args()
    ref = jax.jit(jm.unet.apply)(params, *map(jnp.asarray, args))
    with torch.no_grad():
        out = model.unet_apply(*map(torch.from_numpy, args))
    return out.float().numpy(), np.asarray(ref).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tiny_unet_forward_per_policy_matches_jax():
    params = JModel.create(tiny=True, dtype=jnp.float32,
                           init_rng=jax.random.key(3)).params["unet"]
    out32, ref32 = _unet_outputs("no", params)
    np.testing.assert_allclose(out32, ref32, rtol=RTOL, atol=ATOL)
    # the same weights rounded to fp16 (norms stay fp32, as in JAX)
    out16, ref16 = _unet_outputs("fp16", params)
    assert np.isfinite(out16).all() and np.isfinite(ref16).all()
    assert _rel(out16, ref16) <= 1e-2
    assert _rel(out16, out32) <= 5e-3 and _rel(ref16, ref32) <= 5e-3


# ----------------------------------------------- fp32 step, ddpm smoke


def test_smoke_literal_mirrors_the_yaml():
    """The card's run takes the YAML's settings from a literal; they must
    stay the file's, but for the model type its first comment swaps."""
    import chip_smoke
    raw = yaml.safe_load(SMOKE_YAML.read_text())
    lit = chip_smoke.DDPM_512_SMOKE
    for section in ("model", "optimizer", "training"):
        for key, value in raw[section].items():
            want = "sdxl" if (section, key) == ("model", "model_type") \
                else value
            assert lit[section][key] == want, (section, key)
    assert raw["data"]["image_size"] == chip_smoke.F32_SIZE
    assert 'swap to "sdxl"' in SMOKE_YAML.read_text()


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "vae_latents": rng.standard_normal((1, 4, 16, 16)).astype(
            np.float32),
        "prompt_embeds": rng.standard_normal((1, 77, 64)).astype(np.float32),
        "pooled_prompt_embeds": rng.standard_normal((1, 32)).astype(
            np.float32),
        "time_ids": np.asarray([[128., 128, 0, 0, 128, 128]], np.float32),
        "noise": rng.standard_normal((1, 4, 16, 16)).astype(np.float32),
        "timesteps": np.asarray([400]),
    }


def test_tiny_fp32_smoke_step_matches_jax():
    jcfg = JC.Config.from_yaml(str(SMOKE_YAML))
    assert jcfg.optimizer.optimizer_type == "adamw"
    assert jcfg.training.mixed_precision == "no"
    jcfg.optimizer.learning_rate = 1e-3  # a step that moves the weights
    jmodel = JModel.create(
        tiny=True, policy=JT.Policy.from_mixed_precision("no"),
        init_rng=jax.random.key(1))
    jopt = jax_make_optimizer(jcfg)
    jstep = JTR.make_train_step(jmodel.unet_apply,
                                JS.NoiseSchedule.from_config(jcfg), jopt,
                                jcfg, donate=False)
    state = JTR.create_train_state(jmodel.trainable_params(), jopt)
    state, _ = jstep(state, {k: jnp.asarray(v)
                             for k, v in _batch(11).items()})
    batch = _batch(12)
    ref_state, ref_metrics = jstep(state, {k: jnp.asarray(v)
                                           for k, v in batch.items()})

    cfg = TC.Config.from_dict(dataclasses.asdict(jcfg))
    model = SDXLModel.from_config(cfg, device="cpu")
    model.unet.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params)), strict=True)
    opt = make_optimizer(cfg)
    assert isinstance(opt, AdamW)
    step = TTR.make_train_step(model.unet_apply,
                               TS.NoiseSchedule.from_config(cfg), opt, cfg)
    tstate = TTR.create_train_state(model.trainable_params(), opt)
    adam = state.opt_state[0]

    def tree(t):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, t))
    tstate.opt_state = AdamWState(step=int(adam.count), mu=tree(adam.mu),
                                  nu=tree(adam.nu))
    tstate, metrics = step(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})

    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]),
                                   rtol=RTOL)
    ref_adam = ref_state.opt_state[0]
    for ours, theirs in ((tstate.opt_state.mu, tree(ref_adam.mu)),
                         (tstate.opt_state.nu, tree(ref_adam.nu))):
        atol = 1e-6 * max(t.abs().max().item() for t in theirs.values())
        for name, m in ours.items():
            np.testing.assert_allclose(m.numpy(), theirs[name].numpy(),
                                       rtol=RTOL, atol=atol, err_msg=name)
    ref = tree(ref_state.params)
    for name, p in tstate.params.items():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=4 * opt.lr,
                                   err_msg=name)
    assert tstate.opt_state.step == 2
