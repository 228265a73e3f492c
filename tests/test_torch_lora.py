"""PyTorch port: LoRA (``models/lora.py``, the trainer's ``const_params``,
``export_lora`` / ``import_lora``) against the JAX package, on the tiny
fp32 UNet holding the flax module's parameters.

* Selection: the default targets, the finetune demo's three regexes and a
  regex that matches nothing select the same kernels in both packages.
* ``lora_merge`` and the merge path's UNet output at the fp32 bar (rtol
  2e-4 / atol 2e-5, ``tests/test_weight_parity.py``), the JAX tree carried
  across by ``from_jax_lora``.
* The branch path with dropout, on attention, MLP and convolution adapters
  (the downsampler's stride 2 and the 1x1 shortcut among them), against
  JAX's flax interceptor with JAX's Bernoulli masks handed in (the port
  cannot draw JAX's bits); conv adapters' merge against branch at
  dropout 0; the seeded masks repeat under remat.
* One train step with ``const_params`` against JAX's: loss and the LoRA
  tree after a plain AdamW step at the fp32 bar.
* ``export_lora`` of either package read by the other's ``import_lora``,
  dense and conv; ``extend_token_embedding``.
"""
import dataclasses
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.models import lora as JL
from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu.training import checkpoints as JC
from sdxl_training_improvements_tpu.training import schedules as JS
from sdxl_training_improvements_tpu.training.trainer import (
    create_train_state as jax_state, make_train_step as jax_step)
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models import lora as TL
from sdxl_training_improvements_tpu_torch.models import unet as TU
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_lora, from_jax_params)
from sdxl_training_improvements_tpu_torch.training import checkpoints as TC
from sdxl_training_improvements_tpu_torch.training import schedules as TS
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    make_optimizer)
from sdxl_training_improvements_tpu_torch.training.trainer import (
    create_train_state, make_train_step)

RTOL, ATOL = 2e-4, 2e-5
DEMO_TARGETS = (r"attn\d/(to_q|to_k|to_v|to_out_0)", r"ff/(net_0/proj|net_2)",
                r"conv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: with six
    xdist workers each spinning a pool the size of the host, the tiny
    model's steps ran ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def unets():
    """(flax module, its params, the port's UNet with them, inputs)."""
    cfg = JU.UNetConfig.tiny()
    jm = JU.SDXLUNet(config=cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    args = (_rand((2, 4, 16, 16), 6), np.asarray([10, 900], np.int32),
            _rand((2, 77, cfg.cross_attention_dim), 7),
            _rand((2, cfg.pooled_embed_dim), 8),
            np.asarray([[64, 64, 0, 0, 64, 64], [32, 48, 4, 2, 32, 48]],
                       np.float32))
    params = jax.jit(jm.init)(jax.random.key(4), *map(jnp.asarray, args))
    tm = TU.SDXLUNet(TU.UNetConfig.tiny())
    tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    return jm, params, tm.eval(), args


def _jax_tree(params, targets, seed=0):
    """JAX's LoRA tree with a nonzero ``up`` (so the delta matters)."""
    tree = JL.lora_init(params, jax.random.key(seed), rank=4,
                        targets=targets)
    return {p: {"down": pair["down"],
                "up": jnp.asarray(_rand(pair["up"].shape, seed + 1, 0.05))}
            for p, pair in tree.items()}


def _model(tm):
    return types.SimpleNamespace(unet=tm, unet_apply=tm)


# -------------------------------------------------------------- selection
@pytest.mark.parametrize("targets", [
    JL.DEFAULT_TARGETS, DEMO_TARGETS[:1], DEMO_TARGETS[1:2],
    DEMO_TARGETS[2:], DEMO_TARGETS])
def test_targets_select_the_same_kernels(unets, targets):
    _, params, tm, _ = unets
    ref = set(JL.lora_init(params, jax.random.key(0), targets=targets))
    got = {TL.jax_path(f"{n}.weight")
           for n in TL.targeted_modules(tm, targets)}
    assert got == ref and got
    tree = from_jax_lora(jax.tree_util.tree_map(
        np.asarray, JL.lora_init(params, jax.random.key(0),
                                 targets=targets)))
    assert {n for n, _, _ in TL.lora_pairs(tree)} == set(
        TL.targeted_modules(tm, targets))


def test_no_match_raises_in_both(unets):
    _, params, tm, _ = unets
    with pytest.raises(ValueError, match="no kernels matched"):
        JL.lora_init(params, jax.random.key(0), targets=("nothing_here",))
    with pytest.raises(ValueError, match="no kernels matched"):
        TL.lora_init(tm, torch.Generator(), targets=("nothing_here",))


def test_init_shapes_and_zero_delta(unets):
    _, _, tm, args = unets
    tree = TL.lora_init(tm, torch.Generator().manual_seed(0), rank=4,
                        targets=DEMO_TARGETS)
    for name, down, up in TL.lora_pairs(tree):
        w = tm.get_submodule(name).weight
        assert down.shape == (4,) + tuple(w.shape[1:])
        assert up.shape == (w.shape[0], 4) and not up.any()
    std = torch.cat([d.flatten() for _, d, _ in TL.lora_pairs(tree)]).std()
    assert abs(float(std) - 0.5) < 0.02  # N(0, 1/r), r = 4
    merged = TL.lora_merge(dict(tm.named_parameters()), tree)
    for k, v in tm.named_parameters():
        assert torch.equal(merged[k], v)


# ----------------------------------------------------------- merge path
def test_merge_matches_jax(unets):
    jm, params, tm, args = unets
    jtree = _jax_tree(params, DEMO_TARGETS)
    tree = from_jax_lora(jax.tree_util.tree_map(np.asarray, jtree))
    jmerged = JL.lora_merge(params, jtree, alpha=0.7)
    merged = TL.lora_merge(dict(tm.named_parameters()), tree, alpha=0.7)
    ref_state = from_jax_params(jax.tree_util.tree_map(np.asarray, jmerged))
    for k, v in ref_state.items():
        np.testing.assert_allclose(merged[k].detach().numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL)
    ref = jax.jit(jm.apply)(jmerged, *map(jnp.asarray, args))
    _, apply_fn = TL.lora_train_wrappers(_model(tm), torch.Generator(),
                                         targets=DEMO_TARGETS, alpha=0.7)
    try:
        with torch.no_grad():
            out = apply_fn(tree, *map(torch.from_numpy, args))
    finally:
        apply_fn.adapter.remove()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_conv_adapters_merge_equals_branch(unets):
    """At dropout 0 the two paths compute the same delta (a rank-r conv
    with the module's geometry, then the 1x1 mix) in another order."""
    _, params, tm, args = unets
    tree = from_jax_lora(jax.tree_util.tree_map(
        np.asarray, _jax_tree(params, DEMO_TARGETS[2:], seed=3)))
    assert any(d.dim() == 4 for _, d, _ in TL.lora_pairs(tree))
    _, apply_fn = TL.lora_train_wrappers(_model(tm), torch.Generator(),
                                         targets=DEMO_TARGETS[2:])
    try:
        with torch.no_grad():
            a = apply_fn(tree, *map(torch.from_numpy, args), branch=False)
            b = apply_fn(tree, *map(torch.from_numpy, args), branch=True)
    finally:
        apply_fn.adapter.remove()
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- branch path
def _input_shapes(tm, names, args):
    """Each targeted module's input shape in one forward."""
    shapes, hooks = {}, []
    for n in names:
        hooks.append(tm.get_submodule(n).register_forward_pre_hook(
            lambda m, a, n=n: shapes.setdefault(n, tuple(a[0].shape))
            and None))
    with torch.no_grad():
        tm(*map(torch.from_numpy, args))
    for h in hooks:
        h.remove()
    return shapes


def test_branch_with_dropout_matches_jax_on_its_masks(unets):
    jm, params, tm, args = unets
    dropout = 0.25
    jtree = _jax_tree(params, DEMO_TARGETS, seed=5)
    tree = from_jax_lora(jax.tree_util.tree_map(np.asarray, jtree))
    rng = jax.random.key(11)
    _, japply = JL.lora_train_wrappers(
        params, lambda p, *a, **k: jm.apply(p, *a, **k), jax.random.key(0),
        rank=4, alpha=0.8, targets=DEMO_TARGETS, dropout=dropout, module=jm)
    # jitted: the interceptor runs while tracing (eager flax is slow)
    ref = jax.jit(lambda t, *a: japply(t, *a, rng=rng))(
        jtree, *map(jnp.asarray, args))
    # JAX's masks, as its interceptor draws them, in the port's layout
    names = [n for n, _, _ in TL.lora_pairs(tree)]
    masks = {}
    for n, shape in _input_shapes(tm, names, args).items():
        path = TL.jax_path(f"{n}.weight")
        key = jax.random.fold_in(rng, zlib.crc32(path.encode()))
        conv = len(shape) == 4
        jshape = (shape[0], shape[2], shape[3], shape[1]) if conv else shape
        m = torch.from_numpy(np.asarray(jax.random.bernoulli(
            key, 1.0 - dropout, jshape)))
        masks[n] = m.permute(0, 3, 1, 2) if conv else m
    _, apply_fn = TL.lora_train_wrappers(_model(tm), torch.Generator(),
                                         alpha=0.8, targets=DEMO_TARGETS,
                                         dropout=dropout)
    try:
        with torch.no_grad():
            out = apply_fn(tree, *map(torch.from_numpy, args), masks=masks)
            assert apply_fn.adapter.matched == set(names)
            plain = apply_fn(tree, *map(torch.from_numpy, args))
    finally:
        apply_fn.adapter.remove()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not np.allclose(out.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


def test_seeded_masks_repeat_under_remat(unets):
    """A block recomputed in the backward draws its module's mask again
    from the step seed and the path: the LoRA gradients with remat equal
    those without."""
    _, params, tm, args = unets
    targets = (r"attn\d/to_q", r"resnets_0/conv1")  # linear and conv
    tree = from_jax_lora(jax.tree_util.tree_map(
        np.asarray, _jax_tree(params, targets, seed=7)))
    args = [a[:1] for a in args]  # batch 1
    grads, config = [], tm.config
    for remat in (False, True):
        tm.config = dataclasses.replace(config, remat=remat)
        t = {k: v.clone().requires_grad_(True) for k, v in tree.items()}
        _, apply_fn = TL.lora_train_wrappers(_model(tm), torch.Generator(),
                                             targets=targets, dropout=0.3)
        try:
            out = apply_fn(t, *map(torch.from_numpy, args), seed=123)
            grads.append(torch.autograd.grad(out.square().mean(),
                                             list(t.values())))
        finally:
            apply_fn.adapter.remove()
    tm.config = config
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ train step
def test_train_step_with_const_params_matches_jax(unets):
    """One step (plain AdamW) of the LoRA tree on the frozen base: JAX's
    ``make_train_step(..., const_params=base)`` and the port's, the batch
    replaying the same noise and timesteps."""
    jm, params, tm, args = unets
    raw = {"optimizer": {"optimizer_type": "adamw", "learning_rate": 1e-3},
           "training": {"batch_size": 2, "mixed_precision": "no"}}
    jcfg, tcfg = JConfig.from_dict(raw), Config.from_dict(raw)
    jtree = _jax_tree(params, JL.DEFAULT_TARGETS, seed=9)
    noise = _rand((2, 4, 16, 16), 12)
    batch = {"vae_latents": args[0], "prompt_embeds": args[2],
             "pooled_prompt_embeds": args[3], "time_ids": args[4],
             "noise": noise, "timesteps": np.asarray([250, 700], np.int32)}
    _, japply = JL.lora_train_wrappers(
        params, lambda p, *a, rng=None, **k: jm.apply(p, *a, **k),
        jax.random.key(0), targets=JL.DEFAULT_TARGETS)
    jopt = optax.adamw(learning_rate=1e-3, weight_decay=jcfg.optimizer
                       .weight_decay)
    step = jax_step(japply, JS.NoiseSchedule.from_config(jcfg), jopt, jcfg,
                    donate=False, const_params=params)
    jst, jm_ = step(jax_state(jtree, jopt), jax.tree_util.tree_map(
        jnp.asarray, batch))

    tree = from_jax_lora(jax.tree_util.tree_map(np.asarray, jtree))
    for t in tree.values():
        t.requires_grad_(True)
    _, apply_fn = TL.lora_train_wrappers(_model(tm), torch.Generator(),
                                         targets=JL.DEFAULT_TARGETS)
    base = dict(tm.named_parameters())
    try:
        opt = make_optimizer(tcfg)
        tstep = make_train_step(apply_fn, TS.NoiseSchedule.from_config(tcfg),
                                opt, tcfg, const_params=base)
        st = create_train_state(tree, opt)
        st, met = tstep(st, {k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()})
    finally:
        apply_fn.adapter.remove()
    assert not any(p.requires_grad for p in tm.parameters())
    np.testing.assert_allclose(float(met["loss"]), float(jm_["loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jm_["grad_norm"]), rtol=RTOL, atol=ATOL)
    ref = from_jax_lora(jax.tree_util.tree_map(np.asarray, jst.params))
    assert set(ref) == set(st.params)
    for k, v in ref.items():
        np.testing.assert_allclose(st.params[k].detach().numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL)
    for t in tm.parameters():
        t.requires_grad_(True)


# ------------------------------------------------------- export / import
@pytest.mark.parametrize("targets", [JL.DEFAULT_TARGETS, DEMO_TARGETS[2:]])
def test_export_lora_crosses_between_packages(unets, targets, tmp_path):
    _, params, tm, _ = unets
    jtree = jax.tree_util.tree_map(np.asarray, _jax_tree(params, targets))
    tree = from_jax_lora(jtree)
    # the port writes, JAX reads
    TC.export_lora(tmp_path / "port", tree, rank=4, alpha=1.0)
    back = JC.import_lora(tmp_path / "port" / TC.LORA_FILE, params)
    assert set(back) == set(jtree)
    for p, pair in jtree.items():
        for half in ("down", "up"):
            np.testing.assert_array_equal(np.asarray(back[p][half]),
                                          pair[half])
    # JAX writes, the port reads
    JC.export_lora(tmp_path / "jax", jtree, rank=4, alpha=1.0)
    got = TC.import_lora(tmp_path / "jax" / TC.LORA_FILE, tm)
    assert set(got) == set(tree)
    for k, v in tree.items():
        assert torch.equal(got[k], v), k
    # alpha is folded into lora_B on export: a round trip applies alpha 1
    TC.export_lora(tmp_path / "a2", tree, rank=4, alpha=2.0)
    got = TC.import_lora(tmp_path / "a2" / TC.LORA_FILE, tm)
    for n, down, up in TL.lora_pairs(tree):
        assert torch.equal(got[f"{n}.up"], up * 2.0)


def test_import_lora_refusals(unets, tmp_path):
    _, _, tm, _ = unets
    from sdxl_training_improvements_tpu_torch.models import weights as W
    w = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"
    W.save_safetensors({f"unet.{w}.lora_A.weight": torch.zeros(4, 64),
                        f"text_encoder.x.lora_A.weight": torch.zeros(4, 8)},
                       tmp_path / "half.safetensors")
    with pytest.raises(ValueError, match="missing lora_A or lora_B"):
        TC.import_lora(tmp_path / "half.safetensors", tm)
    W.save_safetensors({"unet.conv_in.lora_A.weight": torch.zeros(4, 4, 3, 3),
                        "unet.conv_in.lora_B.weight":
                            torch.zeros(32, 4, 3, 3)},
                       tmp_path / "wide.safetensors")
    with pytest.raises(ValueError, match="1x1"):
        TC.import_lora(tmp_path / "wide.safetensors", tm)
    W.save_safetensors({"unet.nowhere.lora_A.weight": torch.zeros(4, 4)},
                       tmp_path / "bad.safetensors")
    with pytest.raises(KeyError, match="matches no kernel"):
        TC.import_lora(tmp_path / "bad.safetensors", tm)


def test_extend_token_embedding_matches_jax():
    emb = _rand((40, 16), 3)
    jparams = {"text_model": {"token_embedding": {"embedding":
                                                  jnp.asarray(emb)}}}
    key = jax.random.key(2)
    jnew, jvocab = JL.extend_token_embedding(jparams, key, 3)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (3, 16))))
    state = {"text_model.embeddings.token_embedding.weight":
             torch.from_numpy(emb), "other": torch.zeros(2)}
    new, vocab = TL.extend_token_embedding(state, None, 3, noise=noise)
    assert vocab == jvocab == 40
    got = new["text_model.embeddings.token_embedding.weight"]
    assert got.shape == (43, 16) and new["other"] is state["other"]
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jnew["text_model"]["token_embedding"]["embedding"]), rtol=1e-6,
        atol=1e-7)
    drawn, _ = TL.extend_token_embedding(
        state, torch.Generator().manual_seed(0), 3)
    assert torch.equal(drawn["text_model.embeddings.token_embedding.weight"]
                       [:40], state[
                           "text_model.embeddings.token_embedding.weight"])
