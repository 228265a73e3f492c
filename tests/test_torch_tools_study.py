"""PyTorch port: ``tools/study_int8_moments`` against JAX's optimizers.

Each arm (bf16 moments, int8 moments, fp32 plain AdamW) takes 3 steps of
the tiny UNet from the study's fp32 start on injected batches (latents,
noise and timesteps from numpy).  The port's gradients go to both the
port's update and JAX's (``adamw_bf16(noise="hash")`` with JAX's seeds,
or ``optax.adamw``), from the same state (JAX's init carried across), at
the bars of ``tests/test_torch_optim_extra.py`` and
``tests/test_torch_adamw.py``: bf16 parameters bit for bit, fp32 leaves
at rtol 1e-6 / atol 4e-8.  The port's optimizer runs on views of JAX's
leaves (the same elements in JAX's memory order): the counter-hash noise
indexes an element by its place in its package's own layout (a conv
kernel is HWIO in JAX, OIHW channels-last in the port), so only there do
the two draw the same roundings (``tests/test_torch_loop_optimizers.py``
says the same of the trainer).  The arm then takes those parameters for
its next step.  The loss is held against JAX's on the same parameters:
the fp32 arm at rtol 2e-4 (fp32 activations), the bf16 arms at rtol 5e-3
(a bf16 UNet in two packages rounds at other places; the bar of
``tests/test_torch_loop_optimizers.py``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.models import weights as JW
from sdxl_training_improvements_tpu.models.unet import (
    SDXLUNet as JUNet, UNetConfig as JUNetConfig)
from sdxl_training_improvements_tpu.training.methods import (
    get_method as jax_method)
from sdxl_training_improvements_tpu.training.optimizers import (
    adamw_bf16 as jax_adamw_bf16)
from sdxl_training_improvements_tpu.training.schedules import (
    NoiseSchedule as JSchedule)
from sdxl_training_improvements_tpu_torch.models.unet import UNetConfig
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state)
from sdxl_training_improvements_tpu_torch.tools import (
    study_int8_moments as S)
from sdxl_training_improvements_tpu_torch.tools.parity_check import (
    seeded_unet_state)

LOSS_RTOL = {"fp32": 2e-4, "bf16": 5e-3, "int8": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    return seeded_unet_state(UNetConfig.tiny(), 0)


def _jax_tree(template, values):
    """JAX's tree of ``template`` filled from port names -> tensors, each
    leaf in its port tensor's dtype (bf16 as bf16)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, _ in flat:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        name, _ = JW._leaf_to_hf(keys, np.zeros((0,)))
        *_, leaf = [p for p in keys if p != "params"]
        t = values[name]
        arr = JW._hf_from_leaf(name, t.detach().float().numpy(), leaf)
        leaves.append(jnp.asarray(arr).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _names(template):
    """The port's names of JAX's leaves, in JAX's flatten order."""
    return [JW._leaf_to_hf(tuple(str(getattr(k, "key", k)) for k in path),
                           np.zeros((0,)))[0]
            for path, _ in jax.tree_util.tree_flatten_with_path(template)[0]]


def _jax_seeds(key, names, order):
    """The two uint32 seeds JAX's per-leaf "hash" update draws for each
    leaf (JAX's flatten order, ``names``), in the port's ``order``."""
    _, step_key = jax.random.split(key)
    keys = jax.random.split(step_key, len(names))
    seeds = dict(zip(names, (np.asarray(jax.random.bits(k, (2,), jnp.uint32))
                             for k in keys)))
    return torch.tensor(np.stack([seeds[n] for n in order]).astype(np.int64))


def _batch(rng):
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    t = rng.integers(0, 1000, (2,)).astype(np.int64)
    return lat, noise, t


def _torch(leaf):
    a = np.asarray(leaf)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, np.float32))


def _perms(tree, like):
    """Port name -> the permutation of JAX's leaf that gives the port's
    tensor (found on ``like``'s values)."""
    out = {}
    for name, leaf in zip(_names(tree), jax.tree_util.tree_leaves(tree)):
        base, want = _torch(leaf), like[name]
        for perm in itertools.permutations(range(base.dim())):
            view = base.permute(perm)
            if view.shape == want.shape and torch.equal(
                    view.float(), want.detach().float()):
                out[name] = perm
                break
        else:
            raise AssertionError(f"{name}: no permutation of JAX's leaf")
    return out


def _jax_layout(tree, perms):
    """Port name -> a view of each JAX leaf with the port's shape: the
    same elements, in JAX's memory order (the port's hash noise indexes
    an element by its memory position, so these views draw JAX's)."""
    return {name: _torch(leaf).permute(perms[name])
            for name, leaf in zip(_names(tree),
                                  jax.tree_util.tree_leaves(tree))}


@pytest.mark.parametrize("arm", S.ARMS)
def test_study_arm_three_steps_match_jax(arm, start):
    port = S.Arm(arm, "cpu", start)
    ucfg = JUNetConfig.tiny()
    dtype = jnp.float32 if arm == "fp32" else jnp.bfloat16
    jm = JUNet(config=ucfg, dtype=dtype, param_dtype=dtype)
    template = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((2, 4, 16, 16)), jnp.zeros((2,)),
        jnp.zeros((2, 77, ucfg.cross_attention_dim)),
        jnp.zeros((2, ucfg.pooled_embed_dim)), jnp.zeros((2, 6))))
    names = _names(template)
    jparams = _jax_tree(template, port.params)
    if arm == "fp32":
        jopt = optax.adamw(S.LR, b1=S.BETAS[0], b2=S.BETAS[1], eps=S.EPS,
                           weight_decay=S.WD)
    else:
        jopt = jax_adamw_bf16(lr=S.LR, betas=S.BETAS, eps=S.EPS,
                              weight_decay=S.WD, noise="hash",
                              moments="int8" if arm == "int8" else "bf16")
    jstate = jopt.init(jparams)
    # jitted, as the port's chain reproduces XLA's compiled arithmetic
    jupdate = jax.jit(jopt.update)
    # the study's optimizer over JAX-layout views, from JAX's init
    perms = _perms(jparams, port.params)
    views = _jax_layout(jparams, perms)
    if arm == "fp32":
        ostate = port.opt.init(views)
    else:
        ostate = from_jax_opt_state(
            jax.tree_util.tree_map(np.asarray, jstate._replace(key=None)),
            like=views, optimizer=port.opt)
    loss_fn, sched, mcfg = jax_method("ddpm"), JSchedule.create(), \
        JConfig().model
    jloss_fn = jax.jit(lambda p, b: loss_fn(
        lambda q, *a, **k: jm.apply(q, *a), p, b, jax.random.key(0), sched,
        mcfg)[0])
    rng = np.random.default_rng(11)
    for step in range(3):
        lat, noise, t = _batch(rng)
        tb = dict(port.cond, vae_latents=torch.from_numpy(lat),
                  noise=torch.from_numpy(noise), timesteps=torch.from_numpy(t))
        loss, grads = port.loss_and_grads(tb, None)
        jb = {"vae_latents": jnp.asarray(lat), "noise": jnp.asarray(noise),
              "timesteps": jnp.asarray(t.astype(np.int32)),
              "prompt_embeds": jnp.zeros((2, 77, ucfg.cross_attention_dim),
                                         dtype),
              "pooled_prompt_embeds": jnp.zeros((2, ucfg.pooled_embed_dim),
                                                dtype),
              "time_ids": jnp.zeros((2, 6), jnp.float32)}
        jloss = jloss_fn(jparams, jb)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL[arm], err_msg=f"step {step}")
        jgrads = _jax_tree(template, grads)
        kw = {}
        if arm != "fp32":
            kw["seeds"] = _jax_seeds(jstate.key, names, list(views))
        updates, jstate = jupdate(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        deltas, ostate = port.opt.update(_jax_layout(jgrads, perms),
                                         ostate, views, **kw)
        with torch.no_grad():
            for n, v in views.items():
                v.add_(deltas[n])
        refs = _jax_layout(jparams, perms)
        for n, got in views.items():
            ref = refs[n]
            if got.dtype == torch.bfloat16:
                assert torch.equal(got.view(torch.int16),
                                   ref.view(torch.int16)), (step, n)
            else:
                np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                           rtol=1e-6, atol=4e-8,
                                           err_msg=f"step {step} {n}")
        # the arm's own parameters take the same values for the next step
        with torch.no_grad():
            for n, p in port.params.items():
                p.copy_(views[n])
