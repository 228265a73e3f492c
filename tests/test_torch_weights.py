"""PyTorch port: parameters carried across from the JAX package.

``from_jax_params`` must give exactly the keys and arrays of the JAX
package's own diffusers export (``flax_to_hf_state``/``_clip_flax_to_hf``)
and load strictly into the port's modules; the full-size port modules
(built on the meta device) must have the SDXL-base key manifests.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.models import weights as JW
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel)
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import (
    SDXLUNet, UNetConfig)
from sdxl_training_improvements_tpu_torch.models.vae import (
    AutoencoderKL, VAEConfig)
from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_params)

FIXTURES = Path(__file__).parent / "fixtures"
COMPONENTS = ("unet", "vae", "clip_l", "clip_g")


@pytest.fixture(scope="module")
def jax_trees():
    model = JModel.create(tiny=True, dtype=jnp.float32,
                          init_rng=jax.random.key(0),
                          init_components=COMPONENTS)
    return {c: jax.tree_util.tree_map(np.asarray, model.params[c])
            for c in COMPONENTS}


@pytest.fixture(scope="module")
def port_model():
    return SDXLModel.create(tiny=True, dtype=torch.float32,
                            device="cpu")


def _jax_export(name, tree):
    if name.startswith("clip"):
        return JW._clip_flax_to_hf(tree, with_projection=name == "clip_g")
    return JW.flax_to_hf_state(tree)


@pytest.mark.parametrize("name", COMPONENTS)
def test_keys_and_arrays_match_jax_export(jax_trees, name):
    ours = from_jax_params(jax_trees[name], clip=name.startswith("clip"))
    theirs = _jax_export(name, jax_trees[name])
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("name", COMPONENTS)
def test_loads_strictly_into_port(jax_trees, port_model, name):
    module = getattr(port_model, name)
    state = from_jax_params(jax_trees[name], clip=name.startswith("clip"))
    module.load_state_dict(state, strict=True)
    for k, v in module.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def test_bf16_leaves_convert_bit_exactly():
    tree = {"params": {"conv_in": {
        "kernel": np.asarray(jnp.linspace(-3, 3, 2 * 3 * 4 * 5,
                                          dtype=jnp.bfloat16)
                             ).reshape(2, 3, 4, 5),
        "bias": np.asarray(jnp.ones((5,), jnp.bfloat16))}}}
    state = from_jax_params(tree)
    w = state["conv_in.weight"]
    assert w.dtype == torch.bfloat16 and w.shape == (5, 4, 2, 3)
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(tree["params"]["conv_in"]["kernel"], np.float32
                   ).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("name,build", [
    ("unet", lambda: SDXLUNet(UNetConfig.sdxl())),
    ("vae", lambda: AutoencoderKL(VAEConfig.sdxl())),
    ("clip_l", lambda: CLIPTextModel(CLIPTextConfig.clip_l())),
    ("clip_g", lambda: CLIPTextModel(CLIPTextConfig.clip_g())),
])
def test_full_size_modules_match_manifest(name, build):
    with torch.device("meta"):
        module = build()
    manifest = json.loads(
        (FIXTURES / f"sdxl_{name}_manifest.json").read_text())
    assert {k: list(v.shape) for k, v in module.state_dict().items()} \
        == manifest
