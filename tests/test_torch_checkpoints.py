"""PyTorch port: checkpoint I/O against the JAX package and the real
``safetensors`` package.

* The port's reader on files the JAX package writes (``save_unet``,
  ``save_vae``, ``save_clip``, through ``safetensors``) in F32, BF16 and
  F16: bit-equal to the same tree moved by ``from_jax_params``.
* The port's writer read back by ``safetensors.numpy.load_file``, and a
  port ``export_diffusers`` loaded by JAX's ``import_diffusers``: equal
  parameters for the base, inpainting and refiner tiny models.
* The sharded index layout and the refusal of a key in two files.
* ``check_bijective`` on the full-size SDXL modules (built on the meta
  device) against the key/shape manifests of ``tests/fixtures``.
* ``UNetConfig.from_diffusers_config`` / ``to_diffusers_config`` against
  JAX's.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.models import unet as JU
from sdxl_training_improvements_tpu.models import weights as JW
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.training import checkpoints as JC
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models import weights as W
from sdxl_training_improvements_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel)
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.models.unet import (
    SDXLUNet, UNetConfig)
from sdxl_training_improvements_tpu_torch.models.vae import (
    AutoencoderKL, VAEConfig)
from sdxl_training_improvements_tpu_torch.training import checkpoints as C

FIXTURES = Path(__file__).parent / "fixtures"
COMPONENTS = ("unet", "vae", "clip_l", "clip_g")
NP_DTYPES = {"F32": np.float32, "BF16": ml_dtypes.bfloat16,
             "F16": np.float16}


def _tiny_refiner(config_cls):
    """The tiny refiner UNet config (CLIP-G-only widths) of either
    package's ``UNetConfig``."""
    return config_cls.tiny(
        num_time_ids=5, cross_attention_dim=32,
        projection_class_embeddings_input_dim=32 + 5 * 8)


@pytest.fixture(scope="module")
def jax_trees():
    model = JModel.create(tiny=True, dtype=jnp.float32,
                          init_rng=jax.random.key(0),
                          init_components=COMPONENTS)
    return {c: jax.tree_util.tree_map(np.asarray, model.params[c])
            for c in COMPONENTS}


def _save_jax(name, tree, path):
    if name.startswith("clip"):
        JW.save_clip(tree, path, with_projection=name == "clip_g")
    else:
        JW.save_unet(tree, path)


@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
@pytest.mark.parametrize("name", COMPONENTS)
def test_reader_bit_equal_on_jax_files(jax_trees, tmp_path, name, dtype):
    tree = jax.tree_util.tree_map(lambda a: a.astype(NP_DTYPES[dtype]),
                                  jax_trees[name])
    path = tmp_path / "model.safetensors"
    _save_jax(name, tree, path)
    got = W.read_safetensors(path)
    want = W.from_jax_params(tree, clip=name.startswith("clip"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    # the header the package wrote names the same dtype
    n = int.from_bytes(path.read_bytes()[:8], "little")
    header = json.loads(path.read_bytes()[8:8 + n])
    assert {v["dtype"] for k, v in header.items()
            if k != "__metadata__"} == {dtype}


def test_writer_read_by_safetensors(tmp_path):
    gen = torch.Generator().manual_seed(0)
    state = {"w32": torch.randn(3, 5, generator=gen),
             "w16": torch.randn(7, generator=gen).half(),
             "wbf": torch.randn(2, 3, 4, generator=gen).bfloat16(),
             "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 4),
             "ids": torch.arange(6, dtype=torch.int64),
             "view": torch.randn(4, 6, generator=gen).t()}
    path = tmp_path / "x.safetensors"
    nbytes = W.save_safetensors(state, path)
    assert nbytes == path.stat().st_size
    theirs = load_file(str(path))
    assert sorted(theirs) == sorted(state)
    for k, v in state.items():
        want = (v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                if v.dtype == torch.bfloat16 else v.contiguous().numpy())
        assert theirs[k].dtype == want.dtype, k
        np.testing.assert_array_equal(theirs[k], want, err_msg=k)
    ours = W.read_safetensors(path)
    for k, v in state.items():
        assert torch.equal(ours[k], v), k


def test_reader_refuses_truncated_file(tmp_path):
    path = tmp_path / "x.safetensors"
    save_file({"a": np.ones((4, 4), np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="data_offsets"):
        W.read_safetensors(path)


def test_sharded_index_and_duplicate_keys(tmp_path):
    """diffusers' sharded layout, written by ``safetensors``: the shards
    read as one state; an index naming the wrong shard for a key, or a key
    in two files, raises."""
    rng = np.random.default_rng(1)
    state = {f"block.{i}.weight": rng.standard_normal(64).astype(np.float32)
             for i in range(5)}
    shards = [sorted(state)[:2], sorted(state)[2:4], sorted(state)[4:]]
    weight_map = {}
    for i, keys in enumerate(shards):
        name = f"diffusion_pytorch_model-0000{i + 1}-of-00003.safetensors"
        save_file({k: state[k] for k in keys}, str(tmp_path / name))
        weight_map.update(dict.fromkeys(keys, name))
    index = tmp_path / "diffusion_pytorch_model.safetensors.index.json"
    index.write_text(json.dumps({"metadata": {"total_size": 5 * 64 * 4},
                                 "weight_map": weight_map}))
    back = W.load_safetensors_dir(tmp_path)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v)

    weight_map["block.0.weight"] = weight_map["block.4.weight"]
    index.write_text(json.dumps({"weight_map": weight_map}))
    with pytest.raises(ValueError, match="block.0.weight"):
        W.load_safetensors_dir(tmp_path)

    # a precision variant beside the main file: the same keys twice
    dup = tmp_path / "dup"
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    W.save_safetensors(tensors, dup / "model.safetensors")
    W.save_safetensors({k: v.half() for k, v in tensors.items()},
                       dup / "model.fp16.safetensors")
    with pytest.raises(ValueError, match="duplicate tensor keys"):
        W.load_safetensors_dir(dup)
    with pytest.raises(FileNotFoundError):
        W.load_safetensors_dir(tmp_path / "missing")


@pytest.mark.parametrize("name,build", [
    ("unet", lambda: SDXLUNet(UNetConfig.sdxl())),
    ("vae", lambda: AutoencoderKL(VAEConfig.sdxl())),
    ("clip_l", lambda: CLIPTextModel(CLIPTextConfig.clip_l())),
    ("clip_g", lambda: CLIPTextModel(CLIPTextConfig.clip_g())),
])
def test_bijective_against_full_size_manifest(name, build):
    with torch.device("meta"):
        module = build()
    manifest = json.loads(
        (FIXTURES / f"sdxl_{name}_manifest.json").read_text())
    assert W.check_bijective(module, manifest) == ([], [])
    # one key dropped, one stray key, one shape changed
    first = sorted(manifest)[0]
    broken = dict(manifest)
    del broken[first]
    broken["stray.weight"] = [1]
    assert W.check_bijective(module, broken) == ([first], ["stray.weight"])
    broken = dict(manifest)
    broken[first] = [s + 1 for s in manifest[first]]
    with pytest.raises(ValueError, match="shape mismatch"):
        W.check_bijective(module, broken)


@pytest.mark.parametrize("variant", ["base", "inpainting", "refiner"])
def test_export_loads_in_jax(tmp_path, variant):
    ucfg = {"base": UNetConfig.tiny(),
            "inpainting": UNetConfig.tiny(in_channels=9),
            "refiner": _tiny_refiner(UNetConfig)}[variant]
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu",
                             unet_config=ucfg, refiner=variant == "refiner",
                             generator=torch.Generator().manual_seed(3))
    cfg = Config()
    cfg.training.method = "flow_matching"
    nbytes = C.export_diffusers(tmp_path, C.components(model), cfg,
                                unet_config=ucfg)
    assert nbytes == sum(p.stat().st_size
                         for p in tmp_path.rglob("*.safetensors"))
    assert (tmp_path / "text_encoder").exists() == (variant != "refiner")
    root = json.loads((tmp_path / "config.json").read_text())
    assert root["training"]["method"] == "flow_matching"

    jucfg = JU.UNetConfig.from_diffusers_config(
        json.loads((tmp_path / "unet" / "config.json").read_text()))
    jmodel = JModel.create(tiny=True, dtype=jnp.float32, unet_config=jucfg,
                           refiner=variant == "refiner")
    params = JC.import_diffusers(jmodel, tmp_path)
    assert sorted(params) == sorted(C.components(model))
    for name, module in C.components(model).items():
        tree = jax.tree_util.tree_map(np.asarray, params[name])
        state = W.from_jax_params(tree, clip=name.startswith("clip"))
        ours = module.state_dict()
        assert sorted(state) == sorted(ours), name
        for k, v in ours.items():
            assert torch.equal(state[k], v), (name, k)


def test_import_loads_jax_export(jax_trees, tmp_path):
    """JAX's ``export_diffusers`` -> the port's ``import_diffusers``:
    every tensor equal, cast to the module's dtype (bf16 here)."""
    JC.export_diffusers(tmp_path, jax_trees, JConfig(),
                        unet_config=JU.UNetConfig.tiny())
    model = SDXLModel.create(tiny=True, dtype=torch.bfloat16, device="cpu",
                             init_weights=False)
    assert C.import_diffusers(model, tmp_path) == set(COMPONENTS)
    for name in COMPONENTS:
        want = W.from_jax_params(jax_trees[name],
                                 clip=name.startswith("clip"))
        for k, v in getattr(model, name).state_dict().items():
            assert torch.equal(v, want[k].to(v.dtype)), (name, k)
    assert model.unet.conv_in.weight.dtype == torch.bfloat16
    assert next(model.vae.parameters()).dtype == torch.float32


def test_load_refuses_missing_and_stray_keys(tmp_path):
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    state = dict(model.vae.state_dict())
    del state["decoder.conv_in.weight"]
    state["decoder.extra.weight"] = torch.zeros(1)
    W.save_safetensors(state, tmp_path / "vae" / "x.safetensors")
    with pytest.raises(KeyError, match="1 keys missing"):
        W.load_component(model.vae, tmp_path / "vae")
    with pytest.raises(ValueError, match="with_projection"):
        W.save_clip(model.clip_l, tmp_path / "x.safetensors",
                    with_projection=True)


@pytest.mark.parametrize("variant", ["sdxl", "sdxl_inpainting",
                                     "sdxl_refiner", "tiny"])
def test_diffusers_config_matches_jax(variant):
    ours = getattr(UNetConfig, variant)()
    theirs = getattr(JU.UNetConfig, variant)()
    raw = ours.to_diffusers_config()
    assert raw == theirs.to_diffusers_config()
    back = UNetConfig.from_diffusers_config(raw)
    jback = JU.UNetConfig.from_diffusers_config(raw)
    for field in ("in_channels", "block_out_channels",
                  "transformer_layers_per_block", "mid_depth",
                  "attention_head_dim", "cross_attention_dim",
                  "projection_class_embeddings_input_dim", "num_time_ids",
                  "norm_num_groups", "layers_per_block"):
        assert getattr(back, field) == getattr(jback, field) \
            == getattr(ours, field), field


def test_diffusers_config_refusals():
    raw = UNetConfig.sdxl().to_diffusers_config()
    for key, value in (("addition_embed_type", "text"),
                       ("class_embed_type", "timestep"),
                       ("layers_per_block", [2, 2, 2]),
                       ("down_block_types", ["SimpleDown"] * 3),
                       ("projection_class_embeddings_input_dim", 1000)):
        with pytest.raises(ValueError):
            UNetConfig.from_diffusers_config({**raw, key: value})
        with pytest.raises(ValueError):
            JU.UNetConfig.from_diffusers_config({**raw, key: value})


def test_full_size_refiner_matches_jax_keys():
    """The 4-stage refiner (mid depth 4 after a plain last stage, cross
    dim 1280, 5 time ids) builds with the keys and shapes of JAX's, so a
    refiner checkpoint loads strictly."""
    jcfg = JU.UNetConfig.sdxl_refiner()
    junet = JU.SDXLUNet(config=jcfg, dtype=jnp.float32,
                        param_dtype=jnp.float32)
    template = jax.eval_shape(lambda: junet.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 77, jcfg.cross_attention_dim)),
        jnp.zeros((1, jcfg.pooled_embed_dim)), jnp.zeros((1, 5))))
    with torch.device("meta"):
        unet = SDXLUNet(UNetConfig.sdxl_refiner())
    state = unet.state_dict()
    assert JW.check_bijective(template, state) == ([], [])
    assert W.check_bijective(unet, state) == ([], [])
    assert sum(v.numel() for v in state.values()) == sum(
        int(np.prod(leaf.shape))
        for leaf in jax.tree_util.tree_leaves(template))
