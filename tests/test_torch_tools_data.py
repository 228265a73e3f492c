"""PyTorch port: ``tools/bench_precompute``, ``tools/verify_checkpoint``
and ``tools/profile_step`` on the CPU.

* ``bench_precompute`` on 8 tiny images: the serial and the pipelined
  precompute write the same cache (each arm's VAE draws from a generator
  seeded 0).
* ``verify_checkpoint``: exit 0 on a tiny checkpoint the port exports and
  on one JAX exports; 1 on a dropped key, an extra key and a wrong shape
  (JAX's ``tools/verify_checkpoint.py`` gives the same codes on the same
  directories); 2 with no component; a CLIP's ``position_ids`` buffer is
  ignored, as JAX drops it.
* ``profile_step`` (``--device cpu --tiny``): the rollup's shares sum to
  1 and name the host time as such; ``kernel_group`` sorts the card's
  kernel names into their categories.
"""
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu.config import Config as JConfig
from sdxl_training_improvements_tpu.models.sdxl import SDXLModel as JModel
from sdxl_training_improvements_tpu.models.unet import (
    UNetConfig as JUNetConfig)
from sdxl_training_improvements_tpu.training import checkpoints as JC
from sdxl_training_improvements_tpu_torch.config import Config
from sdxl_training_improvements_tpu_torch.models import weights as W
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.tools import bench_precompute as B
from sdxl_training_improvements_tpu_torch.tools import profile_step as PS
from sdxl_training_improvements_tpu_torch.tools import verify_checkpoint as V

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import verify_checkpoint as JV  # noqa: E402

COMPONENTS = ("unet", "vae", "clip_l", "clip_g")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_precompute_serial_and_pipeline_write_one_cache(tmp_path):
    res = B.run(8, 64, workers=2, real_vae=False, batch=4, device="cpu",
                root=tmp_path / "bench")
    for arm in ("serial", "parallel"):
        assert res[arm]["images"] == 8 and res[arm]["images_per_sec"] > 0
    assert res["serial"]["digest"] == res["parallel"]["digest"]
    assert not (tmp_path / "bench").exists()


def test_bench_precompute_cli(tmp_path, capsys):
    out = tmp_path / "out.json"
    rc = B.main(["--device", "cpu", "--images", "4", "--size", "64",
                 "--batch", "2", "--workers", "2", "--device-ms", "5",
                 "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and printed["caches_equal"] and printed["card"] is None
    assert json.loads(out.read_text())["images"] == 4


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ckpt")
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cpu")
    C.export_diffusers(root, C.components(model), Config(),
                       unet_config=model.unet_config)
    return root


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt")
    model = JModel.create(tiny=True, dtype=jnp.float32,
                          init_rng=jax.random.key(0),
                          init_components=COMPONENTS)
    JC.export_diffusers(root, {c: model.params[c] for c in COMPONENTS},
                        JConfig(), unet_config=JUNetConfig.tiny())
    return root


def _broken(src: Path, dst: Path, how: str) -> Path:
    shutil.copytree(src, dst)
    path = next((dst / "vae").glob("*.safetensors"))
    state = W.read_safetensors(path)
    key = sorted(state)[0]
    if how == "dropped":
        del state[key]
    elif how == "extra":
        state["stray.weight"] = torch.zeros(3)
    else:
        state[key] = torch.zeros(tuple(s + 1 for s in state[key].shape))
    path.unlink()
    W.save_safetensors(state, path)
    return dst


@pytest.mark.parametrize("which", ["port", "jax"])
def test_verify_passes_exported_checkpoints(which, port_ckpt, jax_ckpt):
    ckpt = port_ckpt if which == "port" else jax_ckpt
    lines = []
    assert V.verify(ckpt, tiny=True, out=lines.append) == 0
    assert [ln.split("]")[0] for ln in lines] == [
        "[unet", "[vae", "[clip_l", "[clip_g"]
    assert all(" OK: " in ln for ln in lines)
    assert V.main([str(ckpt), "--tiny"]) == 0
    # the full-size topology refuses the tiny shapes
    assert V.verify(ckpt, out=lambda _: None) == 1


@pytest.mark.parametrize("how", ["dropped", "extra", "shape"])
def test_verify_fails_like_jax(how, port_ckpt, tmp_path, monkeypatch):
    bad = _broken(port_ckpt, tmp_path / how, how)
    lines = []
    assert V.verify(bad, tiny=True, out=lines.append) == 1
    failed = [ln for ln in lines if "FAIL" in ln]
    assert len(failed) == 1 and failed[0].startswith("[vae]"), lines
    monkeypatch.setattr(sys, "argv", ["verify_checkpoint", str(bad),
                                      "--tiny"])
    with pytest.raises(SystemExit) as exc:
        JV.main()
    assert exc.value.code == 1


def test_verify_ignores_clip_position_ids_and_needs_a_component(
        port_ckpt, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(port_ckpt, ckpt)
    path = next((ckpt / "text_encoder").glob("*.safetensors"))
    state = W.read_safetensors(path)
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    path.unlink()
    W.save_safetensors(state, path)
    assert V.verify(ckpt, tiny=True, out=lambda _: None) == 0
    (tmp_path / "empty").mkdir()
    assert V.verify(tmp_path / "empty", out=lambda _: None) == 2


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::fused_adamw_kernel<float, false, 0>",
     "fused_adamw (hand CUDA)"),
    ("flash_bwd_dq_kernel<64>", "flash_bwd (hand CUDA)"),
    ("flash_f32_fwd_kernel<16>", "flash_fwd (hand CUDA)"),
    ("gn_silu_bwd_kernel<__nv_bfloat16>", "gn_silu (hand CUDA)"),
    ("probe_kernel", "probe (hand Triton)"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "convolution"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("void at::native::reduce_kernel<512, 1>", "norm/softmax"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>",
     "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, AbsFunctor>",
     "elementwise"),
    ("something else", "other")])
def test_kernel_group(name, group):
    assert PS.kernel_group(name) == group


def test_profile_step_on_the_cpu_names_host_time(tmp_path, capsys):
    out = tmp_path / "prof.json"
    assert PS.main(["--device", "cpu", "--tiny", "--batch", "1", "--hw",
                    "8", "--steps", "1", "--top", "5",
                    "--out", str(out)]) == 0
    prof = json.loads(out.read_text())
    assert prof["time"].startswith("host") and prof["idle_share"] is None
    assert prof["card"] is None and len(prof["top"]) == 5
    assert sum(g["share"] for g in prof["groups"].values()) == \
        pytest.approx(1.0)
    assert all(np.isfinite(prof["losses"]))
    assert "rollup by category" in capsys.readouterr().out
