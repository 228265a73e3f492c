"""PyTorch port: the training entry point on the card.

* Batches through ``prefetch_to_device`` (pinned memory, a side-stream
  copy ordered before the consumer's work) are ``torch.equal`` to the
  same batches copied synchronously, with the consumer's stream kept busy
  so that a missing wait would show.
* ``main.main`` on the tiny config at 64^2 over seeded PNGs, on the card:
  the loss is finite, the kernels launch, and a run resumed from its
  final checkpoint is ``torch.equal`` to the uninterrupted one.
* The precompute's latents through the fp32 VAE encoder: kernels against
  the plain versions at 1e-3 rel L2.

No JAX: run them on the card with ``python -m pytest
tests/test_torch_loop_kernels.py -m cuda --noconftest``; they skip
without a card.
"""
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch import _yaml
from sdxl_training_improvements_tpu_torch import main as entry
from sdxl_training_improvements_tpu_torch.data.pipeline import (
    prefetch_to_device)
from sdxl_training_improvements_tpu_torch.models import layers
from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
from sdxl_training_improvements_tpu_torch.ops import attention as TA
from sdxl_training_improvements_tpu_torch.ops import flash_attention as TF
from sdxl_training_improvements_tpu_torch.ops import groupnorm as TG
from sdxl_training_improvements_tpu_torch.png import write_png
from sdxl_training_improvements_tpu_torch.training import checkpoints as C
from sdxl_training_improvements_tpu_torch.training import loop

REL_L2 = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the H100 (README)")


def _plain_ops():
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        layers, "groupnorm_silu", TG.groupnorm_silu_reference))
    stack.enter_context(mock.patch.object(
        layers, "dot_product_attention", TA.dot_product_attention_reference))
    return stack


@pytest.mark.cuda
def test_prefetched_batches_equal_synchronous_copies(cuda):
    rng = np.random.default_rng(0)
    host = [{"vae_latents": rng.standard_normal((4, 4, 96, 96)).astype(
                np.float32),
             "time_ids": rng.standard_normal((4, 6)).astype(np.float32)}
            for _ in range(12)]
    busy = torch.randn(4096, 4096, device="cuda")
    for i, batch in enumerate(prefetch_to_device(iter(host), "cuda",
                                                 prefetch=3)):
        busy = busy @ busy / 64.0  # keeps the consumer's stream busy
        for k, v in host[i].items():
            assert batch[k].is_cuda
            assert torch.equal(batch[k], torch.from_numpy(v).cuda()), (i, k)
    torch.cuda.synchronize()
    assert i == len(host) - 1


def _dataset(root, n=4):
    rng = np.random.default_rng(0)
    img = root / "imgs"
    img.mkdir()
    for i in range(n):
        write_png(img / f"i{i}.png",
                  rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        (img / f"i{i}.txt").write_text(f"masterpiece, tag{i}, cat")
    return img


def _config(root, img, **training):
    raw = {"model": {"model_type": "sdxl_tiny",
                     "pretrained_model_name": str(root / "none")},
           "optimizer": {"optimizer_type": "adamw", "learning_rate": 1e-4},
           "training": {"batch_size": 2, "mixed_precision": "no",
                        "save_every": 0, "save_best": False, **training},
           "data": {"train_data_dir": [str(img)]},
           "global_config": {
               "cache": {"cache_dir": str(root / "cache")},
               "image": {"min_size": [32, 32], "max_size": [96, 96]},
               "logging": {"log_dir": str(root / "logs"), "log_every": 1}}}
    path = root / f"cfg_{len(list(root.glob('cfg_*')))}.yaml"
    path.write_text(_yaml.dump(raw))
    return str(path)


def _run(argv):
    trainers = []
    init = loop.SDXLTrainer.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    with mock.patch.object(loop.SDXLTrainer, "__init__", recording_init):
        assert entry.main(argv) == 0
    return trainers[0]


@pytest.mark.cuda
def test_entry_point_on_card_resumes_bit_equal(cuda, tmp_path):
    img = _dataset(tmp_path)
    before = (TG.gn_silu_fwd_cuda.launches, TG.gn_silu_bwd_cuda.launches,
              TF.flash_attention_fwd_cuda.launches)
    a = _run(["--config", _config(tmp_path, img, num_epochs=2,
                                  save_final_model=False),
              "--output-dir", str(tmp_path / "a")])
    launched = [x - y for x, y in zip(
        (TG.gn_silu_fwd_cuda.launches, TG.gn_silu_bwd_cuda.launches,
         TF.flash_attention_fwd_cuda.launches), before)]
    assert all(n > 0 for n in launched), launched
    assert a.state.step == 4
    ref, ref_meta = C.flatten_train_state(a.state)
    ref = {k: v.detach().cpu() for k, v in ref.items()}
    _run(["--config", _config(tmp_path, img, num_epochs=1),
          "--output-dir", str(tmp_path / "b")])
    b = _run(["--config", _config(tmp_path, img, num_epochs=2,
                                  save_final_model=False),
              "--output-dir", str(tmp_path / "b"), "--resume"])
    got, meta = C.flatten_train_state(b.state)
    assert meta == ref_meta
    assert set(got) == set(ref)
    for k, v in got.items():
        assert torch.equal(v.detach().cpu(), ref[k]), k


@pytest.mark.cuda
def test_precompute_latents_kernels_match_plain(cuda):
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    px = torch.rand(4, 3, 64, 64, device="cuda", generator=gen) * 2 - 1
    n = 64 // model.vae.config.downscale_factor
    noise = torch.randn(4, 4, n, n, device="cuda", generator=gen)
    before = TG.gn_silu_fwd_cuda.launches_by_dtype.get(torch.float32, 0)
    with torch.no_grad():
        lat = model.encode_images(px, noise=noise)
        assert TG.gn_silu_fwd_cuda.launches_by_dtype[torch.float32] > before
        with _plain_ops():
            ref = model.encode_images(px, noise=noise)
    assert torch.isfinite(lat).all()
    assert ((lat - ref).norm() / ref.norm()).item() <= REL_L2
