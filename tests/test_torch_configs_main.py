"""PyTorch port: ``main.main`` runs every shipped single-device config.

Each ``configs/*.yaml`` except ``v5p8_dp_full.yaml`` (an 8-way mesh,
ROADMAP queue 1 item 14) goes through the port's YAML reader with only
what a CPU run on the tiny model needs changed: the model type, the image
sizes and paths, the cache and log directories.  Every optimizer setting,
precision, method, batch tiling, remat setting and host-streamed state the
config names is kept, and ``main.main`` builds the trainer and takes one
step (``--max-steps 1``) with no ``NotImplementedError``, leaving finite
parameters.  ``v5e16_single_chip.yaml`` runs its
int8 moments with both host flags, so its optimizer state streams.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch import _yaml
from sdxl_training_improvements_tpu_torch import main as entry
from sdxl_training_improvements_tpu_torch.png import write_png
from sdxl_training_improvements_tpu_torch.training import loop

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SINGLE_DEVICE = sorted(p.name for p in CONFIGS.glob("*.yaml")
                       if p.name != "v5p8_dp_full.yaml")
IMAGE = {"min_size": [32, 32], "max_size": [96, 96], "bucket_step": 16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(folder: Path, n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True)
    for i in range(n):
        write_png(folder / f"i{i}.png",
                  rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        (folder / f"i{i}.txt").write_text(f"masterpiece, tag{i % 2}, cat")
    return str(folder)


def _cpu_config(name: str, root: Path) -> Path:
    raw = _yaml.load_file(CONFIGS / name)
    raw.setdefault("model", {})
    raw["model"]["model_type"] = "sdxl_tiny"
    raw["model"]["pretrained_model_name"] = str(root / "none")
    dirs = raw.get("data", {}).get("train_data_dir", ["train"])
    per_dir = -(-16 // len(dirs))  # one global batch, whatever the tiling
    raw.setdefault("data", {})
    raw["data"]["train_data_dir"] = [
        _images(root / f"data{i}", per_dir, i) for i in range(len(dirs))]
    raw["data"]["image_size"] = 64
    gc = raw.setdefault("global_config", {})
    gc["image"] = IMAGE
    gc.setdefault("cache", {})["cache_dir"] = str(root / "cache")
    gc["logging"] = {"log_dir": str(root / "logs"), "log_every": 1}
    training = raw.setdefault("training", {})
    training.update(num_epochs=1, save_every=0, save_best=False,
                    save_final_model=False, num_inference_steps=2)
    path = root / name
    path.write_text(_yaml.dump(raw))
    return path


@pytest.mark.parametrize("name", SINGLE_DEVICE)
def test_main_runs_every_single_device_config(tmp_path, name):
    assert len(SINGLE_DEVICE) == 5
    cfg_path = _cpu_config(name, tmp_path)
    trainers = []
    init = loop.SDXLTrainer.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    loop.SDXLTrainer.__init__ = recording_init
    try:
        rc = entry.main(["--config", str(cfg_path), "--output-dir",
                         str(tmp_path / "out"), "--device", "cpu",
                         "--max-steps", "1"])
    finally:
        loop.SDXLTrainer.__init__ = init
    assert rc == 0
    trainer = trainers[0]
    assert trainer.state.step == 1
    params = trainer.state.params
    assert all(torch.isfinite(p.float()).all() for p in params.values())
    raw = _yaml.load_file(CONFIGS / name)
    opt = trainer.optimizer
    if raw.get("optimizer", {}).get("shift_host"):
        assert opt.shift_host and opt.moments_host and opt.moments == "int8"
        host = list(trainer.state.opt_state.shift.values())
        assert host and all(t.device.type == "cpu" for t in host)
