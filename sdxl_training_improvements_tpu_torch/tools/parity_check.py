"""Loss-curve parity of the port's training step against the JAX package.

Port of ``tools/parity_check.py``.  The north star allows <= 1%
loss-curve divergence over 1k steps.  Both frameworks start from the same
weights (``seeded_unet_state``: a framework-neutral draw with numpy), take
the same data, noise and timesteps each step (``gen_step_data`` on
``default_rng(seed + 1)``, the batch's ``noise`` / ``timesteps`` replayed
by the loss) and the same plain AdamW with the global-norm clip, so a
divergence is an implementation error, not sampling noise.  JAX's curves
are committed as fixtures (``tests/fixtures/parity/jax_<method>_s<seed>
.json``, written by ``tools/make_parity_fixtures.py``).

    python -m sdxl_training_improvements_tpu_torch.tools.parity_check \\
        --method ddpm --seed 42 --steps 1000 --out port.json \\
        --against tests/fixtures/parity/jax_ddpm_s42.json
    python -m sdxl_training_improvements_tpu_torch.tools.parity_check \\
        --compare jax.json port.json

On a card TF32 stays off for cuBLAS and cuDNN (``SDXLModel.create`` sets
both), as ``configs/ddpm_512_smoke.yaml`` asks; the fp32 attention and
GN+SiLU run through the port's kernels.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.tools import card, require_device

LR = 1e-5
WD = 0.01
BETAS = (0.9, 0.999)
EPS = 1e-8
CLIP = 1.0
TOL = 0.01  # the north star's bar on max |a - b| / max(|a|, 1e-8)
SYNC_EVERY = 50  # steps whose losses are read at once

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / \
    "parity"
CURVES = (("ddpm", 42), ("flow_matching", 7))  # tests/test_loss_parity.py


def fixture_path(method: str, seed: int) -> Path:
    return FIXTURES / f"jax_{method}_s{seed}.json"


def gen_step_data(rng: np.random.Generator, batch: int, size: int,
                  ctx_dim: int, pooled_dim: int, num_timesteps: int,
                  method: str = "ddpm") -> dict:
    """One step's batch + injected noise/timesteps, all numpy fp32 (JAX
    ``tools/parity_check.py:38``, draw for draw).

    For flow matching the injected ``timesteps`` are the logit-normal
    t in [0,1] (the method's deterministic-replay override)."""
    if method == "flow_matching":
        t = (1.0 / (1.0 + np.exp(-rng.standard_normal(batch)))
             ).astype(np.float32)
    else:
        t = rng.integers(0, num_timesteps, (batch,)).astype(np.int32)
    return {
        "vae_latents": rng.standard_normal(
            (batch, 4, size, size), dtype=np.float32),
        "prompt_embeds": 0.1 * rng.standard_normal(
            (batch, 77, ctx_dim), dtype=np.float32),
        "pooled_prompt_embeds": 0.1 * rng.standard_normal(
            (batch, pooled_dim), dtype=np.float32),
        "time_ids": np.tile(np.asarray(
            [[size * 8., size * 8., 0., 0., size * 8., size * 8.]],
            np.float32), (batch, 1)),
        "noise": rng.standard_normal((batch, 4, size, size),
                                     dtype=np.float32),
        "timesteps": t,
    }


def _unet_shapes(cfg) -> Dict[str, tuple]:
    from sdxl_training_improvements_tpu_torch.models.unet import SDXLUNet
    with torch.device("meta"):
        unet = SDXLUNet(cfg)
    return {k: tuple(v.shape) for k, v in unet.state_dict().items()}


def seeded_unet_state(cfg, seed: int) -> Dict[str, np.ndarray]:
    """A diffusers-keyed fp32 state dict of the UNet of ``cfg``, drawn
    from ``np.random.default_rng(seed)`` over the keys in sorted order:
    conv and linear weights (the tensors of two or more dims) and their
    biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default init;
    norm scales 1 and norm biases 0.  Either framework loads it (JAX
    through ``hf_to_flax_params``)."""
    shapes = _unet_shapes(cfg)
    rng = np.random.default_rng(seed)
    state = {}
    for k in sorted(shapes):
        shape = shapes[k]
        owner = k.rsplit(".", 1)[0]
        weight = shapes.get(owner + ".weight", ())
        if len(weight) >= 2:  # a conv or linear weight, or its bias
            bound = float(np.prod(weight[1:])) ** -0.5
            state[k] = rng.uniform(-bound, bound, shape).astype(np.float32)
        elif k.endswith(".weight"):
            state[k] = np.ones(shape, np.float32)
        else:
            state[k] = np.zeros(shape, np.float32)
    return state


def state_digest(state: Dict[str, np.ndarray]) -> str:
    """sha256 over the keys in sorted order and their fp32 bytes."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k], np.float32).tobytes())
    return h.hexdigest()


def run_port(steps: int, seed: int, batch: int = 2, size: int = 16,
             method: str = "ddpm", device: str = "cuda") -> List[float]:
    """The port's real ``make_train_step`` on ``UNetConfig.tiny()`` (fp32,
    ``Config()`` defaults, accumulation 1, clip 1.0) from
    ``seeded_unet_state(cfg, seed)``, plain AdamW at ``LR``, ``WD``,
    ``BETAS``, ``EPS``; the data of JAX's ``run_jax``.  The losses are
    read every ``SYNC_EVERY`` steps."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    from sdxl_training_improvements_tpu_torch.training.optimizers.adamw \
        import AdamW
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step)

    dev = require_device(device)
    model = SDXLModel.create(tiny=True, dtype=torch.float32, device=dev,
                             init_weights=False)
    ucfg = model.unet_config
    start = seeded_unet_state(ucfg, seed)
    with torch.no_grad():
        model.unet.load_state_dict(
            {k: torch.from_numpy(v) for k, v in start.items()}, strict=True)
    cfg = Config()
    cfg.training.method = method
    cfg.training.gradient_accumulation_steps = 1
    cfg.training.clip_grad_norm = CLIP
    opt = AdamW(LR, betas=BETAS, eps=EPS, weight_decay=WD)
    step_fn = make_train_step(model.unet_apply,
                              NoiseSchedule.from_config(cfg), opt, cfg)
    state = create_train_state(model.trainable_params(), opt, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pending, losses = [], []
    for i in range(steps):
        d = gen_step_data(rng, batch, size, ucfg.cross_attention_dim,
                          ucfg.pooled_embed_dim, 1000, method=method)
        tb = {k: torch.from_numpy(v).to(dev, non_blocking=True)
              for k, v in d.items()}
        state, metrics = step_fn(state, tb)
        pending.append(metrics["loss"].detach())
        if len(pending) == SYNC_EVERY or i == steps - 1:
            losses += torch.stack(pending).cpu().tolist()
            pending = []
    return losses


def compare_curves(a, b, tol: float = TOL) -> dict:
    """JAX ``compare``'s metric, max over steps of |a - b| / max(|a|,
    1e-8), with the steps that miss ``tol`` (at most 20, worst first)."""
    n = min(len(a), len(b))
    if n == 0:
        raise ValueError("empty curves")
    a, b = np.asarray(a[:n], np.float64), np.asarray(b[:n], np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-8)
    worst = np.argsort(-rel)[:20]
    return {
        "steps_compared": n,
        "max_rel_divergence": float(rel.max()),
        "mean_rel_divergence": float(rel.mean()),
        "argmax_step": int(rel.argmax()),
        "within_1pct": bool(rel.max() <= tol),
        "steps_over_tol": [{"step": int(i), "a": float(a[i]),
                            "b": float(b[i]), "rel": float(rel[i])}
                           for i in worst if rel[i] > tol],
    }


def compare(path_a: str, path_b: str, tol: float = TOL) -> int:
    a = json.loads(Path(path_a).read_text())["losses"]
    b = json.loads(Path(path_b).read_text())["losses"]
    out = compare_curves(a, b, tol)
    print(json.dumps(out))
    return 0 if out["within_1pct"] else 1


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--impl", default="port", choices=["port"])
    p.add_argument("--method", default="ddpm",
                   choices=["ddpm", "flow_matching"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="parity_curve.json")
    p.add_argument("--against", default=None, metavar="JAX_JSON",
                   help="compare the curve with this one (JAX's fixture) "
                        "at the 1%% bar; exit 1 if it misses")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    t0 = time.perf_counter()
    losses = run_port(args.steps, args.seed, args.batch, args.size,
                      method=args.method, device=args.device)
    seconds = time.perf_counter() - t0
    out = {"impl": "port", "method": args.method, "steps": args.steps,
           "seed": args.seed, "batch": args.batch, "size": args.size,
           "device": args.device, "card": card(args.device),
           "torch": torch.__version__, "seconds": round(seconds, 2),
           "losses": losses}
    rc = 0
    if args.against:
        ref = json.loads(Path(args.against).read_text())
        out["against"] = args.against
        out["comparison"] = compare_curves(ref["losses"], losses)
        rc = 0 if out["comparison"]["within_1pct"] else 1
        print(json.dumps({k: v for k, v in out["comparison"].items()
                          if k != "steps_over_tol"}))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}: first={losses[0]:.6g} last={losses[-1]:.6g} "
          f"({seconds:.1f} s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
