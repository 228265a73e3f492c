"""Write JAX's loss curves that the port's ``tools/parity_check`` is held
against: ``tests/fixtures/parity/jax_<method>_s<seed>.json``.

Runs the JAX package's real train step on the CPU exactly as
``tools/parity_check.py``'s ``run_jax`` does (tiny UNet, fp32,
``Config()`` defaults, accumulation 1, clip 1.0, ``optax.adamw`` at
``LR``/``WD``/``BETAS``/``EPS``, the data of ``gen_step_data`` on
``default_rng(seed + 1)``), with one change: the weights start from the
port's framework-neutral ``seeded_unet_state(cfg, seed)`` (numpy draws),
converted with ``hf_to_flax_params``, instead of the torch twin's init.

    env JAX_PLATFORMS=cpu python tools/make_parity_fixtures.py [--steps N]
        [--method ddpm|flow_matching --seed S]

Needs JAX (the sandbox, not the card's machine).  Without ``--method``
it writes both curves of ``tests/test_loss_parity.py``: ddpm at seed 42
and flow_matching at seed 7.  The first step compiles for about a minute;
1000 steps take a few minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run_jax(steps: int, seed: int, batch: int = 2, size: int = 16,
            method: str = "ddpm"):
    """(losses, digest of the start) of JAX's train step from the seeded,
    framework-neutral start."""
    import jax
    import jax.numpy as jnp
    import optax
    from sdxl_training_improvements_tpu.config import Config
    from sdxl_training_improvements_tpu.models import weights as W
    from sdxl_training_improvements_tpu.models.unet import (
        SDXLUNet, UNetConfig)
    from sdxl_training_improvements_tpu.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu.training.trainer import (
        create_train_state, make_train_step)
    from sdxl_training_improvements_tpu_torch.models.unet import (
        UNetConfig as PortUNetConfig)
    from sdxl_training_improvements_tpu_torch.tools import parity_check as P

    ucfg = UNetConfig.tiny()
    flax_unet = SDXLUNet(config=ucfg, dtype=jnp.float32,
                         param_dtype=jnp.float32)
    template = jax.eval_shape(lambda: flax_unet.init(
        jax.random.key(0), jnp.zeros((1, 4, size, size)), jnp.zeros((1,)),
        jnp.zeros((1, 77, ucfg.cross_attention_dim)),
        jnp.zeros((1, ucfg.pooled_embed_dim)), jnp.zeros((1, 6))))
    start = P.seeded_unet_state(PortUNetConfig.tiny(), seed)
    params = W.hf_to_flax_params(template, start, strict=True)

    cfg = Config()
    cfg.training.method = method
    cfg.training.gradient_accumulation_steps = 1
    cfg.training.clip_grad_norm = P.CLIP
    opt = optax.adamw(P.LR, b1=P.BETAS[0], b2=P.BETAS[1], eps=P.EPS,
                      weight_decay=P.WD)
    step_fn = make_train_step(
        lambda p, *a, **kw: flax_unet.apply(p, *a),
        NoiseSchedule.from_config(cfg), opt, cfg, donate=False)
    state = create_train_state(params, opt, seed=seed)

    rng = np.random.default_rng(seed + 1)
    losses = []
    for _ in range(steps):
        d = P.gen_step_data(rng, batch, size, ucfg.cross_attention_dim,
                            ucfg.pooled_embed_dim, 1000, method=method)
        state, metrics = step_fn(state, {k: jnp.asarray(v)
                                         for k, v in d.items()})
        losses.append(float(metrics["loss"]))
    return losses, P.state_digest(start)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--method", choices=["ddpm", "flow_matching"])
    p.add_argument("--seed", type=int)
    args = p.parse_args()
    import jax
    from sdxl_training_improvements_tpu_torch.tools import parity_check as P
    curves = ([(args.method, args.seed)] if args.method else P.CURVES)
    P.FIXTURES.mkdir(parents=True, exist_ok=True)
    for method, seed in curves:
        t0 = time.perf_counter()
        losses, digest = run_jax(args.steps, seed, method=method)
        out = P.fixture_path(method, seed)
        out.write_text(json.dumps({
            "impl": "jax", "method": method, "seed": seed,
            "steps": args.steps, "batch": 2, "size": 16,
            "command": (f"env JAX_PLATFORMS=cpu python "
                        f"tools/make_parity_fixtures.py --steps "
                        f"{args.steps} --method {method} --seed {seed}"),
            "jax_version": jax.__version__,
            "backend": jax.default_backend(),
            "start_sha256": digest,
            "losses": losses}, indent=1))
        print(f"wrote {out}: {len(losses)} losses in "
              f"{time.perf_counter() - t0:.0f} s, first {losses[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
