"""How often the finetune demo's VAE pretrain spikes, in JAX and in the
port: every step's reconstruction mse of the recipe (the tiny VAE, Adam
at lr 2e-3, batch 16, 1500 steps, the 192-image codec dataset of
``stage_pretrain``), on the CPU, and the port's also on the card.

The port's arm calls ``sdxl_training_improvements_tpu_torch.tools.
finetune_demo.pretrain_vae`` with ``curve_every=1``; JAX's arm runs the
loop of ``tools/finetune_demo.py`` ``pretrain_vae`` (its loss closure,
``optax.adam``, the same batch draws) with every step's mse kept.  A
spike is a step whose batch mse is more than ``SPIKE_RATIO`` times the
median of the 50 steps before it (from step 100 on).  Each arm ends with
the held-out green triangle's round trip (``vae_recon_check``).

    env JAX_PLATFORMS=cpu python tools/study_vae_spikes.py --arm jax
    python tools/study_vae_spikes.py --arm port [--device cuda]

Needs JAX and Pillow for ``--arm jax`` (a CPU machine with the JAX
package; the card's machine has neither).  Each arm writes ``--out`` (default
``artifacts/finetune_demo_torch/vae_spikes_<arm>_<device>.json``); 1500
steps take about 20 minutes an arm on a few CPU cores, 2.5 on the card
(under cuDNN's deterministic algorithms, as ``pretrain_vae`` runs).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEPS, BATCH, LR, SEED = 1500, 16, 2e-3, 0  # stage_pretrain's recipe
SPIKE_RATIO, WINDOW = 5.0, 50


def run_port(img_dir: Path, steps: int, device: str):
    from sdxl_training_improvements_tpu_torch.tools import finetune_demo as D
    vae, curve = D.pretrain_vae(img_dir, steps=steps, batch=BATCH, lr=LR,
                                seed=SEED, log=_every_100, device=device,
                                curve_every=1)
    return [c["mse"] for c in curve], D.vae_recon_check(
        vae, D.NEW_CONCEPT, print)


def run_jax(img_dir: Path, steps: int, device: str):
    """JAX's ``pretrain_vae`` loop with every step's mse kept."""
    import jax
    import jax.numpy as jnp
    import optax
    from PIL import Image
    from sdxl_training_improvements_tpu.models.vae import (
        AutoencoderKL, VAEConfig)
    sys.path.insert(0, str(REPO / "tools"))
    import finetune_demo as JD

    paths = sorted(img_dir.glob("*.png"))
    imgs = np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32)
                     for p in paths])
    imgs = np.transpose(imgs / 127.5 - 1.0, (0, 3, 1, 2))
    vae = AutoencoderKL(VAEConfig.tiny())
    params = jax.jit(vae.init)(jax.random.key(SEED),
                               jnp.zeros((1,) + imgs.shape[1:], jnp.float32),
                               jax.random.key(0))
    opt = optax.adam(LR)
    opt_state = jax.jit(opt.init)(params)

    def loss_fn(p, px, key):
        mean, logvar = vae.apply(p, px, method=vae.moments)
        z = mean + jnp.exp(0.5 * logvar) * jax.random.normal(
            key, mean.shape, mean.dtype)
        recon = vae.apply(p, z * vae.config.scaling_factor,
                          method=vae.decode)
        mse = jnp.mean(jnp.square(recon - px))
        kl = 0.5 * jnp.mean(jnp.square(mean) + jnp.exp(logvar) - 1 - logvar)
        scale_pen = jnp.square(
            jnp.std(mean * vae.config.scaling_factor) - 1.0)
        return mse + 1e-4 * kl + 0.1 * scale_pen, mse

    @jax.jit
    def step(p, s, px, key):
        (_, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, px, key)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, mse

    key = jax.random.key(SEED + 1)
    rng = np.random.default_rng(SEED)
    mses = []
    for i in range(steps):
        idx = rng.integers(0, len(imgs), BATCH)
        key, k = jax.random.split(key)
        params, opt_state, mse = step(params, opt_state,
                                      jnp.asarray(imgs[idx]), k)
        mses.append(float(mse))
        _every_100(f"  vae step {i}: recon mse {mses[-1]:.5f}")
    return mses, JD.vae_recon_check(params, JD.NEW_CONCEPT, print)


def _every_100(msg: str) -> None:
    parts = msg.split()
    if len(parts) > 2 and parts[1] == "step" and \
            int(parts[2].rstrip(":")) % 100 == 0:
        print(msg, flush=True)


def spikes(mses) -> list:
    """(step, mse, ratio to the median of the WINDOW steps before) of
    every spike from step 100 on."""
    out = []
    for i in range(100, len(mses)):
        ref = statistics.median(mses[i - WINDOW:i])
        if mses[i] > SPIKE_RATIO * ref:
            out.append({"step": i, "mse": mses[i], "ratio": mses[i] / ref})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arm", choices=("port", "jax"), required=True)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="the port's arm only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.arm == "jax" and args.device != "cpu":
        ap.error("JAX's arm runs on the CPU")
    from sdxl_training_improvements_tpu_torch.tools import card
    from sdxl_training_improvements_tpu_torch.tools import finetune_demo as D
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = Path(tmp) / "data_vae"
        n = D.make_dataset(img_dir, D.BASE_CONCEPTS + [D.NEW_CONCEPT],
                           n_per=48, seed=5)
        t0 = time.perf_counter()
        mses, recon = (run_port if args.arm == "port" else run_jax)(
            img_dir, args.steps, args.device)
        seconds = time.perf_counter() - t0
    found = spikes(mses)
    out = {"arm": args.arm, "device": args.device,
           "card": card(args.device), "steps": args.steps,
           "batch": BATCH, "lr": LR, "dataset_images": n,
           "spike_rule": f"mse > {SPIKE_RATIO} x median of the {WINDOW} "
                         "steps before, from step 100",
           "spikes": found, "n_spikes": len(found),
           "mse_last": mses[-1], "mse_min_last_500": min(mses[-500:]),
           "mse_median_last_500": statistics.median(mses[-500:]),
           "heldout_recon": recon, "seconds": seconds,
           "command": " ".join(sys.argv), "mse": mses}
    path = Path(args.out or REPO / "artifacts" / "finetune_demo_torch" /
                f"vae_spikes_{args.arm}_{args.device}.json")
    path.write_text(json.dumps(out, indent=1))
    print(f"{args.arm}: {len(found)} spikes "
          f"{[(s['step'], round(s['ratio'], 1)) for s in found]}; last mse "
          f"{mses[-1]:.5f}; held-out {recon}; {seconds:.0f} s -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
