"""The sharded-training dry-run matrix at tiny shapes.

Port of ``__graft_entry__.py:150-217`` ``dryrun_multichip(n)`` over
the three mesh axes.  Every rank of an initialised world of ``n`` ranks
calls it
(``parallel/mesh.py`` ``initialize_multihost``: gloo ranks on the CPU or
NCCL ranks on the cards); each variant builds its mesh, the optimizer
and the step from a ``Config`` as JAX's ``_run_variant`` does, places
a fresh copy of the tiny bf16 UNet with ``shard_train_state``
(``tpu.shard_params`` on: each rank stores its fsdp chunks of the large
leaves, and the UNet gathers them per unit) and takes its steps on
seeded global batches:

* ``ddpm_dp_fsdp_retile``: mesh [n/2, 2, 1] (n even, else [n, 1, 1]),
  adamw_bf16, a global batch of 4n (2 x 2n) re-tiled into micro-batches
  of n rows (JAX's n/2 rows would not split over the n ranks: the port
  cuts each micro-batch into whole rows per rank);
* ``ddpm_dp_only``: [n, 1, 1], plain adamw, 4 steps, global batch 2n;
* ``ddpm_fsdp_only_int8_moments``: [1, n, 1], adamw_bf16 with int8
  moments;
* ``ddpm_fsdp_only``: [1, n, 1], plain adamw, the dp-only run's 4 steps
  and batches, whose losses must agree with dp-only within JAX's 5e-3;
* ``flow_matching_ema``: the first variant's mesh, flow matching, plain
  adamw with a weight EMA;
* ``ddpm_tp_only`` (n > 1): [1, 1, n], the UNet's transformer blocks
  megatron-split (where the tiny UNet's heads divide by n), plain adamw,
  the dp-only run's 4 steps and batches: its losses must agree with
  dp-only within 5e-3 (JAX's dp / tp-only pair);
* ``ddpm_dp_tp`` (n even, n > 2): [n/2, 1, 2], adamw_bf16 with rbg
  noise, each split leaf drawing its slice of the whole leaf's planes.

    python -m sdxl_training_improvements_tpu_torch.parallel.dryrun [--device cpu]

under ``torchrun --nproc-per-node N`` (or JAX's env triple) runs it and
prints each variant's losses.
"""
from __future__ import annotations

import argparse
import copy
from typing import Dict, List, Optional

import torch

from sdxl_training_improvements_tpu_torch.parallel import mesh as M

TRAJECTORY_RTOL = 5e-3


def _variant(name: str, model, start: Dict[str, torch.Tensor], shape,
             device, *, method: str = "ddpm", optimizer: str = "adamw_bf16",
             accum: int = 2, micro_batch: Optional[int] = None,
             ema_decay: Optional[float] = None, moments_8bit: bool = False,
             noise: str = "hash", steps: int = 1, seed: int = 0,
             global_batch: Optional[int] = None, log=print) -> List[float]:
    """One cell: ``steps`` steps on mesh ``shape``; the per-step losses."""
    from sdxl_training_improvements_tpu_torch.config import Config
    from sdxl_training_improvements_tpu_torch.training.optimizers import (
        make_optimizer)
    from sdxl_training_improvements_tpu_torch.training.schedules import (
        NoiseSchedule)
    from sdxl_training_improvements_tpu_torch.training.trainer import (
        create_train_state, make_train_step, shard_train_state)
    n = M.process_count()
    mesh = M.create_mesh(list(shape), device_type=device.type)
    config = Config()
    config.training.method = method
    config.training.gradient_accumulation_steps = accum
    config.optimizer.optimizer_type = optimizer
    config.optimizer.moments_8bit = moments_8bit
    config.tpu.sr_noise = noise
    config.training.ema_decay = ema_decay
    config.tpu.shard_params = True
    b = global_batch or 2 * n
    config.training.batch_size = b // accum
    config.tpu.micro_batch_size = micro_batch
    # the placement cuts the parameters (megatron slices, fsdp chunks): a
    # copy of the model
    model = copy.deepcopy(model)
    with torch.no_grad():  # a fresh copy of the parameters per variant
        for k, p in model.trainable_params().items():
            p.copy_(start[k])
    opt = make_optimizer(config)
    step = make_train_step(model.unet_apply,
                           NoiseSchedule.from_config(config), opt, config,
                           mesh=mesh)
    state = shard_train_state(
        create_train_state(model.trainable_params(), opt), mesh,
        shard_params=True, unet=model.unet)
    ucfg = model.unet_config
    losses = []
    for i in range(steps):
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        batch = {
            "vae_latents": torch.randn(b, 4, 16, 16, generator=gen) * 0.1,
            "prompt_embeds": torch.randn(
                b, 77, ucfg.cross_attention_dim, generator=gen) * 0.02,
            "pooled_prompt_embeds": torch.zeros(b, ucfg.pooled_embed_dim),
            "time_ids": torch.zeros(b, 6)}
        state, metrics = step(state, {k: v.to(device)
                                      for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
        if not float(metrics["grad_norm"]) > 0:
            raise RuntimeError(f"dryrun {name}: grad norm "
                               f"{float(metrics['grad_norm'])}")
    for loss in losses:
        if not torch.isfinite(torch.tensor(loss)):
            raise RuntimeError(f"non-finite loss in {name}: {losses}")
    if state.step != steps:
        raise RuntimeError(f"dryrun {name}: step {state.step} != {steps}")
    for k, p in state.params.items():
        if not torch.isfinite(p).all():
            raise RuntimeError(f"dryrun {name}: non-finite parameter {k}")
    log(f"dryrun_multichip[{name}]: mesh={dict(M.axis_sizes(mesh))} "
        f"sharded leaves={len(state.zero.chunks)} split leaves="
        f"{len(state.zero.tp)} loss={losses[-1]:.4f} OK")
    return losses


def dryrun_multichip(n_devices: int, device="cpu", log=print
                     ) -> Dict[str, List[float]]:
    """The matrix (module docstring) on this world of ``n_devices`` ranks;
    every rank calls it.  Returns each variant's losses; raises on a
    non-finite loss or parameter, a zero grad norm, or a dp-only /
    fsdp-only trajectory that disagrees."""
    from sdxl_training_improvements_tpu_torch.models.sdxl import SDXLModel
    n = M.process_count()
    if n != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of {n} "
                         "ranks")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = SDXLModel.create(
        tiny=True, dtype=torch.bfloat16, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    start = {k: p.detach().clone()
             for k, p in model.trainable_params().items()}
    full = (n // 2, 2, 1) if n % 2 == 0 else (n, 1, 1)
    run = dict(model=model, start=start, device=device, log=log)
    out = {"ddpm_dp_fsdp_retile": _variant(
        "ddpm_dp_fsdp_retile", shape=full, method="ddpm",
        optimizer="adamw_bf16", global_batch=4 * n, micro_batch=n, **run)}
    steps = 4
    out["ddpm_dp_only"] = _variant(
        "ddpm_dp_only", shape=(n, 1, 1), optimizer="adamw", steps=steps,
        seed=7, global_batch=2 * n, **run)
    out["ddpm_fsdp_only_int8_moments"] = _variant(
        "ddpm_fsdp_only_int8_moments", shape=(1, n, 1), moments_8bit=True,
        **run)
    out["ddpm_fsdp_only"] = _variant(
        "ddpm_fsdp_only", shape=(1, n, 1), optimizer="adamw", steps=steps,
        seed=7, global_batch=2 * n, **run)
    out["flow_matching_ema"] = _variant(
        "flow_matching_ema", shape=full, method="flow_matching",
        optimizer="adamw", ema_decay=0.999, **run)
    pairs = ["ddpm_fsdp_only"]
    if n > 1:
        out["ddpm_tp_only"] = _variant(
            "ddpm_tp_only", shape=(1, 1, n), optimizer="adamw",
            steps=steps, seed=7, global_batch=2 * n, **run)
        pairs.append("ddpm_tp_only")
    if n % 2 == 0 and n > 2:
        out["ddpm_dp_tp"] = _variant(
            "ddpm_dp_tp", shape=(n // 2, 1, 2), optimizer="adamw_bf16",
            noise="rbg", **run)
    rel = []
    for other in pairs:
        for i, (a, c) in enumerate(zip(out["ddpm_dp_only"], out[other])):
            r = abs(a - c) / max(abs(c), 1e-12)
            if not r < TRAJECTORY_RTOL:
                raise RuntimeError(
                    f"trajectory divergence at step {i}: dp-mesh {a} vs "
                    f"{other} {c} (rel {r:.2e})")
            rel.append(r)
    log(f"dryrun_multichip[trajectory_agreement]: {steps} steps, "
        f"{' and '.join(pairs)}, max rel divergence {max(rel):.2e} OK")
    log(f"dryrun_multichip({n_devices}): all variants OK")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    M.initialize_multihost(args.device)
    dryrun_multichip(M.process_count(), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
