"""The train step.

Port of ``sdxl_training_improvements_tpu/training/trainer.py``
(``TrainState``, ``create_train_state``, ``global_norm``,
``make_train_step``).  One step:

1. the global batch is cut into micro-batches (``gradient_accumulation_
   steps``, or ``tpu.micro_batch_size`` re-tiling the same global batch);
2. each micro-batch's loss is differentiated with ``torch.autograd.grad``
   and its gradients summed in the accumulator dtype (fp32, or bf16 with
   ``tpu.grad_accum_dtype``), then divided by the count;
3. a non-finite gradient element becomes 0; the global norm is taken and
   the gradients scaled by ``min(1, clip / (norm + 1e-6))`` in their own
   dtype;
4. the optimizer returns deltas and the step adds them to the parameters
   in place, in the parameters' dtype (JAX's ``optax.apply_updates``).

Randomness is keyed by sample: the state's CPU generator draws two seeds
per sample of the global batch (``batch["sample_seeds"]``) and one seed per
micro-batch, so a sample's noise and timestep do not depend on the tiling.
Not ported here: ``const_params`` (LoRA's frozen base), meshes and
host-streamed state (ROADMAP queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from sdxl_training_improvements_tpu_torch.ops.probe import run_probe
from sdxl_training_improvements_tpu_torch.training.methods import get_method
from sdxl_training_improvements_tpu_torch.training.schedules import (
    NoiseSchedule)

_SEED_HIGH = 2 ** 62


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # updated in place by the step
    opt_state: Any
    generator: torch.Generator  # CPU: per-sample and per-micro seeds
    # the startup probe's result on a card (ops/probe.py), else None
    probe: Optional[Dict[str, float]] = None


def create_train_state(params: Mapping[str, torch.Tensor], optimizer,
                       seed: int = 42) -> TrainState:
    """State over ``params`` (name -> tensor, e.g. ``SDXLModel.
    trainable_params()``).  On a card it first runs the startup probe,
    where the TPU trainer probed Mosaic at its first kernel dispatch."""
    params = dict(params)
    first = next(iter(params.values()))
    probe = run_probe(first.device) if first.device.type == "cuda" else None
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params),
                      generator=torch.Generator().manual_seed(seed),
                      probe=probe)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


def make_train_step(unet_apply: Callable, schedule: NoiseSchedule,
                    optimizer, config) -> Callable:
    """Build ``step(state, batch, events=None) -> (state, metrics)``.

    ``batch`` leaves are [global_batch, ...]; with accumulation G the
    leading dim must be divisible by G.  ``events``, a dict, receives CUDA
    events at the phase boundaries ("start", "backward", "clip",
    "update") for timing the step on a card."""
    loss_fn = get_method(config.training.method)
    accum = max(1, config.training.gradient_accumulation_steps)
    micro = getattr(config.tpu, "micro_batch_size", None)
    if micro:
        global_batch = config.training.batch_size * accum
        if global_batch % micro:
            raise ValueError(
                f"tpu.micro_batch_size ({micro}) must divide the global "
                f"batch (batch_size {config.training.batch_size} x "
                f"gradient_accumulation_steps {accum} = {global_batch})")
        accum = global_batch // micro
    clip = config.training.clip_grad_norm
    mcfg = config.model
    accum_dtype = (torch.bfloat16 if config.tpu.grad_accum_dtype
                   == "bfloat16" else torch.float32)

    def mark(events, name):
        if events is not None:
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

    def step(state: TrainState, batch: Mapping[str, torch.Tensor],
             events: Optional[dict] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mark(events, "start")
        names = list(state.params)
        params = [state.params[n] for n in names]
        global_b = next(iter(batch.values())).shape[0]
        if global_b % accum:
            raise ValueError(f"global batch {global_b} is not divisible "
                             f"into {accum} micro-batches")
        mb_size = global_b // accum
        sample_seeds = torch.randint(0, _SEED_HIGH, (global_b, 2),
                                     generator=state.generator)
        micro_seeds = torch.randint(0, _SEED_HIGH, (accum,),
                                    generator=state.generator).tolist()
        full = dict(batch, sample_seeds=sample_seeds)
        device = params[0].device

        grads = None
        losses, metrics = [], []
        for i in range(accum):
            mb = {k: v[i * mb_size:(i + 1) * mb_size]
                  for k, v in full.items()}
            gen = torch.Generator(device=device).manual_seed(micro_seeds[i])
            loss, m = loss_fn(unet_apply, mb, gen, schedule, mcfg)
            g = list(torch.autograd.grad(loss, params))
            losses.append(loss.detach())
            metrics.append(m)
            for j, gj in enumerate(g):  # frees each autograd grad in turn
                g[j] = gj.to(accum_dtype)
            if grads is None:
                grads = g
            else:
                for a, gj in zip(grads, g):
                    a.add_(gj)
            del g
        if accum > 1:
            for a in grads:
                a.div_(accum)
        mark(events, "backward")

        for g in grads:
            g.masked_fill_(~torch.isfinite(g), 0.0)
        gnorm = global_norm(grads)
        if clip is not None and clip > 0:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        mark(events, "clip")

        deltas, state.opt_state = optimizer.update(
            dict(zip(names, grads)), state.opt_state, state.params)
        del grads
        with torch.no_grad():
            for n, p in zip(names, params):
                p.add_(deltas[n])
        mark(events, "update")

        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        out["loss"] = torch.stack(losses).mean()
        out["grad_norm"] = gnorm
        state.step += 1
        return state, out

    return step
