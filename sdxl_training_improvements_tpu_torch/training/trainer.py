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
``const_params`` (LoRA's frozen base, JAX ``trainer.py:54-66``) is an
argument of the step, not part of the state: its tensors are set to
``requires_grad=False``, are not copied and have no optimizer state; the
step hands them to ``unet_apply(params, *args, base_params=...,
seed=...)``, whose first argument is the trainable tree (LoRA's pairs)
and ``seed`` the micro-batch's seed (LoRA's dropout masks).  The
host-streamed optimizer state lives in the optimizer
(``optimizers/adamw_bf16.py``).

Over several cards (JAX ``trainer.py:56-140``, ``:251-348``):
``shard_train_state(state, mesh, shard_params, unet=)`` places the state
on the mesh (``parallel/zero.py``: with a tensor axis the UNet's
transformer blocks split into megatron slices, ``models/unet.py``
``place_on_mesh``, their parameters and optimizer state cut to this
rank's slice; the sharded leaves' optimizer state cut to this rank's
chunks) and ``make_train_step(..., mesh=)`` runs on every rank: each
takes its contiguous rows of every micro-batch (``shard_batch``, JAX's
``P((data, fsdp))``, the same rows on every tensor rank of a group)
from the global batch, which every rank holds;
the per-sample and per-micro-batch seeds are drawn for the whole global
batch on every rank from the replicated generator and then sliced, so a
sample's noise does not depend on the rank.  After the accumulation the
gradients are reduced once (``Zero.reduce_gradients``, in the
accumulator dtype), then masked, normed over the shards and clipped; the
optimizer updates the rank's chunks; the loss and the metrics are
averaged over the ranks.  With the parameters stored as chunks
(``shard_params`` with the UNet placed) the UNet gathers each unit's
chunks to run it, and the gathers' backward reduce-scatters each
micro-batch's gradients over fsdp into the rank's chunks
(``Zero.collecting``), which the accumulator holds, summed over the
micro-batches; the reduction after the accumulation then sums them over
data only, and the update lands in the stored chunks.  Without the UNet
the step gathers the updated chunks back into the whole parameters.
The loss's finite guard decides on the mean over the ranks' blocks
(``methods.mean_over``), so a micro-batch's clamp is JAX's.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from sdxl_training_improvements_tpu_torch.ops.probe import run_probe
from sdxl_training_improvements_tpu_torch.parallel import mesh as M
from sdxl_training_improvements_tpu_torch.training.methods import (
    get_method, mean_over)
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
    # the mesh layout (parallel/zero.py) once shard_train_state placed it
    zero: Any = None


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


def shard_train_state(state: TrainState, mesh, shard_params: bool = False,
                      unet=None) -> TrainState:
    """Place ``state`` (every rank's identical one-card state) on ``mesh``:
    with a tensor axis above 1 the leaves of ``unet`` (the module whose
    parameters ``state.params`` holds) that megatron splits become this
    rank's slices, in place (``models/unet.py`` ``place_on_mesh``; None:
    nothing splits, as under LoRA); with ``shard_params`` the optimizer
    state (and EMA shadow) of each leaf JAX shards over fsdp is cut to
    this rank's chunk (``parallel/zero.py``), field by field as JAX
    places it, and, when ``unet`` is given, so is the parameter itself
    (``Zero.store_params``: the UNet gathers each unit's chunks to run
    it); without ``unet`` the parameters stay whole on every rank.  A
    restored checkpoint is placed the same way, so a state saved by any
    number of ranks resumes on any other."""
    from sdxl_training_improvements_tpu_torch.parallel.zero import Zero
    tp = {}
    if unet is not None:
        from sdxl_training_improvements_tpu_torch.models.unet import (
            place_on_mesh)
        mine = {id(p) for p in state.params.values()}
        if not all(id(p) in mine for p in unet.parameters()):
            raise ValueError("shard_train_state(unet=): the module's "
                             "parameters must be state.params")
        _, tp = place_on_mesh(unet, mesh)
    zero = Zero(mesh, state.params, shard_params=shard_params, tp=tp)
    zero.shard_state(state.opt_state)
    if unet is not None and zero.chunks:
        zero.store_params(state.params, unet)
    state.zero = zero
    return state


def shard_batch(batch: Mapping[str, torch.Tensor], mesh, accum: int = 1
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: of each of its ``accum``
    micro-batches, block ``M.batch_index(mesh)`` of data x fsdp equal
    contiguous blocks (JAX's ``P((data, fsdp))``), the micro-batches'
    blocks joined in order."""
    index, blocks = M.batch_index(mesh)
    global_b = next(iter(batch.values())).shape[0]
    if global_b % (accum * blocks):
        raise ValueError(
            f"global batch {global_b} is not divisible into {accum} "
            f"micro-batches over the data-parallel mesh extent {blocks}")
    local = global_b // accum // blocks

    def rows(v):
        parts = [v[(i * blocks + index) * local:
                   (i * blocks + index + 1) * local] for i in range(accum)]
        return parts[0] if accum == 1 else torch.cat(parts)
    return {k: rows(v) for k, v in batch.items()}


def make_train_step(unet_apply: Callable, schedule: NoiseSchedule,
                    optimizer, config,
                    const_params: Optional[Mapping[str, torch.Tensor]] = None,
                    mesh=None) -> Callable:
    """Build ``step(state, batch, events=None) -> (state, metrics)``.

    ``batch`` leaves are [global_batch, ...]; with accumulation G the
    leading dim must be divisible by G.  ``events``, a dict, receives CUDA
    events at the phase boundaries ("start", "backward", "clip",
    "update") for timing the step on a card.  ``mesh``: every rank calls
    the step with the same global batch on a state placed by
    ``shard_train_state`` (module docstring)."""
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
    if const_params is not None:
        for t in const_params.values():
            t.requires_grad_(False)

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
        zero = state.zero
        if mesh is not None:
            if zero is None:
                raise ValueError("the state is not placed on the mesh: "
                                 "shard_train_state(state, mesh, "
                                 "shard_params) first")
            full = shard_batch(full, mesh, accum)
            mb_size //= zero.world
        device = params[0].device

        grads = None
        losses, metrics = [], []
        stored = zero is not None and zero.stored
        # the stored chunks' gradients, reduce-scattered over fsdp by the
        # gathers' backward and summed over the micro-batches
        sink: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            mb = {k: v[i * mb_size:(i + 1) * mb_size]
                  for k, v in full.items()}
            gen = torch.Generator(device=device).manual_seed(micro_seeds[i])
            apply = unet_apply
            if const_params is not None:
                apply = functools.partial(unet_apply, state.params,
                                          base_params=const_params,
                                          seed=micro_seeds[i])
            with (mean_over(zero.dp_group, zero.world) if zero is not None
                  else contextlib.nullcontext()):
                loss, m = loss_fn(apply, mb, gen, schedule, mcfg)
            with (zero.collecting(accum_dtype, sink) if stored
                  else contextlib.nullcontext()):
                g = list(torch.autograd.grad(loss, params,
                                             allow_unused=stored))
            losses.append(loss.detach())
            metrics.append(m)
            for j, gj in enumerate(g):  # frees each autograd grad in turn
                if gj is not None:  # None: a stored chunk's, in the sink
                    g[j] = gj.to(accum_dtype)
            if grads is None:
                grads = g
            else:
                for a, gj in zip(grads, g):
                    if gj is not None:
                        a.add_(gj)
            del g
        if stored:
            grads = [sink.pop(n) if n in zero.chunks else a
                     for n, a in zip(names, grads)]
        if zero is not None:  # the accumulator this rank held
            zero.grad_bytes = sum(a.numel() * a.element_size()
                                  for a in grads)
        if accum > 1:
            for a in grads:
                a.div_(accum)
        if zero is not None:  # the mean over the ranks; chunks if sharded
            reduced = zero.reduce_gradients(dict(zip(names, grads)))
            grads = [reduced[n] for n in names]
            del reduced
        mark(events, "backward")

        for g in grads:
            g.masked_fill_(~torch.isfinite(g), 0.0)
        gnorm = (global_norm(grads) if zero is None
                 else zero.norm(dict(zip(names, grads))))
        if clip is not None and clip > 0:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        mark(events, "clip")

        if zero is None:
            deltas, state.opt_state = optimizer.update(
                dict(zip(names, grads)), state.opt_state, state.params)
        else:
            deltas, state.opt_state = optimizer.update(
                dict(zip(names, grads)), state.opt_state,
                zero.views(state.params), zero=zero)
        del grads
        with torch.no_grad():
            for n, p in zip(names, params):
                (p if zero is None else zero.view(n, p)).add_(deltas[n])
        if zero is not None and not stored:
            zero.gather_params(state.params)
        mark(events, "update")

        out = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        out["loss"] = torch.stack(losses).mean()
        if zero is not None:
            out = dict(zip(out, zero.average(list(out.values()))))
        out["grad_norm"] = gnorm
        state.step += 1
        return state, out

    return step
