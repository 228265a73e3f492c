"""The fsdp chunk plan of the full-width SDXL UNet, on the host alone.

What one rank stores under ``tpu.shard_params`` at mesh [data, fsdp,
tensor] = [1, F, 1] (``parallel/zero.py`` ``store_params``), from the
parameters' shapes on the meta device (no weights, no card): the
parameters' and the fp32 gradient accumulator's GiB a rank, against the
whole leaves', the chunked leaves, the gather units and the largest
unit's gathered GiB, and the fsdp collectives a step under remat "full"
(one all-gather a unit bucket in the forward and one in the
recomputation, at most one a chunked leaf gathered again in the backward
of the units that run without remat, one reduce-scatter a bucket).  A
layer whose input needs no gradient saves no weight, so it gathers none
again: the time and add embeddings' first layers (92 all-gathers a step
at full width, 2 fewer than the bound).

    python tools/fsdp_plan.py [F ...]      # default: 2 4 8
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch  # noqa: E402

from sdxl_training_improvements_tpu_torch.models.unet import (  # noqa: E402
    SDXLUNet, UNetConfig)
from sdxl_training_improvements_tpu_torch.parallel import mesh as M  # noqa
from sdxl_training_improvements_tpu_torch.parallel.zero import (  # noqa
    BUCKET_BYTES)

GIB = 2 ** 30


def plan(fsdp: int, dtype=torch.bfloat16) -> dict:
    with torch.device("meta"):
        unet = SDXLUNet(UNetConfig.sdxl()).to(dtype)
    params = dict(unet.named_parameters())
    sizes = {M.DATA_AXIS: 1, M.FSDP_AXIS: fsdp, M.TENSOR_AXIS: 1}
    chunked = {n for n, p in params.items()
               if M.FSDP_AXIS in M.port_spec(n, p, sizes, True)}
    whole = sum(p.numel() for p in params.values())
    stored = sum(p.numel() // fsdp if n in chunked else p.numel()
                 for n, p in params.items())
    units, remat = [], []
    for name, module in unet.gather_units():
        mine = [f"{name}.{n}" for n, _ in module.named_parameters()]
        mine = [n for n in mine if n in chunked]
        if not mine:
            continue
        nbytes = [params[n].numel() * params[n].element_size() for n in mine]
        buckets, size = 1, 0
        for b in nbytes:
            if size and size + b > BUCKET_BYTES:
                buckets, size = buckets + 1, 0
            size += b
        units.append((name, sum(nbytes), buckets, len(mine)))
        remat.append(type(module).__name__ in ("ResnetBlock2D",
                                                 "Transformer2DModel"))
    elsize = torch.empty((), dtype=dtype).element_size()
    gathers = sum(b for (_, _, b, _), r in zip(units, remat)) + sum(
        b if r else n for (_, _, b, n), r in zip(units, remat))
    largest = max(units, key=lambda u: u[1])
    return dict(
        fsdp=fsdp, leaves=len(params), chunked_leaves=len(chunked),
        whole_param_gib=whole * elsize / GIB,
        param_gib=stored * elsize / GIB, grad_gib=stored * 4 / GIB,
        whole_grad_gib=whole * 4 / GIB, units=len(units),
        largest_unit=largest[0], largest_unit_gib=largest[1] / GIB,
        gathers_per_step_at_most=gathers,
        scatters_per_step=sum(u[2] for u in units))


if __name__ == "__main__":
    for f in [int(a) for a in sys.argv[1:]] or [2, 4, 8]:
        print(json.dumps(plan(f)))
