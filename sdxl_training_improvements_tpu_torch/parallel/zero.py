"""Data parallelism and ZeRO sharding over the mesh's data and fsdp axes.

The collectives that XLA inserts into JAX's sharded step
(``sdxl_training_improvements_tpu/training/trainer.py:251-348``, from the
specs of ``parallel/mesh.py``), called by the port's step itself:

* every rank holds every parameter whole (JAX also shards the stored
  parameters under ``tpu.shard_params``; the port's step has no per-block
  gather, so the two differ in memory, not in results: ROADMAP item 14b);
* a leaf that JAX shards over fsdp (``mesh.port_spec`` carries ``fsdp``:
  at least 2-D, at least 2^16 elements, a divisible dim) is cut into
  ``fsdp`` equal contiguous chunks of its memory order
  (``ops/fused_adamw.py`` ``memory_order``), and the rank at fsdp
  coordinate r keeps chunk r of its optimizer state and EMA shadow; the
  ranks of one fsdp group along ``data`` hold the same chunk;
* the gradients are reduced once a step, in flat buckets of at most
  ``BUCKET_BYTES``: replicated leaves by an all-reduce over all ranks,
  sharded leaves by a reduce-scatter over fsdp into the rank's chunk and
  an all-reduce over data, each divided by the ranks (the mean over the
  global batch, as JAX's);
* the optimizer updates the rank's chunks and the replicated leaves; an
  all-gather over fsdp puts each sharded parameter back together.

The chunk of an optimizer tensor is the same slice of the one-card
tensor's memory order (SOAP's first moment: of its contiguous JAX layout),
so a save can gather the one-card state and a restore can cut it again
(``SHARDED_FIELDS``).  With ``tensor`` = 1, data x fsdp is every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from sdxl_training_improvements_tpu_torch.ops.fused_adamw import memory_order
from sdxl_training_improvements_tpu_torch.parallel import mesh as M

BUCKET_BYTES = 256 << 20

# the optimizer-state fields that hold a sharded leaf's chunk, and the
# one-card layout of each ("param": the parameter's shape and strides;
# "jax": SOAP's contiguous JAX-layout first moment); everything else
# (steps, decay phases, int8 scales, SOAP's second moment and factors)
# stays whole on every rank, as JAX places it (``trainer.py:283-345``)
SHARDED_FIELDS = {
    ("AdamWState", "mu"): "param", ("AdamWState", "nu"): "param",
    ("AdamWBF16State", "exp_avg"): "param",
    ("AdamWBF16State", "exp_avg_sq"): "param",
    ("AdamWBF16State", "shift"): "param",
    ("EMAState", "ema"): "param",
    ("ScheduleFreeKahanState", "exp_avg_sq"): "param",
    ("ScheduleFreeKahanState", "z"): "param",
    ("ScheduleFreeKahanState", "kahan_comp"): "param",
    ("SOAPState", "exp_avg"): "jax",
}


@dataclass(frozen=True)
class Chunk:
    """This rank's part of a sharded leaf: ``size`` elements from ``base``
    in the leaf's memory order, of ``numel``."""
    base: int
    size: int
    numel: int


def tensor_axis_refusal(mesh_shape) -> Optional[str]:
    """The refusal of a mesh with a tensor axis above 1, or None."""
    if mesh_shape is not None and len(mesh_shape) >= 3 and mesh_shape[2] > 1:
        return (f"tpu.mesh_shape {list(mesh_shape)}: a tensor axis above 1 "
                "(megatron splitting by TP_RULES) is not ported (ROADMAP "
                "queue 1, item 14b)")
    return None


class Zero:
    """The layout of ``params`` (name -> tensor, every rank's whole copy)
    on ``mesh``: which leaves shard, and the step's collectives."""

    def __init__(self, mesh, params: Mapping[str, torch.Tensor],
                 shard_params: bool = False):
        sizes = M.axis_sizes(mesh)
        refusal = tensor_axis_refusal(
            [sizes[a] for a in M.AXIS_NAMES])
        if refusal:
            raise NotImplementedError(refusal)
        self.data, self.fsdp = sizes[M.DATA_AXIS], sizes[M.FSDP_AXIS]
        self.world = self.data * self.fsdp
        self.fsdp_group = mesh.get_group(M.FSDP_AXIS)
        self.data_group = mesh.get_group(M.DATA_AXIS)
        self._plan(params, sizes, mesh.get_local_rank(M.FSDP_AXIS),
                   shard_params)

    def _plan(self, params, sizes, fsdp_rank: int, shard_params: bool):
        """``chunks``: each sharded leaf's chunk on this rank; ``like``:
        each sharded parameter's shape and strides (meta tensors)."""
        self.chunks: Dict[str, Chunk] = {}
        self.like: Dict[str, torch.Tensor] = {}
        for name, p in params.items():
            if M.FSDP_AXIS in M.port_spec(name, p, sizes, shard_params):
                c = p.numel() // sizes[M.FSDP_AXIS]
                self.chunks[name] = Chunk(fsdp_rank * c, c, p.numel())
                self.like[name] = torch.empty_strided(
                    p.shape, p.stride(), dtype=p.dtype, device="meta")

    # ------------------------------------------------------------ views
    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``t`` (a view of its storage) when ``name``
        shards, else ``t``."""
        c = self.chunks.get(name)
        if c is None:
            return t
        return memory_order(t)[c.base:c.base + c.size]

    def views(self, tensors: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return {n: self.view(n, t) for n, t in tensors.items()}

    def full_like(self, name: str, dtype, device) -> torch.Tensor:
        """An empty tensor laid out as the parameter ``name``."""
        like = self.like[name]
        return torch.empty_strided(like.shape, like.stride(), dtype=dtype,
                                   device=device)

    def chunk_of(self, name: str, full: torch.Tensor,
                 how: str = "param") -> torch.Tensor:
        """A copy of this rank's chunk of the one-card tensor ``full`` (of
        the parameter's shape, in any strides; "jax": SOAP's JAX layout,
        read contiguously)."""
        c = self.chunks[name]
        if how == "jax":
            flat = full.reshape(-1)
        else:
            flat = memory_order(self.full_like(name, full.dtype,
                                               full.device).copy_(full))
        return flat[c.base:c.base + c.size].clone()

    def gather(self, name: str, chunk: torch.Tensor,
               how: str = "param") -> torch.Tensor:
        """The whole tensor of the chunks over fsdp, laid out as the one-card
        tensor (the parameter's shape and strides; "jax": contiguous in
        the parameter's JAX layout).  A collective: every rank of the fsdp
        group calls it."""
        flat = self._gather_flat(name, chunk.contiguous())
        like = self.like[name]
        if how == "jax":
            from sdxl_training_improvements_tpu_torch.training.optimizers \
                .soap import to_jax_layout
            return flat.view(to_jax_layout(like).shape)
        from sdxl_training_improvements_tpu_torch.training.optimizers \
            .adamw_bf16 import from_memory_order
        return from_memory_order(flat, like)

    def _gather_flat(self, name: str, chunk: torch.Tensor) -> torch.Tensor:
        """The chunks of ``name`` over fsdp, joined (1-D)."""
        flat = torch.empty(self.chunks[name].numel, dtype=chunk.dtype,
                           device=chunk.device)
        dist.all_gather_into_tensor(flat, chunk, group=self.fsdp_group)
        return flat

    def gather_tensors(self, tensors: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Each sharded entry of ``tensors`` (a chunk) gathered whole."""
        return {n: (self.gather(n, t) if n in self.chunks else t)
                for n, t in tensors.items()}

    def max_over_shards(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a chunk's statistic) reduced by MAX over fsdp, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.fsdp_group)
        return x

    # ------------------------------------------------------------ step
    def _buckets(self, names: Sequence[str], nbytes) -> List[List[str]]:
        out: List[List[str]] = []
        cur: List[str] = []
        size = 0
        for n in names:
            b = nbytes(n)
            if cur and size + b > BUCKET_BYTES:
                out.append(cur)
                cur, size = [], 0
            cur.append(n)
            size += b
        if cur:
            out.append(cur)
        return out

    def reduce_gradients(self, grads: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """The mean of every rank's gradients: whole replicated leaves (in
        place), chunks of sharded ones (views of a reduce-scatter's
        output).  Every gradient must have one dtype."""
        names = list(grads)
        rep = [n for n in names if n not in self.chunks]
        shd = [n for n in names if n in self.chunks]
        out = dict(grads)
        size = next(iter(grads.values())).element_size() if grads else 0
        for bucket in self._buckets(rep, lambda n: grads[n].numel() * size):
            flat = torch.cat([memory_order(grads[n]) for n in bucket])
            dist.all_reduce(flat)
            flat.div_(self.world)
            off = 0
            for n in bucket:
                k = grads[n].numel()
                memory_order(grads[n]).copy_(flat[off:off + k])
                off += k
        for bucket in self._buckets(
                shd, lambda n: grads[n].numel() * size):
            total = sum(self.chunks[n].size for n in bucket)
            g0 = grads[bucket[0]]
            rows = torch.empty((self.fsdp, total), dtype=g0.dtype,
                               device=g0.device)
            off = 0
            for n in bucket:
                c = self.chunks[n].size
                rows[:, off:off + c].copy_(
                    memory_order(grads[n]).view(self.fsdp, c))
                off += c
            mine = torch.empty(total, dtype=g0.dtype, device=g0.device)
            dist.reduce_scatter_tensor(mine, rows.view(-1),
                                       group=self.fsdp_group)
            del rows
            if self.data > 1:
                dist.all_reduce(mine, group=self.data_group)
            mine.div_(self.world)
            off = 0
            for n in bucket:
                c = self.chunks[n].size
                out[n] = mine[off:off + c]
                off += c
        return out

    def norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the reduced gradients: the replicated leaves'
        squares summed as ``trainer.global_norm`` sums them, plus the
        chunks' squares summed over fsdp."""
        sq = sum(g.float().square().sum() for n, g in grads.items()
                 if n not in self.chunks)
        shd = [g for n, g in grads.items() if n in self.chunks]
        if shd:
            part = sum(g.float().square().sum() for g in shd)
            dist.all_reduce(part, group=self.fsdp_group)
            sq = sq + part
        return torch.sqrt(sq)

    def gather_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """After the chunks' update: every sharded parameter whole again on
        every rank, in place (an all-gather over fsdp per bucket of one
        dtype)."""
        shd = [n for n in params if n in self.chunks]
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for n in shd:
            by_dtype.setdefault(params[n].dtype, []).append(n)
        with torch.no_grad():
            for names in by_dtype.values():
                for bucket in self._buckets(
                        names, lambda n: params[n].numel()
                        * params[n].element_size()):
                    mine = torch.cat([self.view(n, params[n])
                                      for n in bucket])
                    rows = torch.empty(self.fsdp * mine.numel(),
                                       dtype=mine.dtype, device=mine.device)
                    dist.all_gather_into_tensor(rows, mine,
                                                group=self.fsdp_group)
                    rows = rows.view(self.fsdp, -1)
                    off = 0
                    for n in bucket:
                        c = self.chunks[n].size
                        memory_order(params[n]).view(self.fsdp, c).copy_(
                            rows[:, off:off + c])
                        off += c

    def average(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over all ranks of each 0-d value (one all-reduce)."""
        stacked = torch.stack([v.float() for v in values])
        dist.all_reduce(stacked)
        stacked = stacked / self.world
        return list(stacked.unbind())

    # ------------------------------------------------------------ state
    def state_fields(self, opt, prefix: str = "opt"):
        """Yield (key, name, how, owner dict, entry key) for each sharded
        tensor of the optimizer state ``opt`` (a dataclass, nested for
        EMA), the key as ``training/checkpoints.py`` names it; an int8
        moment's codes under ``.q``."""
        import dataclasses
        for f in dataclasses.fields(opt):
            value = getattr(opt, f.name)
            if dataclasses.is_dataclass(value):
                yield from self.state_fields(value, f"{prefix}.{f.name}")
                continue
            how = SHARDED_FIELDS.get((type(opt).__name__, f.name))
            if how is None or not isinstance(value, dict):
                continue
            for n, t in value.items():
                if n not in self.chunks:
                    continue
                if isinstance(t, dict):
                    yield f"{prefix}.{f.name}.{n}.q", n, how, t, "q"
                else:
                    yield f"{prefix}.{f.name}.{n}", n, how, value, n

    def shard_state(self, opt) -> None:
        """Cut every sharded tensor of the one-card optimizer state
        ``opt`` to this rank's chunk, in place."""
        for _, n, how, owner, k in list(self.state_fields(opt)):
            owner[k] = self.chunk_of(n, owner[k], how)
