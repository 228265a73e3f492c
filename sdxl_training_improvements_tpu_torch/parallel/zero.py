"""Data parallelism, ZeRO and FSDP sharding and the megatron slices
over the mesh.

The collectives that XLA inserts into JAX's sharded step
(``sdxl_training_improvements_tpu/training/trainer.py:251-348``, from the
specs of ``parallel/mesh.py``), called by the port's step itself:

* a leaf split over the tensor axis (``mesh.tp_plan``: the transformer
  blocks' projections) is held as its megatron slice;
* a leaf that JAX shards over fsdp (``mesh.port_spec`` of its whole
  shape carries ``fsdp``: at least 2-D, at least 2^16 elements, a
  divisible dim) is cut into ``fsdp`` equal contiguous chunks of the
  memory order of what the rank holds (``ops/fused_adamw.py``
  ``memory_order``: the leaf, or its slice), and the rank at fsdp
  coordinate r keeps chunk r of its optimizer state and EMA shadow; a
  split leaf's optimizer state is its slice's;
* under ``tpu.shard_params`` with the UNet given (``store_params``, as
  ``training/trainer.py`` ``shard_train_state(unet=)`` calls it) the
  rank stores only that chunk of the parameter too, as JAX places it:
  each remat unit of the UNet (``models/unet.py`` ``gather_units``)
  all-gathers its chunks over fsdp just before it runs and drops them
  after (``run_unit``; in buckets of one dtype, at most ``BUCKET_BYTES``
  whole), and the gather's backward reduce-scatters the whole leaves'
  gradients, in the accumulator dtype, into the rank's chunks, which the
  step accumulates (``collecting``).  Under remat the recomputation
  gathers again; without it a saved whole weight is dropped and gathered
  again when the backward unpacks it (``parallel/tensor.py``
  ``drop_saved_wholes``).  Without the UNet (LoRA's pairs) the
  parameters stay whole and the chunks are gathered back after the
  update (``gather_params``);
* the gradients are reduced once a step over data x fsdp (every tensor
  rank of a group holds the same batch rows), in flat buckets of at
  most ``BUCKET_BYTES``: unchunked leaves by an all-reduce, chunked ones
  by a reduce-scatter over fsdp into the rank's chunk (per micro-batch
  in the gather's backward when the chunks are stored) and an all-reduce
  over data, each divided by data x fsdp (the mean over the global
  batch, as JAX's);
* the global norm counts each replicated leaf once and sums a split
  leaf's squares over the tensor group;
* the optimizer updates the rank's pieces (a split leaf's noise drawn at
  its elements' places in the whole leaf, through the slice's index
  map).

A piece of an optimizer tensor is the same part of the one-card tensor
(SOAP's first moment: of its contiguous JAX layout), so a save gathers
the one-card state, parameters included (``whole_params``), and a
restore cuts it again (``SHARDED_FIELDS``), for any mesh.  With
``tensor`` = 1 nothing splits and data x fsdp is every rank: the step is
the data and fsdp one.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from sdxl_training_improvements_tpu_torch.ops.fused_adamw import memory_order
from sdxl_training_improvements_tpu_torch.parallel import mesh as M
from sdxl_training_improvements_tpu_torch.parallel.tensor import (
    drop_saved_wholes, gather_chunks, gather_for_use, gather_rows,
    join_leaf)

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


class _UnitBucket:
    """Chunked leaves of one remat unit gathered by one collective (one
    dtype): ``names`` (in the UNet), ``local`` (in the unit), ``likes``
    (what the rank holds whole: the leaf or its slice), ``sizes`` (the
    chunks)."""

    def __init__(self, zero: "Zero", names, local):
        self.zero, self.names, self.local = zero, list(names), list(local)
        self.likes = [zero.like[n] for n in self.names]
        self.sizes = [zero.chunks[n].size for n in self.names]
        self.group = zero.fsdp_group

    def grad_dtype(self) -> torch.dtype:
        return self.zero.grad_dtype

    def deliver(self, mine: torch.Tensor):
        """The reduced chunks into the step's accumulator (``Zero.
        collecting``), or back through autograd in the parameters'
        dtype outside it."""
        z = self.zero
        z.scatters += 1
        pieces, off = [], 0
        for n, c in zip(self.names, self.sizes):
            pieces.append(mine[off:off + c])
            off += c
        if z.sink is None:
            return [p.to(z.like[n].dtype) for n, p in
                    zip(self.names, pieces)]
        for n, p in zip(self.names, pieces):
            if n in z.sink:
                z.sink[n].add_(p)
            else:
                z.sink[n] = p
        return [None] * len(pieces)


class Zero:
    """The layout of ``params`` (name -> tensor, every rank's copy: whole,
    or its megatron slice for the leaves of ``tp``) on ``mesh``: which
    leaves shard, and the step's collectives.  ``tp``: ``mesh.tp_plan``
    of the whole leaves (empty when nothing splits)."""

    # stored chunks (``store_params``): whether the parameters are, whether
    # the units gather (off while ``holding`` the gathered parameters),
    # the step's gradient accumulator and its dtype (``collecting``), the
    # fsdp collectives issued so far and the last step's accumulator bytes
    stored = False
    active = True
    sink: Optional[Dict[str, torch.Tensor]] = None
    grad_dtype = torch.float32
    gathers = scatters = grad_bytes = 0

    def __init__(self, mesh, params: Mapping[str, torch.Tensor],
                 shard_params: bool = False,
                 tp: Optional[Mapping[str, "M.TPSplit"]] = None):
        sizes = M.axis_sizes(mesh)
        self.data, self.fsdp = sizes[M.DATA_AXIS], sizes[M.FSDP_AXIS]
        self.tensor = sizes[M.TENSOR_AXIS]
        self.world = self.data * self.fsdp
        self.tp: Dict[str, M.TPSplit] = dict(tp or {})
        self.fsdp_group = mesh.get_group(M.FSDP_AXIS)
        self.data_group = mesh.get_group(M.DATA_AXIS)
        self.tensor_group = (mesh.get_group(M.TENSOR_AXIS)
                             if self.tensor > 1 else None)
        self.dp_group = M.dp_group(mesh)  # None: every rank (tensor 1)
        self._plan(params, sizes, mesh.get_local_rank(M.FSDP_AXIS),
                   shard_params)
        self.units: Dict[int, List[_UnitBucket]] = {}
        self.params: Dict[str, torch.Tensor] = {}

    def _plan(self, params, sizes, fsdp_rank: int, shard_params: bool):
        """``chunks``: each chunked leaf's chunk on this rank; ``like``:
        each chunked parameter's (local) shape and strides (meta
        tensors).  Whether a leaf chunks is JAX's spec of its whole
        shape."""
        self.chunks: Dict[str, Chunk] = {}
        self.like: Dict[str, torch.Tensor] = {}
        for name, p in params.items():
            whole = self.tp[name].like if name in self.tp else p
            if M.FSDP_AXIS in M.port_spec(name, whole, sizes, shard_params):
                c = p.numel() // sizes[M.FSDP_AXIS]
                self.chunks[name] = Chunk(fsdp_rank * c, c, p.numel())
                self.like[name] = torch.empty_strided(
                    p.shape, p.stride(), dtype=p.dtype, device="meta")

    @property
    def sharded(self) -> bool:
        """Whether any leaf is chunked or split."""
        return bool(self.chunks or self.tp)

    def holds_piece(self, name: str) -> bool:
        """Whether this rank holds a piece of ``name`` (a chunk, a slice,
        or a chunk of a slice) rather than the whole leaf."""
        return name in self.chunks or name in self.tp

    # ------------------------------------------------------ stored chunks
    def store_params(self, params: Mapping[str, torch.Tensor],
                     unet) -> None:
        """Keep only this rank's chunk of each chunked parameter of
        ``unet`` (``params``: its parameters by name): the parameter's
        data becomes a 1-D copy of the chunk and the rest of the leaf's
        storage is freed; ``unet.fsdp`` becomes this layout, so that each
        of its units (``unet.gather_units()``) gathers its chunks to run.
        Every chunked leaf must lie in a unit."""
        if self.stored:
            raise ValueError("the parameters are stored as chunks already")
        units = dict(unet.gather_units())
        owner = {}
        for prefix, module in units.items():
            for local, p in module.named_parameters():
                owner.setdefault(f"{prefix}.{local}", (prefix, local))
        missing = sorted(set(self.chunks) - set(owner))
        if missing:
            raise ValueError(f"chunked leaves outside every unit of the "
                             f"UNet: {missing[:3]}")
        by_unit: Dict[str, List[str]] = {}
        for n in self.chunks:
            by_unit.setdefault(owner[n][0], []).append(n)
        for prefix, names in by_unit.items():
            by_dtype: Dict[torch.dtype, List[str]] = {}
            for n in names:
                by_dtype.setdefault(self.like[n].dtype, []).append(n)
            buckets = []
            for same in by_dtype.values():
                for b in self._buckets(same, lambda n: self.chunks[n].numel
                                       * self.like[n].element_size()):
                    buckets.append(_UnitBucket(
                        self, b, [owner[n][1] for n in b]))
            self.units[id(units[prefix])] = buckets
        with torch.no_grad():
            for n in self.chunks:
                c = self.chunks[n]
                p = params[n]
                p.data = memory_order(p.data)[c.base:c.base + c.size].clone()
                self.params[n] = p
        self.stored = True
        unet.fsdp = self

    def unstore(self, params: Mapping[str, torch.Tensor], unet) -> None:
        """The inverse of ``store_params``: each stored chunk's parameter
        holds its leaf (its slice) again and ``unet`` gathers nothing (a
        collective)."""
        with torch.no_grad():
            for n in self.chunks:
                params[n].data = self.gather(n, params[n].data, whole=False)
        self.stored = False
        self.units, self.params = {}, {}
        unet.fsdp = None

    def param_pieces(self) -> List[str]:
        """The leaves whose stored parameter is a piece: the split ones,
        and the chunked ones when the chunks are stored."""
        return list(dict.fromkeys(
            [*self.tp, *(self.chunks if self.stored else ())]))

    def run_unit(self, module, *args, recomputed: bool = False):
        """``module(*args)`` with its chunked parameters gathered for the
        call (``module``: a unit of ``store_params``' UNet).
        ``recomputed``: the call runs under ``torch.utils.checkpoint``,
        whose recomputation gathers again; otherwise a gathered weight
        that autograd saves is dropped and gathered again in the backward
        (``drop_saved_wholes``)."""
        buckets = self.units.get(id(module)) if self.active else None
        if not buckets:
            return module(*args)
        wholes = {}
        for b in buckets:
            self.gathers += 1
            got = gather_for_use(b, [self.params[n] for n in b.names])
            wholes.update(zip(b.local, got))
        hooks = (contextlib.nullcontext() if recomputed
                 or not torch.is_grad_enabled()
                 else drop_saved_wholes(wholes, self._regather(buckets)))
        with hooks:
            return torch.func.functional_call(module, wholes, args)

    def _regather(self, buckets):
        """name in the unit -> its leaf gathered again (no gradient)."""
        where = {loc: n for b in buckets for n, loc in zip(b.names, b.local)}

        def regather(local: str) -> torch.Tensor:
            n = where[local]
            self.gathers += 1
            return gather_chunks([self.params[n].detach()], [self.like[n]],
                                 self.fsdp_group)[0]
        return regather

    @contextlib.contextmanager
    def collecting(self, dtype: torch.dtype, sink: Dict[str, torch.Tensor]):
        """Within the block the stored chunks' gradients are reduce-
        scattered over fsdp in ``dtype`` and added into ``sink`` (name ->
        this rank's chunk), not returned through autograd."""
        self.sink, self.grad_dtype = sink, dtype
        try:
            yield sink
        finally:
            self.sink, self.grad_dtype = None, torch.float32

    @contextlib.contextmanager
    def holding(self, params: Mapping[str, torch.Tensor],
                values: Mapping[str, torch.Tensor]):
        """Within the block each parameter named in ``values`` holds that
        tensor (a stored chunk's: its gathered leaf or slice) and the
        units gather nothing; the stored tensors come back after."""
        saved = {n: params[n].data for n in values
                 if values[n] is not params[n]}
        self.active = False
        try:
            for n in saved:
                params[n].data = values[n]
            yield
        finally:
            for n, d in saved.items():
                params[n].data = d
            self.active = True

    # ------------------------------------------------------------ views
    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of the parameter ``t`` (a view of its storage)
        when ``name`` chunks, else ``t``; a stored chunk is itself."""
        c = self.chunks.get(name)
        if c is None or self.stored:
            return t
        return memory_order(t)[c.base:c.base + c.size]

    def views(self, tensors: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return {n: self.view(n, t) for n, t in tensors.items()}

    def _local_like(self, name: str, how: str) -> torch.Tensor:
        """The meta tensor of what the rank holds of ``name`` before the
        chunk: the parameter's layout, or ("jax") its contiguous JAX
        layout."""
        like = (self.like[name] if name in self.like
                else self.tp[name].empty_local(device="meta"))
        if how == "jax":
            from sdxl_training_improvements_tpu_torch.training.optimizers \
                .soap import to_jax_layout
            return torch.empty(to_jax_layout(like).shape, dtype=like.dtype,
                               device="meta")
        return like

    def chunk_of(self, name: str, full: torch.Tensor,
                 how: str = "param") -> torch.Tensor:
        """A copy of this rank's piece of the one-card tensor ``full`` (of
        the parameter's whole shape, in any strides; "jax": SOAP's JAX
        layout, read contiguously): its megatron slice, then its chunk."""
        split = self.tp.get(name)
        if split is not None:
            full = split.cut(full.contiguous() if how == "jax" else full,
                             how)
        c = self.chunks.get(name)
        if c is None:
            return full if split is not None else full.clone()
        if how == "jax":
            flat = full.reshape(-1)
        else:
            like = self._local_like(name, how)
            flat = memory_order(torch.empty_strided(
                like.shape, like.stride(), dtype=full.dtype,
                device=full.device).copy_(full))
        return flat[c.base:c.base + c.size].clone()

    def gather(self, name: str, piece: torch.Tensor,
               how: str = "param", whole: bool = True) -> torch.Tensor:
        """The one-card tensor of every rank's piece, laid out as the
        one-card tensor (the parameter's shape and strides; "jax":
        contiguous in the parameter's JAX layout); ``whole`` False stops
        at the rank's slice (the chunks gathered over fsdp only).  A
        collective of the fsdp and tensor groups."""
        out = piece
        if name in self.chunks:
            flat = self._gather_flat(name, piece.contiguous())
            like = self._local_like(name, how)
            if how == "jax":
                out = flat.view(like.shape)
            else:
                from sdxl_training_improvements_tpu_torch.training \
                    .optimizers.adamw_bf16 import from_memory_order
                out = from_memory_order(flat, like)
        split = self.tp.get(name)
        if not whole or split is None:
            return out
        return self._gather_slices(split, out, how)

    def _gather_slices(self, split, local: torch.Tensor, how: str
                       ) -> torch.Tensor:
        """The whole leaf of the tensor group's slices."""
        flat = memory_order(local.contiguous() if how == "jax" else local)
        return join_leaf(split, self._gather_tensor_rows(flat), how)

    def _gather_tensor_rows(self, flat: torch.Tensor) -> torch.Tensor:
        """[tensor, n]: every tensor rank's 1-D ``flat``, by rank."""
        return gather_rows(flat, self.tensor_group)

    def _gather_flat(self, name: str, chunk: torch.Tensor) -> torch.Tensor:
        """The chunks of ``name`` over fsdp, joined (1-D)."""
        flat = torch.empty(self.chunks[name].numel, dtype=chunk.dtype,
                           device=chunk.device)
        dist.all_gather_into_tensor(flat, chunk, group=self.fsdp_group)
        return flat

    def gather_tensors(self, tensors: Mapping[str, torch.Tensor],
                       whole: bool = True) -> Dict[str, torch.Tensor]:
        """Each sharded entry of ``tensors`` (a piece) gathered whole (or,
        ``whole`` False, to the rank's slice)."""
        return {n: (self.gather(n, t, whole=whole) if self.holds_piece(n)
                    else t) for n, t in tensors.items()}

    def whole_params(self, params: Mapping[str, torch.Tensor],
                     whole: bool = True, chunked: Optional[bool] = None
                     ) -> Dict[str, torch.Tensor]:
        """The one-card parameters (``whole`` False: the rank's slices, as
        a placed UNet holds them) of what the rank holds: the chunked
        leaves' chunks gathered over fsdp (``chunked``: whether they are
        given as chunks; default: whether the chunks are stored), the
        split leaves' slices over the tensor group, the others as they
        are (a collective)."""
        chunked = self.stored if chunked is None else chunked
        out = {}
        for n, p in params.items():
            if chunked and n in self.chunks:
                p = self.gather(n, p.detach(), whole=whole)
            elif whole and n in self.tp:
                p = self._gather_slices(self.tp[n], p.detach(), "param")
            out[n] = p
        return out

    def max_over_shards(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x`` (a piece's statistic) reduced by MAX over the ranks that
        hold the other pieces of ``name``'s leaf, in place."""
        if name in self.chunks:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.fsdp_group)
        if name in self.tp:
            dist.all_reduce(x, op=dist.ReduceOp.MAX,
                            group=self.tensor_group)
        return x

    def absmax_reduce(self, name: str):
        """The int8 moments' absmax reduction of a piece of ``name``."""
        return lambda x: self.max_over_shards(x, name)

    def noise_map(self, name: str):
        """(the whole leaf's elements, the piece's first element in what
        the rank holds, the slice's ``IndexMap`` or None): where the noise
        of this rank's piece of ``name`` lies in the whole leaf's."""
        c = self.chunks.get(name)
        base = c.base if c is not None else 0
        split = self.tp.get(name)
        if split is None:
            return c.numel, base, None
        return split.like.numel(), base, split.index_map()

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
        """The mean over data x fsdp of the gradients: unchunked leaves
        (in place), chunks of chunked ones (views of a reduce-scatter's
        output; with stored chunks the gradients are the chunks, summed
        over fsdp already in the gather's backward, and are summed over
        data in place).  Every gradient must have one dtype."""
        names = list(grads)
        rep = [n for n in names if n not in self.chunks]
        shd = [n for n in names if n in self.chunks]
        out = dict(grads)
        size = next(iter(grads.values())).element_size() if grads else 0
        nbytes = lambda n: grads[n].numel() * size  # noqa: E731
        for bucket in self._buckets(rep, nbytes):
            self._all_reduce_mean(grads, bucket, self.dp_group)
        if self.stored:
            for bucket in self._buckets(shd if self.data > 1 else [],
                                        nbytes):
                self._all_reduce_mean(grads, bucket, self.data_group)
            if self.data == 1:
                for n in shd:
                    grads[n].div_(self.world)
            return out
        for bucket in self._buckets(shd, nbytes):
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

    def _all_reduce_mean(self, grads, bucket: Sequence[str], group
                         ) -> None:
        """``grads[n]`` for n in ``bucket`` summed over ``group`` and
        divided by data x fsdp, in place."""
        flat = torch.cat([memory_order(grads[n]) for n in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(self.world)
        off = 0
        for n in bucket:
            k = grads[n].numel()
            memory_order(grads[n]).copy_(flat[off:off + k])
            off += k

    def norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the reduced gradients: the replicated
        leaves' squares summed as ``trainer.global_norm`` sums them, the
        chunks' squares summed over fsdp, a split leaf's over the tensor
        group."""
        def squares(chunked: bool, split: bool):
            return sum(g.float().square().sum() for n, g in grads.items()
                       if (n in self.chunks) == chunked
                       and (n in self.tp) == split)

        def over_fsdp(part):
            dist.all_reduce(part, group=self.fsdp_group)
            return part
        sq = squares(False, False)
        if any(n in self.chunks and n not in self.tp for n in grads):
            sq = sq + over_fsdp(squares(True, False))
        if any(n in self.tp for n in grads):
            part = squares(False, True)
            if any(n in self.tp and n in self.chunks for n in grads):
                part = part + over_fsdp(squares(True, True))
            part = torch.as_tensor(part, dtype=torch.float32,
                                   device=next(iter(grads.values())).device)
            dist.all_reduce(part, group=self.tensor_group)
            sq = sq + part
        return torch.sqrt(sq)

    def gather_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """After the chunks' update, when the parameters are not stored as
        chunks (no UNet given: LoRA's pairs): every chunked parameter
        whole again on every rank of its fsdp group (a split leaf: its
        slice), in place (an all-gather over fsdp per bucket of one
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
        """The mean over data x fsdp of each 0-d value (one all-reduce;
        the tensor ranks of a group hold the same values)."""
        stacked = torch.stack([v.float() for v in values])
        dist.all_reduce(stacked, group=self.dp_group)
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
                if not self.holds_piece(n):
                    continue
                if isinstance(t, dict):
                    yield f"{prefix}.{f.name}.{n}.q", n, how, t, "q"
                else:
                    yield f"{prefix}.{f.name}.{n}", n, how, value, n

    def shard_state(self, opt) -> None:
        """Cut every sharded tensor of the one-card optimizer state
        ``opt`` to this rank's piece, in place."""
        for _, n, how, owner, k in list(self.state_fields(opt)):
            owner[k] = self.chunk_of(n, owner[k], how)
