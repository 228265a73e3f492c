"""Megatron's f and g over the mesh's ``tensor`` axis, and the cut and
gather of a split leaf.

Where JAX's XLA derives the collectives of a megatron-split transformer
block from the ``TP_RULES`` specs (``parallel/mesh.py``), the port's
modules call them (``models/layers.py``):

* ``copy_to_tensor`` (f): the identity forward, an all-reduce of the
  gradient backward; it stands before a column-parallel projection, whose
  input every tensor rank holds whole;
* ``reduce_from_tensor`` (g): an all-reduce forward, the identity
  backward; it joins the partial outputs of a row-parallel projection.

A group of one (or None) makes both the identity, so one code path runs
at every tensor size.  ``TPSplit`` (``parallel/mesh.py``) says how a leaf
is split and cuts a whole leaf to a rank's slice; ``gather_rows`` +
``join_leaf`` put the slices back together.

The fsdp axis under ``tpu.shard_params`` (``parallel/zero.py``): a rank
stores only its chunk of a large leaf, a contiguous run of the leaf's
memory order (of its megatron slice on a tensor axis), and the UNet
gathers a unit's chunks just before the unit runs (``gather_chunks``:
an all-gather of the bucket's chunks, joined, then each leaf copied out
in its own layout).  Its backward (``_GatherChunks``) reduce-scatters
the whole leaves' gradients, in the accumulator dtype, into the rank's
chunks: XLA's all-gather of a sharded weight where it is used, and the
reduce-scatter of its gradient.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sdxl_training_improvements_tpu_torch.ops.fused_adamw import memory_order


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` itself forward; its gradient summed over ``group``."""
    if group_size(group) == 1:
        return x
    return _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """g: ``x`` summed over ``group``; the gradient passes unchanged."""
    if group_size(group) == 1:
        return x
    return _ReduceFromTensor.apply(x, group)


def row_parallel(linear: torch.nn.Linear, x: torch.Tensor, group
                 ) -> torch.Tensor:
    """A row-parallel projection: this rank's input columns times its
    weight slice, summed over ``group``, and the (whole) bias added once
    after the sum.  Over a group of one the module's own call, which adds
    the bias in its product (and keeps a LoRA adapter's forward)."""
    if group_size(group) == 1:
        return linear(x)
    out = reduce_from_tensor(F.linear(x, linear.weight), group)
    return out if linear.bias is None else out + linear.bias


def gather_rows(flat: torch.Tensor, group) -> torch.Tensor:
    """[size, n]: every rank of ``group``'s 1-D ``flat``, by rank."""
    rows = torch.empty((group_size(group), flat.numel()), dtype=flat.dtype,
                       device=flat.device)
    dist.all_gather_into_tensor(rows.view(-1), flat.contiguous(),
                                group=group)
    return rows


def join_leaf(split, rows: torch.Tensor, how: str = "param"
              ) -> torch.Tensor:
    """The whole leaf of every tensor rank's slice, ``rows[r]`` rank r's
    in its memory order: laid out as the parameter (``how`` "param") or
    contiguous in the JAX layout ("jax")."""
    if how == "jax":
        whole = torch.empty(split._layout("jax")[0], dtype=rows.dtype,
                            device=rows.device)
    else:
        whole = torch.empty_strided(split.like.shape, split.like.stride(),
                                    dtype=rows.dtype, device=rows.device)
    for r in range(rows.shape[0]):
        split.place(whole, rows[r], r, how)
    return whole


def _dense_like(like: torch.Tensor, dtype, device) -> torch.Tensor:
    return torch.empty_strided(like.shape, like.stride(), dtype=dtype,
                               device=device)


def gather_chunks(chunks: Sequence[torch.Tensor],
                  likes: Sequence[torch.Tensor], group
                  ) -> Tuple[torch.Tensor, ...]:
    """Each leaf whole (``likes[i]``'s shape and strides) from every rank's
    1-D chunk of its memory order, ``chunks[i]`` this rank's: one
    all-gather over ``group`` for the bucket.  A bucket of one leaf is a
    view of the gathered buffer; more leaves are copied out of it."""
    n = group_size(group)
    mine = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    rows = torch.empty((n, mine.numel()), dtype=mine.dtype,
                       device=mine.device)
    dist.all_gather_into_tensor(rows.view(-1), mine.contiguous(),
                                group=group)
    if len(chunks) == 1:
        from sdxl_training_improvements_tpu_torch.training.optimizers \
            .adamw_bf16 import from_memory_order
        return (from_memory_order(rows.view(-1), likes[0]),)
    out, off = [], 0
    for c, like in zip(chunks, likes):
        whole = _dense_like(like, mine.dtype, mine.device)
        memory_order(whole).view(n, c.numel()).copy_(
            rows[:, off:off + c.numel()])
        out.append(whole)
        off += c.numel()
    return tuple(out)


def scatter_grads(grads: Sequence[Optional[torch.Tensor]],
                  likes: Sequence[torch.Tensor], sizes: Sequence[int],
                  group, dtype: torch.dtype) -> torch.Tensor:
    """This rank's chunks of the sum over ``group`` of the whole leaves'
    gradients ``grads`` (any strides; None: zeros), joined [sum of
    ``sizes``] in ``dtype``: one reduce-scatter for the bucket."""
    n = group_size(group)
    ref = next(g for g in grads if g is not None)
    rows = torch.empty((n, sum(sizes)), dtype=dtype, device=ref.device)
    off = 0
    for g, like, c in zip(grads, likes, sizes):
        dst = rows[:, off:off + c]
        if g is None:
            dst.zero_()
        else:
            if g.stride() != like.stride():
                g = _dense_like(like, g.dtype, g.device).copy_(g)
            dst.copy_(memory_order(g).view(n, c))
        off += c
    mine = torch.empty(sum(sizes), dtype=dtype, device=ref.device)
    dist.reduce_scatter_tensor(mine, rows.view(-1), group=group)
    return mine


class _GatherChunks(torch.autograd.Function):
    """``bucket``: ``likes``, ``sizes``, ``group``, ``grad_dtype()`` (the
    reduce-scatter's dtype) and ``deliver(mine)`` (what becomes of this
    rank's reduced chunks: the chunks' gradients, or None each when it
    keeps them itself)."""

    @staticmethod
    def forward(ctx, bucket, *chunks):
        ctx.bucket = bucket
        return gather_chunks(chunks, bucket.likes, bucket.group)

    @staticmethod
    def backward(ctx, *grads):
        b = ctx.bucket
        mine = scatter_grads(grads, b.likes, b.sizes, b.group,
                             b.grad_dtype())
        return (None,) + tuple(b.deliver(mine))


def gather_for_use(bucket, chunks: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
    """The bucket's leaves whole; differentiable when a gradient is being
    recorded for a chunk (the backward reduce-scatters, ``_GatherChunks``)."""
    if torch.is_grad_enabled() and any(c.requires_grad for c in chunks):
        return _GatherChunks.apply(bucket, *chunks)
    with torch.no_grad():
        return gather_chunks(chunks, bucket.likes, bucket.group)


class drop_saved_wholes(torch.autograd.graph.saved_tensors_hooks):
    """Within the block, a tensor that autograd saves and that lies in the
    storage of one of ``wholes`` (name -> a gathered leaf) is kept as its
    name and view, not as the tensor; the backward asks ``regather(name)``
    for the leaf again when it unpacks it.  So a unit run without remat
    holds no gathered weight between its forward and its backward."""

    def __init__(self, wholes, regather: Callable[[str], torch.Tensor]):
        where = {t.untyped_storage().data_ptr(): n
                 for n, t in wholes.items()}

        def pack(t):
            name = where.get(t.untyped_storage().data_ptr())
            if name is None:
                return t.detach()
            return name, t.shape, t.stride(), t.storage_offset()

        def unpack(x):
            if isinstance(x, torch.Tensor):
                return x
            name, shape, stride, offset = x
            return regather(name).as_strided(shape, stride, offset)
        super().__init__(pack, unpack)


def maybe_group(mesh) -> Optional[object]:
    """The mesh's tensor group, or None when the tensor axis is 1."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    if mesh is None or M.axis_sizes(mesh)[M.TENSOR_AXIS] == 1:
        return None
    return mesh.get_group(M.TENSOR_AXIS)
