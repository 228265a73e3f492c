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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


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


def maybe_group(mesh) -> Optional[object]:
    """The mesh's tensor group, or None when the tensor axis is 1."""
    from sdxl_training_improvements_tpu_torch.parallel import mesh as M
    if mesh is None or M.axis_sizes(mesh)[M.TENSOR_AXIS] == 1:
        return None
    return mesh.get_group(M.TENSOR_AXIS)
