"""Process bring-up, the (data, fsdp, tensor) mesh and its sharding rules.

Port of ``sdxl_training_improvements_tpu/parallel/mesh.py``.  A card runs
one process, one rank.  ``initialize_multihost`` joins the ranks through
``torch.distributed``: NCCL carries the collectives on the cards (gloo
when the caller trains on the CPU), and a second, gloo group carries the
small host values (barriers, the input-integrity exchange, the validation
loss).  The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks with JAX's fixed axis names; the sharding rules are JAX's, as
plain functions of a leaf's flax path and flax shape, a spec being a
tuple of axis names (JAX's ``PartitionSpec`` as a tuple).

Where JAX's XLA inserts the collectives from these specs, the port's
train step calls them itself (``parallel/zero.py``), and its transformer
blocks call megatron's f and g over the ``tensor`` axis
(``parallel/tensor.py``, ``models/layers.py``).  ``tp_plan`` says how
each leaf is split there (``TPSplit``): ``TP_RULES`` with two
differences that change placement, not results.  An attention is split
only when its head count divides by the tensor size (each rank runs
whole heads), else every tensor rank keeps it whole; the GEGLU's value
and gate halves are split each on its own (megatron's layout: a rank's
slice is [value_r | gate_r], so no realignment before the gate), where
JAX cuts the fused [value | gate] columns contiguously.  Checkpoints
keep the one-card layout.
"""
from __future__ import annotations

import datetime
import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)

Spec = Tuple[Optional[str], ...]

# the host-side barrier waits this long for the last rank: precompute and
# the kernels' first builds can skew the ranks by minutes, and JAX's
# coordination-service barrier waits 30 minutes (``mesh.py:60``)
BARRIER_TIMEOUT_S = 1800

_HOST_GROUP = None
_BARRIER_SEQ = 0


def cluster_env() -> Optional[Dict[str, object]]:
    """The cluster the environment names, or None (one process).

    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``
    / ``MASTER_PORT``, or JAX's triple ``COORDINATOR_ADDRESS``
    (``host:port``), ``SDXL_NUM_PROCESSES`` and ``SDXL_PROCESS_ID``
    (``tests/mp_worker.py``), ``LOCAL_RANK`` defaulting to the rank (one
    host)."""
    env = os.environ
    if env.get("WORLD_SIZE") is not None and env.get("RANK") is not None:
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT")
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif env.get("COORDINATOR_ADDRESS") or env.get(
            "JAX_COORDINATOR_ADDRESS"):
        coord = env.get("COORDINATOR_ADDRESS") or env[
            "JAX_COORDINATOR_ADDRESS"]
        if env.get("SDXL_NUM_PROCESSES") is None or env.get(
                "SDXL_PROCESS_ID") is None:
            raise RuntimeError(
                f"COORDINATOR_ADDRESS={coord!r} names a cluster but "
                "SDXL_NUM_PROCESSES / SDXL_PROCESS_ID are not both set")
        addr, _, port = coord.rpartition(":")
        world = int(env["SDXL_NUM_PROCESSES"])
        rank = int(env["SDXL_PROCESS_ID"])
    else:
        return None
    if not port:
        raise RuntimeError("the cluster's environment names no port "
                           "(MASTER_PORT, or COORDINATOR_ADDRESS host:port)")
    local = int(env.get("LOCAL_RANK", rank))
    return {"addr": addr or "localhost", "port": int(port), "world": world,
            "rank": rank, "local_rank": local}


def initialize_multihost(device_type: str = "cuda") -> None:
    """Join the cluster the environment names; a no-op without one, or
    when this process has joined already (a second trainer).

    ``device_type`` "cuda": NCCL, after ``torch.cuda.set_device(
    LOCAL_RANK)``; "cpu": gloo.  Every failure once a cluster is named
    raises: a rank that trained alone would diverge from the others."""
    global _HOST_GROUP
    env = cluster_env()
    if env is None or dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cluster is named and the device is "
                               "'cuda', but torch.cuda.is_available() is "
                               "False")
        torch.cuda.set_device(env["local_rank"])
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no collective backend for device {device_type!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{env['addr']}:{env['port']}",
        world_size=env["world"], rank=env["rank"],
        timeout=datetime.timedelta(seconds=BARRIER_TIMEOUT_S))
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo"))


def host_group():
    """The gloo group of all ranks for host values (None: one process)."""
    return _HOST_GROUP if dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    env = cluster_env()
    return 0 if env is None else env["local_rank"]


def barrier(name: str, timeout_s: int = BARRIER_TIMEOUT_S) -> None:
    """Host-side barrier of all ranks (no-op in one process), with a long
    explicit timeout; a rank that does not arrive is named in the error
    (``monitored_barrier``), as JAX's coordination-service barrier names
    the laggard.  ``name`` goes into the error's message."""
    global _BARRIER_SEQ
    if process_count() <= 1:
        return
    _BARRIER_SEQ += 1
    try:
        dist.monitored_barrier(
            group=host_group(), wait_all_ranks=True,
            timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name}-{_BARRIER_SEQ}: {e}") from e


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = AXIS_NAMES,
                device_type: Optional[str] = None, world: Optional[int] = None):
    """The (data, fsdp, tensor) mesh over the ranks, rank r at
    ``unravel(r, mesh_shape)`` (JAX's reshape of the device list).

    Default: every rank on ``data``.  Raises JAX's ``ValueError``s for
    other axis names and for a shape that does not cover the world
    (``world``: the ranks, by default the process group's), before any
    process group is touched."""
    if tuple(axis_names) != AXIS_NAMES:
        raise ValueError(
            f"mesh axis names must be {list(AXIS_NAMES)} (fixed semantic "
            f"roles: data-parallel, ZeRO, megatron), got {list(axis_names)}")
    n = process_count() if world is None else world
    if mesh_shape is None:
        mesh_shape = [n] + [1] * (len(axis_names) - 1)
    if int(math.prod(mesh_shape)) != n:
        raise ValueError(f"mesh_shape {list(mesh_shape)} does not cover {n} "
                         "devices")
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, torch.arange(n).reshape(
        tuple(mesh_shape)), mesh_dim_names=AXIS_NAMES)


def mesh_from_config(config, device_type: Optional[str] = None):
    return create_mesh(config.tpu.mesh_shape, tuple(config.tpu.axis_names),
                       device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a mapping given as
    one (JAX's ``mesh.shape``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def batch_index(mesh) -> Tuple[int, int]:
    """(this rank's block of the batch, the blocks): JAX's
    ``P((data, fsdp))`` cuts each micro-batch into data x fsdp contiguous
    blocks in row-major order of the two coordinates."""
    sizes = axis_sizes(mesh)
    data, fsdp = (mesh.get_local_rank(DATA_AXIS),
                  mesh.get_local_rank(FSDP_AXIS))
    return data * sizes[FSDP_AXIS] + fsdp, sizes[DATA_AXIS] * sizes[FSDP_AXIS]


# --------------------------------------------------------------------------
# Sharding rules (JAX ``mesh.py:125-217``, copied)
# --------------------------------------------------------------------------

# Params smaller than this stay replicated: sharding biases and norm scales
# saves ~nothing and costs a collective each; 2^16 elements ~= the largest
# SDXL bias (10240) x6.
FSDP_MIN_SIZE = 1 << 16


def _fsdp_dim_for(shape, fsdp_size: int, exclude: Optional[int] = None,
                  min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """Largest divisible dim of a *large, >=2-D* param to ZeRO-shard over
    the fsdp axis, or None to replicate.  ``exclude`` skips a dim already
    taken by tensor parallelism."""
    if len(shape) < 2 or int(math.prod(shape)) < min_size:
        return None
    candidates = [(d, i) for i, d in enumerate(shape)
                  if i != exclude and d % fsdp_size == 0 and d >= fsdp_size]
    if not candidates:
        return None
    _, idx = max(candidates)
    return idx


def _fsdp_spec_for(path_leaf_shape, fsdp_size: int,
                   min_size: int = FSDP_MIN_SIZE) -> Spec:
    """Pure-ZeRO spec for one param (no TP dim in play)."""
    idx = _fsdp_dim_for(path_leaf_shape, fsdp_size, min_size=min_size)
    if idx is None:
        return ()
    spec = [None] * len(path_leaf_shape)
    spec[idx] = FSDP_AXIS
    return tuple(spec)


# megatron column/row over the ``tensor`` axis: column-parallel (output dim
# split: qkv, the GEGLU proj) then row-parallel (input dim split: to_out,
# ff net_2).  JAX splits the fused [value|gate] GEGLU output contiguously
# and realigns it before the gate (JAX ``mesh.py:174-181``); the port's
# ``tp_plan`` splits the two halves each on its own.
TP_RULES = (
    (re.compile(r"attn\d/to_[qkv]/kernel$"), 1),      # column: out dim
    (re.compile(r"attn\d/to_out_0/kernel$"), 0),      # row: in dim
    (re.compile(r"ff/net_0/proj/kernel$"), 1),        # column (GEGLU)
    (re.compile(r"ff/net_0/proj/bias$"), 0),          # bias of column layer
    (re.compile(r"ff/net_2/kernel$"), 0),             # row: in dim
)


def _tp_dim_for(path: str, shape, tensor_size: int) -> Optional[int]:
    if tensor_size <= 1:
        return None
    for pat, dim in TP_RULES:
        if pat.search(path) and len(shape) > dim \
                and shape[dim] % tensor_size == 0:
            return dim
    return None


def spec_for_param(path: str, shape, mesh, shard_params: bool = False
                   ) -> Spec:
    """Combined TP + ZeRO spec for one param at its flax ``path`` ("/"
    joined) and flax ``shape``: the tensor axis takes its megatron dim,
    then fsdp the largest remaining divisible dim of large >=2-D tensors.
    ``mesh``: a ``DeviceMesh`` or {axis: size}."""
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    tp_dim = _tp_dim_for(path, shape, sizes[TENSOR_AXIS])
    if tp_dim is not None:
        spec[tp_dim] = TENSOR_AXIS
    fsdp_size = sizes[FSDP_AXIS]
    if shard_params and fsdp_size > 1:
        idx = _fsdp_dim_for(shape, fsdp_size, exclude=tp_dim)
        if idx is not None:
            spec[idx] = FSDP_AXIS
    return tuple(spec)


def port_spec(name: str, tensor: torch.Tensor, mesh,
              shard_params: bool = False) -> Spec:
    """``spec_for_param`` of the port's parameter ``name``, through its
    flax path and flax shape (``models/weights.py``)."""
    from sdxl_training_improvements_tpu_torch.models.weights import (
        flax_path, jax_shape)
    path = "/".join(flax_path(name, tensor.dim()))
    return spec_for_param(path, jax_shape(name, tensor.shape), mesh,
                          shard_params=shard_params)


# --------------------------------------------------------------------------
# The tensor axis: which leaves split, and how a slice maps to its leaf
# --------------------------------------------------------------------------

_ATTN = re.compile(r"^(.*\.attn\d)\.")


def _dense_strides(shape, order) -> Tuple[int, ...]:
    """Contiguous strides for ``shape`` with the dims in ``order``
    (outermost first)."""
    strides = [0] * len(shape)
    acc = 1
    for d in reversed(order):
        strides[d] = acc
        acc *= shape[d]
    return tuple(strides)


@dataclass(frozen=True)
class TPSplit:
    """One leaf split over the tensor axis: rank ``rank`` of ``size``
    holds the part of dim ``dim`` (the torch dim; ``jax_dim`` in the JAX
    layout) that megatron gives it, a dense tensor whose dims lie in
    memory in the whole leaf's order.  ``glu``: the dim is the GEGLU's
    [value | gate] and the rank holds [value_r | gate_r].  ``like``: the
    whole leaf (a meta tensor: shape, strides, dtype).

    ``how`` picks the layout a method works in: "param" the parameter's
    own, "jax" the contiguous JAX layout (SOAP's first moment)."""
    dim: int
    jax_dim: int
    size: int
    rank: int
    glu: bool
    like: torch.Tensor

    def _layout(self, how: str):
        """(whole shape, dim order outermost first, split dim)."""
        if how == "jax":
            shape = self.like.shape
            jshape = (tuple(shape[::-1]) if len(shape) == 2
                      else tuple(shape))
            return jshape, list(range(len(jshape))), self.jax_dim
        order = sorted(range(self.like.dim()),
                       key=lambda d: -self.like.stride(d))
        return tuple(self.like.shape), order, self.dim

    def parts(self, rank: Optional[int] = None, how: str = "param"
              ) -> List[Tuple[int, int]]:
        """(start, length) along the split dim of the rank's pieces, in
        the order the slice holds them."""
        r = self.rank if rank is None else rank
        shape, _, dim = self._layout(how)
        whole = shape[dim]
        if self.glu:
            half = whole // 2
            h = half // self.size
            return [(r * h, h), (half + r * h, h)]
        n = whole // self.size
        return [(r * n, n)]

    def local_shape(self, how: str = "param") -> Tuple[int, ...]:
        shape, _, dim = self._layout(how)
        out = list(shape)
        out[dim] = sum(n for _, n in self.parts(how=how))
        return tuple(out)

    def empty_local(self, dtype=None, device=None, how: str = "param"
                    ) -> torch.Tensor:
        """An empty slice, dense, its dims in the whole leaf's order."""
        shape = self.local_shape(how)
        order = self._layout(how)[1]
        return torch.empty_strided(
            shape, _dense_strides(shape, order),
            dtype=self.like.dtype if dtype is None else dtype,
            device=device)

    def _views(self, whole: torch.Tensor, local: torch.Tensor, rank: int,
               how: str):
        dim = self._layout(how)[2]
        at = 0
        for start, n in self.parts(rank, how):
            yield whole.narrow(dim, start, n), local.narrow(dim, at, n)
            at += n

    def cut(self, whole: torch.Tensor, how: str = "param",
            rank: Optional[int] = None) -> torch.Tensor:
        """A copy of the rank's slice of ``whole`` (in layout ``how``)."""
        r = self.rank if rank is None else rank
        local = self.empty_local(whole.dtype, whole.device, how)
        with torch.no_grad():
            for src, dst in self._views(whole, local, r, how):
                dst.copy_(src)
        return local

    def place(self, whole: torch.Tensor, flat: torch.Tensor, rank: int,
              how: str = "param") -> None:
        """Write rank ``rank``'s slice, given 1-D in its memory order,
        into ``whole``."""
        from sdxl_training_improvements_tpu_torch.ops.fused_adamw import (
            memory_order)
        local = self.empty_local(flat.dtype, flat.device, how)
        memory_order(local).copy_(flat)
        with torch.no_grad():
            for dst, src in self._views(whole, local, rank, how):
                dst.copy_(src)

    def index_map(self, rank: Optional[int] = None):
        """The ``ops.fused_adamw.IndexMap`` from the slice's memory order
        to the whole leaf's (the parameter's layout): slice element i lies
        at ``off + (i // run) * stride + i % run`` (+ ``jump`` in the gate
        half of a GEGLU row)."""
        from sdxl_training_improvements_tpu_torch.ops.fused_adamw import (
            IndexMap)
        r = self.rank if rank is None else rank
        shape, order, dim = self._layout("param")
        inner = math.prod(shape[d] for d in order[order.index(dim) + 1:])
        (start, n), *gate = self.parts(r)
        run = sum(k for _, k in self.parts(r)) * inner
        jump = (gate[0][0] - start - n) * inner if gate else 0
        # the split dim outermost: one run (a contiguous slice unless it
        # holds a GEGLU's two halves)
        outer = order.index(dim) == 0
        return IndexMap(off=start * inner, run=run,
                        stride=run if outer else shape[dim] * inner,
                        half=n * inner if gate else run, jump=jump)


def _torch_dim(name: str, ndim: int, jax_dim: int) -> int:
    """The port's dim of JAX dim ``jax_dim`` (a Linear kernel is
    transposed)."""
    if name.endswith(".weight") and ndim == 2:
        return 1 - jax_dim
    return jax_dim


def tp_plan(params: Mapping[str, torch.Tensor], mesh,
            heads: Mapping[str, int], rank: Optional[int] = None
            ) -> Dict[str, TPSplit]:
    """The leaves of ``params`` (whole, name -> tensor) that split over
    the mesh's tensor axis, each with its ``TPSplit``.  ``heads``: each
    attention module's head count by name (``models/unet.py``
    ``attention_heads``); an attention whose heads do not divide by the
    tensor size stays whole, and so does a GEGLU / output pair whose
    inner width does not.  ``rank``: the tensor coordinate (default:
    this process's on ``mesh``)."""
    sizes = axis_sizes(mesh)
    t = sizes[TENSOR_AXIS]
    if t <= 1:
        return {}
    if rank is None:
        rank = mesh.get_local_rank(TENSOR_AXIS)
    from sdxl_training_improvements_tpu_torch.models.weights import (
        flax_path, jax_shape)
    plan: Dict[str, TPSplit] = {}
    for name, p in params.items():
        path = "/".join(flax_path(name, p.dim()))
        jdim = _tp_dim_for(path, jax_shape(name, p.shape), t)
        if jdim is None:
            continue
        glu = "/ff/net_0/proj/" in f"/{path}"
        attn = _ATTN.match(name)
        if attn is not None:
            if attn.group(1) not in heads:
                raise ValueError(f"{name}: no head count for "
                                 f"{attn.group(1)!r}")
            if heads[attn.group(1)] % t:
                continue
        elif "/ff/" in f"/{path}":
            width = (p.shape[_torch_dim(name, p.dim(), jdim)] // 2 if glu
                     else p.shape[_torch_dim(name, p.dim(), jdim)])
            if width % t:
                continue
        plan[name] = TPSplit(
            dim=_torch_dim(name, p.dim(), jdim), jax_dim=jdim, size=t,
            rank=rank, glu=glu,
            like=torch.empty_strided(p.shape, p.stride(), dtype=p.dtype,
                                     device="meta"))
    return plan


def dp_group(mesh):
    """The group of the ranks that share this rank's tensor coordinate
    (data x fsdp), or None (the default group) when the tensor axis is
    1.  The first call on a mesh makes one group per tensor coordinate,
    so every rank makes it."""
    sizes = axis_sizes(mesh)
    if sizes[TENSOR_AXIS] == 1:
        return None
    if getattr(mesh, "_sdxl_dp_group", None) is None:
        grid = mesh.mesh.reshape(-1, sizes[TENSOR_AXIS])
        mine = mesh.get_local_rank(TENSOR_AXIS)
        for t in range(sizes[TENSOR_AXIS]):
            g = dist.new_group([int(r) for r in grid[:, t]])
            if t == mine:
                mesh._sdxl_dp_group = g
    return mesh._sdxl_dp_group


def is_main_process() -> bool:
    """Rank-0 gate (JAX ``process_index() == 0``)."""
    return process_index() == 0


def get_world_size() -> int:
    """The ranks, one card each (JAX ``device_count``)."""
    return process_count()
