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
train step calls them itself (``parallel/zero.py``).  The ``tensor`` axis
(megatron splitting by ``TP_RULES``) has its rules here but no step yet:
a mesh with a tensor axis above 1 is refused by the trainer (ROADMAP
queue 1, item 14b).
"""
from __future__ import annotations

import datetime
import math
import os
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

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
# ff net_2).  The fused [value|gate] GEGLU output split contiguously needs
# a realignment before the gate (JAX ``mesh.py:174-181``); item 14b.
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


def is_main_process() -> bool:
    """Rank-0 gate (JAX ``process_index() == 0``)."""
    return process_index() == 0


def get_world_size() -> int:
    """The ranks, one card each (JAX ``device_count``)."""
    return process_count()
