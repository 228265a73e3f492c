"""Host-memory offload: dicts of tensors to pinned host memory and back,
and the depth-2 pipeline that streams host-resident groups through the
card.

Port of ``sdxl_training_improvements_tpu/core/offload.py`` (``offload_to_
host``, ``fetch_to_device``, ``tree_bytes``) over dicts of tensors (a
value may be a dict of tensors itself: an int8 moment's codes and scale).
JAX expresses the offload as a memory kind of the array's sharding; here
a host tensor is a CPU tensor in page-locked memory when a card is
present (so that its copies to and from the card are asynchronous), and a
plain CPU tensor otherwise.

``stream_groups`` is the host-streamed optimizer update's pipeline (JAX
``adamw_bf16.update_per_leaf``'s optimization-barrier chain at depth 2):
for each group its inputs are copied to the card on a side stream, the
computation runs on the current stream, and its outputs are copied back
on the side stream.  The host enqueues group k+1's inputs before group
k's computation and group k's outputs after it, so the side stream runs
H2D(k+1) and D2H(k-1) while the current stream computes group k, and at
most two groups' device buffers are in flight.  Events order the
streams; ``record_stream`` keeps the caching allocator from reusing a
buffer before the other stream is done with it.  On the CPU the same
schedule runs with plain copies.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Mapping, Sequence

import torch

Tree = Mapping[str, object]


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def pinned_like(x: torch.Tensor) -> torch.Tensor:
    """An empty host tensor with x's shape, dtype and strides, page-locked
    when a card is present."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="cpu",
                               pin_memory=torch.cuda.is_available())


def to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of x (pinned when a card is present), with x's
    strides."""
    return pinned_like(x).copy_(x)


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A copy of x on ``device`` with x's strides, asynchronous from
    pinned memory."""
    return torch.empty_like(x, device=device).copy_(x, non_blocking=True)


def offload_to_host(tree: Tree) -> Dict[str, object]:
    """Every tensor of ``tree`` copied to host memory (pinned when a card
    is present)."""
    return _map(to_host, tree)


def fetch_to_device(tree: Tree, device) -> Dict[str, object]:
    """Every tensor of ``tree`` copied to ``device``, keeping its
    strides."""
    return _map(functools.partial(to_device, device=device), tree)


def tree_bytes(tree: Tree) -> int:
    """Bytes of every tensor of ``tree``."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


def stream_groups(groups: Sequence, fetch: Callable, compute: Callable,
                  store: Callable, device) -> None:
    """Run every group through the depth-2 pipeline of the module
    docstring.  ``fetch(group)`` returns the group's device inputs (a
    list of tensors, copied from the host with ``non_blocking``);
    ``compute(group, inputs)`` returns its device outputs (a list of
    tensors); ``store(group, outputs)`` copies them back to the host with
    ``non_blocking``.  On a card the last copies are still running when
    this returns: the host reads the stored tensors after
    ``torch.cuda.synchronize``, and the next call's copies follow them on
    the same side stream."""
    device = torch.device(device)
    if device.type != "cuda":
        for group in groups:
            store(group, compute(group, fetch(group)))
        return
    side = _copy_stream(device)
    main = torch.cuda.current_stream(device)

    def stage(group):
        with torch.cuda.stream(side):
            inputs = fetch(group)
            ready = torch.cuda.Event()
            ready.record(side)
        return inputs, ready

    staged = stage(groups[0]) if groups else None
    for k, group in enumerate(groups):
        inputs, ready = staged
        if k + 1 < len(groups):
            staged = stage(groups[k + 1])
        main.wait_event(ready)
        for x in inputs:
            x.record_stream(main)
        outputs = compute(group, inputs)
        done = torch.cuda.Event()
        done.record(main)
        side.wait_event(done)
        with torch.cuda.stream(side):
            store(group, outputs)
        for x in outputs:
            x.record_stream(side)
