"""Pure-bf16 AdamW with stochastic rounding: four state layouts, two
noises, int8 moments and host-streamed state.

Port of ``sdxl_training_improvements_tpu/training/optimizers/
adamw_bf16.py``.  Per bf16 parameter: bf16 ``exp_avg``, ``exp_avg_sq``
and ``shift`` (the stochastic-rounding residual carried forward) and an
fp32 ``accumulated_decay``, whose starting phase is uniform * 5e-3.  Each
step:

* bf16 parameters run the chain of ``ops/fused_adamw.py`` (the fused CUDA
  kernel on the card, the plain chain on the CPU);
* fp32 parameters (the norms) run exact AdamW with no bias correction on
  m and ``sqrt(1 - beta2**t)`` on the step (``f32_update`` /
  ``f32_delta``); this is why ``torch.optim.AdamW`` is not used;
* weight decay is batched: ``accumulated_decay`` accrues wd * lr per step
  and fires as ``shift -= acc * p'`` once it exceeds 5e-3; the decision
  is taken on the host.

``layout`` (JAX ``:112-155``; ``flat_state=True`` is ``"flat"``):

* ``per_leaf`` — state per parameter, keyed by its name;
* ``flat`` — the bf16 parameters, in the JAX tree's flatten order (their
  flax paths, sorted: ``models/weights.py`` ``flax_path``), cut into
  ``flat_groups`` contiguous groups of about equal size
  (``_partition_flat``); each group's state is one 1-D buffer
  ``flat_{g}`` and its update one launch over the concatenated p and g
  (the gradient cast to bf16 first, as JAX does), the deltas split back
  as views; one decay phase per group;
* ``hybrid`` — the bf16 parameters under ``hybrid_threshold`` elements in
  one flat group ``flat_0``, the others per parameter, one decay phase
  each (``_partition_hybrid``);
* ``stacked`` — the bf16 parameters of one JAX shape stacked, groups in
  the order of their shapes (``_partition_stacked``): state ``stack_{j}``
  of [k, n] (each row a parameter in memory order), one launch per stack
  with one decay amount per row (per-parameter phases, as per-leaf).

fp32 parameters keep state per name in every layout.  Within a parameter
the noise index is its memory position; in a group, the group's offset
plus it.

``noise``: ``"hash"`` derives the noise from two uint32 seeds per leaf or
group (drawn by the state's CPU generator) and the element's index, as
JAX's counter hash; ``"rbg"`` draws two uint32 planes of the leaf's or
group's size on its device (``state.noise_generator``) and the kernel's
rbg variant reads them.  JAX's defaults: rbg for ``per_leaf``, hash for
the others.  ``update(seeds=, planes=)`` replaces the draws, so a test
can hand in JAX's: ``seeds`` [units, 2], ``planes`` a [2, n] tensor per
unit (per_leaf: every parameter in ``params`` order, fp32 ones ignored;
the other layouts: the bf16 groups and per-parameter bf16 leaves in
JAX's key order).

``moments="int8"`` (``optimizer.moments_8bit``; JAX ``:305-327``) stores
``exp_avg`` and ``exp_avg_sq`` of each bf16 leaf as 8-bit log codes plus
one fp32 scale (``ops/quantize.py``: ``{"q", "s"}``), 4 instead of 6 state
bytes a parameter: the update dequantizes both to bf16, runs the same
fused chain and quantizes them again.

``shift_host`` / ``moments_host`` (JAX ``:169-202``, ``:386-426``) keep
the shift, or the moments, in host memory (pinned on a card,
``core/offload.py``) and stream them through the card in groups of about
``stream_group_params`` parameters, two groups in flight
(``offload.stream_groups``).  int8 moments, host state and the other
layouts exclude each other as in JAX.

``update`` returns the per-parameter deltas (bf16 ``p' - p`` for bf16
leaves) and the new state; the train step adds the deltas in the
parameters' dtype, as JAX's ``optax.apply_updates`` does.  The moments
and shift are updated in place on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sdxl_training_improvements_tpu_torch.core import offload
from sdxl_training_improvements_tpu_torch.models.weights import (
    flax_path, jax_shape)
from sdxl_training_improvements_tpu_torch.ops.fused_adamw import (
    draw_planes, fused_adamw_update, memory_order)
from sdxl_training_improvements_tpu_torch.ops.quantize import (
    dequantize_8bit, quantize_8bit, quantized_zeros)

DECAY_THRESHOLD = 5e-3
LAYOUTS = ("per_leaf", "flat", "stacked", "hybrid")
Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclass
class AdamWBF16State:
    step: int
    # keyed by parameter name, or flat_{g} / stack_{j} for a group; a bf16
    # leaf's moments under int8 are {"q": codes, "s": scale}
    exp_avg: Dict[str, Moment]
    exp_avg_sq: Dict[str, Moment]
    shift: Dict[str, torch.Tensor]
    # 0-d fp32 CPU tensors ([k] for a stack); fp32 leaves keep theirs
    # unused, as in JAX
    accumulated_decay: Dict[str, torch.Tensor]
    generator: torch.Generator  # CPU; draws the phases, then the seeds
    layout: str = "per_leaf"
    # "rbg": draws the planes, on the parameters' device
    noise_generator: Optional[torch.Generator] = None


@dataclass(frozen=True)
class _Unit:
    """One update: a parameter (``kind`` "leaf"), a flat group or a
    stack, with its state key and its parameters' names."""
    key: str
    names: Tuple[str, ...]
    kind: str


def _partition_flat(leaves, n_groups: int):
    """JAX ``_partition_flat``: fp32 leaf indices + contiguous bf16 groups
    of about equal element count."""
    f32_idx = [i for i, x in enumerate(leaves) if x.dtype == torch.float32]
    bf16_idx = [i for i, x in enumerate(leaves) if x.dtype == torch.bfloat16]
    if not bf16_idx:
        return f32_idx, []
    n_groups = max(1, min(n_groups, len(bf16_idx)))
    total = sum(leaves[i].numel() for i in bf16_idx)
    target = total / n_groups
    groups, cur, acc = [], [], 0
    for i in bf16_idx:
        cur.append(i)
        acc += leaves[i].numel()
        if acc >= target * (len(groups) + 1) and len(groups) < n_groups - 1:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return f32_idx, groups


def _partition_hybrid(leaves, threshold: int):
    """JAX ``_partition_hybrid``: fp32 indices, the small bf16 leaves as
    one group, the big ones."""
    f32_idx = [i for i, x in enumerate(leaves) if x.dtype == torch.float32]
    small = [i for i, x in enumerate(leaves)
             if x.dtype == torch.bfloat16 and x.numel() < threshold]
    big = [i for i, x in enumerate(leaves)
           if x.dtype == torch.bfloat16 and x.numel() >= threshold]
    return f32_idx, ([small] if small else []), big


def _partition_stacked(leaves, shapes):
    """JAX ``_partition_stacked``: fp32 indices and the bf16 leaves grouped
    by their JAX ``shapes``, the groups in sorted shape order."""
    f32_idx = [i for i, x in enumerate(leaves) if x.dtype == torch.float32]
    by_shape: Dict[Tuple[int, ...], List[int]] = {}
    for i, x in enumerate(leaves):
        if x.dtype == torch.bfloat16:
            by_shape.setdefault(shapes[i], []).append(i)
    return f32_idx, [by_shape[k] for k in sorted(by_shape)]


def flax_order(params: Mapping[str, torch.Tensor]) -> List[str]:
    """The parameters' names in the JAX tree's flatten order."""
    return sorted(params, key=lambda n: flax_path(n, params[n].dim()))


def from_memory_order(flat: torch.Tensor, like: torch.Tensor
                      ) -> torch.Tensor:
    """A view of the 1-D ``flat`` (``like.numel()`` elements in memory
    order) with ``like``'s shape and strides."""
    order = sorted(range(like.dim()), key=lambda d: -like.stride(d))
    inverse = sorted(range(like.dim()), key=lambda d: order[d])
    return flat.view([like.shape[d] for d in order]).permute(inverse)


class AdamWBF16:
    """``init(params)`` and ``update(grads, state, params, seeds=None,
    planes=None)`` over dicts of tensors keyed by parameter name."""

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 seed: int = 0, moments: str = "bf16",
                 layout: Optional[str] = None, flat_state: bool = False,
                 flat_groups: int = 8, hybrid_threshold: int = 1 << 20,
                 noise: Optional[str] = None, shift_host: bool = False,
                 moments_host: bool = False,
                 stream_group_params: int = 1 << 25):
        layout = layout or ("flat" if flat_state else "per_leaf")
        if layout not in LAYOUTS:
            raise ValueError(
                f"layout must be per_leaf|flat|stacked|hybrid, got {layout!r}")
        noise = noise if noise is not None else (
            "rbg" if layout == "per_leaf" else "hash")
        if noise not in ("rbg", "hash"):
            raise ValueError(f"noise must be 'rbg' or 'hash', got {noise!r}")
        if moments not in ("bf16", "int8"):
            raise ValueError(f"moments must be 'bf16' or 'int8', got "
                             f"{moments!r}")
        for flag, on in (("moments='int8'", moments == "int8"),
                         ("shift_host", shift_host),
                         ("moments_host", moments_host)):
            if on and layout != "per_leaf":
                raise ValueError(f"{flag} requires layout='per_leaf' "
                                 f"(got layout={layout!r})")
        self.layout, self.noise, self.moments = layout, noise, moments
        self.flat_groups, self.hybrid_threshold = flat_groups, \
            hybrid_threshold
        self.shift_host, self.moments_host = shift_host, moments_host
        self.stream_group_params = stream_group_params
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.seed = seed
        self._partitions: dict = {}

    @staticmethod
    def _validate(params: Mapping[str, torch.Tensor]) -> None:
        """JAX's ``_validate``: bf16 leaves, or fp32 norms, only (an fp16
        UNet takes plain ``adamw``)."""
        for name, p in params.items():
            if p.dtype not in (torch.bfloat16, torch.float32):
                raise ValueError("adamw_bf16 requires bfloat16 (or float32 "
                                 f"norm) params, got {p.dtype} for {name}")

    # ------------------------------------------------------------ layout
    def _units(self, params: Mapping[str, torch.Tensor]
               ) -> Tuple[List[_Unit], List[_Unit]]:
        """(bf16 units in JAX's key order, fp32 leaves) of the layout;
        per_leaf: every parameter in ``params`` order, fp32 ones included
        (they draw seeds they ignore, as in JAX), and no second list."""
        if self.layout == "per_leaf":
            return [_Unit(n, (n,), "leaf") for n in params], []
        sig = tuple((n, p.dtype, tuple(p.shape)) for n, p in params.items())
        if sig not in self._partitions:
            self._partitions[sig] = self._partition(params)
        return self._partitions[sig]

    def _partition(self, params):
        names = flax_order(params)
        leaves = [params[n] for n in names]
        if self.layout == "flat":
            f32, groups = _partition_flat(leaves, self.flat_groups)
            big: List[int] = []
        elif self.layout == "hybrid":
            f32, groups, big = _partition_hybrid(leaves,
                                                 self.hybrid_threshold)
        else:
            f32, groups = _partition_stacked(
                leaves, [jax_shape(n, params[n].shape) for n in names])
            big = []
        kind, prefix = (("stack", "stack_") if self.layout == "stacked"
                        else ("flat", "flat_"))
        units = [_Unit(f"{prefix}{g}", tuple(names[i] for i in grp), kind)
                 for g, grp in enumerate(groups)]
        units += [_Unit(names[i], (names[i],), "leaf") for i in big]
        return units, [_Unit(names[i], (names[i],), "leaf") for i in f32]

    def groups(self, params: Mapping[str, torch.Tensor]
               ) -> Dict[str, Tuple[str, ...]]:
        """Each flat group's or stack's state key -> its parameters' names,
        in order (empty for per_leaf)."""
        units, _ = self._units(params)
        return {u.key: u.names for u in units if u.kind != "leaf"}

    def _quantized(self, p: torch.Tensor) -> bool:
        return self.moments == "int8" and p.dtype == torch.bfloat16

    @property
    def _host(self) -> bool:
        return self.shift_host or self.moments_host

    # ------------------------------------------------------------ state
    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWBF16State:
        self._validate(params)
        gen = torch.Generator().manual_seed(self.seed)
        units, f32 = self._units(params)
        if self.layout in ("per_leaf", "stacked"):
            # per-parameter phases (stacked: by JAX leaf index)
            phases = torch.rand(len(params), generator=gen) * DECAY_THRESHOLD
        else:
            phases = torch.rand(max(len(units), 1), generator=gen) \
                * DECAY_THRESHOLD
        device = next(iter(params.values())).device if params else "cpu"
        noise_gen = None
        if self.noise == "rbg":
            noise_gen = torch.Generator(device=device).manual_seed(
                int(torch.randint(0, 2 ** 62, (), generator=gen)))
        m, v, shift, acc = {}, {}, {}, {}
        index = {n: i for i, n in enumerate(
            params if self.layout == "per_leaf" else flax_order(params))}
        for u, unit in enumerate(units):
            ps = [params[n] for n in unit.names]
            if unit.kind == "leaf":
                p = ps[0]
                m[unit.key] = self._zero_moment(p, signed=True)
                v[unit.key] = self._zero_moment(p, signed=False)
                shift[unit.key] = self._place(torch.zeros_like(p), "shift")
            else:
                size = sum(p.numel() for p in ps)
                shape = ((len(ps), ps[0].numel()) if unit.kind == "stack"
                         else (size,))
                for tree in (m, v, shift):
                    tree[unit.key] = torch.zeros(shape, dtype=torch.bfloat16,
                                                 device=device)
            if self.layout == "per_leaf":
                acc[unit.key] = phases[index[unit.key]].clone()
            elif unit.kind == "stack":
                acc[unit.key] = phases[[index[n] for n in unit.names]].clone()
            else:
                acc[unit.key] = phases[u].clone()
        for unit in f32:
            p = params[unit.key]
            m[unit.key], v[unit.key] = torch.zeros_like(p), \
                torch.zeros_like(p)
            shift[unit.key] = torch.zeros_like(p)
        return AdamWBF16State(step=0, exp_avg=m, exp_avg_sq=v, shift=shift,
                              accumulated_decay=acc, generator=gen,
                              layout=self.layout, noise_generator=noise_gen)

    def _place(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """``t`` in host memory when ``what`` ("shift" or "moments") is
        host-streamed."""
        host = self.shift_host if what == "shift" else self.moments_host
        return offload.to_host(t) if host else t

    def _zero_moment(self, p: torch.Tensor, signed: bool):
        z = (quantized_zeros(p, signed) if self._quantized(p)
             else torch.zeros_like(p))
        if isinstance(z, dict):
            return {k: self._place(x, "moments") for k, x in z.items()}
        return self._place(z, "moments")

    def lr_eff(self, step: int) -> float:
        """``lr * sqrt(1 - beta2**step)`` in fp32 arithmetic, as JAX's
        ``cur_lr * denom_correction``.  The power is rounded once to fp32
        (XLA's ``pow``); ``torch.pow`` would multiply out small integer
        exponents with a rounding per product."""
        b2t = np.float32(float(np.float32(self.beta2)) ** step)
        dc = np.sqrt(np.float32(1.0) - b2t, dtype=np.float32)
        return float(np.float32(self.lr) * dc)

    # ----------------------------------------------------------- update
    def update(self, grads: Mapping[str, torch.Tensor],
               state: AdamWBF16State, params: Mapping[str, torch.Tensor],
               seeds: Optional[torch.Tensor] = None,
               planes: Optional[Sequence[Optional[torch.Tensor]]] = None,
               zero=None
               ) -> Tuple[Dict[str, torch.Tensor], AdamWBF16State]:
        """One step (``seeds`` and ``planes`` as in the module docstring).
        A leaf that is neither bf16 nor fp32 raises before any leaf is
        updated.

        ``zero`` (``parallel/zero.py``): the sharded leaves' ``grads``,
        ``params`` and state are this rank's pieces (a chunk, a megatron
        slice, or a chunk of a slice); each piece hashes its elements'
        places in the whole leaf (the kernel's ``base`` and index map),
        takes its part of the whole leaf's rbg planes (drawn whole, so
        the stream does not depend on the mesh), and quantizes int8
        moments with the whole leaf's absmax (a MAX over the pieces)."""
        self._validate(params)
        if state.layout != self.layout:
            raise ValueError(f"optimizer state of layout {state.layout!r} "
                             f"given to the {self.layout!r} layout")
        if zero is not None and zero.sharded and (
                self.layout != "per_leaf" or self._host):
            raise ValueError(
                "sharded optimizer state needs the per-leaf layout with "
                "resident state: make_optimizer refuses "
                "tpu.flat_optimizer=on and host-streamed state under "
                "tpu.shard_params and with a tensor axis above 1, as JAX "
                "does, and no config selects the hybrid or stacked "
                "layouts")
        step = state.step + 1
        lr_eff = self.lr_eff(step)
        units, f32 = self._units(params)
        if self.noise == "hash" and seeds is None:
            seeds = torch.randint(0, 2 ** 32, (len(units), 2),
                                  generator=state.generator,
                                  dtype=torch.int64)
        seed_rows = (seeds.tolist() if seeds is not None
                     else [(0, 0)] * len(units))
        if planes is None:
            planes = [None] * len(units)
        deltas: Dict[str, torch.Tensor] = {}
        work = list(zip(units, seed_rows, planes))
        if self._host:
            self._update_streamed(work, grads, state, params, lr_eff,
                                  deltas)
        else:
            for unit, seed, plane in work:
                self._update_unit(unit, seed, plane, grads, state, params,
                                  lr_eff, deltas, zero=zero)
        for unit in f32:
            name = unit.key
            deltas[name], state.exp_avg[name], state.exp_avg_sq[name] = \
                self._f32_leaf(params[name], grads[name],
                               state.exp_avg[name], state.exp_avg_sq[name],
                               lr_eff)
        state.step = step
        return deltas, state

    def _noise(self, state, n: int, plane, device, where=None):
        """The rbg planes of a unit of n elements: the injected ones, or
        a draw; None under hash noise.  ``where``: the unit is a piece of
        a leaf (``Zero.noise_map``: the leaf's elements, the piece's
        first element, the slice's index map), whose planes are its part
        of the whole leaf's."""
        if self.noise != "rbg":
            return None
        whole, base, imap = where if where is not None else (n, 0, None)
        if plane is None:
            plane = draw_planes(whole, state.noise_generator)
        if imap is not None:
            plane = plane[:, imap.indices(base, n, plane.device)]
        elif where is not None:
            plane = plane[:, base:base + n]
        if device.type == "cuda":  # the kernel reads int32 bits
            return plane.to(device=device, dtype=torch.int32).contiguous()
        return plane.to(device)

    def _decay(self, acc: torch.Tensor):
        """(decay amount(s) for this step, the new accumulated decay)."""
        acc = acc + self.weight_decay * self.lr
        fire = acc > DECAY_THRESHOLD
        if acc.dim() == 0:
            return (float(acc) if bool(fire) else 0.0,
                    torch.zeros_like(acc) if bool(fire) else acc)
        return (torch.where(fire, acc, torch.zeros_like(acc)),
                torch.where(fire, torch.zeros_like(acc), acc))

    def _update_unit(self, unit: _Unit, seed, plane, grads, state, params,
                     lr_eff: float, deltas, staged=None, zero=None):
        """Update one unit.  ``staged``: the leaf's (m, v, shift) on the
        card when some of its state lives on the host; the new ones are
        then returned instead of written to ``state``."""
        key = unit.key
        if unit.kind == "leaf":
            name = unit.names[0]
            p, g = params[name], grads[name]
            where = (zero.noise_map(name) if zero is not None
                     and zero.holds_piece(name) else None)
            reduce = zero.absmax_reduce(name) if where is not None else None
            m, v, sh = staged if staged is not None else (
                state.exp_avg[key], state.exp_avg_sq[key], state.shift[key])
            if p.dtype == torch.float32:  # per_leaf's fp32 leaves
                deltas[name], m, v = self._f32_leaf(p, g, m, v, lr_eff)
            else:
                decay, state.accumulated_decay[key] = self._decay(
                    state.accumulated_decay[key])
                quantized = self._quantized(p)
                if quantized:
                    m = _like(p, dequantize_8bit(m, signed=True))
                    v = _like(p, dequantize_8bit(v, signed=False))
                deltas[name], m, v, sh = fused_adamw_update(
                    p, g, m, v, sh, lr_eff, decay, seed[0], seed[1],
                    self.beta1, self.beta2, self.eps,
                    planes=self._noise(state, p.numel(), plane, p.device,
                                       where),
                    base=where[1] if where is not None else 0,
                    imap=where[2] if where is not None else None)
                if quantized:
                    m = quantize_8bit(m, signed=True, absmax_reduce=reduce)
                    v = quantize_8bit(v, signed=False, absmax_reduce=reduce)
            if staged is not None:
                return m, v, sh
            state.exp_avg[key], state.exp_avg_sq[key] = m, v
            state.shift[key] = sh
            return None
        # a flat group or a stack: one launch over the concatenation
        decay, state.accumulated_decay[key] = self._decay(
            state.accumulated_decay[key])
        ps = [params[n] for n in unit.names]
        stacked = unit.kind == "stack"
        join = torch.stack if stacked else torch.cat
        p_all = join([memory_order(x) for x in ps])
        g_all = join([memory_order(grads[n].to(torch.bfloat16))
                      for n in unit.names])
        delta, m, v, sh = fused_adamw_update(
            p_all, g_all, state.exp_avg[key], state.exp_avg_sq[key],
            state.shift[key], lr_eff, 0.0 if stacked else decay, seed[0],
            seed[1], self.beta1, self.beta2, self.eps,
            planes=self._noise(state, p_all.numel(), plane, p_all.device),
            decay=decay.to(p_all.device) if stacked else None)
        state.exp_avg[key], state.exp_avg_sq[key], state.shift[key] = m, v, sh
        flat = delta.reshape(-1)
        off = 0
        for n, p in zip(unit.names, ps):
            deltas[n] = from_memory_order(flat[off:off + p.numel()], p)
            off += p.numel()
        return None

    def _update_streamed(self, work, grads, state, params, lr_eff: float,
                         deltas) -> None:
        """Per-leaf update with host-resident shift and/or moments, in
        groups of about ``stream_group_params`` parameters through
        ``offload.stream_groups`` (JAX's depth-2 barrier chain)."""
        groups, cur, n = [], [], 0
        for item in work:
            cur.append(item)
            n += params[item[0].key].numel()
            if n >= self.stream_group_params:
                groups.append(cur)
                cur, n = [], 0
        if cur:
            groups.append(cur)
        device = next(iter(params.values())).device

        def roles(unit) -> List[str]:
            """The leaf's state that lives on the host (an fp32 leaf's
            shift never changes and stays where it is)."""
            out = ["m", "v"] if self.moments_host else []
            if self.shift_host and params[unit.key].dtype != torch.float32:
                out.append("shift")
            return out

        def current(unit) -> Dict[str, Moment]:
            k = unit.key
            return {"m": state.exp_avg[k], "v": state.exp_avg_sq[k],
                    "shift": state.shift[k]}

        def tensors(value) -> List[torch.Tensor]:
            return list(value.values()) if isinstance(value, dict) \
                else [value]

        def fetch(group):
            return [offload.to_device(t, device)
                    for unit, _, _ in group
                    for role in roles(unit)
                    for t in tensors(current(unit)[role])]

        def compute(group, inputs):
            it = iter(inputs)
            outputs = []
            for unit, seed, plane in group:
                staged = current(unit)
                for role in roles(unit):
                    host = staged[role]
                    staged[role] = ({kk: next(it) for kk in host}
                                    if isinstance(host, dict) else next(it))
                new = dict(zip(("m", "v", "shift"), self._update_unit(
                    unit, seed, plane, grads, state, params, lr_eff, deltas,
                    staged=(staged["m"], staged["v"], staged["shift"]))))
                for role in roles(unit):
                    outputs.extend(tensors(new[role]))
                k = unit.key
                if not self.moments_host:
                    state.exp_avg[k], state.exp_avg_sq[k] = new["m"], new["v"]
                if "shift" not in roles(unit):
                    state.shift[k] = new["shift"]
            return outputs

        def store(group, outputs):
            it = iter(outputs)
            for unit, _, _ in group:
                for role in roles(unit):
                    for host in tensors(current(unit)[role]):
                        host.copy_(next(it), non_blocking=True)

        offload.stream_groups(groups, fetch, compute, store, device)

    def _f32_leaf(self, p, g, m, v, lr_eff: float):
        """JAX ``f32_update`` + ``f32_delta``: exact fp32 AdamW."""
        b1, b2 = self.beta1, self.beta2
        g32 = g.float()
        m = m * b1 + (1.0 - b1) * g32
        v = v * b2 + (1.0 - b2) * g32 * g32
        delta = (-lr_eff) * m / (torch.sqrt(v) + self.eps) \
            - self.weight_decay * self.lr * p
        return delta, m, v


def _like(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` with ``p``'s strides: the fused kernel takes one layout, and
    on the card the decode's elementwise ops returned other strides for
    some leaves (a ValueError from ``fused_adamw_cuda`` on an H100)."""
    if t.stride() == p.stride():
        return t
    return torch.empty_like(p, dtype=t.dtype).copy_(t)
