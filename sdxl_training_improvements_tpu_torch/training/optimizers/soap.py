"""SOAP: Adam in the eigenbasis of Shampoo's preconditioner.

Port of ``sdxl_training_improvements_tpu/training/optimizers/soap.py``
(reference ``src/training/optimizers/soap/__init__.py``, arXiv:2409.11321):

* per axis of size <= ``max_precond_dim`` an fp32 EMA of the gradient's
  outer product over the other axes (``gg``); larger axes get a (0, 0)
  placeholder and are skipped;
* the first step only installs the eigenbasis (``eigh`` of each GG, the
  columns flipped to descending eigenvalues; an fp32 ``eigh`` that fails
  to converge is solved again in fp64, as the reference does, where
  JAX's would return NaN) and changes no parameter;
* after it, Adam with the first moment on the raw gradient and the second
  in the projected space, the normalised step projected back, decoupled
  weight decay ``- lr * wd * p``;
* every ``precondition_frequency`` steps (after the update) one power
  iteration and a QR refresh the basis, with ``exp_avg_sq`` re-sorted by
  the estimated eigenvalues.

Each leaf is worked on in the JAX package's layout (Linear ``[in, out]``,
convolution ``[kh, kw, in, out]``; the port's ``weight`` is ``[out, in]``
/ ``[out, in, kh, kw]``), so the merged shapes, the preconditioned axes
and their order are JAX's, and the state (``exp_avg`` in that layout,
``exp_avg_sq`` in its merged shape) carries across unchanged.  With
``merge_dims`` adjacent axes share a preconditioner while their product
fits in ``max_precond_dim`` (``_merged_shape``, copied).

JAX vmaps same-shape leaves only to keep its compiled program small; the
numerics are per leaf.  Here the update loops over the leaves, and
``eigh`` and ``qr`` run one matrix at a time (``torch.linalg``), on the
leaf's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

Mats = Tuple[torch.Tensor, ...]


def _merged_shape(shape: Tuple[int, ...], max_dim: int) -> Tuple[int, ...]:
    """Merge adjacent dims while the running product stays <= max_dim
    (reference ``merge_dims``, ``:80-107``)."""
    new_shape = []
    curr = 1
    for sh in shape:
        temp = curr * sh
        if temp > max_dim:
            if curr > 1:
                new_shape.append(curr)
                curr = sh
            else:
                new_shape.append(sh)
                curr = 1
        else:
            curr = temp
    if curr > 1 or not new_shape:
        new_shape.append(curr)
    return tuple(new_shape)


def _precond_shape(shape: Tuple[int, ...], max_dim: int,
                   precondition_1d: bool) -> Tuple[int, ...]:
    """Size of the preconditioner for each (possibly merged) axis; 0 = skip."""
    if len(shape) == 0:
        return ()
    if len(shape) == 1:
        ok = precondition_1d and shape[0] <= max_dim
        return (shape[0] if ok else 0,)
    return tuple(sh if sh <= max_dim else 0 for sh in shape)


def to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A view of a port weight in the JAX package's layout."""
    if t.dim() == 2:
        return t.t()
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t


def from_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``to_jax_layout``."""
    if t.dim() == 2:
        return t.t()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t


@dataclass
class SOAPState:
    step: int
    exp_avg: Dict[str, torch.Tensor]     # fp32, JAX layout
    exp_avg_sq: Dict[str, torch.Tensor]  # fp32, projected, merged shape
    gg: Dict[str, Mats]                  # per leaf, one matrix per axis
    q: Dict[str, Mats]                   # per leaf, the eigenbases


class SOAP:
    def __init__(self, lr: float = 3e-3, betas=(0.95, 0.95),
                 shampoo_beta: float = -1, eps: float = 1e-8,
                 weight_decay: float = 0.01, precondition_frequency: int = 10,
                 max_precond_dim: int = 10000, merge_dims: bool = False,
                 precondition_1d: bool = False,
                 normalize_grads: bool = False, correct_bias: bool = True):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.sh_beta = shampoo_beta if shampoo_beta >= 0 else self.beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.freq = precondition_frequency
        self.max_dim = max_precond_dim
        self.merge_dims = merge_dims
        self.precondition_1d = precondition_1d
        self.normalize_grads = normalize_grads
        self.correct_bias = correct_bias
        # eigh calls that failed in fp32 and were solved in fp64
        self.eigh_retries = 0

    def leaf_shape(self, shape) -> Tuple[int, ...]:
        """The (merged) JAX-layout shape a parameter of port ``shape``
        is preconditioned in."""
        s = tuple(to_jax_layout(torch.empty(shape, device="meta")).shape)
        return _merged_shape(s, self.max_dim) if self.merge_dims else s

    def init(self, params: Mapping[str, torch.Tensor]) -> SOAPState:
        def mats(p):
            ps = _precond_shape(self.leaf_shape(p.shape), self.max_dim,
                                self.precondition_1d)
            return tuple(torch.zeros((d, d), dtype=torch.float32,
                                     device=p.device) for d in ps)

        return SOAPState(
            step=0,
            exp_avg={n: torch.zeros(to_jax_layout(p).shape,
                                    dtype=torch.float32, device=p.device)
                     for n, p in params.items()},
            exp_avg_sq={n: torch.zeros(self.leaf_shape(p.shape),
                                       dtype=torch.float32, device=p.device)
                        for n, p in params.items()},
            gg={n: mats(p) for n, p in params.items()},
            q={n: mats(p) for n, p in params.items()})

    # ------------------------------------------------------------ pieces
    @staticmethod
    def _project(g: torch.Tensor, q: Mats) -> torch.Tensor:
        for mat in q:
            if mat.shape[0] > 0:
                g = torch.tensordot(g, mat, dims=([0], [0]))
            else:
                g = torch.movedim(g, 0, -1)
        return g

    @staticmethod
    def _project_back(g: torch.Tensor, q: Mats) -> torch.Tensor:
        for mat in q:
            if mat.shape[0] > 0:
                g = torch.tensordot(g, mat, dims=([0], [1]))
            else:
                g = torch.movedim(g, 0, -1)
        return g

    def _update_gg(self, g: torch.Tensor, gg: Mats) -> Mats:
        new = []
        for idx, mat in enumerate(gg):
            if mat.shape[0] == 0:
                new.append(mat)
                continue
            axes = [i for i in range(g.dim()) if i != idx]
            outer = torch.tensordot(g, g, dims=(axes, axes))
            new.append(mat * self.sh_beta + outer * (1.0 - self.sh_beta))
        return tuple(new)

    def _eigh_q(self, gg: Mats) -> Mats:
        out = []
        for mat in gg:
            if mat.shape[0] == 0:
                out.append(mat)
                continue
            eye = torch.eye(mat.shape[0], dtype=mat.dtype, device=mat.device)
            try:
                _, qm = torch.linalg.eigh(mat + 1e-30 * eye)
            except torch.linalg.LinAlgError:
                # the reference's retry (get_orthogonal_matrix): a GG of a
                # tiny gradient (entries near fp32's subnormals) can stop
                # cuSOLVER's fp32 iteration; JAX's eigh returns NaN there
                self.eigh_retries += 1
                _, qm = torch.linalg.eigh(mat.double() + 1e-30 * eye.double())
                qm = qm.to(mat.dtype)
            # row-major, as the checkpoint restores it: LAPACK's
            # column-major result would send the next products down other
            # GEMM paths than a resumed run's, with other roundings
            out.append(torch.flip(qm, dims=[1]).contiguous())
        return tuple(out)

    @staticmethod
    def _qr_refresh(gg: Mats, q: Mats, v: torch.Tensor
                    ) -> Tuple[Mats, torch.Tensor]:
        new_q = []
        for ind, (mat, o) in enumerate(zip(gg, q)):
            if mat.shape[0] == 0:
                new_q.append(o)
                continue
            est_eig = torch.diagonal(o.T @ mat @ o)
            # JAX: argsort (stable, ascending), then reversed
            sort_idx = torch.flip(torch.argsort(est_eig, stable=True), [0])
            v = torch.index_select(v, ind, sort_idx)
            o = o[:, sort_idx]
            qm, _ = torch.linalg.qr(mat @ o)
            new_q.append(qm.contiguous())  # row-major, as in _eigh_q
        return tuple(new_q), v

    def step_size(self, step: int) -> float:
        """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in fp32 (``lr`` without
        ``correct_bias``)."""
        if not self.correct_bias:
            return self.lr
        f = np.float32
        b1t = f(float(f(self.beta1)) ** step)
        b2t = f(float(f(self.beta2)) ** step)
        return float(f(self.lr) * np.sqrt(f(1.0) - b2t, dtype=f)
                     / (f(1.0) - b1t))

    # ------------------------------------------------------------ update
    def update(self, grads: Mapping[str, torch.Tensor], state: SOAPState,
               params: Mapping[str, torch.Tensor], zero=None
               ) -> Tuple[Dict[str, torch.Tensor], SOAPState]:
        """One step.  ``zero`` (``parallel/zero.py``): a sharded leaf's
        gradient, parameter, first moment and delta are this rank's
        pieces (its chunk, megatron slice, or chunk of a slice; the first
        moment's of its contiguous JAX layout), as JAX places SOAP's
        state; the gradient and the first moment are gathered whole for
        the projections, which every rank computes whole (``exp_avg_sq``,
        ``gg`` and ``q`` stay whole on every rank), and each rank keeps
        its piece of the elementwise results, so the pieces are the whole
        leaf's update."""
        step = state.step + 1  # 1-based; step 1 installs the basis only
        first = state.step == 0
        refresh = step % self.freq == 0
        step_size = self.step_size(step)
        b1, b2 = self.beta1, self.beta2
        deltas: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for n, p in params.items():
                piece = zero is not None and zero.holds_piece(n)
                g = zero.gather(n, grads[n]) if piece else grads[n]
                g32 = to_jax_layout(g).float()
                lshape = self.leaf_shape(g.shape)
                gm = g32.reshape(lshape)
                gg = state.gg[n] = self._update_gg(gm, state.gg[n])
                if first:
                    state.q[n] = self._eigh_q(gg)
                    deltas[n] = torch.zeros_like(p)
                    continue
                q = state.q[n]
                g_proj = self._project(gm, q)
                if not piece:
                    m = state.exp_avg[n].mul_(b1).add_(g32, alpha=1.0 - b1)
                else:
                    g_part = zero.chunk_of(n, g32, how="jax")
                    state.exp_avg[n].mul_(b1).add_(g_part, alpha=1.0 - b1)
                    m = zero.gather(n, state.exp_avg[n], how="jax")
                v = state.exp_avg_sq[n].mul_(b2).add_(g_proj * g_proj,
                                                      alpha=1.0 - b2)
                denom = torch.sqrt(v) + self.eps
                m_proj = self._project(m.reshape(lshape), q)
                norm_grad = self._project_back(m_proj / denom, q).reshape(
                    g32.shape)
                if self.normalize_grads:
                    norm_grad = norm_grad / (
                        1e-30 + torch.sqrt(torch.mean(norm_grad ** 2)))
                if not piece:
                    p32 = to_jax_layout(p.detach()).float()
                    delta = (-step_size * norm_grad
                             - self.lr * self.weight_decay * p32)
                    deltas[n] = from_jax_layout(delta).to(p.dtype)
                else:  # the same elementwise terms, on this rank's piece
                    part = zero.chunk_of(
                        n, from_jax_layout(-step_size * norm_grad))
                    deltas[n] = (part - self.lr * self.weight_decay
                                 * p.detach().float()).to(p.dtype)
                if refresh:
                    state.q[n], state.exp_avg_sq[n] = self._qr_refresh(
                        gg, q, v)
        state.step = step
        return deltas, state
