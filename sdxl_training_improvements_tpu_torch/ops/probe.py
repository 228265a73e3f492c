"""Startup probe: one elementwise kernel streamed against its plain version.

Port of ``sdxl_training_improvements_tpu/ops/probe.py``.  The JAX module
times a Pallas kernel ``x * 2 + 1`` over a 64 MB fp32 array (``_run_probe``)
against the same expression in XLA, to decide whether Mosaic runs at native
speed and so whether the Pallas kernels are dispatched.  The port
dispatches by device and has no such gate, so nothing reads a verdict:
``run_probe`` returns the two times and rates, as a check that a
hand-written kernel launches and streams device memory at the expected
rate.  ``training/trainer.py::create_train_state`` runs it once on the
card, where the TPU trainer ran the probe at its first kernel dispatch.

The kernel (``probe_kernel``, Triton) replaces the Pallas ``_run_probe``'s
``kernel``: one fused pass, 8 bytes per element, bound by HBM bandwidth.
Triton serves as well as CUDA here: no reduction, layout or rounding
subtlety, and Triton's launch path is part of what it measures.
"""
from __future__ import annotations

import functools
import statistics
from typing import Dict

import torch

PROBE_SHAPE = (4096, 4096)  # fp32, 64 MB, as the JAX probe
_BLOCK = 4096
_ITERS = 10


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain ``x * 2 + 1``."""
    return x * 2.0 + 1.0


@functools.lru_cache(maxsize=None)
def _kernel():
    """(triton, probe_kernel), defined at first launch."""
    import triton
    import triton.language as tl

    @triton.jit
    def probe_kernel(x_ptr, y_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask)
        tl.store(y_ptr + offs, x * 2.0 + 1.0, mask=mask)

    return triton, probe_kernel


def probe_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the Triton kernel on a contiguous fp32 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"probe kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("probe kernel takes a contiguous fp32 tensor")
    triton, probe_kernel = _kernel()
    y = torch.empty_like(x)
    n = x.numel()
    probe_kernel[(triton.cdiv(n, _BLOCK),)](x, y, n, BLOCK=_BLOCK,
                                            num_warps=8)
    probe_cuda.launches += 1
    return y


probe_cuda.launches = 0


def _time_ms(fn, x) -> float:
    """Median CUDA-event time of one call over ``_ITERS`` calls, warm."""
    fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_probe(device=None) -> Dict[str, float]:
    """Time the kernel and the plain ``x * 2 + 1`` over the 64 MB probe
    array on a card: ms per call, GB/s (8 bytes per element) and the
    kernel's max abs error against the plain version."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"run_probe needs a CUDA device, got {device}")
    x = torch.linspace(-1.0, 1.0, PROBE_SHAPE[0] * PROBE_SHAPE[1],
                       device=device).reshape(PROBE_SHAPE)
    err = (probe_cuda(x) - probe_reference(x)).abs().max().item()
    ms = _time_ms(probe_cuda, x)
    plain_ms = _time_ms(probe_reference, x)
    gb = 8 * x.numel() / 1e9
    return {"ms": ms, "plain_ms": plain_ms, "gbps": gb / (ms * 1e-3),
            "plain_gbps": gb / (plain_ms * 1e-3), "max_abs_err": err}
