"""Throughput monitoring, device memory statistics and profiler traces.

Port of ``sdxl_training_improvements_tpu/core/profiling.py``:
``ThroughputMonitor`` is a copy; ``device_memory_stats`` reads the card's
allocator (``torch.cuda.memory_stats``) under the JAX package's keys;
``profiler_trace`` runs ``torch.profiler`` around a block and writes a
Chrome trace into the directory.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import torch


class ThroughputMonitor:
    """Windowed samples/sec + batch-time (``throughput.py:19-92``)."""

    def __init__(self, window_size: int = 100, batch_size: int = 1):
        self.window_size = window_size
        self.batch_size = batch_size
        # (duration, samples) per batch so per-call batch_size overrides
        # feed the rate, not just the lifetime counter
        self.batch_times: deque = deque(maxlen=window_size)
        self._start: Optional[float] = None
        self.total_samples = 0

    def start_batch(self) -> None:
        self._start = time.perf_counter()

    def end_batch(self, batch_size: Optional[int] = None) -> None:
        if self._start is None:
            return
        n = batch_size or self.batch_size
        self.batch_times.append((time.perf_counter() - self._start, n))
        self.total_samples += n
        self._start = None

    def get_metrics(self) -> Dict[str, float]:
        if not self.batch_times:
            return {}
        total_t = float(sum(t for t, _ in self.batch_times))
        total_n = sum(n for _, n in self.batch_times)
        mean_t = total_t / len(self.batch_times)
        return {
            "throughput/samples_per_sec": total_n / total_t,
            "throughput/batch_time_ms": mean_t * 1000.0,
            "throughput/steps_per_sec": 1.0 / mean_t,
        }

    def __getstate__(self):
        state = self.__dict__.copy()
        state["batch_times"] = list(self.batch_times)
        return state

    def __setstate__(self, state):
        state["batch_times"] = deque(state["batch_times"],
                                     maxlen=state["window_size"])
        self.__dict__.update(state)


def device_memory_stats() -> Dict[str, float]:
    """Per-card memory in GB, under the JAX package's keys: in use and
    peak from the caching allocator, the limit from the card's total."""
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    gb = 1024 ** 3
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        out[f"memory/device{i}_in_use_gb"] = \
            stats.get("allocated_bytes.all.current", 0) / gb
        out[f"memory/device{i}_peak_gb"] = \
            torch.cuda.max_memory_allocated(i) / gb
        out[f"memory/device{i}_limit_gb"] = \
            torch.cuda.get_device_properties(i).total_memory / gb
    return out


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` around a block (host and, with a card, device
    activity), written as ``trace.json`` (Chrome trace format) into
    ``log_dir``; no-op when the directory is unset."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
