"""Profiling and throughput metrics (port of
``climatemodel_tpu/utils/timing.py``).

Wall-clock throughput counters in the units the framework optimises for
(simulated model-days/s, cell-updates/s), a best-of-N timer that waits for
the card, and a thin wrapper over ``torch.profiler`` for device traces.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

from .checkpoint import tree_flatten


@dataclass
class Throughput:
    """Accumulating throughput counter.

    >>> meter = Throughput()
    >>> with meter.measure(work=n_cells * n_steps):
    ...     out = step(state); torch.cuda.synchronize()
    >>> meter.rate
    """
    total_work: float = 0.0
    total_seconds: float = 0.0
    n_measurements: int = 0

    @contextlib.contextmanager
    def measure(self, work: float):
        t0 = time.perf_counter()
        yield
        self.total_seconds += time.perf_counter() - t0
        self.total_work += work
        self.n_measurements += 1

    @property
    def rate(self) -> float:
        return self.total_work / self.total_seconds if self.total_seconds else 0.0


def _wait_for(out):
    """Wait for the card where any tensor of ``out`` (a tree) lives on it;
    PyTorch returns before the device finishes."""
    leaves, _ = tree_flatten(out)
    devices = {x.device for x in leaves
               if torch.is_tensor(x) and x.device.type == 'cuda'}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, repeats=3, **kwargs):
    """Best-of-N wall time of fn(*args), waiting for the card when the
    output lives on it; returns (best_seconds, last_output).  The first
    call (warm-up: kernel builds, allocator growth) is excluded."""
    out = fn(*args, **kwargs)
    _wait_for(out)
    best = float('inf')
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait_for(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def model_days_per_second(simulated_seconds: float, wall_seconds: float) -> float:
    """Throughput in simulated model-days per wall second."""
    return simulated_seconds / 86400.0 / wall_seconds


def cell_updates_per_second(n_cells: int, n_steps: int,
                            wall_seconds: float) -> float:
    """Throughput in grid-cell updates per wall second."""
    return n_cells * n_steps / wall_seconds


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host activity, and the card's
    where there is one), written as a Chrome trace into ``log_dir`` (open
    it in Perfetto or TensorBoard).  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
