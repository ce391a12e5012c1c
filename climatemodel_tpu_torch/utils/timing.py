"""Profiling and throughput metrics (port of
``climatemodel_tpu/utils/timing.py``).

Wall-clock throughput counters in the units the framework optimises for
(simulated model-days/s, cell-updates/s), a best-of-N timer that waits for
the card, a thin wrapper over ``torch.profiler`` for device traces, and the
program's own spans and counters.

Spans and counters.  A counter (:func:`count`) is a plain integer add and
is always on.  A span is a named interval of the host's work with the id
of the span open around it.  A *top-level* span (a call decorated with
:func:`spanned` ``top=True`` while no span is open: a march, a finish) is
always recorded, with the change of every counter over its interval;
every other span (:func:`span`) only while a ``torch.profiler`` session
records, so off the profiler an inner span site costs one check.  Spans
are stamped with ``time.time_ns()``, the clock the profiler stamps its
events with, so they line up with a device trace's kernels;
:func:`device_trace` writes them beside its Chrome trace.  The log keeps
the last :data:`SPAN_LIMIT` spans (:func:`spans`).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import re
import socket
import time
from dataclasses import dataclass
from typing import NamedTuple

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


#: spans the log keeps, the oldest dropped first.  A march under the
#: profiler records about one span an iteration (a few more a sweep of the
#: group blend), a march off it one; 65536 spans are some 10 MB.
SPAN_LIMIT = 1 << 16


class Span(NamedTuple):
    """A recorded span: ``start_ns``/``end_ns`` on ``time.time_ns()``'s
    clock; ``parent`` the id of the span open around it (None at the top);
    ``counters`` the change of every counter over a top-level span (None
    on the others)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    counters: dict | None


_log = collections.deque(maxlen=SPAN_LIMIT)
_open = []                          # ids of the open recorded spans
_ids = itertools.count(1)
_counts = collections.defaultdict(int)
_profiling = torch.autograd._profiler_enabled


def count(name: str, n: int = 1):
    """Add ``n`` to the program counter ``name`` (always on)."""
    _counts[name] += n


def counters() -> dict:
    """Every program counter's total since the process started."""
    return dict(_counts)


def spans(since_ns: int | None = None) -> list:
    """The span log, oldest first; with ``since_ns``, the spans begun at or
    after that ``time.time_ns()`` reading."""
    if since_ns is None:
        return list(_log)
    return [s for s in _log if s.start_ns >= since_ns]


def recording() -> bool:
    """True while a ``torch.profiler`` session records (whatever its
    activities): then inner spans are recorded."""
    return _profiling()


class _Recorded:
    __slots__ = ('name', 'top', 'id', 'parent', 'start', 'before')

    def __init__(self, name, top):
        self.name, self.top = name, top

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        self.id = next(_ids)
        _open.append(self.id)
        self.before = dict(_counts) if self.top else None
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.pop()
        delta = None
        if self.top:
            delta = {k: v - self.before.get(k, 0) for k, v in _counts.items()
                     if v != self.before.get(k, 0)}
        _log.append(Span(self.name, self.start, end, self.id, self.parent,
                         delta))
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager of an inner span, recorded while a
    ``torch.profiler`` session records (one check otherwise)."""
    return _Recorded(name, False) if _profiling() else _OFF


def _call_span(name: str):
    """Context manager of a public call's span: top-level where no span is
    open (always recorded, with the counters' change), else as
    :func:`span`."""
    return _Recorded(name, True) if not _open else span(name)


def spanned(name: str, top: bool = False):
    """Decorator: the whole call in a span named ``name``, top-level where
    ``top`` and no span is open, else as :func:`span`."""
    enter = _call_span if top else span

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with enter(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _chrome_events(recorded, base_ns=0):
    """``recorded`` spans as Chrome-trace complete events, their times in
    microseconds after ``base_ns`` (a Chrome trace's
    ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    return [dict(ph='X', cat='span', name=s.name, pid=pid, tid='spans',
                 ts=(s.start_ns - base_ns) / 1e3,
                 dur=(s.end_ns - s.start_ns) / 1e3,
                 args=dict(id=s.id, parent=s.parent,
                           **({'counters': s.counters} if s.counters
                              else {})))
            for s in recorded]


def _base_ns(path) -> int:
    """A Chrome trace's ``baseTimeNanoseconds``, read from the file's head
    (the profiler writes it before the events)."""
    with open(path) as f:
        found = re.search(r'"baseTimeNanoseconds":\s*(\d+)', f.read(1 << 16))
    return int(found.group(1)) if found else 0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host activity, and the card's
    where there is one), written as a Chrome trace
    ``<host>_<pid>.<ns>.pt.trace.json`` into ``log_dir`` (open it in
    Perfetto or TensorBoard), with the spans recorded in the block beside
    it in ``<host>_<pid>.<ns>.spans.json``: a Chrome trace on the same
    clock and time base (merge the two files' ``traceEvents`` to see the
    spans over the kernels).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = time.time_ns()

    def ready(prof):
        os.makedirs(log_dir, exist_ok=True)
        stem = os.path.join(str(log_dir), f'{socket.gethostname()}_'
                            f'{os.getpid()}.{time.time_ns()}')
        prof.export_chrome_trace(stem + '.pt.trace.json')
        base = _base_ns(stem + '.pt.trace.json')
        with open(stem + '.spans.json', 'w') as f:
            json.dump(dict(traceEvents=_chrome_events(spans(since), base),
                           displayTimeUnit='ms', baseTimeNanoseconds=base), f)

    with profile(activities=activities, on_trace_ready=ready) as prof:
        yield prof
