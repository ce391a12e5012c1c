"""The device trace of a traced run: ``torch.profiler`` over one march's
f32 call, reduced to kernel intervals and, where the host's operations were
recorded too, the host operations around them.

Recording the host's operations slows the host several times over, and a
host-bound march with it, so the device metrics (busy time, idle share,
operations, rooflines) read a trace of the card's activity alone; a second
traced march records the host too, for the idle gaps of the breakdown.

The reduction reads the profiler's raw (Kineto) events, without building
PyTorch's own summaries: a march launches some 10^5 kernels.
"""
from __future__ import annotations

import bisect
import collections
import contextlib


class Trace:
    """Kernel intervals ``(start_s, end_s, name)`` on the card and host
    operations ``(start_s, name)``, on one clock, of a traced window whose
    host-clock length is ``window_s``."""

    def __init__(self, kernels, host_ops, window_s):
        self.kernels = sorted(kernels)
        self.host_ops = sorted(host_ops)
        self.window_s = window_s

    def busy_s(self):
        """Length of the union of the kernel intervals."""
        busy, end = 0.0, None
        for s, e, _ in self.kernels:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def kernel_times(self, part):
        """Durations (s) of the kernels whose name holds ``part``."""
        return [e - s for s, e, name in self.kernels if part in name]

    def top_kernels(self, k=10):
        by = collections.Counter()
        for s, e, name in self.kernels:
            by[name] += e - s
        return [[n, t] for n, t in by.most_common(k)]

    def idle_gaps(self, k=10):
        """Idle time between kernels, summed by the host operation that had
        last begun when the card went idle."""
        starts = [s for s, _ in self.host_ops]
        by = collections.Counter()
        end = None
        for s, e, _ in self.kernels:
            if end is not None and s > end:
                i = bisect.bisect_right(starts, end) - 1
                by[self.host_ops[i][1] if i >= 0 else 'start'] += s - end
            end = e if end is None else max(end, e)
        return [[n, t] for n, t in by.most_common(k)]


def _annotation(ev):
    """A user annotation shown on the device's timeline (such as NCCL's
    ``nccl:_all_gather_base`` range around its kernel), not an operation."""
    flag = getattr(ev, 'is_user_annotation', None)
    kind = getattr(ev, 'activity_type', None)
    return bool((flag and flag()) or (kind and 'annotation' in kind()))


def _when(ev):
    """(start, duration) in seconds of a raw event, by either API."""
    if hasattr(ev, 'start_ns'):
        return ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    return ev.start_us() * 1e-6, ev.duration_us() * 1e-6


@contextlib.contextmanager
def profiled(out, host=False):
    """Profile the block; append its :class:`Trace` to ``out`` (the
    window is the block's host-clock wall, ending in a synchronise).
    ``host``: record the host's operations too (without a card, always)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        window = time.perf_counter() - t0
    kernels, host_ops = [], []
    device = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        start, dur = _when(ev)
        name = ev.name()
        if ev.device_type() == device:
            if not _annotation(ev):
                kernels.append((start, start + dur, name))
        elif not name.startswith(('cuda', 'cu', 'ProfilerStep')):
            host_ops.append((start, name))
    out.append(Trace(kernels, host_ops, window))
