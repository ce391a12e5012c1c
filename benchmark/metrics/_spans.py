"""Shared helpers of the readers of the program's own spans and counters
(``climatemodel_tpu_torch/utils/timing.py``), read in the run's process
after the window.

A harness march makes one top-level ``march`` span (its f32 call) and one
top-level ``finish`` span (the f64 finish), each with the change of every
program counter over it, so the run's marches are the last
``len(run['marches'])`` of each, in order.  The march traced for the card
is the top-level ``march`` span that overlaps the kernels of
``run['traces'][0]``: spans and kernels share the profiler's clock
(``time.time_ns()``).  Its inner spans (recorded under the profiler) are
its descendants.  Its per-iteration metrics divide by the iterations
``iteration_ms`` divides by (``info.steps.max()``, ``traced_iterations``),
so that they are parts of it; the counter ``march.iterations`` holds also
the no-op iterations up to the closing stop check.  A program that
records no spans gives None.  A driver whose marches run in other
processes (``grey_ranks``) hands rank 0's span log back as
``run['spans']``, which is read instead of this process's.
"""
from __future__ import annotations

import bisect

from metrics._common import trace0, traced_iterations, untraced

#: innermost host spans in which a card-idle gap is put down to a wait
#: for the card, or to the host's dispatch
SYNC = ('march.stop_check', 'blend.sync')
DISPATCH = ('march.step', 'blend')


def log():
    """The program's span log, or None where the program has none."""
    from climatemodel_tpu_torch.utils import timing
    read = getattr(timing, 'spans', None)
    return read() if read is not None else None


def spans_of(run):
    """The span log of the process that made the run's marches, or None."""
    spans = run.get('spans')
    return spans if spans is not None else log()


def _tops(run, name, spans):
    tops = [s for s in spans if s.name == name and s.parent is None]
    n = len(run['marches'])
    return tops[-n:] if len(tops) >= n else None


def untraced_tops(run, name):
    """The top-level ``name`` spans ('march' or 'finish') of
    ``_common.untraced``'s marches, or None."""
    spans = spans_of(run)
    tops = _tops(run, name, spans) if spans is not None else None
    if tops is None:
        return None
    plain = {id(m) for m in untraced(run)}
    return [s for s, m in zip(tops, run['marches']) if id(m) in plain]


def traced_march(run):
    """(the top-level ``march`` span traced for the card, its descendants
    in the order they began), or None."""
    tr, spans = trace0(run), spans_of(run)
    if tr is None or not tr.kernels or spans is None:
        return None
    lo = tr.kernels[0][0]
    hi = max(e for _, e, _ in tr.kernels)
    tops = [s for s in spans if s.name == 'march' and s.parent is None
            and s.start_ns * 1e-9 < hi and s.end_ns * 1e-9 > lo]
    if len(tops) != 1 or not tops[0].counters:
        return None
    ids = {tops[0].id}
    inner = []
    for s in sorted(spans, key=lambda s: s.id):
        if s.parent in ids:
            ids.add(s.id)
            inner.append(s)
    return tops[0], inner


def iterations(top):
    """Lock-step iterations of a top-level march span (its counter)."""
    return top.counters.get('march.iterations', 0)


def total_ns(spans, name):
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name)


def self_ns(spans, name):
    """Time of the ``name`` spans outside their direct children (which run
    one after another, so do not overlap)."""
    ids = {s.id for s in spans if s.name == name}
    child = sum(s.end_ns - s.start_ns for s in spans if s.parent in ids)
    return total_ns(spans, name) - child


def per_iter_ms(run, time_ns):
    """``time_ns(inner spans)`` of the march traced for the card, in ms a
    lock-step iteration as ``iteration_ms`` counts them, or None."""
    got, its = traced_march(run), traced_iterations(run)
    if got is None or not its:
        return None
    return 1e-6 * time_ns(got[1]) / its


def innermost(spans):
    """(times_ns, names): from each time on, the innermost open span's name
    (None outside them all).  Spans of one thread nest."""
    times, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1].end_ns <= t:
            done = stack.pop()
            times.append(done.end_ns)
            names.append(stack[-1].name if stack else None)
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close_until(s.start_ns)
        stack.append(s)
        times.append(s.start_ns)
        names.append(s.name)
    close_until(float('inf'))
    return times, names


def idle_share(run, kinds):
    """Card-idle time between kernels of the traced march whose gap began
    while the host's innermost open span was one of ``kinds``, over the
    traced window (``device_idle_share``'s denominator), in %; or None."""
    tr, got = trace0(run), traced_march(run)
    if got is None or tr.window_s <= 0:
        return None
    top, inner = got
    times, names = innermost([top] + inner)
    idle, end = 0.0, None
    for s, e, _ in tr.kernels:
        if end is not None and s > end:
            i = bisect.bisect_right(times, round(end * 1e9)) - 1
            if i >= 0 and names[i] in kinds:
                idle += s - end
        end = e if end is None else max(end, e)
    return 100.0 * idle / tr.window_s
