"""The readers of the program's spans and counters (``metrics/_spans.py``
and the metrics that use it): on a synthetic run with hand-placed kernels
and spans, on a program that records none, on a tiny cell on the CPU, and
the shared clock on the card."""
import time

import pytest
import torch

import run
from climatemodel_tpu_torch.utils import timing
from core.trace import Trace, profiled
from metrics import _spans, device_idle_share

SEED = 2 ** 31 + 977
T0 = 1_790_000_000_000_000_000          # an epoch in ns, as the clock reads
NEW = ('dispatch_ms_per_iter', 'stop_check_ms_per_iter', 'blend_ms_per_iter',
       'idle_at_sync_share', 'idle_in_dispatch_share', 'blend_syncs_per_iter',
       'finish_iterations', 'finish_repeats', 'finish_members')


def ms(t):
    return T0 + int(t * 1_000_000)


def sp(name, a, b, i, parent=None, counters=None):
    return timing.Span(name, ms(a), ms(b), i, parent, counters)


def top(name, a, i, **counters):
    return sp(name, a, a + 1, i, None, counters)


def synthetic():
    """A run of four marches (two untraced, one traced for the card, one
    for the host) after a warm-up; the card's march lasts 100 ms with two
    iterations (``info.steps.max()``; the loop's counter reads three, the
    last a no-op before the closing stop check):

        march     [0, 100]       iterations 3
          step    [10, 30]  > blend [12, 28] > blend.sync [20, 26]
          step    [40, 50]
          check   [60, 90]
        kernels   [5, 15] [22, 24] [27, 45] [62, 70] [80, 85]

    Gaps: 15-22 begins in the blend (dispatch, 7 ms), 24-27 in its sync
    (3 ms), 45-62 in the second step (dispatch, 17 ms), 70-80 in the stop
    check (sync, 10 ms)."""
    spans = [top('march', -900, 1, **{'march.iterations': 50}),
             top('finish', -880, 2, **{'march.iterations': 999})]
    i = 3
    for j, sweeps in enumerate((10, 14)):         # the untraced marches
        spans += [top('march', -800 + 100 * j, i, **{
                      'march.iterations': 8, 'blend.sweeps': sweeps}),
                  top('finish', -750 + 100 * j, i + 1,
                      **{'march.iterations': 30 + 10 * j,
                         'finish.repeats': 1 + j,
                         'finish.members': 6 - 2 * j})]
        i += 2
    spans += [sp('blend.sync', 20, 26, 12, 11),
              sp('blend', 12, 28, 11, 10),
              sp('march.step', 10, 30, 10, 9),
              sp('march.step', 40, 50, 13, 9),
              sp('march.stop_check', 60, 90, 14, 9),
              sp('march', 0, 100, 9, None, {'march.iterations': 3,
                                             'blend.sweeps': 99}),
              top('finish', 150, 15, **{'march.iterations': 70}),
              top('march', 300, 16, **{'march.iterations': 8}),
              top('finish', 350, 17, **{'march.iterations': 70})]
    kernels = [(ms(a) * 1e-9, ms(b) * 1e-9, 'k') for a, b in
               ((5, 15), (22, 24), (27, 45), (62, 70), (80, 85))]
    r = dict(marches=[dict(traced=t, iterations=2)
                      for t in (None, None, 'device', 'host')],
             traces=[Trace(kernels, [], 100e-3)])
    return r, spans


@pytest.fixture
def fake_log(monkeypatch):
    r, spans = synthetic()
    monkeypatch.setattr(_spans, 'log', lambda: list(spans))
    return r


def read(name, r):
    return run.metric_reader(name)(r)


def test_readers_on_a_synthetic_run(fake_log):
    r = fake_log
    approx = pytest.approx
    assert read('dispatch_ms_per_iter', r) == approx((4 + 10) / 2)
    assert read('stop_check_ms_per_iter', r) == approx(30 / 2)
    assert read('blend_ms_per_iter', r) == approx(16 / 2)
    sync = read('idle_at_sync_share', r)
    dispatch = read('idle_in_dispatch_share', r)
    assert sync == approx(13.0, abs=1e-3)
    assert dispatch == approx(24.0, abs=1e-3)
    assert sync + dispatch <= device_idle_share.read(r)
    assert read('blend_syncs_per_iter', r) == (10 + 14) / 16
    assert read('finish_iterations', r) == (30 + 40) / 2
    assert read('finish_repeats', r) == (1 + 2) / 2
    assert read('finish_members', r) == (6 + 4) / 2


def test_the_traced_march_is_the_one_over_the_kernels(fake_log):
    march, inner = _spans.traced_march(fake_log)
    assert march.id == 9 and march.counters['march.iterations'] == 3
    assert [s.id for s in inner] == [10, 11, 12, 13, 14]


def test_innermost_open_span():
    times, names = _spans.innermost([sp('a', 0, 10, 1), sp('b', 2, 4, 2, 1),
                                     sp('c', 4, 6, 3, 1)])
    at = dict(zip(times, names))
    assert [at[ms(t)] for t in (0, 2, 4, 6, 10)] == ['a', 'b', 'c', 'a',
                                                     None]


def test_a_program_without_spans_reads_nothing(monkeypatch):
    r, _ = synthetic()
    monkeypatch.delattr(timing, 'spans')
    assert all(read(name, r) is None for name in NEW)


def test_a_harness_march_makes_one_march_and_one_finish_span():
    c = run.load_cell('grey_rce.sweep512k')
    c['traffic']['members'] = 12
    since = time.time_ns()
    r = run.measure(c, SEED, 0.5, 0, torch.device('cpu'))
    tops = [s for s in timing.spans(since) if s.parent is None]
    # the warm-up, then each march of the window
    n = 1 + len(r['marches'])
    assert [s.name for s in tops] == ['march', 'finish'] * n
    assert all(s.counters['march.iterations'] > 0 for s in tops[::2])
    per = [m['iterations'] for m in r['marches']]
    assert [_spans.iterations(s) - per_march
            for s, per_march in zip(tops[2::2], per)] == \
        [(-it) % 8 for it in per]
    out = run.result(c, r, 0)
    assert out['correct']
    finishes = tops[3::2]
    assert read('finish_iterations', r) == sum(
        _spans.iterations(s) for s in finishes) / len(r['marches'])
    for name in ('finish_repeats', 'finish_members'):
        assert read(name, r) == sum(s.counters.get(f"finish.{name[7:]}", 0)
                                    for s in finishes) / len(r['marches'])


@pytest.mark.card
def test_spans_hold_their_kernels_on_the_card(card, capsys):
    """Under the harness's card-only profile the program records its inner
    spans, and a span around a launch and its synchronise holds the
    kernel's profiled interval (one clock)."""
    x = torch.ones(1 << 24, device=card)
    torch.cuda.synchronize(card)
    traces, since = [], time.time_ns()
    with profiled(traces):
        on = timing.recording()
        for _ in range(20):
            with timing.span('launch'):
                x.mul_(1.0)
                torch.cuda.synchronize(card)
    assert on
    spans = [s for s in timing.spans(since) if s.name == 'launch']
    kernels = traces[0].kernels
    assert len(spans) == len(kernels) == 20
    lead = [k[0] - s.start_ns * 1e-9 for s, k in zip(spans, kernels)]
    tail = [s.end_ns * 1e-9 - k[1] for s, k in zip(spans, kernels)]
    with capsys.disabled():
        print(f'\nspan start to kernel start: {min(lead) * 1e6:.2f}-'
              f'{max(lead) * 1e6:.2f} us; kernel end to span end: '
              f'{min(tail) * 1e6:.2f}-{max(tail) * 1e6:.2f} us')
    assert min(lead) > 0 and min(tail) > 0
