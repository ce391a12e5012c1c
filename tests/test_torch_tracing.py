"""The port's spans and counters (``utils/timing.py``) and where the march,
the group blend and the f64 finish record them.

Top-level spans (a march or a finish called with no span open) are always
recorded with the change of every counter; inner spans only while a
``torch.profiler`` session records.  Recording never changes a result.
"""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from climatemodel_tpu_torch.constants import p_surface_earth
from climatemodel_tpu_torch.models import column as pcol
from climatemodel_tpu_torch.models import ensemble as pens
from climatemodel_tpu_torch.models.grey import GreyGas
from climatemodel_tpu_torch.ops import convection as pconv
from climatemodel_tpu_torch.utils import timing

F = np.linspace(800.0, 1600.0, 4)


def _grey(nz=20):
    return GreyGas(nz=nz, ny=1, tau_lw_func='scale_height',
                   tau_lw_func_args=[0.22 * p_surface_earth, 4.0],
                   device='cpu', dtype=torch.float32)


def _march(world, convective=False, max_steps=40):
    states, fo, p_int, p_c = pens.grey_ensemble(world, F)
    kw = dict(max_steps=max_steps, convective_adjust=convective)
    fs, info = pens.grey_evolve_ensemble(states, fo, p_int, p_c, 1e-3, **kw)
    return fs, info, fo, p_int, p_c, kw


def _finish(fs, info, fo, p_int, p_c, kw):
    return pens.grey_finish_unconverged_f64(
        fs, info, fo, p_int, p_c, 1e-3, finish_repeats=2,
        finish_max_steps=10, **kw)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_the_profiler_only_top_level_spans_with_their_counters():
    world = _grey()
    since = time.time_ns()
    before = timing.counters()
    fs, info, *rest = _march(world)
    _finish(fs, info, *rest)
    got = timing.spans(since)
    assert [s.name for s in got] == ['march', 'finish']
    march, finish = got
    assert march.parent is None and finish.parent is None
    assert march.start_ns <= march.end_ns <= finish.start_ns <= finish.end_ns
    assert march.counters['march.iterations'] >= int(info.steps.max())
    # the finish's two repeats of its four candidates, each its own march
    assert finish.counters['finish.repeats'] == 2
    assert finish.counters['finish.members'] == 4
    assert finish.counters['march.iterations'] >= 10
    after = timing.counters()
    for k, v in march.counters.items():
        assert after[k] - before.get(k, 0) == v + finish.counters.get(k, 0)


def test_under_the_profiler_spans_nest():
    world = _grey()
    fs, info, *rest = _march(world)
    since = time.time_ns()
    with _cpu_profile():
        assert timing.recording()
        _finish(fs, info, *rest)
    assert not timing.recording()
    got = timing.spans(since)
    by_id = {s.id: s for s in got}
    finish = [s for s in got if s.name == 'finish']
    assert len(finish) == 1 and finish[0].parent is None
    assert finish[0].counters['finish.repeats'] == 2
    marches = [s for s in got if s.name == 'march']
    assert len(marches) == 2
    assert all(m.parent == finish[0].id and m.counters is None
               for m in marches)
    steps = [s for s in got if s.name == 'march.step']
    checks = [s for s in got if s.name == 'march.stop_check']
    assert steps and checks
    assert {s.parent for s in steps + checks} == {m.id for m in marches}
    syncs = [s for s in got if s.name == 'finish.sync']
    assert len(syncs) == 3 and {s.parent for s in syncs} == {finish[0].id}
    for s in got:       # every child lies inside its parent
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize('convective', [False, True])
def test_counters_count_the_loop_and_the_blend(monkeypatch, convective):
    """``march.iterations`` is the lock-step iterations that stepped (each
    a call of the member step here, one shard) and ``blend.sweeps`` the
    group blend's outer sweeps, one host sync each (each sweep, and the
    last look that finds no group, computes the unstable mask once)."""
    calls = {'step': 0, 'mask': 0}
    step, mask = pcol._Lockstep.step, pconv._unstable_mask

    def counted_step(self, frozen):
        calls['step'] += 1
        return step(self, frozen)

    def counted_mask(*a):
        calls['mask'] += 1
        return mask(*a)
    monkeypatch.setattr(pcol._Lockstep, 'step', counted_step)
    monkeypatch.setattr(pconv, '_unstable_mask', counted_mask)
    since = time.time_ns()
    _, info, *_ = _march(_grey(30), convective=convective, max_steps=60)
    [march] = timing.spans(since)
    assert march.counters['march.iterations'] == calls['step']
    # the loop ends at a stop check, one every SYNC_EVERY iterations, so
    # past the last member's stop it steps fewer than SYNC_EVERY no-ops
    idle = calls['step'] - int(info.steps.max())
    assert 0 <= idle < pcol.SYNC_EVERY
    assert calls['step'] % pcol.SYNC_EVERY == 0
    if convective:
        assert calls['mask'] > 0
        assert march.counters['blend.sweeps'] == calls['mask']
    else:
        assert 'blend.sweeps' not in march.counters


def test_blend_spans_under_the_profiler():
    world = _grey(30)
    since = time.time_ns()
    with _cpu_profile():
        _march(world, convective=True, max_steps=16)
    got = timing.spans(since)
    by_id = {s.id: s for s in got}
    [march] = [s for s in got if s.name == 'march']
    blends = [s for s in got if s.name == 'blend']
    syncs = [s for s in got if s.name == 'blend.sync']
    assert blends and len(syncs) == march.counters['blend.sweeps']
    assert all(by_id[b.parent].name == 'march.step' for b in blends)
    assert {s.parent for s in syncs} <= {b.id for b in blends}


def test_one_finish_span_a_call_even_on_the_early_return():
    world = _grey()
    fs, info, fo, p_int, p_c, kw = _march(world, max_steps=3000)
    settled = info._replace(equilibrium=torch.ones_like(info.equilibrium))
    since = time.time_ns()
    out = _finish(fs, settled, fo, p_int, p_c, kw)
    assert len(out[2]) == 0
    [finish] = timing.spans(since)
    assert finish.name == 'finish'
    assert 'finish.repeats' not in finish.counters
    assert finish.counters.get('finish.members', 0) == 0


def test_the_log_is_bounded():
    since = time.time_ns()
    with _cpu_profile():
        for _ in range(timing.SPAN_LIMIT + 10):
            with timing.span('x'):
                pass
    got = timing.spans()
    assert len(got) == timing.SPAN_LIMIT
    assert all(s.name == 'x' and s.start_ns >= since for s in got)
    assert got[-1].id - got[0].id == timing.SPAN_LIMIT - 1


def test_spans_are_stamped_on_the_profiler_clock():
    """A span around a torch op contains the op's profiler event: the
    profiler stamps its events with ``time.time_ns()``'s clock (not
    ``perf_counter_ns`` or ``monotonic_ns``).  A PyTorch whose profiler
    changes its clock fails here."""
    x = torch.ones(4096)
    since = time.time_ns()
    with _cpu_profile() as prof:
        with timing.span('add'):
            torch.add(x, x)
    [s] = timing.spans(since)
    [ev] = [e for e in prof.profiler.kineto_results.events()
            if e.name() == 'aten::add']
    start = ev.start_ns()
    assert s.start_ns <= start <= start + ev.duration_ns() <= s.end_ns


def test_recording_does_not_change_the_march():
    world = _grey(30)
    plain = _march(world, convective=True, max_steps=30)[:2]
    with _cpu_profile():
        traced = _march(world, convective=True, max_steps=30)[:2]
    same = []
    plain[0].map(lambda a, b: same.append(torch.equal(a, b)), traced[0])
    assert same and all(same)
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)
